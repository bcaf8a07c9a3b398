"""Lightweight span tracing + cross-thread trace correlation.

The port's copy of the reference's ``utils/tracing.py``, with one change:
its profiler hook is PyTorch's. An always-on tracer:

  * `span(SPAN_FETCH, url=...)` context manager records spans with
    attributes; spans nest (thread-local stack) into one trace tree per
    top-level span. Durations are measured on `time.monotonic()` (wall
    steps cannot produce negative or inflated spans); each span keeps an
    epoch `start` timestamp for display only.
  * **trace context**: `bind(cycle_id=..., job_id=...)` stamps
    correlation ids on the current thread; `context()` snapshots the
    thread's ids + innermost open span into a `TraceContext` handle, and
    `attach(ctx)` adopts that handle on ANOTHER thread — spans opened
    there parent under the originating trace instead of orphaning into
    their own roots (the engine's fetch pool, the pipeline's watchdog
    sacrificial threads). Ids are stamped into span attrs and — via
    `TraceContextFilter` — into log records, so `grep cycle_id=` lines
    up logs, traces and provenance across the whole process.
  * **W3C trace context (distributed)**: every span carries a 128-bit
    `trace_id` and 64-bit `span_id`; a root span either mints a fresh
    trace (sampled per `set_sample_rate`, the TRACE_SAMPLE knob) or
    ADOPTS a remote parent (`adopt_remote` around the root, fed by
    `parse_traceparent` on an incoming `traceparent` header), so a span
    tree can start on one replica and continue on another. Unsampled
    roots are measured (stats) but neither ringed nor exported.
    `resource` (e.g. {"replica": ...}) is stamped onto every finished
    root, and `add_sink` fans finished sampled roots out to exporters.
  * finished traces land in a bounded ring buffer; `snapshot()` returns
    recent traces as plain dicts. Each span holds at most
    `_MAX_CHILDREN` children (excess
    is counted, not stored) so a pathological fan-out cannot grow a
    trace without bound.
  * per-name aggregate stats (count, total, max) for cheap hot-loop
    dashboards, rendered as Prometheus gauges via `render_metrics()` under
    `foremast_trace_*`.
  * `notes`: a tiny per-thread accumulator the dataplane uses to report
    per-job fetch accounting (delta vs full, points, seconds) up to the
    engine without threading a collector object through every layer.
  * device work is asynchronous, so a span times the host side only;
    `span` additionally opens a `torch.profiler.record_function` range, so
    host spans line up with the card's timeline in a PyTorch profiler
    trace (chip_smoke.py splits the engine cycle's device idle share by
    them).

Span names are REGISTERED constants (`SPAN_NAMES` below, plus the
`SCORE_SPANS`/`STAGE_SPANS` derived maps), so the name set stays a stable,
greppable inventory.
"""
from __future__ import annotations

import logging
import os
import random
import re
import threading
import time
from contextlib import contextmanager

from torch.profiler import record_function

__all__ = [
    "Tracer", "TraceContext", "TraceContextFilter", "tracer", "span",
    "install_log_filter", "SPAN_NAMES", "SCORE_SPANS", "STAGE_SPANS",
    "W3CContext", "parse_traceparent", "mint_trace_id", "mint_span_id",
    "TRACEPARENT_HEADER",
]


# ---------------------------------------------------------------------------
# span-name registry (enforced by the devtools trace-registry rule): every
# tracing.span()/add_timing() name in library code is either one of these
# literals or a reference to one of these constants.
# ---------------------------------------------------------------------------
SPAN_ENGINE_CYCLE = "engine.cycle"
SPAN_ENGINE_CLAIM = "engine.claim"
SPAN_ENGINE_PREPROCESS = "engine.preprocess"
SPAN_ENGINE_SCORE = "engine.score"
SPAN_ENGINE_LSTM_TRAIN = "engine.lstm_train"
SPAN_ENGINE_TRIAGE = "engine.triage"
SPAN_ENGINE_VERDICT = "engine.verdict"
SPAN_DATAPLANE_FETCH = "dataplane.fetch"
SPAN_INGEST_RECEIVE = "ingest.receive"
SPAN_INGEST_FORWARD = "ingest.forward"
SPAN_INGEST_WAL = "ingest.wal_append"
SPAN_INGEST_SPLICE = "ingest.splice"

# per-family scoring spans/timings (engine.score.<family>)
SCORE_SPANS = {
    "pair": "engine.score.pair",
    "band": "engine.score.band",
    "bivariate": "engine.score.bivariate",
    "lstm": "engine.score.lstm",
    "hpa": "engine.score.hpa",
}

# per-stage cycle timing accumulators (engine.stage.<stage>)
STAGE_SPANS = {
    "preprocess": "engine.stage.preprocess",
    "dispatch": "engine.stage.dispatch",
    "collect": "engine.stage.collect",
    "fold": "engine.stage.fold",
}

SPAN_NAMES = frozenset({
    SPAN_ENGINE_CYCLE, SPAN_ENGINE_CLAIM, SPAN_ENGINE_PREPROCESS,
    SPAN_ENGINE_SCORE, SPAN_ENGINE_LSTM_TRAIN, SPAN_ENGINE_TRIAGE,
    SPAN_ENGINE_VERDICT, SPAN_DATAPLANE_FETCH,
    SPAN_INGEST_RECEIVE, SPAN_INGEST_FORWARD, SPAN_INGEST_WAL,
    SPAN_INGEST_SPLICE,
    *SCORE_SPANS.values(), *STAGE_SPANS.values(),
})

# bound on stored children per span: a span past it counts drops instead
# of growing the trace tree (always-on tracing must be allocation-bounded)
_MAX_CHILDREN = 128


# ---------------------------------------------------------------------------
# W3C trace context (https://www.w3.org/TR/trace-context/): the wire half
# of distributed tracing. `traceparent: 00-<32hex>-<16hex>-<2hex>` travels
# on push requests and ring forwards; parse is STRICT (lowercase hex,
# non-zero ids, version != ff, version 00 admits no extra fields) and a
# malformed header yields None — callers mint a fresh root instead (never
# an error: a hostile header must not 5xx an ingest endpoint).
# ---------------------------------------------------------------------------
TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})(-.+)?$")


def mint_trace_id() -> str:
    return os.urandom(16).hex()


def mint_span_id() -> str:
    return os.urandom(8).hex()


class W3CContext:
    """One parsed/mintable trace-context point: the (trace, span) a new
    span on another thread/replica parents under, plus the sampled flag
    that travels with it."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool = True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    def traceparent(self) -> str:
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"W3CContext({self.traceparent()})"


def parse_traceparent(header) -> W3CContext | None:
    """Strictly parse a `traceparent` header; None on anything malformed
    (bad version, short/non-hex/all-zero ids, oversized, junk) — the
    caller starts a fresh root trace instead."""
    if not isinstance(header, str):
        return None
    header = header.strip()
    if not header or len(header) > 256:
        return None
    m = _TRACEPARENT_RE.match(header)
    if m is None:
        return None
    version, trace_id, span_id, flags, rest = m.groups()
    if version == "ff":
        return None
    if version == "00" and rest:
        return None  # version 00 defines exactly four fields
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return W3CContext(trace_id, span_id, bool(int(flags, 16) & 0x01))


class TraceContext:
    """Snapshot of one thread's trace state, portable across threads."""

    __slots__ = ("ids", "parent", "remote")

    def __init__(self, ids: dict, parent, remote: W3CContext | None = None):
        self.ids = ids
        self.parent = parent  # innermost open _Span, or None
        self.remote = remote  # adopted W3C parent for fresh roots, or None


class _Span:
    __slots__ = ("name", "attrs", "start", "end", "_m0", "_m1", "children",
                 "dropped", "trace_id", "span_id", "parent_span_id",
                 "sampled")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.start = time.time()       # epoch, display only
        self._m0 = time.monotonic()    # duration clock (never steps)
        self._m1 = self._m0
        self.end = 0.0
        self.children: list[_Span] = []
        self.dropped = 0
        # W3C identity — assigned by Tracer.span() at open (inherited
        # from the parent span, adopted from a remote context, or minted)
        self.trace_id = ""
        self.span_id = ""
        self.parent_span_id = ""
        self.sampled = True

    @property
    def duration(self) -> float:
        return self._m1 - self._m0

    def context(self) -> W3CContext:
        """This span as a W3C parent (inject on forwards, hand to the
        scheduler so the verdict span parents under it)."""
        return W3CContext(self.trace_id, self.span_id, self.sampled)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "start": self.start,
            "duration_ms": round(self.duration * 1000.0, 3),
        }
        if self.trace_id:
            d["trace_id"] = self.trace_id
            d["span_id"] = self.span_id
        if self.parent_span_id:
            d["parent_span_id"] = self.parent_span_id
        if self.attrs:
            d["attrs"] = self.attrs
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        if self.dropped:
            d["children_dropped"] = self.dropped
        return d


class Tracer:
    """Thread-safe tracer with a bounded ring of finished root traces."""

    def __init__(self, max_traces: int = 256):
        self.max_traces = max_traces
        self._lock = threading.Lock()
        self._traces: list[dict] = []
        self._stats: dict[str, list] = {}  # name -> [count, total_s, max_s]
        self._local = threading.local()
        # head-based sampling for freshly MINTED roots (TRACE_SAMPLE):
        # adopted remote parents carry their own sampled flag and are
        # honored instead. Unsampled spans keep their ids (propagation
        # stays coherent) and their stats; only ring + sinks are skipped.
        self._sample_rate = 1.0
        # process identity stamped onto every finished root (and onto
        # OTLP resource attributes): e.g. {"replica": "<id>"}
        self.resource: dict = {}
        # finished-sampled-root subscribers (the OTLP trace exporter);
        # called OUTSIDE the ring lock, exceptions swallowed
        self._sinks: list = []

    # -- sampling / export wiring ----------------------------------------
    def set_sample_rate(self, rate: float):
        try:
            rate = float(rate)
        except (TypeError, ValueError):
            rate = 1.0
        self._sample_rate = min(max(rate, 0.0), 1.0)

    @property
    def sample_rate(self) -> float:
        return self._sample_rate

    def _sample_decision(self) -> bool:
        r = self._sample_rate
        if r >= 1.0:
            return True
        if r <= 0.0:
            return False
        return random.random() < r

    def add_sink(self, fn):
        if fn not in self._sinks:
            self._sinks.append(fn)

    def remove_sink(self, fn):
        try:
            self._sinks.remove(fn)
        except ValueError:
            pass

    # -- trace context ----------------------------------------------------
    def current_ids(self) -> dict:
        """This thread's correlation ids ({} when unbound)."""
        ids = getattr(self._local, "ids", None)
        return dict(ids) if ids else {}

    @contextmanager
    def bind(self, **ids):
        """Stamp correlation ids (cycle_id=..., job_id=...) on THIS thread
        for the duration of the block; nested binds layer and restore."""
        old = getattr(self._local, "ids", None)
        merged = dict(old) if old else {}
        merged.update({k: v for k, v in ids.items() if v is not None})
        self._local.ids = merged
        try:
            yield
        finally:
            self._local.ids = old

    def context(self) -> TraceContext:
        """Snapshot this thread's ids + innermost open span for `attach`
        on a worker thread."""
        stack = getattr(self._local, "stack", None)
        return TraceContext(self.current_ids(),
                            stack[-1] if stack else None,
                            getattr(self._local, "remote", None))

    @contextmanager
    def adopt_remote(self, ctx: W3CContext | None):
        """Adopt a remote W3C parent for ROOT spans opened inside the
        block: the root continues the remote trace (same trace_id,
        parent_span_id = the remote span, sampled flag honored) instead
        of minting its own. `ctx=None` is a no-op passthrough, so call
        sites can adopt conditionally without branching."""
        if ctx is None:
            yield
            return
        old = getattr(self._local, "remote", None)
        self._local.remote = ctx
        try:
            yield
        finally:
            self._local.remote = old

    def current_w3c(self) -> W3CContext | None:
        """The innermost open span as a W3C context (or the adopted
        remote parent when no span is open on this thread)."""
        stack = getattr(self._local, "stack", None)
        if stack:
            return stack[-1].context()
        return getattr(self._local, "remote", None)

    def current_traceparent(self) -> str:
        """`traceparent` header value for outbound propagation ('' when
        this thread has no open span or adopted remote context)."""
        ctx = self.current_w3c()
        return ctx.traceparent() if ctx is not None else ""

    def current_trace_id(self) -> str:
        ctx = self.current_w3c()
        return ctx.trace_id if ctx is not None else ""

    @contextmanager
    def attach(self, ctx: TraceContext):
        """Adopt a `context()` handle on the current thread: spans opened
        inside parent under the handle's span (cross-thread children of
        the originating trace) and the ids propagate to spans and log
        records. Thread-local state is restored on exit, so a thread that
        never exits (an abandoned watchdog call) can at worst add late —
        silently dropped — children to an already-finished parent; it can
        never corrupt another thread's stack."""
        old_stack = getattr(self._local, "stack", None)
        old_ids = getattr(self._local, "ids", None)
        old_remote = getattr(self._local, "remote", None)
        self._local.stack = [ctx.parent] if ctx.parent is not None else []
        self._local.ids = dict(ctx.ids) if ctx.ids else None
        self._local.remote = ctx.remote
        try:
            yield
        finally:
            self._local.stack = old_stack
            self._local.ids = old_ids
            self._local.remote = old_remote

    # -- notes: per-thread accounting for the current unit of work --------
    def begin_notes(self):
        """Open a fresh per-thread note accumulator (the engine brackets
        each job's preprocess with begin/take)."""
        self._local.notes = {}

    def add_note(self, key: str, inc: float = 1.0):
        """Fold a count into the current thread's open note accumulator;
        a no-op when none is open (zero overhead outside the engine)."""
        n = getattr(self._local, "notes", None)
        if n is not None:
            n[key] = n.get(key, 0) + inc

    def take_notes(self) -> dict:
        """Close and return the current accumulator ({} when none)."""
        n = getattr(self._local, "notes", None)
        self._local.notes = None
        return n or {}

    # -- recording --
    @contextmanager
    def span(self, name: str, _remote: W3CContext | None = None, **attrs):
        """Record one span. `_remote` forces the span to parent under a
        REMOTE W3C context and finish as its own root tree regardless of
        the local stack — the engine's per-job verdict span uses it to
        close a push's distributed trace from inside the open cycle
        span (the two trees share the push's trace_id; an OTLP backend
        renders them as one trace)."""
        ids = getattr(self._local, "ids", None)
        if ids:
            attrs = {**ids, **attrs}
        s = _Span(name, attrs)
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        parent = stack[-1] if stack else None
        forced_root = _remote is not None
        if forced_root:
            parent = None
        # W3C identity: inherit from the local parent, adopt the remote
        # parent (explicit `_remote`, or the thread's adopt_remote block
        # for a fresh root), or mint a new sampled-or-not trace
        if parent is not None:
            s.trace_id = parent.trace_id
            s.parent_span_id = parent.span_id
            s.sampled = parent.sampled
        else:
            remote = _remote if _remote is not None \
                else getattr(self._local, "remote", None)
            if remote is not None:
                s.trace_id = remote.trace_id
                s.parent_span_id = remote.span_id
                s.sampled = remote.sampled
            else:
                s.trace_id = mint_trace_id()
                s.sampled = self._sample_decision()
        s.span_id = mint_span_id()
        stack.append(s)
        try:
            with record_function(name):
                yield s
        finally:
            s._m1 = time.monotonic()
            s.end = s.start + s.duration
            stack.pop()
            if parent is not None:
                # list.append is atomic under the GIL, so cross-thread
                # children (attach) land safely; the cap check is racy
                # only in how tightly it bounds, never in correctness.
                # A parent with end set already finished (and, if a root,
                # was serialized into the ring) — a late child from an
                # abandoned attach()'d thread is dropped, not appended,
                # so finished traces are never retroactively mutated.
                if parent.end:
                    parent.dropped += 1
                elif len(parent.children) < _MAX_CHILDREN:
                    parent.children.append(s)
                else:
                    parent.dropped += 1
            else:
                self._finish_root(s)
            dur = s.duration
            with self._lock:
                st = self._stats.setdefault(name, [0, 0.0, 0.0])
                st[0] += 1
                st[1] += dur
                st[2] = max(st[2], dur)

    def add_timing(self, name: str, seconds: float, count: int = 1):
        """Fold an externally-measured duration into the per-name aggregate
        stats (and the foremast_trace_* gauges) without opening a span.

        The pipelined engine cycle interleaves its stages — preprocess
        waits, dispatch packing, collect materialization — so a stage's
        time is accumulated piecewise across the whole cycle and cannot
        nest as one context manager. This records the already-summed
        number; traces (the span tree) are untouched."""
        with self._lock:
            st = self._stats.setdefault(name, [0, 0.0, 0.0])
            st[0] += count
            st[1] += seconds
            st[2] = max(st[2], seconds)

    def _finish_root(self, s: _Span):
        if not s.sampled:
            return  # measured (stats above) but never stored or exported
        d = s.to_dict()
        if self.resource:
            d["resource"] = dict(self.resource)
        with self._lock:
            self._traces.append(d)
            if len(self._traces) > self.max_traces:
                del self._traces[: len(self._traces) - self.max_traces]
        for sink in list(self._sinks):
            try:
                sink(d)
            except Exception:  # noqa: BLE001 - a sink must not hurt a span
                logging.getLogger(__name__).exception("trace sink failed")

    # -- reading --
    def snapshot(self, limit: int = 50,
                 trace_id: str | None = None) -> list[dict]:
        with self._lock:
            if trace_id:
                return [t for t in self._traces
                        if t.get("trace_id") == trace_id][-limit:]
            return list(self._traces[-limit:])

    def stats(self) -> dict:
        with self._lock:
            return {
                name: {"count": c, "total_seconds": round(t, 6),
                       "max_seconds": round(mx, 6)}
                for name, (c, t, mx) in sorted(self._stats.items())
            }

    def render_metrics(self) -> str:
        """Prometheus text lines (joined into the exporter's /metrics)."""
        lines = []
        for name, st in self.stats().items():
            tag = f'{{span="{name}"}}'
            lines.append(f"foremast_trace_count{tag} {st['count']}")
            lines.append(f"foremast_trace_seconds_total{tag} {st['total_seconds']}")
            lines.append(f"foremast_trace_seconds_max{tag} {st['max_seconds']}")
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self):
        with self._lock:
            self._traces.clear()
            self._stats.clear()


tracer = Tracer()  # process-wide default
span = tracer.span


class TraceContextFilter(logging.Filter):
    """Stamp the current thread's trace ids onto every log record as
    `record.trace_ctx` (e.g. " cycle_id=w0-c12 job_id=abc"), so a format
    string ending in %(trace_ctx)s makes `grep cycle_id=` correlate the
    process log with /debug/traces and /jobs/<id>/explain. Records from
    unbound threads get an empty string — the format never breaks."""

    def __init__(self, source: Tracer | None = None):
        super().__init__()
        self._tracer = source or tracer

    def filter(self, record: logging.LogRecord) -> bool:
        ids = self._tracer.current_ids()
        record.trace_ctx = (
            "".join(f" {k}={v}" for k, v in sorted(ids.items()))
            if ids else "")
        return True


def install_log_filter(source: Tracer | None = None) -> int:
    """Attach a TraceContextFilter to every root-logger handler (call
    after logging.basicConfig). Returns the number of handlers touched."""
    filt = TraceContextFilter(source)
    handlers = logging.getLogger().handlers
    for h in handlers:
        if not any(isinstance(f, TraceContextFilter) for f in h.filters):
            h.addFilter(filt)
    return len(handlers)
