"""Data sources: fetch (timestamps, values) series for a query URL.

The engine's hot loop fetches current/baseline/historical windows for every
open job. Sources are pluggable:

  * PrometheusDataSource — real HTTP `query_range` (urllib; response shape
    {"data":{"result":[{"values":[[ts,"v"],...]}]}}). Multiple result series
    are averaged element-wise (the reference's recording rules pre-aggregate
    to one series per query; the average keeps us safe if a selector matches
    several).
  * WavefrontDataSource — chart-API shape {"timeseries":[{"data":[[ts,v],...]}]}.
  * FixtureDataSource — dict/url -> series or a callable; the test/demo seam
    (the reference's equivalent seam was the injectable HTTP DoFunc,
    foremast-barrelman/pkg/client/analyst/analystclient.go:24).
  * RawFixtureDataSource — dict/url -> raw response BYTES through the real
    parse path; the seam for parser-sensitive benchmarks and tests.

All sources return (timestamps, values) sequences (lists, or numpy arrays
when the native parser handled the response).

Parsing goes through the C++ extension (the port's own copy in native/: single-pass
extracting scanner + duplicate-averaging merge) when it is available, with
the json.loads path kept as the pure-Python fallback — same results either
way (tests/test_torch_fetch.py asserts exact parity on the port's copy).
"""
from __future__ import annotations

import http.client
import json
import threading
import time
import urllib.request
from collections import OrderedDict
from typing import Callable
from urllib.parse import urljoin, urlsplit

import numpy as np

from .. import native
from ..utils import tracing
from ..utils.locks import make_lock
from ..ops.windowing import MAX_WINDOW_STEPS, Window, align_step, resample_to_grid


class FetchError(Exception):
    pass


class HttpConnectionPool:
    """Bounded per-host keep-alive pool over http.client.

    The engine re-queries the same handful of metric-store hosts every
    cycle; per-call `urllib.request.urlopen` paid a fresh TCP (and TLS)
    handshake for every one of those queries. This pool keeps up to
    `max_per_host` idle connections per (scheme, host, port) and reuses
    them across cycles. Error semantics match the urlopen path the
    sources had: any transport or non-2xx failure raises (the sources
    convert to FetchError), so the resilience layer's breaker/retry
    accounting above is unchanged. A request that fails on a REUSED
    connection retries once on a fresh one — keep-alive servers close
    idle connections at will, and these are idempotent GETs.

    Non-http(s) schemes fall back to urlopen (file:// fixtures etc.).
    """

    _MAX_REDIRECTS = 4  # urlopen followed redirects; keep that behavior

    def __init__(self, max_per_host: int = 8):
        self.max_per_host = max_per_host
        self._idle: dict[tuple, list] = {}
        self._lock = make_lock("dataplane.fetch.conn_pool")
        self.connections_opened = 0  # observability: new TCP handshakes
        self.requests_served = 0
        # env proxies (http_proxy/https_proxy/no_proxy): urlopen honored
        # them via ProxyHandler; proxied hosts keep that path instead of
        # a doomed direct connect
        self._proxies = urllib.request.getproxies()

    def _checkout(self, key, fresh: bool = False):
        if not fresh:
            with self._lock:
                conns = self._idle.get(key)
                if conns:
                    return conns.pop(), True
        scheme, host, port = key
        cls = (http.client.HTTPSConnection if scheme == "https"
               else http.client.HTTPConnection)
        with self._lock:
            self.connections_opened += 1
        return cls(host, port), False

    def _checkin(self, key, conn):
        with self._lock:
            conns = self._idle.setdefault(key, [])
            if len(conns) < self.max_per_host:
                conns.append(conn)
                return
        conn.close()

    def request(self, url: str, timeout: float = 10.0,
                headers: dict | None = None) -> bytes:
        parts = urlsplit(url)
        if parts.scheme not in ("http", "https") or self._proxied(parts):
            req = urllib.request.Request(url, headers=headers or {})
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return r.read()
        for _ in range(self._MAX_REDIRECTS + 1):
            out = self._one(parts, url, timeout, headers)
            if isinstance(out, bytes):
                self.requests_served += 1
                return out
            url = out  # redirect target
            parts = urlsplit(url)
            if parts.scheme not in ("http", "https"):
                with urllib.request.urlopen(url, timeout=timeout) as r:
                    return r.read()
        raise OSError(f"too many redirects for {url}")

    def _one(self, parts, url: str, timeout, headers):
        key = (parts.scheme, parts.hostname or "",
               parts.port or (443 if parts.scheme == "https" else 80))
        path = parts.path or "/"
        if parts.query:
            path += "?" + parts.query
        last_exc = None
        for attempt in (0, 1):
            # the retry attempt forces a FRESH connection: after a server
            # roll the idle pool may hold several dead sockets, and popping
            # another one would report a healthy backend as failed
            conn, reused = self._checkout(key, fresh=attempt > 0)
            conn.timeout = timeout
            if conn.sock is not None:
                # http.client applies self.timeout only inside connect();
                # a reused connection's live socket must be re-armed or it
                # keeps whichever timeout its opener used
                conn.sock.settimeout(timeout)
            try:
                conn.request("GET", path, headers=headers or {})
                resp = conn.getresponse()
                body = resp.read()  # drain fully or the conn can't be reused
            except Exception as e:  # noqa: BLE001 - transport boundary
                conn.close()
                last_exc = e
                if reused:
                    continue  # stale keep-alive connection: one fresh retry
                raise
            if resp.will_close:
                conn.close()
            else:
                self._checkin(key, conn)
            if resp.status in (301, 302, 303, 307, 308):
                loc = resp.getheader("Location")
                if loc:
                    return urljoin(url, loc)
            if not 200 <= resp.status < 300:
                raise OSError(f"HTTP {resp.status} for {url}: "
                              f"{body[:200]!r}")
            return body
        raise last_exc

    def _proxied(self, parts) -> bool:
        if parts.scheme not in self._proxies:
            return False
        try:
            return not urllib.request.proxy_bypass(parts.netloc)
        except Exception:  # noqa: BLE001 - platform bypass lookups can fail
            return True


# process-wide default pool, shared by every HTTP-backed source (they all
# target the same few metric-store hosts); tests monkeypatch
# `HTTP_POOL.request` where they used to monkeypatch urlopen
HTTP_POOL = HttpConnectionPool()


# Span-endpoint cap for hostile timestamps, shared by grid_from_series and
# pinned by tests/test_native_fuzz.py — MUST match kTsCap in
# native/src/foremast_native.cpp (fm_parse_grid) so the python fallback
# and the native fast path degrade identically on absurd bodies.
TS_SPAN_CAP = 4.0e18


def grid_from_series(ts, vals, step: int = 60,
                     max_steps: int = MAX_WINDOW_STEPS) -> Window:
    """(ts, vals) -> the engine's grid Window: span from the data's own
    min/max timestamps, clamped to the largest compiled bucket keeping the
    most recent samples (a query returning >11 days must not produce an
    unbucketable window). np.max/np.min because ts may be a 10k-point
    ndarray off the native parser (builtin max would box every element)."""
    ts_arr = np.asarray(ts, np.float64)
    vals_arr = np.asarray(vals, np.float64)
    # span from FINITE timestamps only, clamped well inside int range —
    # json.loads accepts NaN/Infinity tokens where strict JSON forbids
    # them, and int(nan) raises while int(1e300) builds an absurd window
    # (resample_to_grid already drops the non-finite samples themselves)
    finite = ts_arr[np.isfinite(ts_arr)]
    if finite.size == 0:
        return Window(np.zeros(1, np.float32), np.zeros(1, bool), 0, step)
    cap = TS_SPAN_CAP
    end = align_step(float(np.clip(np.max(finite), -cap, cap)), step) + step
    start = max(align_step(float(np.clip(np.min(finite), -cap, cap)), step),
                end - max_steps * step)
    return resample_to_grid(ts_arr, vals_arr, start, end, step)


def _probably_error_body(raw: bytes) -> bool:
    """Status probe shared by every native fast path. Only a PREFIX is
    scanned: Prometheus serializes the top-level "status" first, and a
    full-body scan would false-positive on series whose LABELS contain
    status="error" (common on the error metrics we monitor), permanently
    disabling the fast path for them."""
    head = raw[:256]
    return b'"status":"error"' in head or b'"status": "error"' in head


def window_from_prometheus_body(raw: bytes, step: int = 60,
                                max_steps: int = MAX_WINDOW_STEPS) -> Window:
    """Response body -> grid Window; single fused native call when the
    extension is built (parse+align+clamp+resample without intermediate
    arrays), else the parse_series/Python path + grid_from_series. Same
    error-probe rules as parse_prometheus_body."""
    if not _probably_error_body(raw):
        win = native.parse_grid(raw, native.FLAVOR_PROMETHEUS, step, max_steps)
        if win is not None:
            vals, mask, start = win
            return Window(vals, mask, start, step)
    ts, vals = parse_prometheus_body(raw)
    return grid_from_series(ts, vals, step, max_steps)


def _avg_series(series: list[list[tuple[float, float]]]):
    """Element-wise average of several [(ts, v)] series by timestamp."""
    if not series:
        return [], []
    acc: dict[float, list[float]] = {}
    for s in series:
        for ts, v in s:
            acc.setdefault(float(ts), []).append(float(v))
    out_ts = sorted(acc)
    return out_ts, [sum(acc[t]) / len(acc[t]) for t in out_ts]


def parse_prometheus_body(raw: bytes):
    """Response body -> (ts, vals); native fast path with Python fallback.

    Fast path: single-pass native scan (no DOM), gated by the
    _probably_error_body prefix probe. Error responses normally arrive
    with non-2xx codes (the transport raised before reaching here) — the
    probe is belt-and-braces for proxies that flatten the status code.
    """
    if not _probably_error_body(raw):
        parsed = native.parse_series(raw, native.FLAVOR_PROMETHEUS)
        if parsed is not None:
            return parsed
    payload = json.loads(raw)
    if payload.get("status") not in (None, "success"):
        raise FetchError(f"prometheus error: {payload}")
    result = payload.get("data", {}).get("result", [])
    series = [
        [(float(ts), float(v)) for ts, v in item.get("values", [])]
        for item in result
    ]
    return _avg_series(series)


class PrometheusDataSource:
    def __init__(self, timeout: float = 10.0, pool: HttpConnectionPool | None = None):
        self.timeout = timeout
        self.pool = pool or HTTP_POOL  # keep-alive: reuse conns across cycles

    def _raw(self, url: str) -> bytes:
        try:
            return self.pool.request(url, timeout=self.timeout)
        except Exception as e:  # noqa: BLE001 - network boundary
            raise FetchError(f"prometheus fetch failed: {e}") from e

    def fetch(self, url: str):
        return parse_prometheus_body(self._raw(url))

    def fetch_series(self, url: str):
        """(ts, vals, nbytes) — the delta layer's seam: parsed samples plus
        the response size for bytes-saved accounting."""
        raw = self._raw(url)
        ts, vals = parse_prometheus_body(raw)
        return ts, vals, len(raw)

    def fetch_window(self, url: str) -> Window:
        """Engine fast path: body bytes -> grid Window (fused native parse
        when built). Sources exposing fetch_window let the engine skip the
        intermediate (ts, vals) arrays entirely."""
        return window_from_prometheus_body(self._raw(url))


def parse_wavefront_body(raw: bytes):
    """Chart-API body -> (ts, vals); native fast path, Python fallback."""
    parsed = native.parse_series(raw, native.FLAVOR_WAVEFRONT)
    if parsed is not None:
        return parsed
    payload = json.loads(raw)
    series = [
        [(float(ts), float(v)) for ts, v in item.get("data", [])]
        for item in payload.get("timeseries", [])
    ]
    return _avg_series(series)


class WavefrontDataSource:
    def __init__(self, token: str = "", timeout: float = 10.0,
                 pool: HttpConnectionPool | None = None):
        self.token = token
        self.timeout = timeout
        self.pool = pool or HTTP_POOL

    def _raw(self, url: str) -> bytes:
        headers = {"Authorization": f"Bearer {self.token}"} if self.token else {}
        try:
            return self.pool.request(url, timeout=self.timeout,
                                     headers=headers)
        except Exception as e:  # noqa: BLE001
            raise FetchError(f"wavefront fetch failed: {e}") from e

    def fetch(self, url: str):
        return parse_wavefront_body(self._raw(url))

    def fetch_series(self, url: str):
        raw = self._raw(url)
        ts, vals = parse_wavefront_body(raw)
        return ts, vals, len(raw)

    def fetch_window(self, url: str, step: int = 60,
                     max_steps: int = MAX_WINDOW_STEPS) -> Window:
        """Fused byte path, same shape as the Prometheus sources'."""
        raw = self._raw(url)
        win = native.parse_grid(raw, native.FLAVOR_WAVEFRONT, step, max_steps)
        if win is not None:
            vals, mask, start = win
            return Window(vals, mask, start, step)
        ts, vals = parse_wavefront_body(raw)
        return grid_from_series(ts, vals, step, max_steps)


class RawFixtureDataSource:
    """URL -> canned raw Prometheus response BYTES, parsed through the same
    path as the live source (native scanner + Python fallback).

    FixtureDataSource hands the engine pre-parsed series, which is right
    for logic tests but skips the parse stage entirely; this source keeps
    the parse in the loop, so parser-sensitive paths (bench_cycle's
    FOREMAST_NATIVE comparison, parser regression tests) exercise the
    production code without a network."""

    def __init__(self, pages: dict | None = None,
                 resolver: Callable[[str], bytes] | None = None,
                 keep_urls: bool = True):
        self.pages = {} if pages is None else pages
        self.resolver = resolver
        # keep_urls=False keeps only the counter: a 100k-job simfleet
        # cycle issues ~200k fetches, and retaining every URL string
        # would dominate the resident-memory figure a fleet benchmark
        # exists to measure.
        self.keep_urls = keep_urls
        self.requests: list[str] = []
        self.request_count = 0

    def _raw(self, url: str) -> bytes:
        self.request_count += 1
        if self.keep_urls:
            self.requests.append(url)
        raw = self.pages.get(url)
        if raw is None and self.resolver is not None:
            raw = self.resolver(url)
        if raw is None:
            raise FetchError(f"no fixture page for {url}")
        return raw

    def fetch(self, url: str):
        return parse_prometheus_body(self._raw(url))

    def fetch_series(self, url: str):
        raw = self._raw(url)
        ts, vals = parse_prometheus_body(raw)
        return ts, vals, len(raw)

    def fetch_window(self, url: str) -> Window:
        return window_from_prometheus_body(self._raw(url))


class FixtureDataSource:
    """URL -> canned series; or a resolver callable(url) -> (ts, vals)."""

    def __init__(self, fixtures: dict | None = None,
                 resolver: Callable[[str], tuple] | None = None):
        # keep the caller's dict object (tests mutate it after construction);
        # `fixtures or {}` would silently detach an initially-empty dict
        self.fixtures = {} if fixtures is None else fixtures
        self.resolver = resolver
        self.requests: list[str] = []

    def fetch(self, url: str):
        self.requests.append(url)
        if url in self.fixtures:
            ts, vals = self.fixtures[url]
            return list(ts), list(vals)
        if self.resolver is not None:
            return self.resolver(url)
        raise FetchError(f"no fixture for {url}")


class _Flight:
    """One in-progress cache miss: the leader's outcome, shared by waiters."""

    __slots__ = ("done", "result", "exc")

    def __init__(self):
        self.done = threading.Event()
        self.result = None
        self.exc = None


class CachingDataSource:
    """LRU+TTL wrapper, bounded by MAX_CACHE_SIZE — the reference brain's
    in-memory model/window cache (foremast-brain/README.md:30), rebuilt from
    historical queries on miss.

    The TTL is load-bearing, not an optimization detail: the engine re-fetches
    the SAME current-window URL every cycle until endTime (fail-fast recheck,
    design.md:43). A TTL-less cache would freeze the first — mostly empty —
    response and judge stale data forever.

    Misses are SINGLE-FLIGHT: when many fetch-pool threads miss the same
    key at once (the every-cycle case — a TTL expiry hits all of a job's
    duplicate queries in the same instant), only one thread calls the
    inner source; the rest wait and reuse its result. Without this, TTL
    expiry stampedes the backend at the exact moment it is least able to
    take it (every waiter is a would-be concurrent query). A leader's
    failure is re-raised to its waiters — they arrived inside the same
    fetch window, so they share its outcome, not a retry storm."""

    def __init__(self, inner, max_entries: int = 1024, ttl_seconds: float = 55.0,
                 clock=None):
        # default just under the 60 s metric step: one fresh fetch per new
        # sample, cycle-frequency dedupe in between
        self.inner = inner
        self.max_entries = max_entries
        self.ttl_seconds = ttl_seconds
        # injectable clock: the streamed-ingest bench drives the TTL with
        # synthetic time (wall time barely moves between its cycles, so
        # real-time TTLs would never expire inside a bench run)
        self.clock = clock or time.time
        self._cache: OrderedDict[str, tuple] = OrderedDict()  # url -> (res, at)
        self._lock = make_lock("dataplane.fetch.ttl_cache")
        self._flights: dict = {}  # key -> _Flight (in-progress miss)
        # keys invalidated while a flight was in progress: the leader's
        # publish skips caching them (see invalidate())
        self._invalidated: set = set()
        self.hits = 0
        self.misses = 0
        self.single_flight_waits = 0  # threads that reused a leader's fetch

    def fetch(self, url: str):
        return self._cached(url, self.inner.fetch, url)

    def fetch_window(self, url: str):
        """Delegate the engine's Window fast path through the same cache
        (separate key space — a cached parsed series is not a Window).
        Returns None when the inner source has no byte-level path, which
        tells the engine to use fetch() instead."""
        fw = getattr(self.inner, "fetch_window", None)
        if fw is None:
            return None
        return self._cached(("window", url), fw, url)

    def set_cycle_deadline(self, deadline):
        """Pass the engine's cycle deadline through to a resilient inner
        source (no-op over plain sources) — the cache must not hide the
        deadline plumbing from the analyzer."""
        sd = getattr(self.inner, "set_cycle_deadline", None)
        if sd is not None:
            sd(deadline)

    def invalidate(self, url: str) -> None:
        """Drop both key spaces for one URL. The push-ingest receiver
        calls this after splicing fresh samples into the delta layer
        below — the TTL's staleness bound is exactly the wait streaming
        exists to remove, so a known-advanced window must not be served
        stale for the rest of its TTL. An IN-FLIGHT fetch of the same
        key is poisoned too: its result may predate the splice, and the
        single-flight publish would otherwise re-cache the pre-push
        window for a full TTL."""
        with self._lock:
            for key in (url, ("window", url)):
                self._cache.pop(key, None)
                if key in self._flights:
                    self._invalidated.add(key)

    def _cached(self, key, fn, *args):
        now = self.clock()
        with self._lock:
            if key in self._cache:
                res, at = self._cache[key]
                if now - at <= self.ttl_seconds:
                    self._cache.move_to_end(key)
                    self.hits += 1
                    # per-job fetch provenance: served from the TTL cache
                    tracing.tracer.add_note("fetch_cached")
                    return res
                del self._cache[key]
            flight = self._flights.get(key)
            if flight is None:
                flight = _Flight()
                self._flights[key] = flight
                leader = True
            else:
                leader = False
        if not leader:
            # another thread is already fetching this key: wait for its
            # outcome instead of stampeding the backend. The leader sets
            # the event in a finally, so this wait always terminates.
            flight.done.wait()
            with self._lock:
                self.single_flight_waits += 1
            if flight.exc is not None:
                raise flight.exc
            return flight.result
        try:
            flight.result = fn(*args)
        except BaseException as e:
            flight.exc = e
            raise
        finally:
            # publish (result or exc already stamped on the flight), drop
            # the flight entry, THEN wake waiters — a thread arriving after
            # the pop starts a fresh fetch against the updated cache
            with self._lock:
                self._flights.pop(key, None)
                # the poison mark is consumed whatever the outcome: a
                # FAILED invalidated flight must not suppress caching of
                # the next successful fetch
                poisoned = key in self._invalidated
                self._invalidated.discard(key)
                if flight.exc is None:
                    self.misses += 1
                    if not poisoned:
                        # (an invalidated-mid-flight result predates the
                        # push splice — serve it to the waiters but
                        # never cache it)
                        self._cache[key] = (flight.result, now)
                    if len(self._cache) > self.max_entries:
                        self._cache.popitem(last=False)
            flight.done.set()
        return flight.result
