"""Job documents, the brain status machine, and the durable job store.

Wire/behavior contracts re-implemented (not ported) from the reference:
  * internal statuses and their lifecycle — initial -> preprocess_inprogress
    -> preprocess_completed -> postprocess_inprogress -> completed_health |
    completed_unhealth | completed_unknown | preprocess_failed | abort
    (foremast-service/pkg/converter/converter.go:10-29).
  * external mapping — new / inprogress / success / anomaly / abort
    (converter.go:10-29).
  * document shape — appName, strategy, per-category query-config strings,
    hpa metric flags, podCountURL, status, reason, processingContent
    (foremast-service/pkg/models/models.go:102-124).
  * stuck-job takeover — any job inprogress longer than MAX_STUCK_IN_SECONDS
    may be re-leased by another worker (design.md:37-43; 90 s at
    foremast-brain.yaml:80-81). The store is the lease medium, like ES was.

The store here is in-memory + thread-safe with an optional JSON snapshot
(checkpoint/resume). This is the port's copy of the reference's job store
without its archive mirror and its crash-durable tier (ROADMAP queue 1,
item 8): passing either raises NotImplementedError.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import asdict, dataclass, field

from ..utils.locks import make_lock, make_rlock

log = logging.getLogger("foremast_tpu_torch.engine.jobs")


# --- internal status machine -------------------------------------------------
INITIAL = "initial"
PREPROCESS_INPROGRESS = "preprocess_inprogress"
PREPROCESS_COMPLETED = "preprocess_completed"
POSTPROCESS_INPROGRESS = "postprocess_inprogress"
COMPLETED_HEALTH = "completed_health"
COMPLETED_UNHEALTH = "completed_unhealth"
COMPLETED_UNKNOWN = "completed_unknown"
PREPROCESS_FAILED = "preprocess_failed"
ABORT = "abort"

OPEN_STATUSES = (INITIAL, PREPROCESS_INPROGRESS, PREPROCESS_COMPLETED, POSTPROCESS_INPROGRESS)
TERMINAL_STATUSES = (COMPLETED_HEALTH, COMPLETED_UNHEALTH, COMPLETED_UNKNOWN, PREPROCESS_FAILED, ABORT)
INPROGRESS_STATUSES = (PREPROCESS_INPROGRESS, PREPROCESS_COMPLETED, POSTPROCESS_INPROGRESS)

_TRANSITIONS = {
    INITIAL: {PREPROCESS_INPROGRESS, ABORT},
    # INITIAL also reachable: transient fetch failures on perpetual
    # (continuous/hpa) jobs requeue instead of dying
    PREPROCESS_INPROGRESS: {PREPROCESS_COMPLETED, PREPROCESS_FAILED, INITIAL, ABORT},
    PREPROCESS_COMPLETED: {POSTPROCESS_INPROGRESS, ABORT},
    POSTPROCESS_INPROGRESS: {
        COMPLETED_HEALTH,
        COMPLETED_UNHEALTH,
        COMPLETED_UNKNOWN,
        # healthy-so-far jobs requeue until endTime (fail-fast rule:
        # design.md:43); continuous/hpa jobs requeue every cycle
        INITIAL,
        ABORT,
    },
}

EXTERNAL_STATUS = {
    INITIAL: "new",
    PREPROCESS_INPROGRESS: "inprogress",
    PREPROCESS_COMPLETED: "inprogress",
    POSTPROCESS_INPROGRESS: "inprogress",
    COMPLETED_HEALTH: "success",
    COMPLETED_UNHEALTH: "anomaly",
    COMPLETED_UNKNOWN: "abort",
    PREPROCESS_FAILED: "abort",
    ABORT: "abort",
}


def to_external(status: str) -> str:
    return EXTERNAL_STATUS.get(status, "unknown")


def verdict_digest(store) -> str:
    """Fleet-wide verdict identity: blake2b over every open+terminal
    job's (id, status, reason, sorted anomaly). This IS the A/B identity
    contract — every bench/simulator gate compares this digest, so any
    change to what counts as verdict identity happens here, once.
    Deliberately excludes processing_content (the provenance attachment
    the provenance A/B toggles)."""
    import hashlib

    dig = hashlib.blake2b(digest_size=16)
    every = store.by_status(*OPEN_STATUSES, *TERMINAL_STATUSES)
    for d in sorted(every, key=lambda d: d.id):
        dig.update(repr((d.id, d.status, d.reason,
                         sorted(d.anomaly.items()))).encode())
    return dig.hexdigest()


class InvalidTransition(Exception):
    pass


def _match(rec: dict, app, namespace, statuses, strategy) -> bool:
    """The search predicate of the reference's archive (engine/archive.py);
    statuses is None or a list."""
    return (
        (app is None or rec.get("app_name") == app)
        and (namespace is None or rec.get("namespace") == namespace)
        and (statuses is None or rec.get("status") in statuses)
        and (strategy is None or rec.get("strategy") == strategy)
    )


@dataclass
class MetricQueries:
    """Per-metric query URLs by category."""

    current: str = ""
    baseline: str = ""
    historical: str = ""
    # hpa flags (models.go:179-183 HPAMetric)
    priority: int = 0
    is_increase: bool = True
    is_absolute: bool = False


@dataclass
class Document:
    """One analysis job."""

    id: str
    app_name: str
    strategy: str  # rollingUpdate | canary | continuous | hpa | rollover
    start_time: str
    end_time: str
    namespace: str = ""
    metrics: dict = field(default_factory=dict)  # name -> MetricQueries
    pod_count_url: str = ""
    status: str = INITIAL
    reason: str = ""
    anomaly: dict = field(default_factory=dict)  # metric -> flat [ts,v,...]
    processing_content: str = ""
    created_at: float = field(default_factory=time.time)
    modified_at: float = field(default_factory=time.time)
    lease_holder: str = ""
    lease_at: float = 0.0
    # archive freshness mark: the modified_at value of the last doc version
    # the archive CONFIRMED holding. archived_at >= modified_at means the
    # archive is up to date with this doc (used by gc() and the open-job
    # mirror; the mark is the cut version's own stamp, never time.time(),
    # so a concurrent modification can't make a stale record look fresh).
    archived_at: float = 0.0
    # graceful-shutdown handoff mark: a draining runtime stamps this on
    # every open job it releases (release_leases) before its final mirror
    # flush. A peer's adopt_stale_from_archive treats a released record as
    # immediately adoptable — no MAX_STUCK_IN_SECONDS wait — because the
    # owner EXPLICITLY surrendered the lease rather than going silent.
    # Cleared the moment any worker (re)claims the job.
    released_at: float = 0.0

    def to_json(self) -> dict:
        # hand-rolled (not dataclasses.asdict, which recurses + deepcopies):
        # the snapshot flusher serializes every doc under the store lock, and
        # asdict made that cut ~8x slower, blocking transitions fleet-wide.
        # test_engine.py pins this against the dataclass fields for drift.
        return {
            "id": self.id,
            "app_name": self.app_name,
            "strategy": self.strategy,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "namespace": self.namespace,
            "metrics": {
                k: {"current": v.current, "baseline": v.baseline,
                    "historical": v.historical, "priority": v.priority,
                    "is_increase": v.is_increase, "is_absolute": v.is_absolute}
                if isinstance(v, MetricQueries) else v
                for k, v in self.metrics.items()
            },
            "pod_count_url": self.pod_count_url,
            "status": self.status,
            "reason": self.reason,
            "anomaly": {k: list(v) for k, v in self.anomaly.items()},
            "processing_content": self.processing_content,
            "created_at": self.created_at,
            "modified_at": self.modified_at,
            "lease_holder": self.lease_holder,
            "lease_at": self.lease_at,
            "archived_at": self.archived_at,
            "released_at": self.released_at,
        }

    @classmethod
    def from_json(cls, d: dict) -> "Document":
        d = dict(d)
        d["metrics"] = {k: MetricQueries(**v) for k, v in d.get("metrics", {}).items()}
        # forward-compat: pre-released_at snapshots/archives load with the
        # default (0.0 = never released)
        return cls(**d)


@dataclass
class HpaLog:
    """hpalogs record (models.go:194-209): score + reasoning details."""

    job_id: str
    hpascore: float
    reason: str
    details: list  # [{metricType, current, upper, lower}]
    timestamp: float = field(default_factory=time.time)


class JobStore:
    """Thread-safe job + hpalog store with lease-based work stealing.

    In memory, with an optional JSON snapshot written behind by a flusher
    thread (checkpoint/resume). The reference's archive mirror and job tier
    are not ported: `archive` and `tier` must stay None.
    """

    def __init__(self, snapshot_path: str | None = None, archive=None, tier=None):
        if archive is not None or tier is not None:
            raise NotImplementedError(
                "JobStore's archive mirror and crash-durable job tier are not ported "
                "yet (ROADMAP queue 1, item 8)")
        self._lock = make_rlock("engine.jobs.store")
        self._jobs: dict[str, Document] = {}
        self._hpalogs: list[HpaLog] = []
        self._state: dict = {}  # engine-owned durable blobs
        self._snapshot_path = snapshot_path
        # lease lifecycle counters: fresh INITIAL claims and stuck-lease
        # takeover steals
        self.lease_claims_total = 0
        self.lease_steals_total = 0
        # RAM-only exposure instrumentation: how long do accepted mutations
        # live only in RAM before reaching the snapshot? _dirty_since marks
        # the OLDEST unflushed mutation; each completed flush records (flush
        # time - that mark) as the realized loss window.
        self._dirty_since: float | None = None
        self.loss_window_last_seconds = 0.0
        self.loss_window_max_seconds = 0.0
        self._dirty = False
        self._last_write = 0.0
        # background flusher: serialization/IO happen off the callers'
        # threads (see _persist); writes are ordered by a sequence number so
        # a slow older flush can never clobber a newer snapshot
        self._write_lock = make_lock("engine.jobs.snapshot_write")
        self._flush_seq = 0  # bumped under _lock when a payload is cut
        self._written_seq = 0  # last seq that reached disk (under _write_lock)
        self._flush_cost = 0.0  # last serialize+write seconds (adaptive cadence)
        self._flush_wake = threading.Event()
        self._flusher: threading.Thread | None = None
        self._closed = False
        if snapshot_path:
            self._load()

    # -- documents --
    def create(self, doc: Document) -> tuple[Document, bool]:
        """Create or return the existing open duplicate (dedupe-by-id,
        matching the reference service's create semantics)."""
        with self._lock:
            cur = self._jobs.get(doc.id)
            if cur is not None and cur.status in OPEN_STATUSES:
                return cur, False
            self._jobs[doc.id] = doc
            self._persist()
        return doc, True

    def get(self, job_id: str) -> Document | None:
        with self._lock:
            return self._jobs.get(job_id)

    def transition(self, job_id: str, new_status: str, *, reason: str = "",
                   anomaly: dict | None = None, worker: str = "",
                   processing_content: str | None = None) -> Document:
        with self._lock:
            doc = self._jobs[job_id]
            allowed = _TRANSITIONS.get(doc.status, set())
            if new_status not in allowed:
                raise InvalidTransition(f"{doc.status} -> {new_status}")
            doc.status = new_status
            doc.modified_at = time.time()
            if reason:
                doc.reason = reason
            if anomaly is not None:
                doc.anomaly = anomaly
            if processing_content is not None:
                doc.processing_content = processing_content
            if worker:
                doc.lease_holder = worker
                doc.lease_at = doc.modified_at
            self._persist()
        return doc

    def claim_open_jobs(self, worker: str, limit: int = 1024,
                        max_stuck_seconds: float = 90.0,
                        only_ids=None) -> list[Document]:
        """Lease up to `limit` runnable jobs for `worker`.

        A job is runnable if INITIAL, or stuck in an inprogress status longer
        than max_stuck_seconds (takeover — the reference's shared-nothing
        recovery mechanism).

        `only_ids` scopes the claim to the named jobs — the event-driven
        scheduler's partial cycles lease exactly the notified jobs instead
        of walking (and claiming) the whole fleet. When the set is small
        relative to the store, the walk iterates the ids directly.
        """
        now = time.time()
        out = []
        claims = steals = 0
        with self._lock:
            if only_ids is not None and len(only_ids) * 4 < len(self._jobs):
                # sorted: set iteration order is salted per process, and
                # the claim order feeds deterministic bucket packing
                candidates = [d for jid in sorted(only_ids)
                              if (d := self._jobs.get(jid)) is not None]
            else:
                candidates = self._jobs.values()
            for doc in candidates:
                if len(out) >= limit:
                    break
                if only_ids is not None and doc.id not in only_ids:
                    continue
                if doc.status == INITIAL:
                    doc.status = PREPROCESS_INPROGRESS
                    claims += 1
                elif doc.status in INPROGRESS_STATUSES and (
                    now - (doc.lease_at or doc.modified_at) > max_stuck_seconds
                ):
                    doc.status = PREPROCESS_INPROGRESS  # reprocess from scratch
                    steals += 1
                else:
                    continue
                doc.lease_holder = worker
                doc.lease_at = now
                doc.modified_at = now
                doc.released_at = 0.0  # claimed again: handoff mark expires
                out.append(doc)
            if out:
                self.lease_claims_total += claims
                self.lease_steals_total += steals
                self._persist()
        return out

    def advance(self, job_id: str, *statuses: str, worker: str = "") -> Document:
        """Apply a chain of transitions under ONE lock acquisition.

        Semantically identical to calling transition() per status (each hop
        is validated against the state machine) — but the engine advances
        every preprocessed job through two hops per cycle, and at 10k+
        fleet sizes the extra lock round-trips are measurable. Only valid
        for non-terminal hops (terminal verdicts go through transition())."""
        with self._lock:
            doc = self._jobs[job_id]
            # validate the WHOLE chain before touching the doc: a mid-chain
            # failure must not leave it half-advanced with a stale snapshot
            cur = doc.status
            for new_status in statuses:
                if new_status not in _TRANSITIONS.get(cur, set()):
                    raise InvalidTransition(f"{cur} -> {new_status}")
                if new_status in TERMINAL_STATUSES:
                    raise InvalidTransition(
                        f"terminal {new_status} must go through transition()"
                    )
                cur = new_status
            doc.status = cur
            doc.modified_at = time.time()
            if worker:
                doc.lease_holder = worker
                doc.lease_at = doc.modified_at
            self._persist()
        return doc

    def requeue(self, job_id: str, worker: str = "") -> Document:
        """Back to INITIAL for the next cycle (keeps reason/anomaly/config)."""
        return self.transition(job_id, INITIAL, worker=worker)

    def by_status(self, *statuses: str) -> list[Document]:
        with self._lock:
            return [d for d in self._jobs.values() if d.status in statuses]

    def status_counts(self) -> dict:
        """{status: count} over every job (self-metrics gauge)."""
        counts: dict[str, int] = {}
        with self._lock:
            for d in self._jobs.values():
                counts[d.status] = counts.get(d.status, 0) + 1
        return counts

    @property
    def snapshot_flush_seconds(self) -> float:
        """Last measured serialize+write cost (0 until the first flush)."""
        return self._flush_cost

    @property
    def loss_window_open_seconds(self) -> float:
        """Age of the oldest mutation currently living ONLY in RAM (0 when
        everything has reached the snapshot) — the live crash exposure."""
        with self._lock:
            if self._dirty_since is None:
                return 0.0
            return max(time.time() - self._dirty_since, 0.0)

    # -- hpa logs --
    def add_hpalog(self, log: HpaLog, keep_last: int = 1000):
        with self._lock:
            self._hpalogs.append(log)
            if len(self._hpalogs) > keep_last:
                self._hpalogs = self._hpalogs[-keep_last:]
            self._persist()

    # -- durable engine state (checkpoint/resume for non-job state) --
    def put_state(self, key: str, value) -> None:
        """Persist a JSON-safe engine blob through the snapshot."""
        with self._lock:
            self._state[key] = value
            self._persist()

    def get_state(self, key: str, default=None):
        with self._lock:
            return self._state.get(key, default)

    def search(self, app=None, namespace=None, status=None, strategy=None,
               limit: int = 50) -> list[dict]:
        """Jobs matching the filters, newest first. `status` may be a single
        internal status or a list of them."""
        statuses = ([status] if isinstance(status, str) else
                    list(status) if status else None)
        with self._lock:
            live = [
                d.to_json() for d in self._jobs.values()
                if _match({"app_name": d.app_name, "namespace": d.namespace,
                           "status": d.status, "strategy": d.strategy},
                          app, namespace, statuses, strategy)
            ]
        live.sort(key=lambda r: r.get("modified_at", 0.0), reverse=True)
        return live[:limit]

    def hpalogs_for(self, job_id: str, limit: int = 20) -> list[HpaLog]:
        with self._lock:
            logs = [l for l in self._hpalogs if l.job_id == job_id]
        return sorted(logs, key=lambda l: -l.timestamp)[:limit]

    # -- checkpoint/resume --
    def _persist(self):
        """Write-behind: mark dirty and wake the background flusher.

        Serializing the whole store on every transition would be O(jobs^2)
        per cycle under the lock — and even debounced to 1 Hz, a synchronous
        flush makes some unlucky transition pay the whole serialize+write
        while every other worker blocks on the lock. Instead callers only
        flip a bit; the flusher thread owns the cadence (~1 s for typical
        stores, stretching with snapshot cost up to 30 s for 100k-job
        fleets — _flush_interval; either way far inside the 90 s lease
        takeover), and run_cycle/stop() still call flush() synchronously
        at cycle/shutdown boundaries. Always called under self._lock,
        which is what makes the lazy thread start race-free."""
        if not self._snapshot_path:
            return
        self._dirty = True
        if self._dirty_since is None:
            self._dirty_since = time.time()
        if self._flusher is None and not self._closed:
            self._flusher = threading.Thread(
                target=self._flush_loop, name="jobstore-flush", daemon=True
            )
            self._flusher.start()
        self._flush_wake.set()

    def _flush_interval(self) -> float:
        """Adaptive flusher cadence: 1 Hz while snapshots are cheap,
        stretching to 5x the measured serialize+write cost (cap 30 s) for
        huge fleets — a 100k-job store (~1.5 s per snapshot) must not pin
        a core re-serializing at 1 Hz. Worst-case snapshot staleness is
        therefore ~5x cost (<= 30 s), far inside the 90 s lease-takeover
        tolerance; tiny stores keep the ~1 s bound."""
        return min(30.0, max(1.0, 5.0 * self._flush_cost))

    def _flush_loop(self):
        while not self._closed:
            self._flush_wake.wait()
            if self._closed:
                return
            self._flush_wake.clear()
            # wait out the cadence in small closable slices: a plain
            # sleep(30) would make close() miss its join timeout
            deadline = self._last_write + self._flush_interval()
            while not self._closed and time.time() < deadline:
                time.sleep(min(0.2, max(0.0, deadline - time.time())))
            if self._closed:
                return
            try:
                self.flush()
            except Exception as e:  # noqa: BLE001 - flusher must survive
                # snapshot dir gone (teardown), disk trouble, or a
                # non-JSON-safe state blob: stay alive — a dead flusher
                # silently downgrades bounded staleness to cycle-length gaps.
                # The next synchronous flush() surfaces the error to a caller.
                log.warning("snapshot flush failed: %s", e)
                time.sleep(1.0)
                # flush() re-marked dirty; re-arm the (cleared) wake so the
                # retry happens even if the store goes quiescent
                self._flush_wake.set()

    def flush(self):
        """Force-write the snapshot (called at cycle boundaries/shutdown).

        The payload is cut under the store lock (to_json/asdict deep-copy,
        so the cut is a consistent point-in-time view); dumps+write happen
        outside it so transitions never wait on disk. _write_lock keeps the
        shared .tmp path single-writer, and the sequence check drops a flush
        that lost the race to a newer one — os.replace()ing an older
        snapshot over a newer one would be a durability regression."""
        if self._snapshot_path:
            self._try_snapshot()

    def _try_snapshot(self) -> None:
        """Write the snapshot if dirty."""
        with self._lock:
            if not self._dirty:
                return
            dirty_since = self._dirty_since
            self._dirty_since = None
            t0 = time.perf_counter()  # after acquire: cost excludes lock waits
            data = {
                "jobs": [d.to_json() for d in self._jobs.values()],
                "hpalogs": [asdict(l) for l in self._hpalogs],
                # copy under the lock like the other members: dumps() runs
                # outside it, and put_state() mutates this dict in place
                "state": dict(self._state),
            }
            cut_s = time.perf_counter() - t0
            self._dirty = False
            self._last_write = time.time()
            self._flush_seq += 1
            seq = self._flush_seq
        try:
            t1 = time.perf_counter()
            payload = json.dumps(data)
            dumps_s = time.perf_counter() - t1
            with self._write_lock:
                if seq <= self._written_seq:
                    # a newer snapshot already reached disk; it contained a
                    # superset of this payload, so our oldest mutation IS
                    # durable — record its exposure conservatively (the
                    # newer write landed no later than now)
                    if dirty_since is not None:
                        w = max(time.time() - dirty_since, 0.0)
                        self.loss_window_last_seconds = w
                        self.loss_window_max_seconds = max(
                            self.loss_window_max_seconds, w)
                    return
                t2 = time.perf_counter()
                tmp = self._snapshot_path + ".tmp"
                with open(tmp, "w") as f:
                    f.write(payload)
                os.replace(tmp, self._snapshot_path)
                self._written_seq = seq
                # serialize+write work only — lock-wait time must not
                # inflate the adaptive cadence under contention
                self._flush_cost = cut_s + dumps_s + (time.perf_counter() - t2)
            if dirty_since is not None:
                # realized RAM-only exposure for the oldest mutation in
                # this payload (VERDICT r3 #8)
                w = max(time.time() - dirty_since, 0.0)
                self.loss_window_last_seconds = w
                self.loss_window_max_seconds = max(
                    self.loss_window_max_seconds, w)
        except BaseException:
            with self._lock:
                self._dirty = True  # this payload never landed; don't lose it
                # resume the exposure clock at the OLDEST unflushed
                # mutation: ours, or one that arrived during the failed
                # write — whichever is older
                if dirty_since is not None:
                    self._dirty_since = (
                        dirty_since if self._dirty_since is None
                        else min(self._dirty_since, dirty_since))
            raise

    def close(self):
        """Final flush + stop the background flusher (idempotent)."""
        self._closed = True
        self._flush_wake.set()
        if self._flusher is not None:
            self._flusher.join(timeout=5.0)
        self.flush()

    def _load(self):
        if not os.path.exists(self._snapshot_path):
            return
        try:
            with open(self._snapshot_path) as f:
                data = json.load(f)
            jobs = {d["id"]: Document.from_json(d) for d in data.get("jobs", [])}
            logs = [HpaLog(**l) for l in data.get("hpalogs", [])]
            state = data.get("state", {}) or {}
        except (json.JSONDecodeError, OSError, KeyError, TypeError):
            # a torn/corrupt snapshot must not brick the service: quarantine
            # it and start empty (jobs are re-submitted by the operator tick)
            os.replace(self._snapshot_path, self._snapshot_path + ".corrupt")
            return
        self._jobs = jobs
        self._hpalogs = logs
        self._state = state if isinstance(state, dict) else {}
