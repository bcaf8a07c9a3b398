"""Engine scheduling: event-driven partial cycles + reconciliation sweeps.

The port's copy of the reference's ``engine/scheduler.py``.
``StreamScheduler`` scores jobs the moment their windows advance instead of
waiting for the next full cycle:

  * **Partial cycles.** ``notify(job_ids)`` marks jobs whose windows just
    advanced. The scheduler batches notifications for a short debounce
    window, then runs ``analyzer.run_cycle`` over exactly those jobs — the
    same pipeline rungs (fingerprint memo -> tier-0 triage -> family
    accumulators), just scoped to the jobs with fresh evidence.
  * **Reconciliation sweeps.** The full-fleet cycle keeps running at
    ``cycle_seconds`` cadence as the fallback for jobs nobody notifies
    for; the sweep callback is the embedder's whole per-lap chore list.

One thread runs both, so partial cycles and sweeps are serialized against
each other — the analyzer's per-cycle state needs no new locking.
``notify`` itself only takes the scheduler's condition lock, so callers
never block on (or behind) scoring.

``EngineWorker`` below is the plain cadence worker, for embedders and
tests that want the bare loop.
"""
from __future__ import annotations

import logging
import threading
import time

from .analyzer import Analyzer
from ..utils.locks import make_lock

log = logging.getLogger("foremast_tpu_torch.engine")


class EngineWorker:
    def __init__(self, analyzer: Analyzer, name: str = "worker-0",
                 poll_interval: float = 10.0):
        self.analyzer = analyzer
        self.name = name
        self.poll_interval = poll_interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.cycles = 0
        self.last_error: str = ""

    def start(self):
        self._thread = threading.Thread(target=self._run, name=self.name, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.is_set():
            try:
                self.analyzer.run_cycle(worker=self.name)
                self.cycles += 1
            except Exception as e:  # noqa: BLE001 - worker must survive
                self.last_error = f"{type(e).__name__}: {e}"
                log.exception("engine cycle failed")
            self._stop.wait(self.poll_interval)

    def stop(self, timeout: float = 10.0):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout)


class StreamScheduler:
    """Event-driven engine scheduler (module docstring).

    ``run(stop_event)`` is the worker loop body — the runtime points its
    worker thread here. ``notify(job_ids)`` is the ingest tap: safe from
    any thread, never blocks on scoring.
    """

    def __init__(self, analyzer: Analyzer, full_cycle_fn,
                 cycle_seconds: float = 10.0, worker: str = "worker-0",
                 debounce_seconds: float = 0.15,
                 max_partial_jobs: int = 4096, exporter=None,
                 checkpoint_fn=None):
        self.analyzer = analyzer
        self.full_cycle_fn = full_cycle_fn
        # durability chore after each partial cycle (the runtime's
        # window-store checkpoint): pushed-dirtied window state folds
        # into the warm segments between sweeps, so a long CYCLE_SECONDS
        # under sustained push traffic bounds WAL growth at the
        # checkpoint rate limit, not the sweep cadence. Best-effort —
        # the callee rate-limits and swallows its own I/O failures.
        self.checkpoint_fn = checkpoint_fn
        self.cycle_seconds = max(float(cycle_seconds), 0.05)
        self.worker = worker
        # pushes arrive per scrape target; the debounce window folds one
        # scrape interval's burst into ONE partial cycle instead of a
        # cycle per HTTP request
        self.debounce_seconds = max(float(debounce_seconds), 0.0)
        # a notify burst larger than this rides the next full sweep
        # instead of a mega partial cycle (the sweep is the batched path)
        self.max_partial_jobs = max(int(max_partial_jobs), 1)
        self.exporter = exporter
        self._cond = threading.Condition(make_lock("engine.scheduler"))
        self._pending: set[str] = set()
        # observability
        self.partial_cycles_total = 0
        self.partial_jobs_total = 0
        self.notifications_total = 0
        self.sweeps_total = 0
        self.last_partial_at = 0.0

    # ------------------------------------------------------------- ingest
    def notify(self, job_ids) -> int:
        """Mark jobs dirty for an immediate partial cycle. Returns how
        many were newly marked (already-pending ids fold in free)."""
        ids = set(job_ids)
        if not ids:
            return 0
        with self._cond:
            before = len(self._pending)
            self._pending |= ids
            added = len(self._pending) - before
            self.notifications_total += 1
            self._cond.notify()
        # waterfall: the debounce/schedule wait clock starts at notify
        # (engine/slo.py DetectionWaterfall; no-op for unpushed jobs)
        wf = getattr(self.analyzer, "waterfall", None)
        if wf is not None:
            wf.notify(ids)
        return added

    # --------------------------------------------------------------- loop
    def run(self, stop_event: threading.Event):
        """The worker loop: full sweep immediately, then event-driven.

        Sweep cadence matches the old poll loop exactly — the next sweep
        lands ``cycle_seconds`` after the previous one STARTED, floored
        at zero (a slow sweep runs back-to-back, never piles up)."""
        while not stop_event.is_set():
            t0 = time.monotonic()
            self._sweep()
            next_sweep = t0 + self.cycle_seconds
            while not stop_event.is_set():
                with self._cond:
                    timeout = next_sweep - time.monotonic()
                    if not self._pending and timeout > 0:
                        # bounded wait so stop_event stays responsive
                        # even with no pushes and a long cadence
                        self._cond.wait(min(timeout, 0.25))
                    pending = bool(self._pending)
                if time.monotonic() >= next_sweep:
                    break
                if pending and not stop_event.is_set():
                    self._debounce(stop_event, next_sweep)
                    if not self._partial_cycle():
                        # burst bigger than the partial budget: the full
                        # sweep IS the batched path for it — run it now
                        # instead of spinning on the unconsumed pending
                        # set until the cadence tick
                        break

    def _debounce(self, stop_event, next_sweep: float):
        """Let one scrape burst coalesce before the partial cycle."""
        if self.debounce_seconds <= 0:
            return
        deadline = min(time.monotonic() + self.debounce_seconds,
                       next_sweep)
        while not stop_event.is_set():
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            stop_event.wait(min(remaining, 0.05))

    def _sweep(self):
        """One full reconciliation sweep; pending jobs fold into it (the
        sweep claims the whole fleet, so a separate partial would only
        double-score)."""
        with self._cond:
            self._pending.clear()
        try:
            self.full_cycle_fn()
            self.sweeps_total += 1
        except Exception:  # noqa: BLE001 - the loop must survive
            log.exception("reconciliation sweep failed")

    def _partial_cycle(self) -> bool:
        """Run one partial cycle over the pending set. Returns False
        when the set exceeds the partial budget (the caller escalates
        to an immediate full sweep — which clears it)."""
        with self._cond:
            if not self._pending:
                return True
            if len(self._pending) > self.max_partial_jobs:
                return False
            ids = frozenset(self._pending)
            self._pending.clear()
        # waterfall: the partial cycle starts NOW — split each job's
        # measured notify->start wait into debounce vs schedule stages
        wf = getattr(self.analyzer, "waterfall", None)
        if wf is not None:
            wf.claim(ids, self.debounce_seconds)
        try:
            self.analyzer.run_cycle(worker=self.worker, job_ids=ids,
                                    partial=True)
            self.partial_cycles_total += 1
            self.partial_jobs_total += len(ids)
            self.last_partial_at = time.time()
            if self.exporter is not None:
                self.exporter.record_counter(
                    "foremastbrain:partial_cycles_total", {},
                    help="event-driven partial engine cycles (pushed "
                         "jobs scored without waiting for the tick)")
                self.exporter.record_counter(
                    "foremastbrain:partial_cycle_jobs_total", {},
                    len(ids),
                    help="jobs scored through event-driven partial "
                         "cycles")
        except Exception:  # noqa: BLE001 - the loop must survive
            log.exception("partial cycle failed")
        if self.checkpoint_fn is not None:
            try:
                self.checkpoint_fn()
            except Exception:  # noqa: BLE001 - durability is best-effort
                log.exception("post-partial checkpoint failed")
        return True

    # ------------------------------------------------------ observability
    def snapshot(self) -> dict:
        with self._cond:
            pending = len(self._pending)
        return {
            "cycle_seconds": self.cycle_seconds,
            "debounce_seconds": self.debounce_seconds,
            "pending_jobs": pending,
            "partial_cycles": self.partial_cycles_total,
            "partial_jobs": self.partial_jobs_total,
            "notifications": self.notifications_total,
            "sweeps": self.sweeps_total,
        }
