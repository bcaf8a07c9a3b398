"""Detection-latency SLOs: ingest->verdict latency per job class.

The port's copy of the reference's ``engine/slo.py``. The analyzer stamps
each job's window-advance moment through the cycle (the newest valid sample
timestamp across its judged current windows, plus an ingest marker as its
preprocess completes) and observes the latency when the verdict folds: the
poll/scrape wait (cycle ``now`` minus the newest sample's own timestamp)
plus the measured in-cycle tail (``Analyzer._observe_latency``), bucketed
per job CLASS:

  * ``canary``     — new-deployment analyses (rollingUpdate/canary/
                     rollover): the verdict gates a live rollout, so the
                     tightest target;
  * ``continuous`` — steady-state monitors, re-judged every cycle;
  * ``hpa``        — autoscaling scores.

Each class carries an SLO target (SLO_CANARY_S / SLO_CONTINUOUS_S /
SLO_HPA_S) and the fleet-wide objective (SLO_OBJECTIVE, default 0.99). The
tracker keeps its own bucket counts and mirrors everything onto the
exporter:

  foremastbrain:detection_latency_seconds{class=}   histogram
  foremastbrain:slo_attainment{class=}              gauge (0..1)
  foremastbrain:slo_error_budget_burn{class=}       gauge (burn rate)
  foremastbrain:slo_violations_total{class=}        counter

Burn rate is observed violation rate over the budgeted violation rate
(1 - objective). Pure observation: nothing here feeds back into scoring.
``DetectionWaterfall`` splits each observation into stages; its push
stages are stamped by an ingest receiver (not ported yet), the scheduler's
waits by ``engine/scheduler.py``.
"""
from __future__ import annotations

import bisect
import time
from collections import OrderedDict

from ..dataplane.exporter import DEFAULT_TIME_BUCKETS
from ..utils.locks import make_lock

__all__ = [
    "DetectionSLO", "DetectionWaterfall", "classify", "SLO_CLASSES",
    "STAGES", "STAGE_ORDER",
]

SLO_CLASSES = ("canary", "continuous", "hpa")

# ---------------------------------------------------------------------------
# Detection-latency waterfall stages: the decomposition of ONE
# detection_latency_seconds observation into where the time actually
# went, exported as foremastbrain:detection_stage_seconds{stage=}.
# Stage names are REGISTERED constants — the devtools trace-registry
# rule rejects unregistered literals in add_stage() calls, exactly like
# span names — so dashboards and the runbook can enumerate them.
#
#   ingest_receive  sample existed -> receiver accepted it (push
#                   transport lag + decode/route/buffer time)
#   forward_hop     origin replica's first contact -> the owning
#                   replica's receipt (one ring hop; absent unforwarded)
#   wal_append      the durability write before the /ingest ack
#   splice          the delta-cache splice of the pushed batch
#   debounce_wait   scheduler notify -> debounce window elapsed
#                   (bounded by INGEST_DEBOUNCE_MS)
#   schedule_wait   debounce end -> the partial cycle actually started
#                   (waiting behind a running sweep); for POLLED jobs
#                   this is the whole poll/scrape wait (cycle `now`
#                   minus the newest judged sample — push stages absent)
#   score           cycle start -> verdict fold began (fetch + dispatch
#                   + collect for this job's cycle)
#   fold            fold began -> this job's verdict was written
# ---------------------------------------------------------------------------
STAGE_INGEST_RECEIVE = "ingest_receive"
STAGE_FORWARD_HOP = "forward_hop"
STAGE_WAL_APPEND = "wal_append"
STAGE_SPLICE = "splice"
STAGE_DEBOUNCE_WAIT = "debounce_wait"
STAGE_SCHEDULE_WAIT = "schedule_wait"
STAGE_SCORE = "score"
STAGE_FOLD = "fold"

STAGE_ORDER = (
    STAGE_INGEST_RECEIVE, STAGE_FORWARD_HOP, STAGE_WAL_APPEND,
    STAGE_SPLICE, STAGE_DEBOUNCE_WAIT, STAGE_SCHEDULE_WAIT,
    STAGE_SCORE, STAGE_FOLD,
)
STAGES = frozenset(STAGE_ORDER)


def classify(strategy: str) -> str:
    """Job class for SLO accounting from the wire strategy."""
    if strategy == "hpa":
        return "hpa"
    if strategy == "continuous":
        return "continuous"
    return "canary"  # rollingUpdate / canary / rollover


class DetectionSLO:
    """Per-class ingest->verdict latency distributions + SLO math.

    The engine worker writes (observe); HTTP/CLI threads read (snapshot,
    quantile). All reads copy under the lock. Allocation-bounded by
    construction: three classes x one fixed bucket grid."""

    def __init__(self, exporter=None, targets: dict | None = None,
                 objective: float = 0.99,
                 buckets: tuple = DEFAULT_TIME_BUCKETS):
        self.exporter = exporter
        self.targets = dict(targets or {})
        # objective clamped to (0, 1): 1.0 would make the budget zero and
        # every burn infinite; 0 would make attainment meaningless
        self.objective = min(max(float(objective), 0.0), 0.999999)
        self._edges = tuple(buckets)
        self._lock = make_lock("engine.slo")
        # class -> [bucket counts (+Inf implicit last)], sum, count,
        # violations (latency > target)
        self._counts: dict[str, list] = {}
        self._sums: dict[str, float] = {}
        self._totals: dict[str, int] = {}
        self._violations: dict[str, int] = {}

    # -------------------------------------------------------------- writing
    def observe(self, cls: str, latency_s: float):
        """One ingest->verdict observation for a job of class `cls`."""
        v = max(float(latency_s), 0.0)
        target = float(self.targets.get(cls, 0.0))
        violated = target > 0 and v > target
        with self._lock:
            counts = self._counts.get(cls)
            if counts is None:
                counts = self._counts[cls] = [0] * (len(self._edges) + 1)
                self._sums[cls] = 0.0
                self._totals[cls] = 0
                self._violations[cls] = 0
            counts[bisect.bisect_left(self._edges, v)] += 1
            self._sums[cls] += v
            self._totals[cls] += 1
            if violated:
                self._violations[cls] += 1
            attainment = 1.0 - self._violations[cls] / self._totals[cls]
        if self.exporter is not None:
            self.exporter.record_histogram(
                "foremastbrain:detection_latency_seconds", {"class": cls}, v,
                help="Window-advance (newest judged sample) to verdict "
                     "latency per job class (seconds).",
                buckets=self._edges)
            if violated:
                self.exporter.record_counter(
                    "foremastbrain:slo_violations_total", {"class": cls},
                    help="verdicts that landed outside the class's "
                         "detection-latency SLO target")
            self._export_gauges(cls, attainment)

    def _export_gauges(self, cls: str, attainment: float):
        self.exporter.record_gauge(
            "foremastbrain:slo_attainment", {"class": cls},
            round(attainment, 6),
            help="Fraction of verdicts inside the class's detection-"
                 "latency SLO target (cumulative).")
        self.exporter.record_gauge(
            "foremastbrain:slo_error_budget_burn", {"class": cls},
            round(self._burn_from(attainment), 4),
            help="Error-budget burn rate: observed violation rate over "
                 "the budgeted rate (1 - SLO_OBJECTIVE); >1 = budget "
                 "shrinking.")

    def _burn_from(self, attainment: float) -> float:
        budget = 1.0 - self.objective
        return (1.0 - attainment) / budget if budget > 0 else 0.0

    # -------------------------------------------------------------- reading
    def quantile(self, q: float, cls: str | None = None) -> float:
        """Bucket-resolution quantile estimate (seconds): the upper edge
        of the bucket the q-th observation lands in. `cls=None` pools
        every class. 0.0 when nothing was observed."""
        with self._lock:
            if cls is None:
                rows = list(self._counts.values())
            else:
                rows = [self._counts[cls]] if cls in self._counts else []
            if not rows:
                return 0.0
            counts = [sum(r[i] for r in rows)
                      for i in range(len(self._edges) + 1)]
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                # +Inf bucket: report the last finite edge (the estimate
                # is a floor, which is the honest direction for an SLO)
                return float(self._edges[min(i, len(self._edges) - 1)])
        return float(self._edges[-1])

    def attainment(self, cls: str) -> float:
        with self._lock:
            n = self._totals.get(cls, 0)
            if n == 0:
                return 1.0
            return 1.0 - self._violations.get(cls, 0) / n

    def burn(self, cls: str) -> float:
        return self._burn_from(self.attainment(cls))

    def burn_summary(self) -> dict:
        """{class: burn} for classes with observations — the HealthMonitor
        detail tap (informational, never an input to the state; empty before the
        first verdict so existing health-detail consumers see no change)."""
        with self._lock:
            have = [c for c, n in self._totals.items() if n]
        return {c: round(self.burn(c), 4) for c in sorted(have)}

    def snapshot(self) -> dict:
        """Full /status section: per-class distribution + SLO math, plus
        the configured targets even before the first observation (the
        operator should see the knobs, not an empty object)."""
        with self._lock:
            classes = sorted(set(self._totals) | set(self.targets))
            totals = dict(self._totals)
            sums = dict(self._sums)
            violations = dict(self._violations)
        out = {"objective": self.objective, "classes": {}}
        for cls in classes:
            n = totals.get(cls, 0)
            att = (1.0 - violations.get(cls, 0) / n) if n else 1.0
            out["classes"][cls] = {
                "target_s": self.targets.get(cls, 0.0),
                "count": n,
                "violations": violations.get(cls, 0),
                "p50_s": round(self.quantile(0.5, cls), 4),
                "p99_s": round(self.quantile(0.99, cls), 4),
                "mean_s": round(sums.get(cls, 0.0) / n, 4) if n else 0.0,
                "attainment": round(att, 6),
                "burn": round(self._burn_from(att), 4),
            }
        return out

    def digest(self) -> dict:
        """Compact per-class block for the fleet status digest (rides the
        membership heartbeat blob — must stay small)."""
        with self._lock:
            have = sorted(c for c, n in self._totals.items() if n)
        out = {}
        for cls in have:
            att = self.attainment(cls)
            out[cls] = {
                "p50_s": round(self.quantile(0.5, cls), 4),
                "p99_s": round(self.quantile(0.99, cls), 4),
                "attainment": round(att, 6),
                "burn": round(self._burn_from(att), 4),
                "n": self._totals.get(cls, 0),
            }
        return out

    def refresh_metrics(self):
        """Re-stamp the SLO gauges at scrape time (gauges are time-staled
        by the exporter; a quiet fleet must not scrape away its
        attainment history)."""
        if self.exporter is None:
            return
        with self._lock:
            have = [c for c, n in self._totals.items() if n]
        for cls in have:
            self._export_gauges(cls, self.attainment(cls))

    def reset(self):
        """Clear observations (bench legs isolate their measured cycles
        from warm-up; the exporter's cumulative series are untouched)."""
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()
            self._violations.clear()


class DetectionWaterfall:
    """Per-job detection-latency stage attribution (STAGE_ORDER above).

    The push half of the pipeline (ingest receiver, event scheduler)
    accumulates stage seconds into a bounded in-flight book keyed by
    job id; the analyzer closes each record at verdict fold (`observe`),
    exporting one histogram sample per stage
    (``foremastbrain:detection_stage_seconds{stage=}``) so the SLO
    burn decomposes into actionable stages. Polled jobs get the same
    waterfall minus the push stages: their whole wait is
    ``schedule_wait`` (cycle ``now`` − newest judged sample). The book
    also carries each push's adopted W3C trace context + first-contact
    timestamp (stamped ONCE at the origin replica, propagated through
    ring forwards), which is how the verdict span and the provenance
    ``trace_id`` link back to the push's distributed trace.

    Pure observation, allocation-bounded (LRU book + fixed bucket
    grids); HTTP threads write, the engine thread closes — everything
    under one short lock, nothing blocking held."""

    def __init__(self, exporter=None, max_jobs: int = 4096,
                 buckets: tuple = DEFAULT_TIME_BUCKETS):
        self.exporter = exporter
        self.max_jobs = int(max_jobs)
        self._edges = tuple(buckets)
        self._lock = make_lock("engine.slo.waterfall")
        # job_id -> {"origin": wall ts of first contact, "accepted": wall
        # ts the owning replica accepted, "notify_mono": scheduler stamp,
        # "stages": {stage: seconds}, "ctx": W3CContext | None}
        self._inflight: OrderedDict[str, dict] = OrderedDict()
        # stage -> [bucket counts (+Inf implicit), sum, count]; "total"
        # pseudo-row tracks the per-observation stage sum so the bench
        # can compare it against detection_latency_seconds directly
        self._hist: dict[str, list] = {}
        self.observed_total = 0
        self.streamed_total = 0
        self.last: dict = {}

    # ------------------------------------------------------------- writing
    def begin_push(self, job_id: str, origin_wall: float,
                   accepted_wall: float, ctx=None):
        """Open (or refresh) a job's in-flight record at push accept.
        The ORIGIN timestamp is kept from the earliest unobserved push
        (detection latency is measured from first contact, never reset
        by forwarding or a second push); the accepted stamp and trace
        context follow the newest push."""
        with self._lock:
            rec = self._inflight.get(job_id)
            if rec is None:
                rec = self._inflight[job_id] = {
                    "origin": float(origin_wall), "stages": {},
                    "notify_mono": 0.0, "ctx": None,
                }
                while len(self._inflight) > self.max_jobs:
                    self._inflight.popitem(last=False)
            else:
                rec["origin"] = min(rec["origin"], float(origin_wall))
                self._inflight.move_to_end(job_id)
            rec["accepted"] = float(accepted_wall)
            if ctx is not None:
                rec["ctx"] = ctx

    def add_stage(self, job_id: str, stage: str, seconds: float):
        """Accumulate stage seconds onto a job's in-flight record (no-op
        when the job has none — stage timings without a push accept have
        nothing to attribute to)."""
        with self._lock:
            rec = self._inflight.get(job_id)
            if rec is not None:
                rec["stages"][stage] = \
                    rec["stages"].get(stage, 0.0) + max(float(seconds), 0.0)

    def notify(self, job_ids):
        """Scheduler tap: stamp when each pushed job entered the pending
        set (the debounce/schedule wait clock starts here)."""
        now = time.monotonic()
        with self._lock:
            for jid in job_ids:
                rec = self._inflight.get(jid)
                if rec is not None and not rec["notify_mono"]:
                    rec["notify_mono"] = now

    def claim(self, job_ids, debounce_seconds: float):
        """Scheduler tap: the partial cycle is starting NOW for these
        jobs — split the measured notify->start wait into the debounce
        window (bounded by the knob) and the scheduling excess (waiting
        behind a running sweep)."""
        now = time.monotonic()
        db = max(float(debounce_seconds), 0.0)
        with self._lock:
            for jid in job_ids:
                rec = self._inflight.get(jid)
                if rec is None or not rec["notify_mono"]:
                    continue
                wait = max(now - rec["notify_mono"], 0.0)
                rec["notify_mono"] = 0.0
                d = min(wait, db)
                st = rec["stages"]
                st[STAGE_DEBOUNCE_WAIT] = st.get(STAGE_DEBOUNCE_WAIT,
                                                 0.0) + d
                st[STAGE_SCHEDULE_WAIT] = st.get(STAGE_SCHEDULE_WAIT,
                                                 0.0) + (wait - d)
                rec["scheduled"] = True

    def discard(self, job_id: str):
        """Drop a job's in-flight record WITHOUT observing it — the
        SLO-dedupe path: a cycle that re-confirms an already-observed
        advance consumes nothing, and the stale record's stages must not
        leak into (and inflate) the job's NEXT genuine observation."""
        with self._lock:
            self._inflight.pop(job_id, None)

    def single_context(self, job_ids):
        """The one W3C context shared by every in-flight record among
        `job_ids` (None when there are zero, several, or mixed traces) —
        lets a partial cycle triggered by a single push adopt that
        push's trace for its whole engine.cycle span."""
        ctx = None
        with self._lock:
            for jid in job_ids:
                rec = self._inflight.get(jid)
                c = rec.get("ctx") if rec is not None else None
                if c is None:
                    continue
                if ctx is None:
                    ctx = c
                elif ctx.trace_id != c.trace_id:
                    return None
        return ctx

    # ------------------------------------------------------------- closing
    def observe(self, job_id: str, now: float, newest_ts: float,
                score_s: float, fold_s: float) -> dict:
        """Close a job's waterfall at verdict fold. Pushed jobs consume
        their in-flight record (push stages + measured waits, with a
        wall-clock fallback for the accept->cycle wait when no scheduler
        ran, e.g. bench partial cycles); polled jobs synthesize the
        poll-wait-only shape. Returns {"stages", "ctx", "trace_id",
        "streamed", "total_s"}."""
        with self._lock:
            rec = self._inflight.pop(job_id, None)
        stages: dict[str, float] = {}
        ctx = None
        streamed = rec is not None
        if rec is not None:
            ctx = rec.get("ctx")
            for stage in STAGE_ORDER:
                v = rec["stages"].get(stage)
                if v is not None:
                    stages[stage] = v
            if not rec.get("scheduled") and STAGE_SCHEDULE_WAIT not in \
                    stages and rec.get("accepted"):
                # no scheduler stamped the wait (direct run_cycle): the
                # accept->cycle gap in the same clock domain as `now`
                stages[STAGE_SCHEDULE_WAIT] = \
                    max(float(now) - rec["accepted"], 0.0)
        elif newest_ts > 0:
            stages[STAGE_SCHEDULE_WAIT] = max(float(now) - newest_ts, 0.0)
        stages[STAGE_SCORE] = max(float(score_s), 0.0)
        stages[STAGE_FOLD] = max(float(fold_s), 0.0)
        total = sum(stages.values())
        with self._lock:
            for stage, v in stages.items():
                self._observe_hist(stage, v)
            self._observe_hist("total", total)
            self.observed_total += 1
            if streamed:
                self.streamed_total += 1
            self.last = {
                "job_id": job_id,
                "streamed": streamed,
                "stages": {k: round(v, 6) for k, v in stages.items()},
                "total_s": round(total, 6),
                "trace_id": ctx.trace_id if ctx is not None else "",
            }
        if self.exporter is not None:
            for stage, v in stages.items():
                self.exporter.record_histogram(
                    "foremastbrain:detection_stage_seconds",
                    {"stage": stage}, v,
                    help="Detection-latency waterfall: seconds spent per "
                         "stage between a sample existing and its "
                         "verdict (docs/operations.md \"Following one "
                         "push to its verdict\").",
                    buckets=self._edges)
        return {
            "stages": stages,
            "ctx": ctx,
            "trace_id": ctx.trace_id if ctx is not None else "",
            "streamed": streamed,
            "total_s": total,
        }

    def _observe_hist(self, stage: str, v: float):
        h = self._hist.get(stage)
        if h is None:
            h = self._hist[stage] = [[0] * (len(self._edges) + 1), 0.0, 0]
        h[0][bisect.bisect_left(self._edges, v)] += 1
        h[1] += v
        h[2] += 1

    # ------------------------------------------------------------- reading
    def quantile(self, stage: str, q: float) -> float:
        """Bucket-resolution quantile of one stage's distribution (the
        same floor-honest estimate DetectionSLO.quantile makes)."""
        with self._lock:
            h = self._hist.get(stage)
            counts = list(h[0]) if h is not None else None
        if not counts or sum(counts) == 0:
            return 0.0
        rank = q * sum(counts)
        cum = 0
        for i, c in enumerate(counts):
            cum += c
            if cum >= rank:
                return float(self._edges[min(i, len(self._edges) - 1)])
        return float(self._edges[-1])

    def snapshot(self) -> dict:
        """/status section: per-stage distribution summary + the last
        closed waterfall (ordered; absent stages omitted)."""
        with self._lock:
            rows = {s: (list(h[0]), h[1], h[2])
                    for s, h in self._hist.items()}
            out = {
                "observed": self.observed_total,
                "streamed": self.streamed_total,
                "inflight": len(self._inflight),
                "last": dict(self.last),
            }
        stages = {}
        for stage in (*STAGE_ORDER, "total"):
            row = rows.get(stage)
            if row is None:
                continue
            _counts, total, n = row
            stages[stage] = {
                "count": n,
                "mean_s": round(total / n, 6) if n else 0.0,
                "p50_s": round(self.quantile(stage, 0.5), 4),
                "p99_s": round(self.quantile(stage, 0.99), 4),
            }
        out["stages"] = stages
        return out

    def reset(self):
        """Clear distributions AND the in-flight book (bench warm-up
        isolation, mirroring DetectionSLO.reset)."""
        with self._lock:
            self._hist.clear()
            self._inflight.clear()
            self.observed_total = 0
            self.streamed_total = 0
            self.last = {}
