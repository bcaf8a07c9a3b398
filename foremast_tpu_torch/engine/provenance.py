"""Verdict provenance: per-(job, cycle) attribution records.

The port's copy of the reference's ``engine/provenance.py``. The engine has
several ways to produce a verdict (full score, fingerprint-memo reuse,
tier-0 triage, stale-serve, shed carry-over, quarantine park, watchdog
failover, blast-radius isolation); the analyzer stamps one structured
record per judged (job, cycle) into a bounded ring naming the path that
fired, terminal verdicts carry a compact copy in the Document's
``processing_content``, and the flight recorder folds affected jobs'
records into its incident dumps.

Always-on and allocation-bounded: the ring and the per-job index are
LRU-capped, per-record family lists are capped, and with ``enabled=False``
every method is a no-op — recording only OBSERVES the cycle, so verdicts
are identical either way. Path tags are registered constants.
"""
from __future__ import annotations

import json
import logging
import time
from collections import OrderedDict, deque

from .jobs import TERMINAL_STATUSES
from ..utils import tracing
from ..utils.locks import make_lock

log = logging.getLogger("foremast_tpu_torch.engine.provenance")

__all__ = [
    "ProvenanceRecorder", "PATHS",
    "PATH_SCORED", "PATH_STREAM_SCORED", "PATH_MEMO_HIT", "PATH_TRIAGED",
    "PATH_STALE_SERVED", "PATH_SHED_CARRYOVER", "PATH_QUARANTINED",
    "PATH_WATCHDOG_FAILOVER", "PATH_BLAST_RADIUS", "PATH_FETCH_RETRY",
    "PATH_NO_DATA",
]

# -- verdict-path registry ---------------------------------------------------
PATH_SCORED = "scored"                      # fresh device-scored verdict
PATH_STREAM_SCORED = "stream-scored"        # scored by an event-driven
#                                             partial cycle (push ingest
#                                             woke the scheduler; the
#                                             verdict did not wait for
#                                             the global tick)
PATH_MEMO_HIT = "memo-hit"                  # served from fingerprint memo
PATH_TRIAGED = "triaged"                    # tier-0 screen cleared the row(s)
PATH_STALE_SERVED = "stale-served"          # last fresh verdict re-served
PATH_SHED_CARRYOVER = "shed-carryover"      # cycle deadline shed the job
PATH_QUARANTINED = "quarantined"            # parked as a poison job
PATH_WATCHDOG_FAILOVER = "watchdog-failover"  # hung launch, infra requeue
PATH_BLAST_RADIUS = "blast-radius-isolated"  # per-job isolation failed it
PATH_FETCH_RETRY = "fetch-retry"            # transient fetch failure requeue
PATH_NO_DATA = "no-data"                    # nothing judgeable (unknown/fail)

PATHS = frozenset({
    PATH_SCORED, PATH_STREAM_SCORED, PATH_MEMO_HIT, PATH_TRIAGED,
    PATH_STALE_SERVED, PATH_SHED_CARRYOVER, PATH_QUARANTINED,
    PATH_WATCHDOG_FAILOVER, PATH_BLAST_RADIUS, PATH_FETCH_RETRY,
    PATH_NO_DATA,
})

# per-record bound on family score entries: a 40-metric job keeps its 16
# most informative rows plus a drop count, not an unbounded list
_MAX_FAMILY_ENTRIES = 16

# bound on the handoff-hop chain a record carries: a job ping-ponging
# across replicas keeps its newest hops, never an unbounded history
_MAX_HOPS = 8


class ProvenanceRecorder:
    """Bounded store of per-(job, cycle) verdict-attribution records.

    The engine's cycle thread writes; HTTP/CLI threads read. All methods
    are no-ops when ``enabled`` is False (the PROVENANCE=0 A/B leg)."""

    def __init__(self, enabled: bool = True, max_jobs: int = 4096,
                 ring_size: int = 1024):
        self.enabled = enabled
        self.max_jobs = max_jobs
        self._lock = make_lock("engine.provenance")
        self._latest: OrderedDict[str, dict] = OrderedDict()  # job -> record
        self._ring: deque = deque(maxlen=ring_size)  # recent records
        # job -> inherited handoff-hop chain (adopt() seeds it from the
        # Document blob a releasing peer attached; record() stamps it
        # onto every later record so `explain` on the adopter shows the
        # full cross-replica decision chain)
        self._hops: OrderedDict[str, list] = OrderedDict()
        # job -> sticky latest-DETECTION annotations (trace_id,
        # detection_latency_s, detection_stages — annotate() refreshes
        # them at each observed window advance). Re-confirming sweeps
        # re-record a job every cycle; without the carry-forward the
        # push's trace linkage would survive exactly one cadence before
        # the next memo-hit record overwrote it (found live-driving the
        # runtime). Terminal records close the entry like hops.
        self._detections: OrderedDict[str, dict] = OrderedDict()
        self._cycle: dict = {}        # shared per-cycle block (stamped late)
        self._cycle_records: int = 0  # records written this cycle
        self.records_total = 0
        # durable spill hook (engine/jobtier.py JobTier.spill_prov): a
        # TERMINAL record closes the job's chain and never mutates
        # again, so it goes to the segment tier the moment it is
        # written — `explain` then outlives the LRU, gc, and kill -9.
        # Called OUTSIDE the recorder lock (it does file I/O);
        # best-effort — a full disk must not fail the scoring cycle.
        self.spill = None
        self.spills_total = 0
        self.spill_failures_total = 0

    # ------------------------------------------------------------- writing
    def begin_cycle(self, cycle_id: str, worker: str = ""):
        """Open a cycle: records written until finish_cycle share one
        mutable cycle block (stage timings land there after the fold)."""
        if not self.enabled:
            return
        with self._lock:
            self._cycle = {"cycle_id": cycle_id, "worker": worker}
            self._cycle_records = 0

    def record(self, job_id: str, path: str, status: str = "",
               detail: str = "", families: list | None = None,
               fetch: dict | None = None, reason: str = ""):
        """Stamp one job's verdict attribution for the open cycle."""
        if not self.enabled:
            return
        rec = {
            "job_id": job_id,
            "ts": time.time(),
            "path": path,
            "status": status,
            "cycle": self._cycle,  # shared ref; finish_cycle fills it in
        }
        # trace linkage: the current thread's open trace (the engine
        # cycle span) — `explain` answers with the trace_id a
        # trace lookup resolves. For pushed jobs the analyzer's later annotate()
        # overrides this with the push's own distributed trace id.
        tid = tracing.tracer.current_trace_id()
        if tid:
            rec["trace_id"] = tid
        if detail:
            rec["detail"] = detail
        if reason:
            rec["reason"] = reason
        if families:
            if len(families) > _MAX_FAMILY_ENTRIES:
                rec["families_dropped"] = len(families) - _MAX_FAMILY_ENTRIES
                families = families[:_MAX_FAMILY_ENTRIES]
            rec["families"] = families
        if fetch:
            rec["fetch"] = fetch
        with self._lock:
            det = self._detections.get(job_id)
            if det:
                # the latest DETECTION's linkage (trace_id, latency,
                # waterfall) rides every later record until a newer
                # advance refreshes it — a re-confirming sweep must not
                # sever explain's verdict -> trace link. annotate()
                # (running after record() in the observing cycle)
                # overwrites these with the fresh detection's values.
                rec.update(det)
            hops = self._hops.get(job_id)
            if hops:
                # the inherited chain survives every later record: the
                # adopter's terminal verdict archives WITH its history.
                # A TERMINAL record closes the chain — job ids are
                # deterministic (hpa/hmac over the request), so a
                # re-submitted incarnation of the same id must start
                # clean instead of inheriting a dead run's handoffs.
                rec["hops"] = list(hops)
                if status in TERMINAL_STATUSES:
                    self._hops.pop(job_id, None)
            if status in TERMINAL_STATUSES:
                self._detections.pop(job_id, None)
            self._latest[job_id] = rec
            self._latest.move_to_end(job_id)
            while len(self._latest) > self.max_jobs:
                self._latest.popitem(last=False)
            self._ring.append(rec)
            self._cycle_records += 1
            self.records_total += 1
        if self.spill is not None and status in TERMINAL_STATUSES:
            # same slimming the archive summary applies: keep the
            # attribution skeleton, drop the bulky shared cycle block
            # (which finish_cycle would mutate AFTER this spill anyway)
            slim = {k: v for k, v in rec.items() if k != "cycle"}
            slim["cycle_id"] = (self._cycle or {}).get("cycle_id", "")
            try:
                if self.spill(job_id, slim):
                    self.spills_total += 1
                else:
                    self.spill_failures_total += 1
            except Exception as e:  # noqa: BLE001 - observer, never fatal
                self.spill_failures_total += 1
                log.warning("provenance spill failed for %s: %s",
                            job_id, e)

    def finish_cycle(self, stage_seconds: dict | None = None,
                     device_launches: int | None = None,
                     jobs: int | None = None):
        """Close the cycle: stamp cycle-level context into the SHARED
        cycle block every record of this cycle references (one mutation,
        not one per record)."""
        if not self.enabled:
            return
        with self._lock:
            if stage_seconds is not None:
                self._cycle["stage_seconds"] = {
                    k: round(float(v), 6) for k, v in stage_seconds.items()}
            if device_launches is not None:
                self._cycle["device_launches"] = int(device_launches)
            if jobs is not None:
                self._cycle["jobs"] = int(jobs)

    _DETECTION_KEYS = ("trace_id", "detection_latency_s",
                       "detection_stages")

    def annotate(self, job_id: str, **kv):
        """Fold late-arriving fields (detection latency, measured after
        the record was written) into a job's LATEST record. The record
        dict is shared with the ring, so both views update; a no-op when
        the job has no record. Detection fields additionally stick to
        the job (LRU-bounded), so later re-confirming records keep the
        last detection's trace/waterfall linkage."""
        if not self.enabled or not kv:
            return
        det = {k: kv[k] for k in self._DETECTION_KEYS if k in kv}
        with self._lock:
            rec = self._latest.get(job_id)
            if rec is not None:
                rec.update(kv)
            if det:
                self._detections[job_id] = {
                    **self._detections.get(job_id, {}), **det}
                self._detections.move_to_end(job_id)
                while len(self._detections) > self.max_jobs:
                    self._detections.popitem(last=False)

    # --------------------------------------------- cross-replica handoffs
    def handoff_json(self, job_id: str, replica: str = "", worker: str = "",
                     reason: str = "", max_bytes: int = 4096) -> str:
        """Compact JSON a RELEASING replica attaches to the Document
        (processing_content) when it hands a job off — the job's latest
        attribution plus an explicit handoff hop naming this replica and
        its cycle, appended to any hops the job already inherited. The
        adopter feeds it back through adopt(), so `explain` there shows
        the full chain including every handoff. Empty string when
        recording is off (the field stays untouched)."""
        if not self.enabled:
            return ""
        rec = self.get(job_id)
        hop = {
            "replica": replica,
            "worker": worker,
            "reason": reason,
            "ts": round(time.time(), 3),
            "cycle_id": (rec.get("cycle") or {}).get("cycle_id", "")
            if rec else "",
            "path": rec.get("path", "") if rec else "",
        }
        with self._lock:
            inherited = list(self._hops.get(job_id) or ())
        prior = (rec.get("hops") if rec else None) or inherited
        hops = (list(prior) + [hop])[-_MAX_HOPS:]
        slim = {k: v for k, v in (rec or {"job_id": job_id}).items()
                if k != "cycle"}
        slim["cycle_id"] = hop["cycle_id"]
        slim["hops"] = hops
        slim["handoff"] = hop  # marker adopt() keys on
        blob = json.dumps(slim)
        if len(blob) > max_bytes:
            slim.pop("families", None)
            slim["families_dropped"] = "all"
            blob = json.dumps(slim)
        return blob

    def adopt(self, job_id: str, blob: str):
        """An ADOPTING replica imports the handoff blob that traveled on
        the Document: the hop chain is remembered and stamped onto every
        record this replica writes for the job. Non-handoff blobs (plain
        terminal summaries, legacy free text) are ignored."""
        if not self.enabled or not blob:
            return
        try:
            rec = json.loads(blob)
        except ValueError:
            return
        if not isinstance(rec, dict) or "handoff" not in rec:
            return
        hops = [h for h in (rec.get("hops") or []) if isinstance(h, dict)]
        if not hops:
            return
        with self._lock:
            self._hops[job_id] = hops[-_MAX_HOPS:]
            self._hops.move_to_end(job_id)
            while len(self._hops) > self.max_jobs:
                self._hops.popitem(last=False)

    # ------------------------------------------------------------- reading
    def get(self, job_id: str) -> dict | None:
        """Latest record for a job (deep enough copy for JSON serving)."""
        with self._lock:
            rec = self._latest.get(job_id)
            if rec is None:
                return None
            out = dict(rec)
            out["cycle"] = dict(rec.get("cycle") or {})
            return out

    def recent(self, limit: int = 50) -> list[dict]:
        with self._lock:
            recs = list(self._ring)[-limit:]
            return [{**r, "cycle": dict(r.get("cycle") or {})}
                    for r in recs]

    def for_jobs(self, job_ids) -> dict:
        """{job_id: record} for the ids that have one (flight dumps)."""
        out = {}
        for jid in job_ids:
            rec = self.get(jid)
            if rec is not None:
                out[jid] = rec
        return out

    def summary_json(self, job_id: str, max_bytes: int = 4096) -> str:
        """Compact JSON of a job's latest record for the archive
        Document's processing_content — bounded so one verbose record
        cannot bloat every archived verdict."""
        rec = self.get(job_id)
        if rec is None:
            return ""
        # archive documents are long-lived: keep the attribution skeleton,
        # drop the bulky per-cycle timing block
        slim = {k: v for k, v in rec.items() if k != "cycle"}
        slim["cycle_id"] = (rec.get("cycle") or {}).get("cycle_id", "")
        blob = json.dumps(slim)
        if len(blob) > max_bytes:
            slim.pop("families", None)
            slim["families_dropped"] = "all"
            blob = json.dumps(slim)
        return blob
