"""Incident flight recorder: a bounded ring of structured engine events.

The port's copy of the reference's ``engine/flightrec.py``. The recorder
keeps the last N structured events (what shed, what quarantined, which
breaker flipped, which watchdog fired, in what order) in RAM and
auto-dumps a JSON snapshot to disk — recent events + recent traces +
provenance for the jobs the events name + the live knob values — on the
transition into OVERLOADED/STALLED, so every incident leaves a
self-contained artifact even when nobody was watching.

Always-on and allocation-bounded: the ring is a fixed-size deque, event
details are small dicts, dumps are rate-limited (``min_dump_interval_s``)
and pruned to the newest ``MAX_DUMPS`` files. Event types are registered
constants, so dumps stay machine-diffable across builds.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from collections import deque

from ..utils.locks import make_lock

log = logging.getLogger("foremast_tpu_torch.engine.flightrec")

__all__ = [
    "FlightRecorder", "EVENT_TYPES",
    "EVENT_HEALTH_TRANSITION", "EVENT_SHED", "EVENT_QUARANTINE",
    "EVENT_STALE_SERVE", "EVENT_WATCHDOG", "EVENT_BREAKER",
    "EVENT_LEASE_HANDOFF", "EVENT_DUMP",
    "EVENT_REPLICA_JOIN", "EVENT_REPLICA_LEAVE", "EVENT_REBALANCE",
    "EVENT_SHARD_ADOPTION", "EVENT_STORE_RECOVERY",
]

# -- event-type registry -----------------------------------------------------
EVENT_HEALTH_TRANSITION = "health-transition"
EVENT_SHED = "load-shed"
EVENT_QUARANTINE = "quarantine"
EVENT_STALE_SERVE = "stale-serve"
EVENT_WATCHDOG = "watchdog-fire"
EVENT_BREAKER = "breaker-flip"
EVENT_LEASE_HANDOFF = "lease-handoff"
EVENT_DUMP = "flight-dump"
# sharded multi-replica membership (engine/sharding.py): another replica
# joined/left the ring, this replica's shard assignment changed, and a
# post-rebalance adoption scan pulled a peer's jobs
EVENT_REPLICA_JOIN = "replica-join"
EVENT_REPLICA_LEAVE = "replica-leave"
EVENT_REBALANCE = "shard-rebalance"
EVENT_SHARD_ADOPTION = "shard-adoption"
# crash-durable window store (dataplane/winstore.py): boot-time
# segment+WAL replay finished — detail carries the recovery stats
# (replayed records, scan statuses, seconds), so an incident dump after
# a restart self-documents what the replica recovered from disk
EVENT_STORE_RECOVERY = "window-store-recovery"

EVENT_TYPES = frozenset({
    EVENT_HEALTH_TRANSITION, EVENT_SHED, EVENT_QUARANTINE,
    EVENT_STALE_SERVE, EVENT_WATCHDOG, EVENT_BREAKER, EVENT_LEASE_HANDOFF,
    EVENT_DUMP, EVENT_REPLICA_JOIN, EVENT_REPLICA_LEAVE, EVENT_REBALANCE,
    EVENT_SHARD_ADOPTION, EVENT_STORE_RECOVERY,
})

MAX_DUMPS = 8  # newest dump files kept on disk per dump dir


class FlightRecorder:
    """Bounded event ring + incident snapshot dumper.

    ``tracer``/``provenance``/``knobs_fn``/``health_fn`` are optional
    read-only taps the dump folds in; each degrades to an empty section
    when absent (tests construct bare recorders)."""

    def __init__(self, max_events: int = 512, dump_dir: str = "",
                 tracer=None, provenance=None, knobs_fn=None,
                 health_fn=None, min_dump_interval_s: float = 60.0):
        self._lock = make_lock("engine.flightrec")
        self._events: deque = deque(maxlen=max(int(max_events), 16))
        self.dump_dir = dump_dir or tempfile.gettempdir()
        self.tracer = tracer
        self.provenance = provenance
        self.knobs_fn = knobs_fn      # () -> {name: current value}
        self.health_fn = health_fn    # () -> (state, detail)
        self.min_dump_interval_s = float(min_dump_interval_s)
        # None = never auto-dumped: time.monotonic() is time-since-boot on
        # Linux, so a 0.0 sentinel would rate-limit away the first incident
        # of a pod born broken shortly after VM boot
        self._last_auto_dump: float | None = None
        self.events_total = 0
        self.dumps_total = 0
        self.last_dump_path = ""

    # ------------------------------------------------------------- events
    def record_event(self, etype: str, **detail):
        """Append one structured event (detail values must be JSON-safe)."""
        ev = {"ts": time.time(), "type": etype, "detail": detail}
        with self._lock:
            self._events.append(ev)
            self.events_total += 1

    def snapshot(self, limit: int = 100) -> list[dict]:
        with self._lock:
            return [dict(e) for e in list(self._events)[-limit:]]

    # ------------------------------------------------------------- health
    def record_transition(self, old: str, new: str, detail: dict):
        """Append one health-transition event (cheap: ring append only,
        safe to call while the health monitor still holds its state lock
        so the ring order always matches the edge order)."""
        self.record_event(EVENT_HEALTH_TRANSITION, old=old, new=new,
                          **{k: v for k, v in detail.items()
                             if k != "open_breakers"})

    def maybe_auto_dump(self, new: str, detail: dict):
        """Transitions into OVERLOADED/STALLED auto-dump (rate-limited:
        a state flapping at cycle cadence must not write a dump per
        cycle). Dumping does file I/O and re-reads tracer/provenance
        state — call it OUTSIDE any engine lock."""
        if new not in ("overloaded", "stalled"):
            return
        now = time.monotonic()
        with self._lock:
            if (self._last_auto_dump is not None
                    and now - self._last_auto_dump < self.min_dump_interval_s):
                return
            self._last_auto_dump = now
        self.dump(reason=f"health:{new}", health=(new, detail))

    def on_health_transition(self, old: str, new: str, detail: dict):
        """Record + maybe-dump in one call, for callers with no lock held."""
        self.record_transition(old, new, detail)
        self.maybe_auto_dump(new, detail)

    # -------------------------------------------------------------- dumps
    def _affected_jobs(self, events: list[dict]) -> list[str]:
        ids: list[str] = []
        seen = set()
        for ev in events:
            jid = ev.get("detail", {}).get("job_id")
            jids = ev.get("detail", {}).get("jobs") or ()
            for j in ([jid] if jid else []) + list(jids):
                if j not in seen:
                    seen.add(j)
                    ids.append(j)
        return ids[:64]

    def dump(self, reason: str, health=None) -> str | None:
        """Write one self-contained incident snapshot; returns its path.
        Best-effort: a full disk or read-only volume must never take the
        engine down with it (failures log and return None)."""
        self.record_event(EVENT_DUMP, reason=reason)
        events = self.snapshot(limit=self._events.maxlen)
        payload: dict = {
            "reason": reason,
            "ts": time.time(),
            "events": events,
        }
        try:
            if health is None and self.health_fn is not None:
                health = self.health_fn()
            if health is not None:
                payload["health"] = {"state": health[0], "detail": health[1]}
            if self.tracer is not None:
                payload["traces"] = self.tracer.snapshot(limit=20)
            if self.provenance is not None:
                payload["provenance"] = {
                    "affected_jobs": self.provenance.for_jobs(
                        self._affected_jobs(events)),
                    "recent": self.provenance.recent(limit=20),
                }
            if self.knobs_fn is not None:
                payload["knobs"] = self.knobs_fn()
            os.makedirs(self.dump_dir, exist_ok=True)
            stamp = time.strftime("%Y%m%dT%H%M%S", time.gmtime())
            safe_reason = "".join(
                c if c.isalnum() or c in "-_" else "-" for c in reason)
            path = os.path.join(
                self.dump_dir,
                f"foremast-flight-{stamp}-{safe_reason}.json")
            tmp = f"{path}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
            self._prune_dumps()
            with self._lock:
                self.dumps_total += 1
                self.last_dump_path = path
            log.warning("flight recorder dumped %s (%s)", path, reason)
            return path
        except Exception as e:  # noqa: BLE001 - diagnostics must not crash
            log.warning("flight dump failed (%s): %s", reason, e)
            return None

    def _prune_dumps(self):
        try:
            dumps = sorted(
                fn for fn in os.listdir(self.dump_dir)
                if fn.startswith("foremast-flight-") and fn.endswith(".json"))
            for fn in dumps[:-MAX_DUMPS]:
                os.unlink(os.path.join(self.dump_dir, fn))
        except OSError:
            pass
