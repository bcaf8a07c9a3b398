"""Health state machine: the engine's own degraded-mode self-assessment.

The port's copy of the reference's ``engine/health.py``. It condenses the
degraded-mode layer's signals (load shedding, stale-verdict serving,
quarantine, the collect watchdog, breaker states, cycle liveness) into ONE
ordered state:

  OK          every verdict this cycle came from fresh data, on time.
  DEGRADED    verdicts are flowing but some are second-class: a breaker
              is open/half-open, stale verdicts were served, the collect
              watchdog fired, or jobs sit in poison quarantine. Consumers
              that ACT on verdicts must hold off.
  OVERLOADED  the cycle deadline budget forced load shedding: the engine
              cannot score the whole fleet inside its cadence. Verdicts
              that were produced are trustworthy; coverage is not.
  STALLED     no cycle has completed inside the liveness window — the
              worker is wedged (hung card, livelocked fetch).

Severity is ordered OK < DEGRADED < OVERLOADED < STALLED; the machine
reports the worst condition currently true, so DEGRADED->OK recovery is
automatic one clean cycle after the underlying fault clears. The state is
exported as the `foremastbrain:health_state` gauge (0 ok / 1 degraded /
2 overloaded / 3 stalled).
"""
from __future__ import annotations

import time

from ..utils.locks import make_lock

__all__ = ["HealthMonitor", "STATE_OK", "STATE_DEGRADED", "STATE_OVERLOADED",
           "STATE_STALLED", "HEALTH_STATE_VALUES"]

STATE_OK = "ok"
STATE_DEGRADED = "degraded"
STATE_OVERLOADED = "overloaded"
STATE_STALLED = "stalled"

# numeric encoding for the foremastbrain:health_state gauge
HEALTH_STATE_VALUES = {
    STATE_OK: 0, STATE_DEGRADED: 1, STATE_OVERLOADED: 2, STATE_STALLED: 3,
}


class HealthMonitor:
    """Per-cycle degraded-mode signal accumulator + state computation.

    The engine stamps `begin_cycle()`/`end_cycle(...)` around every cycle;
    readers (`/readyz`, `/status`, the operator's suppression probe) call
    `state()` at any time. Thread-safe: the engine worker writes, HTTP
    threads read.

    `breakers_fn` is wired by the runtime to the live breaker boards
    (data source + archive); standalone analyzers (tests, prewarm) leave
    it None and the breaker signal simply reads empty.
    """

    def __init__(self, exporter=None, cycle_seconds: float = 10.0,
                 stall_grace_seconds: float = 30.0,
                 clock=time.monotonic, recorder=None):
        self._lock = make_lock("engine.health")
        self.exporter = exporter
        self.cycle_seconds = float(cycle_seconds)
        # liveness window floor: tiny test cadences must not flag a
        # perfectly healthy engine STALLED between two instant cycles
        self.stall_grace_seconds = float(stall_grace_seconds)
        self._clock = clock
        self.breakers_fn = None  # () -> {key: "closed"|"half-open"|"open"}
        # sharded-brain tap (engine/sharding.py ShardManager.health_summary):
        # () -> {replica, replicas, owned, adopting, draining}. Folded into
        # the state() detail so /readyz and /status answer "which slice of
        # the fleet is this replica responsible for, and is it mid-
        # rebalance" — informational, never an input to the state (a rebalance is
        # normal operation, not degradation).
        self.shards_fn = None
        # detection-latency SLO tap (engine/slo.py DetectionSLO
        # burn_summary): () -> {class: error-budget burn}. Folded into
        # the state() detail like shards_fn — informational, never an
        # input to the state (latency is an SLO conversation, not readiness;
        # readiness failing on a burnt budget would route traffic away
        # from a brain that is merely slow, making it slower).
        self.slo_fn = None
        # flight recorder (engine/flightrec.py): hears state transitions
        # and breaker flips; transitions into OVERLOADED/STALLED auto-dump
        self.recorder = recorder
        self._last_seen_state: str | None = None
        self._last_open_breakers: tuple = ()
        self._started_at: float | None = None
        self._last_cycle_end: float | None = None
        # last COMPLETED cycle's degraded-mode signals
        self.last_cycle: dict = {
            "shed": 0, "stale_served": 0, "watchdog_fires": 0,
            "quarantined": 0, "deadline_overrun": False,
        }

    # ------------------------------------------------------------ wiring
    def configure(self, cycle_seconds: float | None = None,
                  breakers_fn=None, shards_fn=None, slo_fn=None):
        with self._lock:
            if cycle_seconds is not None:
                self.cycle_seconds = float(cycle_seconds)
            if breakers_fn is not None:
                self.breakers_fn = breakers_fn
            if shards_fn is not None:
                self.shards_fn = shards_fn
            if slo_fn is not None:
                self.slo_fn = slo_fn

    # --------------------------------------------------------- engine side
    def begin_cycle(self):
        with self._lock:
            if self._started_at is None:
                self._started_at = self._clock()

    def end_cycle(self, *, shed: int = 0, stale_served: int = 0,
                  watchdog_fires: int = 0, quarantined: int = 0,
                  deadline_overrun: bool = False):
        """Stamp one COMPLETED cycle. The engine calls this only when the
        cycle returned — a raising cycle leaves the liveness reference
        untouched, so both a hung cycle and a crash-looping worker age
        into STALLED (the worker loop swallows exceptions and retries,
        which would otherwise look exactly like health)."""
        with self._lock:
            self._last_cycle_end = self._clock()
            self.last_cycle = {
                "shed": int(shed),
                "stale_served": int(stale_served),
                "watchdog_fires": int(watchdog_fires),
                "quarantined": int(quarantined),
                "deadline_overrun": bool(deadline_overrun),
            }
        self._export()

    # --------------------------------------------------------- reader side
    # first-cycle warmup allowance: before ANY cycle has completed, the
    # stall window stretches (10x, min 10 minutes) — a cold pod's first
    # cycle legitimately pays the kernel library's build + LSTM warm
    # training (minutes on a fresh machine), and flagging that STALLED
    # would make the /readyz readinessProbe pull a healthy warming pod.
    # A genuinely wedged-from-birth worker still trips it, just later.
    FIRST_CYCLE_GRACE_FACTOR = 10.0
    FIRST_CYCLE_GRACE_MIN_S = 600.0

    def _stall_after(self, warming: bool) -> float:
        """Liveness window: a cycle (plus its deadline slack) must complete
        inside 3 cadences, floored by the grace so sub-second test cadences
        don't flap; stretched while the first cycle is still warming up."""
        base = max(3.0 * self.cycle_seconds, self.stall_grace_seconds)
        if warming:
            return max(self.FIRST_CYCLE_GRACE_FACTOR * base,
                       self.FIRST_CYCLE_GRACE_MIN_S)
        return base

    def state(self, now: float | None = None) -> tuple[str, dict]:
        """(state, detail). Worst-condition-wins; detail names every
        contributing signal so the runbook's "which knob moves it"
        question is answerable from the payload alone."""
        now = self._clock() if now is None else now
        with self._lock:
            last = dict(self.last_cycle)
            started = self._started_at
            last_end = self._last_cycle_end
            breakers_fn = self.breakers_fn
            shards_fn = self.shards_fn
            slo_fn = self.slo_fn
        open_breakers = []
        if breakers_fn is not None:
            try:
                open_breakers = sorted(
                    k for k, s in breakers_fn().items() if s != "closed")
            except Exception:  # noqa: BLE001 - a probe must never raise
                open_breakers = []
        detail = dict(last)
        detail["open_breakers"] = open_breakers
        if shards_fn is not None:
            try:
                detail["shards"] = shards_fn()
            except Exception:  # noqa: BLE001 - a probe must never raise
                pass
        if slo_fn is not None:
            try:
                burns = slo_fn()
                if burns:  # empty before the first verdict: no key churn
                    detail["slo_burn"] = burns
            except Exception:  # noqa: BLE001 - a probe must never raise
                pass
        # STALLED: the engine has started cycling but nothing COMPLETED
        # inside the liveness window. The reference is the last completed
        # cycle (first begin before any completes), so it covers every
        # wedge shape the same way: hung mid-cycle, crash-looping (raises
        # each cadence — those never stamp end_cycle), or a dead worker.
        stall_after = self._stall_after(warming=last_end is None)
        reference = last_end if last_end is not None else started
        if reference is not None and now - reference > stall_after:
            detail["seconds_since_cycle"] = round(now - reference, 3)
            return self._observe(STATE_STALLED, detail)
        # OVERLOADED means coverage was actually cut (jobs shed). A cycle
        # that merely OVERRAN the budget without shedding (scoring ran
        # long after every fetch landed) produced full, fresh coverage —
        # that is a capacity warning (`deadline_overrun` in the detail),
        # not a reason to fail readiness or hold remediation.
        if last["shed"] > 0:
            return self._observe(STATE_OVERLOADED, detail)
        if (open_breakers or last["stale_served"] > 0
                or last["watchdog_fires"] > 0 or last["quarantined"] > 0):
            return self._observe(STATE_DEGRADED, detail)
        return self._observe(STATE_OK, detail)

    def _observe(self, state: str, detail: dict) -> tuple[str, dict]:
        """Edge-detect state transitions and breaker flips for the flight
        recorder. Detection happens wherever the state is COMPUTED — the
        STALLED transition has no end_cycle() to hook, it is only ever
        seen by a reader (/readyz probe, /metrics scrape, the operator's
        suppression poll). Events are recorded UNDER the lock so the ring
        order always matches the edge order (two readers winning
        successive edges — incident then recovery — must not land
        inverted in the ring); only the auto-DUMP (file I/O, re-reads
        tracer/provenance state) runs outside."""
        if self.recorder is None:
            return state, detail
        fire_transition = None
        with self._lock:
            if self._last_seen_state != state:
                prev = self._last_seen_state
                self._last_seen_state = state
                # the engine is born OK: a first observation that is
                # already degraded/overloaded/stalled IS a transition
                # (the incident predates the first probe)
                if prev is not None or state != STATE_OK:
                    fire_transition = (prev or STATE_OK, state)
            breakers = tuple(detail.get("open_breakers") or ())
            flips = None
            if breakers != self._last_open_breakers:
                flips = (self._last_open_breakers, breakers)
                self._last_open_breakers = breakers
            try:
                if flips is not None:
                    from .flightrec import EVENT_BREAKER

                    self.recorder.record_event(
                        EVENT_BREAKER, was=list(flips[0]),
                        now=list(flips[1]))
                if fire_transition is not None:
                    self.recorder.record_transition(
                        fire_transition[0], fire_transition[1], detail)
            except Exception:  # noqa: BLE001 - diagnostics never break a probe
                pass
        if fire_transition is not None:
            try:
                self.recorder.maybe_auto_dump(state, detail)
            except Exception:  # noqa: BLE001 - diagnostics never break a probe
                pass
        return state, detail

    # ------------------------------------------------------------- export
    def _export(self):
        if self.exporter is None:
            return
        state, _ = self.state()
        self.exporter.record_gauge(
            "foremastbrain:health_state", {},
            HEALTH_STATE_VALUES[state],
            help="degraded-mode health state: 0 ok, 1 degraded, "
                 "2 overloaded, 3 stalled")

    def refresh_metrics(self):
        """Re-stamp the health gauge at scrape time (the STALLED
        transition has no end_cycle() to fire it — a wedged worker is
        exactly the case where nothing else would export)."""
        self._export()
