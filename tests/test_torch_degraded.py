"""The engine's degraded-mode layer on the port, on the CPU.

The reference's engine cases (tests/test_degraded.py) pointed at the port's
Analyzer with `device="cpu"`: the cycle deadline budget and load shedding
(and the library load that precedes the budget on the card),
stale-verdict serving, poison-job quarantine, the collect watchdog and the
health state machine. Then one fleet and one fault schedule through the
reference's Analyzer and the port's, at the reference's defaults (stale
serving, quarantine and provenance on): named jobs whose fetch fails after
a healthy fresh cycle, mid-window and at endTime; cold jobs whose fetch
fails from the start; a cycle under a 1e-9 s budget; a job whose scoring
fails until it is parked, then heals. Every job's status, reason class and
provenance path agree in every cycle, and so do the layers' own state after
every cycle: the health state and its detail, the SLO counts, the status
digest, the flight events, each judged job's provenance summary and each
terminal Document's processing_content. The verdict digests agree at the
end. The health machine is also held to the reference's on one signal
sequence under an injected clock.
"""
import dataclasses
import json
import math
import time

import numpy as np
import pytest

from foremast_tpu import engine as jax_engine
from foremast_tpu.dataplane.fetch import FetchError as JaxFetchError
from foremast_tpu.engine import flightrec as jax_flightrec
from foremast_tpu.engine import health as jax_health
from foremast_tpu.engine.jobs import verdict_digest as jax_digest
from foremast_tpu_torch.dataplane import FixtureDataSource, VerdictExporter
from foremast_tpu_torch.dataplane.fetch import FetchError
from foremast_tpu_torch.engine import (
    Analyzer,
    Document,
    EngineConfig,
    JobStore,
    MetricQueries,
)
from foremast_tpu_torch.engine import flightrec
from foremast_tpu_torch.engine import health
from foremast_tpu_torch.engine import jobs as J
from foremast_tpu_torch.engine.health import (
    STATE_DEGRADED,
    STATE_OK,
    STATE_OVERLOADED,
    STATE_STALLED,
    HealthMonitor,
)
from foremast_tpu_torch.engine.jobs import verdict_digest
from foremast_tpu_torch.resilience.policy import Deadline
from foremast_tpu_torch.utils.timeutils import to_rfc3339

STEP = 60
SEED = 20260804


def _series(rng, level, n):
    ts = np.arange(n) * STEP
    vals = np.clip(rng.normal(level, level * 0.1 + 0.01, n), 0, None)
    return ts.tolist(), vals.tolist()


def _mk_job(store, fixtures, job_id, *, bad=False, continuous=False,
            end_time=10_000_000.0, rng=None, doc_cls=Document, mq_cls=MetricQueries):
    rng = rng or np.random.default_rng(SEED)
    cur = f"http://prom:9090/{job_id}/cur"
    base = f"http://prom:9090/{job_id}/base"
    hist = f"http://prom:9090/{job_id}/hist"
    fixtures[cur] = _series(rng, 5.0 if bad else 0.5, 30)
    fixtures[base] = _series(rng, 0.5, 30)
    fixtures[hist] = _series(rng, 0.5, 600)
    store.create(doc_cls(
        id=job_id, app_name=f"app-{job_id}", namespace="deg",
        strategy="continuous" if continuous else "canary",
        start_time=to_rfc3339(0.0),
        end_time="" if continuous else to_rfc3339(end_time),
        metrics={"error5xx": mq_cls(current=cur, baseline=base, historical=hist)},
    ))


def _analyzer(src, store, **cfg):
    cfg.setdefault("max_stuck_seconds", 1e9)
    return Analyzer(EngineConfig(**cfg), src, store, device="cpu")


class CountingSource:
    """FixtureDataSource wrapper counting fetches (quarantine and shedding
    must park jobs WITHOUT touching the network)."""

    def __init__(self, fixtures):
        self.inner = FixtureDataSource(fixtures)
        self.fetches = 0

    def fetch(self, url):
        self.fetches += 1
        return self.inner.fetch(url)


class FailingSource:
    """Healthy until failed=True, then every fetch raises FetchError."""

    def __init__(self, fixtures):
        self.inner = FixtureDataSource(fixtures)
        self.failed = False

    def fetch(self, url):
        if self.failed:
            raise FetchError(f"blackout: {url}")
        return self.inner.fetch(url)


# ------------------------------------------------------- load shedding
def test_deadline_sheds_low_priority_and_carries_over():
    """An expired cycle budget sheds the steady-state monitor TAIL (carried
    over to INITIAL, never COMPLETED_UNKNOWN) while the canary — exempt by
    class — and the first monitor — the guaranteed-progress floor — still
    score."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    src = CountingSource(fixtures)
    an = _analyzer(src, store, cycle_deadline_seconds=1e-9)
    _mk_job(store, fixtures, "canary", rng=rng)
    _mk_job(store, fixtures, "watch1", continuous=True, rng=rng)
    _mk_job(store, fixtures, "watch2", continuous=True, rng=rng)

    outcomes = an.run_cycle(worker="w", now=100.0)
    assert outcomes["canary"] == J.INITIAL
    assert outcomes["watch1"] == J.INITIAL
    assert "shed" not in store.get("watch1").reason
    assert outcomes["watch2"] == J.INITIAL
    assert "shed" in store.get("watch2").reason
    assert an.jobs_shed_total == 1
    assert an._shed_streak == {"watch2": 1}
    # the canary and the guaranteed watch1 fetched their 3 URLs each
    assert src.fetches == 6
    assert an.health.state()[0] == STATE_OVERLOADED


class _ClockDeadline(Deadline):
    """A cycle deadline on the injected clock of the test below."""

    clock = {"t": 0.0}

    def __init__(self, at, clock=None):
        super().__init__(at, lambda: _ClockDeadline.clock["t"])

    @classmethod
    def after(cls, seconds, clock=None):
        return cls(cls.clock["t"] + float(seconds))


@pytest.mark.parametrize("slow_step", ["library", "fetch"])
def test_library_build_is_not_charged_to_the_first_cycle_s_budget(monkeypatch, slow_step):
    """On the card the first run_cycle loads (on a fresh machine builds)
    the kernel library before it arms CYCLE_DEADLINE_S, so a build longer
    than the budget sheds nothing. Here the analyzer is told a library is
    pending, and the load is a stand-in that moves an injected clock 10 s
    past a 5 s budget: nothing is shed, and the library loads once. The
    same 10 s spent in the cycle's fetches instead sheds every monitor but
    the first, which shows the clock reaches the budget."""
    from foremast_tpu_torch.engine import analyzer as analyzer_mod

    _ClockDeadline.clock["t"] = 0.0
    monkeypatch.setattr(analyzer_mod, "Deadline", _ClockDeadline)
    loads = []

    def slow_library():
        loads.append(1)
        if slow_step == "library":
            _ClockDeadline.clock["t"] += 10.0

    monkeypatch.setattr(analyzer_mod.kernel_build, "library", slow_library)
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    src = CountingSource(fixtures)
    fetch = src.fetch

    def slow_fetch(url):
        if slow_step == "fetch":
            _ClockDeadline.clock["t"] += 10.0
        return fetch(url)

    src.fetch = slow_fetch
    an = _analyzer(src, store, cycle_deadline_seconds=5.0)
    an._library_pending = True
    _mk_job(store, fixtures, "canary", rng=rng)
    for i in range(3):
        _mk_job(store, fixtures, f"watch{i}", continuous=True, rng=rng)
    an.run_cycle(worker="w", now=100.0)
    an.run_cycle(worker="w", now=110.0)
    assert loads == [1]
    if slow_step == "library":
        assert an.jobs_shed_total == 0
        assert an.health.state()[0] == STATE_OK
    else:
        assert an.jobs_shed_total == 4
        assert an.health.state()[0] == STATE_OVERLOADED


def test_shed_job_completes_with_identical_verdict_next_cycle():
    """A job shed under the deadline produces the same verdict on the next
    cycle as the one it would have produced unshed."""
    def build(deadline):
        rng = np.random.default_rng(SEED)
        fixtures = {}
        store = JobStore()
        an = _analyzer(FixtureDataSource(fixtures), store, cycle_deadline_seconds=deadline)
        _mk_job(store, fixtures, "ok-watch", continuous=True, rng=rng)
        _mk_job(store, fixtures, "bad-watch", bad=True, continuous=True, rng=rng)
        return an, store

    ref_an, ref_store = build(0.0)
    ref_an.run_cycle(worker="w", now=100.0)
    ref = ref_store.get("bad-watch")
    assert ref.status == J.COMPLETED_UNHEALTH

    an, store = build(1e-9)
    an.run_cycle(worker="w", now=100.0)
    doc = store.get("bad-watch")
    assert doc.status == J.INITIAL and "shed" in doc.reason
    an.run_cycle(worker="w", now=110.0)
    doc = store.get("bad-watch")
    assert doc.status == J.COMPLETED_UNHEALTH
    assert doc.reason == ref.reason
    assert doc.anomaly == ref.anomaly


def _settled(store):
    """Every job's (status, anomaly, reason when terminal): an open job
    keeps the reason of its last degraded-mode stamp (a requeue keeps the
    reason, as in the reference), so a carried job's "healthy so far"
    is compared by status."""
    return {d.id: (d.status, sorted(d.anomaly.items()),
                   d.reason if d.status in J.TERMINAL_STATUSES else "")
            for d in store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)}


def test_shed_fleet_settles_to_the_unshed_fleet_s_verdicts():
    """A fleet of canaries and monitors (some bad) under an expired budget,
    then the budget lifted: every shed job gets its unshed verdict."""
    def build(deadline):
        rng = np.random.default_rng(SEED + 1)
        fixtures = {}
        store = JobStore()
        an = _analyzer(FixtureDataSource(fixtures), store, cycle_deadline_seconds=deadline)
        for i in range(6):
            _mk_job(store, fixtures, f"canary-{i}", bad=i == 2, rng=rng)
        for i in range(10):
            _mk_job(store, fixtures, f"watch-{i}", bad=i in (3, 7), continuous=True, rng=rng)
        return an, store

    ref_an, ref_store = build(0.0)
    for now in (100.0, 110.0):
        ref_an.run_cycle(worker="w", now=now)
    an, store = build(1e-9)
    out = an.run_cycle(worker="w", now=100.0)
    shed = {j for j in out if "shed" in store.get(j).reason}
    assert shed == {f"watch-{i}" for i in range(1, 10)}
    an.config = dataclasses.replace(an.config, cycle_deadline_seconds=0.0)
    an.run_cycle(worker="w", now=110.0)
    assert _settled(store) == _settled(ref_store)
    assert store.get("watch-7").status == J.COMPLETED_UNHEALTH


# -------------------------------------------------- stale-verdict serving
def test_stale_verdict_served_mid_window_and_at_end():
    """During a source blackout a warm canary re-serves its last fresh
    verdict: requeue (reason stamped with the staleness age) mid-window,
    COMPLETED_HEALTH — never COMPLETED_UNKNOWN — at endTime."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    src = FailingSource(fixtures)
    an = _analyzer(src, store)
    _mk_job(store, fixtures, "canary", end_time=140.0, rng=rng)
    _mk_job(store, fixtures, "watch", continuous=True, rng=rng)

    an.run_cycle(worker="w", now=100.0)
    src.failed = True
    out = an.run_cycle(worker="w", now=110.0)
    assert out["canary"] == J.INITIAL
    assert "stale verdict" in store.get("canary").reason
    assert "age 10s" in store.get("canary").reason
    assert "stale verdict" in store.get("watch").reason
    out = an.run_cycle(worker="w", now=140.0)
    assert out["canary"] == J.COMPLETED_HEALTH
    assert store.get("canary").status == J.COMPLETED_HEALTH
    assert an.stale_verdicts_served_total >= 3
    assert an.health.state()[0] == STATE_DEGRADED


def test_stale_serving_bounded_by_max_stale_s():
    """Past MAX_STALE_S the job is COLD again: a canary's fetch failure ends
    it PREPROCESS_FAILED."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    src = FailingSource(fixtures)
    an = _analyzer(src, store, max_stale_seconds=50.0)
    _mk_job(store, fixtures, "canary", end_time=10_000.0, rng=rng)
    an.run_cycle(worker="w", now=100.0)
    src.failed = True
    out = an.run_cycle(worker="w", now=200.0)
    assert out.get("canary") != J.COMPLETED_HEALTH
    assert store.get("canary").status == J.PREPROCESS_FAILED
    assert an.stale_verdicts_served_total == 0


def test_empty_data_at_end_time_serves_stale_instead_of_unknown():
    """The fetch succeeds but carries no current data at endTime: a warm
    job completes COMPLETED_HEALTH on the stale verdict; with stale serving
    off it ends COMPLETED_UNKNOWN."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    an = _analyzer(FixtureDataSource(fixtures), store)
    _mk_job(store, fixtures, "canary", end_time=140.0, rng=rng)
    an.run_cycle(worker="w", now=100.0)
    fixtures["http://prom:9090/canary/cur"] = ([], [])
    out = an.run_cycle(worker="w", now=140.0)
    assert out["canary"] == J.COMPLETED_HEALTH
    assert "stale verdict" in store.get("canary").reason

    fixtures2 = {}
    store2 = JobStore()
    an2 = _analyzer(FixtureDataSource(fixtures2), store2, max_stale_seconds=0.0)
    _mk_job(store2, fixtures2, "canary", end_time=140.0, rng=np.random.default_rng(SEED))
    an2.run_cycle(worker="w", now=100.0)
    fixtures2["http://prom:9090/canary/cur"] = ([], [])
    out = an2.run_cycle(worker="w", now=140.0)
    assert out["canary"] == J.COMPLETED_UNKNOWN


def test_unhealthy_is_never_stale_served():
    """Fail-fast wins: an anomaly seen on fresh data completes terminally
    the same cycle, and its warm state is dropped."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    an = _analyzer(FailingSource(fixtures), store)
    _mk_job(store, fixtures, "bad", bad=True, end_time=10_000.0, rng=rng)
    out = an.run_cycle(worker="w", now=100.0)
    assert out["bad"] == J.COMPLETED_UNHEALTH
    assert "bad" not in an._stale_state


# --------------------------------------------------- poison-job quarantine
def test_poison_job_quarantined_with_exponential_readmission():
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    src = CountingSource(fixtures)
    an = _analyzer(src, store, quarantine_after=2, score_pipeline=False)
    _mk_job(store, fixtures, "poison", continuous=True, rng=rng)

    poisoned = {"on": True}
    orig = an._score_pairs

    def score(items):
        if poisoned["on"]:
            raise RuntimeError("poisoned job")
        return orig(items)

    an._score_pairs = score

    an.run_cycle(worker="w", now=100.0)   # failure 1
    assert an.quarantined_count(100.0) == 0
    an.run_cycle(worker="w", now=110.0)   # failure 2 -> parked 30 s
    assert an.quarantined_count(110.0) == 1
    assert an.jobs_quarantined_total == 1
    assert store.get("poison").status == J.INITIAL

    fetches = src.fetches
    out = an.run_cycle(worker="w", now=120.0)  # parked: no fetch, no score
    assert out["poison"] == J.INITIAL
    assert "quarantined" in store.get("poison").reason
    assert src.fetches == fetches
    assert an.health.state()[0] == STATE_DEGRADED

    # the re-admission probe fails -> re-parked at once, backoff doubled
    an.run_cycle(worker="w", now=141.0)
    q = an._quarantine["poison"]
    assert an.jobs_quarantined_total == 2
    assert q[1] == pytest.approx(141.0 + 60.0)

    # a healed probe clears the record
    poisoned["on"] = False
    an.run_cycle(worker="w", now=202.0)
    assert "poison" not in an._quarantine
    assert an.quarantined_count(202.0) == 0


# ---------------------------------------------------- hung-launch watchdog
def test_watchdog_times_out_hung_collect_and_fails_over():
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    an = _analyzer(FixtureDataSource(fixtures), store, watchdog_seconds=0.05)
    _mk_job(store, fixtures, "bad", bad=True, end_time=10_000.0, rng=rng)

    orig = an._collect_pairs
    calls = {"n": 0}

    def hung_collect(state):
        calls["n"] += 1
        if calls["n"] == 1:
            time.sleep(0.2)  # a stuck materialization
        return orig(state)

    an._collect_pairs = hung_collect
    out = an.run_cycle(worker="w", now=100.0)
    # the bucket failed over to the sync per-job path and still verdicted
    assert out["bad"] == J.COMPLETED_UNHEALTH
    assert an.watchdog_fires_total == 1
    assert calls["n"] >= 2
    assert an.health.state()[0] == STATE_DEGRADED
    assert any(e["type"] == "watchdog-fire" for e in an.flight.snapshot())


def test_watchdog_wedged_device_skips_remaining_retries():
    """ONE sync-retry timeout marks the card wedged: the remaining per-job
    retries are skipped instead of serializing N x WATCHDOG_S of timeouts
    into the cycle."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    an = _analyzer(FixtureDataSource(fixtures), store, watchdog_seconds=0.05)
    _mk_job(store, fixtures, "j1", continuous=True, rng=rng)
    _mk_job(store, fixtures, "j2", continuous=True, rng=rng)

    orig = an._collect_pairs
    an._collect_pairs = lambda state: (time.sleep(0.2), orig(state))[1]
    t0 = time.monotonic()
    out = an.run_cycle(worker="w", now=100.0)
    elapsed = time.monotonic() - t0
    assert an.watchdog_fires_total == 2
    assert out["j1"] == J.INITIAL and out["j2"] == J.INITIAL
    reasons = {store.get(j).reason for j in ("j1", "j2")}
    assert any("retry skipped" in r for r in reasons)
    assert elapsed < 2.0
    # a watchdog requeue is infrastructure evidence, never job poison
    assert an._quarantine == {}
    assert an.provenance.get("j1")["path"] == "watchdog-failover"


# --------------------------------------------------- health state machine
def test_health_state_machine_transitions():
    t = {"now": 1000.0}
    h = HealthMonitor(cycle_seconds=10.0, clock=lambda: t["now"])
    assert h.state()[0] == STATE_OK
    h.begin_cycle()
    h.end_cycle()
    assert h.state()[0] == STATE_OK
    h.begin_cycle()
    h.end_cycle(stale_served=2)
    assert h.state()[0] == STATE_DEGRADED
    h.begin_cycle()
    h.end_cycle(shed=3, stale_served=1)
    assert h.state()[0] == STATE_OVERLOADED
    h.begin_cycle()
    h.end_cycle()
    assert h.state()[0] == STATE_OK
    h.configure(breakers_fn=lambda: {"prom:9090": "open"})
    state, detail = h.state()
    assert state == STATE_DEGRADED and detail["open_breakers"] == ["prom:9090"]
    h.configure(breakers_fn=lambda: {"prom:9090": "closed"})
    assert h.state()[0] == STATE_OK
    h.begin_cycle()
    t["now"] += 31.0  # > max(3 * cycle_seconds, 30 s grace)
    state, detail = h.state()
    assert state == STATE_STALLED
    assert detail["seconds_since_cycle"] == pytest.approx(31.0)
    h.end_cycle()
    assert h.state()[0] == STATE_OK


def test_health_stalled_between_cycles_when_worker_wedges():
    t = {"now": 0.0}
    h = HealthMonitor(cycle_seconds=5.0, clock=lambda: t["now"])
    h.begin_cycle()
    h.end_cycle()
    t["now"] += 29.0
    assert h.state()[0] == STATE_OK
    t["now"] += 5.0
    assert h.state()[0] == STATE_STALLED


def test_health_crash_looping_cycles_go_stalled():
    """A cycle that RAISES never stamps end_cycle: a crash-looping engine
    ages into STALLED, later before the first completed cycle (its warm-up
    grace covers the library's build)."""
    t = {"now": 0.0}
    h = HealthMonitor(cycle_seconds=5.0, clock=lambda: t["now"])
    for _ in range(20):
        h.begin_cycle()
        t["now"] += 5.0
    assert h.state()[0] == STATE_OK
    t["now"] += h.FIRST_CYCLE_GRACE_MIN_S
    assert h.state()[0] == STATE_STALLED


def test_run_cycle_exception_does_not_stamp_health_ok():
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    t = {"now": 1000.0}
    an = _analyzer(FixtureDataSource(fixtures), store)
    an.health._clock = lambda: t["now"]
    _mk_job(store, fixtures, "watch", continuous=True, rng=rng)
    an.run_cycle(worker="w", now=100.0)
    assert an.health.state()[0] == STATE_OK

    def boom(*a, **kw):
        raise RuntimeError("store exploded")

    an.store.claim_open_jobs = boom
    for _ in range(10):
        t["now"] += 10.0
        with pytest.raises(RuntimeError):
            an.run_cycle(worker="w", now=100.0)
    assert an.health.state()[0] == STATE_STALLED


def test_health_gauge_and_cycle_signals_on_the_exporter():
    """The engine-side half of the reference's /readyz case: the health
    gauge and the cycle's degraded-mode signals, read from the exporter."""
    rng = np.random.default_rng(SEED)
    fixtures = {}
    store = JobStore()
    exporter = VerdictExporter()
    an = Analyzer(EngineConfig(max_stuck_seconds=1e9), FixtureDataSource(fixtures), store,
                  exporter, device="cpu")
    _mk_job(store, fixtures, "watch", continuous=True, rng=rng)
    an.run_cycle(worker="w", now=100.0)
    assert an.health.state()[0] == "ok"
    assert "stale_verdicts_served" in an.last_cycle_stages
    text = exporter.render()
    assert "# TYPE foremastbrain:health_state gauge" in text
    assert "foremastbrain:health_state 0" in text
    an.health.end_cycle(stale_served=1)
    assert an.health.state()[0] == "degraded"
    an.health.end_cycle(shed=5)
    assert an.health.state()[0] == "overloaded"
    assert "foremastbrain:health_state 2" in exporter.render()
    dig = an.status_digest()
    assert dig["health"] == "overloaded"
    assert set(dig["cycle"]) == {"jobs", "device_launches", "shed", "stale_served",
                                 "watchdog_fires", "quarantined"}


def _drive_health(mod, rec_mod, dump_dir, seed):
    """One random sequence of cycles and reads of `mod`'s HealthMonitor
    under an injected clock, with a flight recorder, a breaker board and an
    SLO tap: every state() answer, the recorder's events and the gauge."""
    rng = np.random.default_rng(seed)
    t = {"now": 500.0}
    breakers = {"prom:9090": "closed"}
    recorder = rec_mod.FlightRecorder(dump_dir=dump_dir, min_dump_interval_s=0.0)
    ex = VerdictExporter()
    hm = mod.HealthMonitor(exporter=ex, cycle_seconds=10.0, clock=lambda: t["now"],
                           recorder=recorder)
    hm.configure(breakers_fn=lambda: dict(breakers),
                 slo_fn=lambda: {"canary": round(float(t["now"]) % 3, 4)})
    answers = []
    for _ in range(40):
        step = rng.integers(0, 6)
        if step == 0:
            hm.begin_cycle()
        elif step == 1:
            sig = rng.integers(0, 3, size=4)
            hm.end_cycle(shed=int(sig[0] == 2), stale_served=int(sig[1]),
                         watchdog_fires=int(sig[2] == 2), quarantined=int(sig[3] == 2),
                         deadline_overrun=bool(rng.integers(0, 2)))
        elif step == 2:
            breakers["prom:9090"] = ("open", "half-open", "closed")[rng.integers(0, 3)]
        elif step == 3:
            t["now"] += float(rng.choice([1.0, 29.0, 31.0, 700.0]))
        answers.append(hm.state())
    gauge = [ln for ln in ex.render().splitlines() if "health_state" in ln]
    events = [(e["type"], e["detail"]) for e in recorder.snapshot(limit=1000)]
    return answers, events, recorder.dumps_total, gauge


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_health_monitor_matches_the_reference(tmp_path, seed):
    """The same cycles, breaker flips and clock through the reference's
    HealthMonitor and the port's: every state and detail, the transitions
    and breaker flips the flight recorder heard, its dumps, and the
    exported gauge are equal."""
    want = _drive_health(jax_health, jax_flightrec, str(tmp_path / "ref"), seed)
    got = _drive_health(health, flightrec, str(tmp_path / "port"), seed)
    assert got == want
    assert len({a[0] for a in want[0]}) >= 3 and want[1]


# ------------------------------------------ one fault schedule, both engines
NOWS = (1000.0, 1010.0, 1020.0, 1030.0, 1040.0, 1055.0)
BUDGET_CYCLE = 3          # the cycle (index into NOWS) under a 1e-9 s budget
FAIL_CYCLES = (1, 2)      # the warm jobs' fetches fail in these cycles
POISON_HEALS = 5          # the poison job scores cleanly from this cycle on
WARM_FAILING = ("canary-mid", "canary-end", "watch-fail")
COLD_FAILING = ("canary-cold", "watch-cold")


def _schedule_fleet(store, fixtures, doc_cls, mq_cls):
    """16 jobs: healthy and bad canaries and monitors; canary-end ends
    between the two blackout cycles; canary-cold and watch-cold never
    fetch; `poison` fails scoring."""
    rng = np.random.default_rng(SEED + 7)
    kw = dict(doc_cls=doc_cls, mq_cls=mq_cls, rng=rng)
    for i in range(4):
        _mk_job(store, fixtures, f"canary-{i}", bad=i == 1, **kw)
    _mk_job(store, fixtures, "canary-mid", **kw)
    _mk_job(store, fixtures, "canary-end", end_time=1015.0, **kw)
    _mk_job(store, fixtures, "canary-cold", **kw)
    for i in range(6):
        _mk_job(store, fixtures, f"watch-{i}", bad=i == 4, continuous=True, **kw)
    _mk_job(store, fixtures, "watch-fail", continuous=True, **kw)
    _mk_job(store, fixtures, "watch-cold", continuous=True, **kw)
    _mk_job(store, fixtures, "poison", continuous=True, **kw)


class _ScheduleSource:
    """Fixture fetches that fail, by job, as the schedule says."""

    def __init__(self, fixtures, error):
        self.fixtures = fixtures
        self.error = error
        self.failing: set = set(COLD_FAILING)

    def fetch(self, url):
        job = url.split("/")[3]
        if job in self.failing:
            raise self.error(f"blackout: {url}")
        ts, vals = self.fixtures[url]
        return list(ts), list(vals)


def _reason_class(reason: str) -> str:
    for prefix, cls in (("stale verdict served", "stale served"), ("shed:", "shed"),
                        ("quarantined:", "quarantined"), ("fetch retry:", "fetch retry"),
                        ("scoring failed:", "scoring failed"),
                        ("anomaly detected", "anomaly"), ("blackout", "fetch failed")):
        if reason.startswith(prefix):
            return cls
    return reason


# clock readings and trace ids: each engine's own
_TIMING_KEYS = ("ts", "trace_id", "fetch_seconds", "detection_latency_s", "detection_stages")
# a verdict's family statistics (float32 p-values, the triage screen's z
# scores) to the tolerance tests/test_torch_triage.py holds the screen to;
# every other value of the layers exactly
FAMILY_RTOL, FAMILY_ATOL = 2e-3, 1e-4


def _untimed(obj):
    """`obj` without the keys that hold clock readings or trace ids."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in _TIMING_KEYS}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _assert_close(got, want, where, in_families=False):
    """Equal structure and values; floats under a `families` key within
    FAMILY_RTOL / FAMILY_ATOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            f"{where}: keys {sorted(got) if isinstance(got, dict) else got} != {sorted(want)}"
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}", in_families or k == "families")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), f"{where}: {got} != {want}"
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]", in_families)
    elif in_families and isinstance(want, float):
        assert isinstance(got, (int, float)) and math.isclose(
            got, want, rel_tol=FAMILY_RTOL, abs_tol=FAMILY_ATOL), f"{where}: {got} != {want}"
    else:
        assert got == want, f"{where}: {got!r} != {want!r}"


def _layers_state(an, store, out, events_seen):
    """The layers' state after one cycle, timing left out: the health state
    and detail, the SLO counts (its quantiles are wall-clock latencies), the
    status digest, the flight events of the cycle, and the provenance
    summary and processing_content of every job the cycle judged."""
    slo = {cls: {k: v for k, v in d.items() if k not in ("p50_s", "p99_s")}
           for cls, d in an.slo.digest().items()}
    digest = an.status_digest()
    digest["slo"] = slo
    events = an.flight.snapshot(limit=10_000)[events_seen:]
    terminal = [j for j in sorted(out) if store.get(j).status in J.TERMINAL_STATUSES]
    return {
        "health": list(an.health.state()),
        "slo": slo,
        "status_digest": digest,
        "events": _untimed(events),
        "provenance": {j: _untimed(json.loads(an.provenance.summary_json(j)))
                       for j in sorted(out)},
        "processing_content": {j: _untimed(json.loads(store.get(j).processing_content))
                               for j in terminal},
    }, events_seen + len(events)


def _run_schedule(an, store, src):
    poisoned = {"on": True}
    score, collect = an._score_pairs, an._collect_pairs

    def is_poison(items):
        return poisoned["on"] and any(it.job_id == "poison" for it in items)

    def poisoned_score(items):
        if is_poison(items):
            raise RuntimeError("poisoned job")
        return score(items)

    def poisoned_collect(state):
        if is_poison(state[0]):
            raise RuntimeError("poisoned job")
        return collect(state)

    an._score_pairs, an._collect_pairs = poisoned_score, poisoned_collect
    base_cfg = an.config
    rows, layers, seen = [], [], 0
    for c, now in enumerate(NOWS):
        src.failing = set(COLD_FAILING) | (set(WARM_FAILING) if c in FAIL_CYCLES else set())
        poisoned["on"] = c < POISON_HEALS
        an.config = dataclasses.replace(
            base_cfg, cycle_deadline_seconds=1e-9 if c == BUDGET_CYCLE else 0.0)
        out = an.run_cycle(worker="w", now=now)
        row = {}
        for jid, status in sorted(out.items()):
            doc = store.get(jid)
            rec = an.provenance.get(jid)
            row[jid] = (status, doc.status, _reason_class(doc.reason),
                        rec["path"] if rec else None)
        rows.append(row)
        state, seen = _layers_state(an, store, out, seen)
        layers.append(state)
    return rows, layers


def test_fault_schedule_matches_the_reference_at_its_defaults():
    """The reference's defaults (MAX_STALE_S 300, QUARANTINE_AFTER 3,
    PROVENANCE on): status, reason class and provenance path equal for
    every job in every cycle, and the verdict digests equal at the end."""
    fixtures = {}
    ref_store = jax_engine.JobStore()
    _schedule_fleet(ref_store, fixtures, jax_engine.Document, jax_engine.MetricQueries)
    ref_src = _ScheduleSource(fixtures, JaxFetchError)
    ref = jax_engine.Analyzer(jax_engine.EngineConfig(max_stuck_seconds=1e9), ref_src,
                              ref_store)
    ref_rows, ref_layers = _run_schedule(ref, ref_store, ref_src)

    store = JobStore()
    _schedule_fleet(store, {}, Document, MetricQueries)
    src = _ScheduleSource(fixtures, FetchError)
    an = _analyzer(src, store)
    rows, layers = _run_schedule(an, store, src)

    for c, (got, want) in enumerate(zip(rows, ref_rows)):
        assert got == want, f"cycle {c}"
    for c, (got, want) in enumerate(zip(layers, ref_layers)):
        # lease releases and adoptions come with sharding, not yet ported
        for key in ("releases", "adoptions"):
            want["status_digest"]["lease"].pop(key)
        _assert_close(got, want, f"cycle {c}")
    assert verdict_digest(store) == jax_digest(ref_store)
    # the schedule drove every degraded-mode path it names
    classes = {v[2] for row in rows for v in row.values()}
    assert {"stale served", "shed", "quarantined", "fetch retry",
            "scoring failed"} <= classes
    assert rows[2]["canary-end"][0] == J.COMPLETED_HEALTH
    assert rows[0]["canary-cold"][0] == J.PREPROCESS_FAILED
    assert rows[POISON_HEALS]["poison"][2] != "quarantined"
    assert "poison" not in an._quarantine
    assert an.jobs_quarantined_total == ref.jobs_quarantined_total == 1
    assert an.stale_verdicts_served_total == ref.stale_verdicts_served_total
    assert an.jobs_shed_total == ref.jobs_shed_total
