"""The event-driven scheduler and the plain worker on the port, on the CPU.

The reference's scheduler cases (tests/test_ingest.py) with their stub
analyzers pointed at the port's `StreamScheduler`: partial cycles for
notified jobs between sweeps at their cadence, and a burst past the
partial budget escalating to an immediate sweep. Then the scheduler over
the port's Analyzer: a partial cycle over a notified subset of a mixed fleet
(canary pairs, band monitors, two-metric and hpa jobs) gives exactly the
verdicts and hpalogs a full sweep over a twin store gives those jobs, and
claims nothing else. `EngineWorker` runs cycles on its thread. The
scheduler's steps are also held to the reference's on one sequence of
notifies, partial cycles and sweeps.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from foremast_tpu.dataplane import VerdictExporter as JaxVerdictExporter
from foremast_tpu.engine import scheduler as jax_scheduler
from foremast_tpu.engine import slo as jax_slo
from foremast_tpu_torch.dataplane import FixtureDataSource, VerdictExporter
from foremast_tpu_torch.engine import (
    Analyzer,
    Document,
    EngineConfig,
    EngineWorker,
    JobStore,
    MetricQueries,
    StreamScheduler,
)
from foremast_tpu_torch.engine import jobs as J
from foremast_tpu_torch.engine import scheduler as scheduler_mod
from foremast_tpu_torch.engine import slo as slo_mod

STEP = 60
SEED = 20261019
NOW = 100_000.0


def _wait(pred, deadline):
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -------------------------------------------------- with stub analyzers
def test_stream_scheduler_partial_and_sweep():
    sweeps = []
    partials = []

    class _An:
        def run_cycle(self, worker="w", job_ids=None, partial=False):
            partials.append((frozenset(job_ids), partial))

    sched = StreamScheduler(_An(), full_cycle_fn=lambda: sweeps.append(1),
                            cycle_seconds=0.6, worker="w", debounce_seconds=0.02)
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        assert _wait(lambda: sweeps, deadline), "first sweep never ran"
        sched.notify({"a", "b"})
        assert _wait(lambda: partials, deadline)
        assert partials[0] == (frozenset({"a", "b"}), True)
        # sweeps keep their cadence around partial cycles
        assert _wait(lambda: len(sweeps) >= 2, deadline)
        snap = sched.snapshot()
        assert snap["partial_cycles"] == 1
        assert snap["partial_jobs"] == 2
    finally:
        stop.set()
        t.join(timeout=5.0)


def test_oversized_burst_escalates_to_immediate_sweep():
    """A notify burst past the partial budget triggers the FULL sweep at
    once, not a spin on the unconsumed pending set until the tick."""
    sweeps = []

    class _An:
        def run_cycle(self, worker="w", job_ids=None, partial=False):
            raise AssertionError("oversized burst must not partial-cycle")

    sched = StreamScheduler(_An(), full_cycle_fn=lambda: sweeps.append(1),
                            cycle_seconds=30.0, worker="w", debounce_seconds=0.0,
                            max_partial_jobs=2)
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 5.0
        assert _wait(lambda: sweeps, deadline)
        sched.notify({"a", "b", "c"})
        assert _wait(lambda: len(sweeps) >= 2, deadline)
        assert sched.snapshot()["pending_jobs"] == 0
        assert sched.partial_cycles_total == 0
    finally:
        stop.set()
        t.join(timeout=5.0)


def _drive_scheduler(sched_mod, slo_module, exporter, seed):
    """One random sequence of notifies, partial cycles (some failing) and
    sweeps through `sched_mod`'s StreamScheduler, its steps called in
    turn on this thread over a stub analyzer: the cycles it runs, each
    step's answer, its snapshot, the waterfall's book and the exporter."""
    rng = np.random.default_rng(seed)
    calls = []

    class _An:
        waterfall = slo_module.DetectionWaterfall()

        def run_cycle(self, worker="w", job_ids=None, partial=False):
            calls.append(("cycle", worker, sorted(job_ids), partial))
            if "boom" in job_ids:
                raise RuntimeError("partial cycle failed")

    an = _An()
    for j in ("a", "b", "c"):
        an.waterfall.begin_push(j, 0.0, 0.0)
    sched = sched_mod.StreamScheduler(
        an, full_cycle_fn=lambda: calls.append(("sweep",)), cycle_seconds=0.01,
        worker="w", debounce_seconds=0.0, max_partial_jobs=4, exporter=exporter,
        checkpoint_fn=lambda: calls.append(("checkpoint",)))
    answers = []
    for _ in range(40):
        op = rng.integers(0, 4)
        if op <= 1:
            ids = {str(j) for j in rng.choice(["a", "b", "c", "d", "e", "f", "boom"],
                                              rng.integers(0, 4), replace=False)}
            answers.append(sched.notify(ids))
        elif op == 2:
            answers.append(sched._partial_cycle())
        else:
            sched._sweep()
        answers.append(sched.snapshot())
    text = "\n".join(ln for ln in exporter.render().splitlines() if "partial_cycle" in ln)
    scheduled = {j: an.waterfall._inflight.get(j, {}).get("scheduled") for j in "abc"}
    return calls, answers, text, scheduled


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stream_scheduler_matches_the_reference(seed):
    """The same notifies, partial cycles and sweeps through the reference's
    StreamScheduler and the port's: the cycles run, the budget escalations,
    the counters, the exporter's series and the waterfall's stamps are
    equal."""
    want = _drive_scheduler(jax_scheduler, jax_slo, JaxVerdictExporter(), seed)
    got = _drive_scheduler(scheduler_mod, slo_mod, VerdictExporter(), seed)
    assert got == want
    kinds = {c[0] for c in want[0]}
    assert kinds == {"cycle", "sweep", "checkpoint"} and False in want[1]


# ---------------------------------------------- over the port's Analyzer
def _add(fixtures, url, rng, n, t0, level, sigma, shift=0.0, region=0):
    ts = t0 + STEP * np.arange(n)
    vals = level + sigma * rng.standard_normal(n)
    vals[region:] += shift * sigma if region else 0.0
    fixtures[url] = (ts.tolist(), vals.tolist())
    return url


def _mixed_fleet(store, fixtures):
    """24 jobs: 8 canary pairs (2 bad), 8 band monitors (2 shifted), 4
    two-metric monitors (1 broken), 4 hpa jobs (one surging)."""
    rng = np.random.default_rng(SEED)
    t_hist, t_cur = NOW - 700 * STEP, NOW - 100 * STEP
    ids = []
    for i in range(8):
        jid = f"canary-{i}"
        b = _add(fixtures, f"http://p/{jid}/b", rng, 60, t_cur, 10.0, 1.0)
        c = _add(fixtures, f"http://p/{jid}/c", rng, 60, t_cur, 10.0, 1.0,
                 shift=6.0 if i in (2, 5) else 0.0, region=1)
        store.create(Document(id=jid, app_name=jid, namespace="s", strategy="canary",
                              start_time="2023-01-01T00:00:00Z",
                              end_time="2099-01-01T00:00:00Z",
                              metrics={"error5xx": MetricQueries(current=c, baseline=b)}))
        ids.append(jid)
    for i in range(8):
        jid = f"band-{i}"
        h = _add(fixtures, f"http://p/{jid}/h", rng, 600, t_hist, 50.0, 2.0)
        c = _add(fixtures, f"http://p/{jid}/c", rng, 60, t_cur, 50.0, 2.0,
                 shift=16.0 if i in (1, 6) else 0.0, region=1)
        store.create(Document(id=jid, app_name=jid, namespace="s", strategy="continuous",
                              start_time="START_TIME", end_time="END_TIME",
                              metrics={"latency": MetricQueries(current=c, historical=h)}))
        ids.append(jid)
    for i in range(4):
        jid = f"bi-{i}"
        metrics = {}
        for name, level in (("latency", 40.0), ("cpu", 20.0)):
            h = _add(fixtures, f"http://p/{jid}/{name}/h", rng, 600, t_hist, level, 2.0)
            c = _add(fixtures, f"http://p/{jid}/{name}/c", rng, 60, t_cur, level, 2.0,
                     shift=12.0 if i == 3 else 0.0, region=1)
            metrics[name] = MetricQueries(current=c, historical=h)
        store.create(Document(id=jid, app_name=jid, namespace="s", strategy="continuous",
                              start_time="START_TIME", end_time="END_TIME",
                              metrics=metrics))
        ids.append(jid)
    for i in range(4):
        jid = f"hpa-{i}"
        tps = _add(fixtures, f"http://p/{jid}/tps", rng, 660, t_hist, 200.0, 6.0,
                   shift=30.0 if i == 0 else 0.0, region=600)
        lat = _add(fixtures, f"http://p/{jid}/lat", rng, 660, t_hist, 5.0, 0.3)
        store.create(Document(id=jid, app_name=jid, namespace="s", strategy="hpa",
                              start_time="START_TIME", end_time="END_TIME",
                              metrics={"tps": MetricQueries(historical=tps, current=tps),
                                       "latency": MetricQueries(historical=lat, current=lat,
                                                                priority=1)}))
        ids.append(jid)
    return ids


class _AtNow:
    """The analyzer as the scheduler sees it, its cycles pinned to one
    `now` (the scheduler runs cycles at the wall clock)."""

    def __init__(self, an, now):
        self.an, self.now = an, now
        self.waterfall = an.waterfall

    def run_cycle(self, worker="w", job_ids=None, partial=False):
        return self.an.run_cycle(worker=worker, now=self.now, job_ids=job_ids,
                                 partial=partial)


def _verdicts(store, ids):
    return {j: (store.get(j).status, store.get(j).reason,
                sorted(store.get(j).anomaly.items())) for j in ids}


def _hpalogs(store, ids):
    return {j: [(log.hpascore, log.reason, log.details) for log in store.hpalogs_for(j)]
            for j in ids}


def test_partial_cycle_gives_the_full_sweep_s_verdicts():
    fixtures = {}
    store, twin = JobStore(), JobStore()
    ids = _mixed_fleet(store, fixtures)
    _mixed_fleet(twin, {})
    an = Analyzer(EngineConfig(max_stuck_seconds=1e9), FixtureDataSource(fixtures), store,
                  device="cpu")
    full = Analyzer(EngineConfig(max_stuck_seconds=1e9), FixtureDataSource(fixtures), twin,
                    device="cpu")
    notified = {"canary-2", "canary-3", "band-1", "band-4", "bi-3", "bi-0", "hpa-0", "hpa-2"}
    sched = StreamScheduler(_AtNow(an, NOW), full_cycle_fn=lambda: None, cycle_seconds=30.0,
                            worker="w", debounce_seconds=0.0)
    stop = threading.Event()
    t = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 20.0
        assert _wait(lambda: sched.sweeps_total >= 1, deadline)
        sched.notify(notified)
        assert _wait(lambda: sched.partial_cycles_total >= 1, deadline)
    finally:
        stop.set()
        t.join(timeout=5.0)
    assert an.last_cycle_stages["partial"] is True
    assert an.last_cycle_stages["jobs"] == len(notified)
    full.run_cycle(worker="w", now=NOW)
    assert _verdicts(store, notified) == _verdicts(twin, notified)
    assert _hpalogs(store, notified) == _hpalogs(twin, notified)
    # the notified set holds every family and both verdicts
    statuses = {store.get(j).status for j in notified}
    assert {J.INITIAL, J.COMPLETED_UNHEALTH} <= statuses
    # nothing else was claimed or judged
    others = [j for j in ids if j not in notified]
    assert all(store.get(j).status == J.INITIAL and not store.get(j).reason for j in others)
    assert all(an.provenance.get(j) is None for j in others)
    assert {an.provenance.get(j)["path"] for j in notified} <= {"stream-scored", "triaged"}
    # the next full sweep of the partial's store agrees with the twin's
    # second sweep job by job
    an.run_cycle(worker="w", now=NOW + 10)
    full.run_cycle(worker="w", now=NOW + 10)
    assert _verdicts(store, ids) == _verdicts(twin, ids)


def test_claim_open_jobs_scoped_to_named_ids():
    store = JobStore()
    for i in range(10):
        store.create(Document(id=f"j{i}", app_name="a", namespace="n", strategy="canary",
                              start_time="", end_time="", metrics={}))
    got = store.claim_open_jobs("w", only_ids={"j3", "j1", "missing"})
    assert [d.id for d in got] == ["j1", "j3"]
    assert all(d.status == J.PREPROCESS_INPROGRESS for d in got)
    assert store.get("j0").status == J.INITIAL
    # a scope covering most of the store walks the store in claim order
    got = store.claim_open_jobs("w", only_ids={f"j{i}" for i in range(10)})
    assert [d.id for d in got] == [f"j{i}" for i in (0, 2, 4, 5, 6, 7, 8, 9)]


def test_engine_worker_runs_cycles_until_stopped():
    fixtures, store = {}, JobStore()
    _mixed_fleet(store, fixtures)
    an = Analyzer(EngineConfig(max_stuck_seconds=1e9), FixtureDataSource(fixtures), store,
                  device="cpu")
    w = EngineWorker(an, name="w0", poll_interval=0.01).start()
    try:
        assert _wait(lambda: w.cycles >= 2, time.monotonic() + 30.0)
    finally:
        w.stop()
    assert not w.last_error
    assert an.current_cycle_id.startswith("w0-c")
