"""Detection-latency SLOs and the waterfall on the port, on the CPU.

The reference's engine cases (tests/test_fleet_plane.py, the waterfall
cases of tests/test_trace_plane.py) pointed at the port: the SLO tracker's
quantiles, attainment and burn; a latency observation for every job class
that rides the provenance record and the terminal Document; verdicts
identical with PROVENANCE off; the waterfall's book, its scheduler stamps,
a polled job's stage sum, and a pushed job's trace carried by a partial
cycle to its verdict. The tracker, `classify` and the waterfall are also
held to the reference's own on the same observations. The service, the
ingest receiver and the federation cases wait for those layers.
"""
from __future__ import annotations

import json
import time
import types

import numpy as np
import pytest

from foremast_tpu.dataplane import VerdictExporter as JaxVerdictExporter
from foremast_tpu.engine import slo as jax_slo
from foremast_tpu.utils import tracing as jax_tracing
from foremast_tpu_torch.dataplane import FixtureDataSource, VerdictExporter
from foremast_tpu_torch.engine import (
    Analyzer,
    Document,
    EngineConfig,
    JobStore,
    MetricQueries,
)
from foremast_tpu_torch.engine import jobs as J
from foremast_tpu_torch.engine import slo as slo_mod
from foremast_tpu_torch.engine.jobs import verdict_digest
from foremast_tpu_torch.engine.slo import DetectionSLO, classify
from foremast_tpu_torch.utils import tracing
from foremast_tpu_torch.utils.timeutils import to_rfc3339

STEP = 60
SEED = 20260804


def _series(rng, level, n, t0=0):
    ts = t0 + np.arange(n) * STEP
    vals = np.clip(rng.normal(level, level * 0.1 + 0.01, n), 0, None)
    return ts.tolist(), vals.tolist()


def _mk_job(store, fixtures, job_id, *, bad=False, strategy="canary",
            end_time=10_000_000.0, rng=None):
    rng = rng or np.random.default_rng(SEED)
    cur = f"http://prom:9090/{job_id}/cur"
    base = f"http://prom:9090/{job_id}/base"
    fixtures[cur] = _series(rng, 5.0 if bad else 0.5, 30)
    fixtures[base] = _series(rng, 0.5, 30)
    continuous = strategy in ("continuous", "hpa")
    store.create(Document(
        id=job_id, app_name=f"app-{job_id}", namespace="fleet",
        strategy=strategy,
        start_time="START_TIME" if continuous else to_rfc3339(0.0),
        end_time="END_TIME" if continuous else to_rfc3339(end_time),
        metrics={"error5xx": MetricQueries(current=cur, baseline=base)},
    ))


def _mk_hpa_job(store, fixtures, job_id):
    rng = np.random.default_rng(5)
    tps_url = f"http://prom/{job_id}/tps"
    sla_url = f"http://prom/{job_id}/sla"
    hist_ts, hist_v = _series(rng, 100.0, 90)
    cur_ts = [t + hist_ts[-1] + STEP for t in np.arange(30) * STEP]
    fixtures[tps_url] = (hist_ts + list(cur_ts),
                         hist_v + np.random.default_rng(1).normal(240, 5, 30).tolist())
    fixtures[sla_url] = _series(rng, 5.0, 120)
    store.create(Document(
        id=job_id, app_name="app", namespace="fleet", strategy="hpa",
        start_time="START_TIME", end_time="END_TIME",
        metrics={
            "tps": MetricQueries(historical=tps_url, current=tps_url),
            "latency": MetricQueries(historical=sla_url, current=sla_url, priority=1),
        },
    ))


def _analyzer(fixtures, store, **cfg):
    cfg.setdefault("max_stuck_seconds", 1e9)
    return Analyzer(EngineConfig(**cfg), FixtureDataSource(fixtures), store,
                    VerdictExporter(), device="cpu")


@pytest.fixture
def full_sampling():
    """The waterfall's trace cases share the process-wide tracer: pin full
    sampling and restore whatever was set before."""
    old = tracing.tracer.sample_rate
    tracing.tracer.set_sample_rate(1.0)
    yield
    tracing.tracer.set_sample_rate(old)


# ------------------------------------------------------- detection SLO unit

def test_slo_quantiles_attainment_burn():
    slo = DetectionSLO(targets={"canary": 0.5}, objective=0.99)
    for v in (0.01, 0.02, 0.3, 0.6, 2.0):
        slo.observe("canary", v)
    assert slo.quantile(0.5, "canary") == 0.5
    assert slo.quantile(0.99, "canary") == 2.5
    assert slo.attainment("canary") == pytest.approx(0.6)
    # 40% violations against a 1% budget = 40x burn
    assert slo.burn("canary") == pytest.approx(40.0)
    snap = slo.snapshot()["classes"]["canary"]
    assert snap["count"] == 5 and snap["violations"] == 2
    assert snap["target_s"] == 0.5
    slo.observe("hpa", 0.001)
    assert slo.quantile(0.0, None) == 0.001
    assert set(slo.burn_summary()) == {"canary", "hpa"}
    assert set(slo.digest()) == {"canary", "hpa"}
    slo.reset()
    assert slo.quantile(0.5, "canary") == 0.0
    assert slo.burn_summary() == {}


def test_slo_no_target_never_violates():
    slo = DetectionSLO(targets={}, objective=0.99)
    slo.observe("continuous", 1e6)
    assert slo.attainment("continuous") == 1.0
    assert slo.burn("continuous") == 0.0


def test_slo_exporter_series():
    ex = VerdictExporter()
    slo = DetectionSLO(exporter=ex, targets={"canary": 0.1})
    slo.observe("canary", 0.5)
    rendered = ex.render()
    assert "foremastbrain:detection_latency_seconds_bucket" in rendered
    assert 'foremastbrain:slo_attainment{class="canary"} 0.0' in rendered
    assert 'foremastbrain:slo_violations_total{class="canary"} 1' in rendered
    assert "foremastbrain:slo_error_budget_burn" in rendered


def test_classify_strategies():
    assert classify("hpa") == "hpa"
    assert classify("continuous") == "continuous"
    for s in ("canary", "rollingUpdate", "rollover"):
        assert classify(s) == "canary"


# ------------------------------------------- engine latency instrumentation

def test_detection_latency_recorded_for_every_job_class():
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store)
    _mk_job(store, fixtures, "c1", bad=True, end_time=5000.0)
    _mk_job(store, fixtures, "m1", strategy="continuous")
    _mk_hpa_job(store, fixtures, "app:fleet:hpa")
    out = an.run_cycle(worker="w", now=0.0)
    assert out["c1"] == J.COMPLETED_UNHEALTH
    assert out["m1"] == J.INITIAL
    assert out["app:fleet:hpa"] == J.INITIAL
    dig = an.slo.digest()
    assert set(dig) == {"canary", "continuous", "hpa"}
    assert all(d["n"] == 1 for d in dig.values())
    # the latency annotation rides the provenance record AND the terminal
    # summary
    rec = an.provenance.get("c1")
    assert rec["detection_latency_s"] > 0.0
    attached = json.loads(store.get("c1").processing_content)
    assert attached["detection_latency_s"] == rec["detection_latency_s"]
    snap = an.slo.snapshot()
    assert snap["classes"]["canary"]["count"] == 1
    assert snap["classes"]["canary"]["target_s"] == an.config.slo_canary_seconds
    _, detail = an.health.state()
    assert set(detail["slo_burn"]) == {"canary", "continuous", "hpa"}
    assert "foremastbrain:detection_latency_seconds_bucket" in an.exporter.render()
    assert an.status_digest()["slo"] == dig


def test_each_window_advance_is_observed_once():
    """A cycle that re-judges a job on the same newest sample re-confirms
    it: no new observation until the window advances; reset_slo clears the
    dedupe with the histograms."""
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store)
    _mk_job(store, fixtures, "m1", strategy="continuous")
    an.run_cycle(worker="w", now=2000.0)
    an.run_cycle(worker="w", now=2010.0)
    assert an.slo.digest()["continuous"]["n"] == 1
    ts, vals = fixtures["http://prom:9090/m1/cur"]
    fixtures["http://prom:9090/m1/cur"] = (ts[1:] + [ts[-1] + STEP], vals[1:] + [0.5])
    an.run_cycle(worker="w", now=2020.0)
    assert an.slo.digest()["continuous"]["n"] == 2
    an.reset_slo()
    assert an.slo.digest() == {}
    an.run_cycle(worker="w", now=2030.0)
    assert an.slo.digest()["continuous"]["n"] == 1


def test_verdicts_identical_with_plane_observing_vs_provenance_off():
    """The plane only OBSERVES: statuses, reasons, anomalies and the digest
    are identical with PROVENANCE off (SLO recording is always on and must
    not feed back either)."""
    outs, digests = {}, {}
    for flag in (True, False):
        fixtures, store = {}, JobStore()
        an = _analyzer(fixtures, store, provenance=flag)
        rng = np.random.default_rng(99)
        for i in range(6):
            _mk_job(store, fixtures, f"j{i}", bad=(i % 3 == 0), end_time=5000.0, rng=rng)
        an.run_cycle(worker="w", now=1000.0)
        an.run_cycle(worker="w", now=6000.0)
        outs[flag] = {
            d.id: (d.status, d.reason, sorted(d.anomaly.items()))
            for d in store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)}
        digests[flag] = verdict_digest(store)
    assert outs[True] == outs[False]
    assert digests[True] == digests[False]


# ------------------------------------------------ against the reference
def _latencies(seed, n=240):
    """Observations across the three classes: log-normal latencies with
    zeros, negatives, bucket edges and values past the last edge."""
    rng = np.random.default_rng(seed)
    classes = rng.choice(["canary", "continuous", "hpa"], n)
    vals = np.exp(rng.normal(0.0, 2.0, n))
    vals[rng.random(n) < 0.05] = 0.0
    vals[rng.random(n) < 0.05] = -1.0
    edges = np.asarray(slo_mod.DEFAULT_TIME_BUCKETS)
    pick = rng.random(n) < 0.1
    vals[pick] = rng.choice(edges, pick.sum())
    vals[rng.random(n) < 0.03] = 1e6
    return [(str(c), float(v)) for c, v in zip(classes, vals)]


def _drive_slo(mod, exporter, seed):
    slo = mod.DetectionSLO(exporter, targets={"canary": 30.0, "continuous": 2.5, "hpa": 0.0},
                           objective=0.97)
    reads = []
    for i, (cls, v) in enumerate(_latencies(seed)):
        slo.observe(cls, v)
        if i % 40 == 39:
            reads.append((slo.digest(), slo.snapshot(), slo.burn_summary(),
                          [slo.quantile(q, c) for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0)
                           for c in (None, "canary", "continuous", "hpa", "none")],
                          [(slo.attainment(c), slo.burn(c)) for c in ("canary", "hpa", "x")]))
    slo.refresh_metrics()
    text = exporter.render()
    slo.reset()
    return reads, text, slo.digest(), slo.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_detection_slo_matches_the_reference(seed):
    """One series of observations through the reference's DetectionSLO and
    the port's: digests, snapshots, burns, quantiles, attainment and the
    exporter's series are equal after every 40 observations."""
    want = _drive_slo(jax_slo, JaxVerdictExporter(), seed)
    got = _drive_slo(slo_mod, VerdictExporter(), seed)
    assert got == want
    assert want[0][-1][0]["continuous"]["burn"] > 0


@pytest.mark.parametrize("strategy", ["canary", "rollover", "continuous", "hpa", "",
                                      "CANARY", "Continuous", "bogus"])
def test_classify_matches_the_reference(strategy):
    assert classify(strategy) == jax_slo.classify(strategy)


def _drive_waterfall(mod, tracing_mod, monkeypatch, seed):
    """One random sequence of pushes, stage stamps, notifies, claims,
    discards and verdict folds through `mod`'s DetectionWaterfall on an
    injected monotonic clock; everything it answers."""
    rng = np.random.default_rng(seed)
    clock = {"t": 1000.0}
    monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: clock["t"]))
    wf = mod.DetectionWaterfall(max_jobs=12)
    ctxs = [tracing_mod.W3CContext(c * 32, "1" * 16) for c in "abc"]
    jobs = [f"j{i}" for i in range(20)]
    answers = []
    for _ in range(300):
        op = rng.integers(0, 7)
        ids = [str(j) for j in rng.choice(jobs, rng.integers(1, 5), replace=False)]
        clock["t"] += float(rng.choice([0.0, 0.01, 0.3, 2.0]))
        if op == 0:
            ctx = ctxs[rng.integers(0, 3)] if rng.random() < 0.7 else None
            for j in ids:
                wf.begin_push(j, 500.0 + float(rng.integers(0, 50)),
                              550.0 + float(rng.integers(0, 50)), ctx=ctx)
        elif op == 1:
            wf.add_stage(ids[0], str(rng.choice(mod.STAGE_ORDER)), float(rng.normal(0.5, 1.0)))
        elif op == 2:
            wf.notify(ids)
        elif op == 3:
            wf.claim(ids, debounce_seconds=float(rng.choice([0.0, 0.05, 1.0])))
        elif op == 4:
            wf.discard(ids[0])
        elif op == 5:
            out = wf.observe(ids[0], now=700.0, newest_ts=float(rng.choice([0.0, 640.0])),
                             score_s=float(rng.random()), fold_s=float(rng.random()) / 10)
            answers.append({k: v for k, v in out.items() if k != "ctx"})
        ctx = wf.single_context(ids)
        answers.append(ctx.trace_id if ctx is not None else None)
    answers.append(wf.snapshot())
    answers.append([wf.quantile(st, q) for st in (*mod.STAGE_ORDER, "total")
                    for q in (0.5, 0.99)])
    return answers


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_waterfall_matches_the_reference(monkeypatch, seed):
    """The same pushes, stamps and folds through the reference's
    DetectionWaterfall and the port's, on one injected clock: every fold's
    stages, the shared trace contexts, the snapshot and the quantiles are
    equal."""
    want = _drive_waterfall(jax_slo, jax_tracing, monkeypatch, seed)
    got = _drive_waterfall(slo_mod, tracing, monkeypatch, seed)
    assert got == want
    assert want[-2]["observed"] > 0 and want[-2]["streamed"] > 0


# --------------------------------------------------------- the waterfall

def test_scheduler_splits_debounce_and_schedule_wait():
    """The scheduler's notify->claim stamps split the measured wait at the
    debounce knob: debounce_wait is bounded by it, the excess lands in
    schedule_wait."""
    wf = slo_mod.DetectionWaterfall()
    wf.begin_push("j0", 100.0, 100.0)
    wf.notify(["j0"])
    time.sleep(0.08)
    wf.claim(["j0"], debounce_seconds=0.02)
    rec = wf._inflight["j0"]
    assert rec["stages"][slo_mod.STAGE_DEBOUNCE_WAIT] == pytest.approx(0.02, abs=0.005)
    assert rec["stages"][slo_mod.STAGE_SCHEDULE_WAIT] >= 0.05
    out = wf.observe("j0", now=200.0, newest_ts=99.0, score_s=0.01, fold_s=0.01)
    assert out["streamed"] is True
    assert out["stages"][slo_mod.STAGE_SCHEDULE_WAIT] < 1.0


def test_waterfall_book_is_bounded():
    wf = slo_mod.DetectionWaterfall(max_jobs=8)
    for i in range(100):
        wf.begin_push(f"j{i}", float(i), float(i))
    assert len(wf._inflight) == 8
    assert "j99" in wf._inflight and "j0" not in wf._inflight
    a = tracing.W3CContext("a" * 32, "1" * 16)
    b = tracing.W3CContext("b" * 32, "2" * 16)
    wf.begin_push("x1", 0.0, 0.0, ctx=a)
    wf.begin_push("x2", 0.0, 0.0, ctx=a)
    assert wf.single_context(["x1", "x2"]).trace_id == "a" * 32
    wf.begin_push("x3", 0.0, 0.0, ctx=b)
    assert wf.single_context(["x1", "x2", "x3"]) is None
    assert wf.single_context(["j98"]) is None


def test_polled_waterfall_sum_equals_detection_latency():
    """A polled job's whole wait is schedule_wait (cycle `now` minus its
    newest judged sample), and the stage sum reproduces the SLO
    observation."""
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store)
    _mk_job(store, fixtures, "m1", strategy="continuous")
    newest = fixtures["http://prom:9090/m1/cur"][0][-1]
    an.run_cycle(worker="w", now=newest + 7.5)
    rec = an.provenance.get("m1")
    stages = rec["detection_stages"]
    assert slo_mod.STAGE_INGEST_RECEIVE not in stages
    assert stages[slo_mod.STAGE_SCHEDULE_WAIT] == pytest.approx(7.5)
    assert sum(stages.values()) == pytest.approx(rec["detection_latency_s"], rel=0.05,
                                                 abs=0.05)
    snap = an.waterfall.snapshot()
    assert snap["observed"] == 1 and snap["streamed"] == 0
    assert "total" in snap["stages"]


def test_pushed_trace_carried_by_a_partial_cycle_to_its_verdict(full_sampling):
    """A job with an open push record (its W3C context, as an ingest
    receiver stamps it) scored by a partial cycle: the cycle adopts the
    push's trace, the verdict's provenance links to it, the verdict span
    closes it, and later re-confirming sweeps keep the linkage."""
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store)
    for i in range(3):
        _mk_job(store, fixtures, f"j{i}", strategy="continuous")
    newest = fixtures["http://prom:9090/j0/cur"][0][-1]
    ctx = tracing.W3CContext("5" * 32, "6" * 16)
    an.waterfall.begin_push("j0", newest + 0.1, newest + 0.2, ctx=ctx)
    an.waterfall.add_stage("j0", slo_mod.STAGE_INGEST_RECEIVE, 0.1)
    out = an.run_cycle(worker="w", now=newest + 0.5, job_ids={"j0"}, partial=True)
    assert set(out) == {"j0"}
    rec = an.provenance.get("j0")
    assert rec["path"] == "stream-scored"
    assert rec["cycle"]["cycle_id"].startswith("w-p")
    assert rec["trace_id"] == "5" * 32
    assert rec["detection_stages"][slo_mod.STAGE_INGEST_RECEIVE] == pytest.approx(0.1)
    assert an.last_cycle_stages["partial"] is True
    traces = tracing.tracer.snapshot(limit=50)
    assert any(t.get("trace_id") == "5" * 32 for t in traces)
    # the other jobs belong to the sweep; j0's sweep is a memo-hit
    # re-confirmation that keeps the push's linkage
    out2 = an.run_cycle(worker="w", now=newest + 1.0)
    assert {"j1", "j2"} <= set(out2)
    rec = an.provenance.get("j0")
    assert rec["path"] == "memo-hit"
    assert rec["trace_id"] == "5" * 32
    assert an.waterfall.snapshot()["streamed"] == 1
