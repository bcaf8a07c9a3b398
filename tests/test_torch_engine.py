"""The port's engine cycle against the reference's, on the CPU.

One fixture fleet (~48 jobs: canary pairs, bad canaries, continuous band
monitors, a level shift beyond the latency band, a borderline spike, a
constant history, canary band jobs, thin and empty histories, expired
canaries) runs through `foremast_tpu.engine.Analyzer` and the port's
`Analyzer(device="cpu")` for two cycles with the same `now`, the windows
advancing one step between them. The verdict digests must be equal, or a
divergence report must explain every differing job: the constant-history
job (the reference's float32 moving average gives it a sigma of float
noise, ROADMAP queue 3), or a job whose status and anomaly agree and whose
reason differs only in printed numbers within float noise.

Port-only arms pin the cycle's contracts: triage on and off (three
threshold arms), memo on and off, the pipeline and the barriered path,
megabatch on and off each give one digest; a screen failure escalates its
whole bucket; a job routed to a family not ported yet fails scoring with
the named NotImplementedError and is never judged healthy.
"""
import json
import re

import jax
import numpy as np
import pytest

from foremast_tpu import engine as jax_engine
from foremast_tpu.dataplane.fetch import RawFixtureDataSource as JaxRawSource
from foremast_tpu.dataplane import VerdictExporter as JaxExporter
from foremast_tpu.engine.jobs import verdict_digest as jax_digest
from foremast_tpu_torch import engine as E
from foremast_tpu_torch.dataplane import VerdictExporter
from foremast_tpu_torch.dataplane.fetch import RawFixtureDataSource
from foremast_tpu_torch.engine.analyzer import NOT_PORTED
from foremast_tpu_torch.engine.jobs import verdict_digest
from foremast_tpu_torch.engine.triage import TriageGate
from foremast_tpu_torch.utils.timeutils import to_rfc3339

jax.config.update("jax_platforms", "cpu")

STEP = 60
SEED = 20261017
NOW = 1_700_100_000.0
CYCLES = 2
CONSTANT_JOBS = {"constant-history"}


def _body(ts, vals) -> bytes:
    values = [[float(t), repr(float(v))] for t, v in zip(ts, vals)]
    return json.dumps({"status": "success", "data": {"resultType": "matrix", "result": [
        {"metric": {}, "values": values}]}}).encode()


class Fleet:
    """Series per URL (timestamps, values) plus the jobs that read them;
    `pages()` renders the bodies of the current cycle, `advance()` appends
    one fresh sample to every current window."""

    def __init__(self, seed=SEED):
        self.rng = np.random.default_rng(seed)
        self.series: dict = {}
        self.jobs: list = []
        self.shift: dict = {}
        t0 = NOW - 400 * STEP
        rng = self.rng

        def add(url, n, start, level, sigma, shift=0.0, poisson=False):
            ts = start + STEP * np.arange(n) + rng.uniform(0, 5, n)
            if poisson:
                vals = rng.poisson(level * STEP, n) / STEP + shift
            else:
                vals = level + sigma * rng.standard_normal(n) + shift
            keep = rng.random(n) > 0.05
            self.series[url] = [ts[keep].tolist(), vals[keep].tolist()]
            self.shift[url] = (level, sigma, shift, poisson)
            return url

        def job(jid, strategy, metric, expired=False, **urls):
            end = "" if strategy == "continuous" else to_rfc3339(NOW - 60 if expired else NOW + 3600)
            self.jobs.append((jid, strategy, metric, end, urls))

        for i in range(16):  # canary pairs, two bad
            rate = 5.0 if i < 2 else 0.5
            b = add(f"u/pair-{i}/b", 40, t0, 0.5, 0, poisson=True)
            c = add(f"u/pair-{i}/c", 40, t0 + 40 * STEP, rate, 0, poisson=True)
            job(f"pair-{i}", "canary", "http_errors_5xx", baseline=b, current=c)
        for i in range(20):  # continuous band monitors, two shifted past the band
            level = float(20 + 4 * i)
            sig = level / 20
            h = add(f"u/band-{i}/h", 200, t0, level, sig)
            c = add(f"u/band-{i}/c", 32, t0 + 200 * STEP, level, sig,
                    shift=16 * sig if i < 2 else 0.0)
            job(f"band-{i}", "continuous", "latency", historical=h, current=c)
        h = add("u/spike/h", 200, t0, 50.0, 2.5)
        c = add("u/spike/c", 32, t0 + 200 * STEP, 50.0, 2.5)
        self.series[c][1][10] += 75.0  # one spike: escalates, stays healthy
        job("spike", "continuous", "latency", historical=h, current=c)
        h = add("u/constant-history/h", 200, t0, 60.42, 0.0)
        c = add("u/constant-history/c", 32, t0 + 200 * STEP, 60.42, 0.0)
        job("constant-history", "continuous", "latency", historical=h, current=c)
        for i in range(3):  # canary-class band jobs: never screened
            h = add(f"u/cband-{i}/h", 150, t0, 30.0, 3.0)
            c = add(f"u/cband-{i}/c", 30, t0 + 150 * STEP, 30.0, 3.0, shift=60.0 if i == 0 else 0)
            job(f"cband-{i}", "canary", "cpu", historical=h, current=c)
        b = add("u/both/b", 30, t0, 40.0, 2.0)
        h = add("u/both/h", 150, t0, 40.0, 2.0)
        c = add("u/both/c", 30, t0 + 150 * STEP, 40.0, 2.0)
        job("both", "canary", "memory", baseline=b, historical=h, current=c)
        h = add("u/thin/h", 12, t0, 20.0, 1.0)
        c = add("u/thin/c", 20, t0 + 12 * STEP, 20.0, 1.0)
        job("thin", "continuous", "latency", historical=h, current=c)
        c = add("u/expired/c", 30, t0, 0.5, 0, poisson=True)
        b = add("u/expired/b", 30, t0, 0.5, 0, poisson=True)
        job("expired", "canary", "http_errors_5xx", expired=True, baseline=b, current=c)
        job("expired-empty", "canary", "http_errors_5xx", expired=True,
            current="u/missing/c")
        self.series["u/missing/c"] = [[], []]
        job("no-current", "continuous", "latency", historical=h, current="u/missing/c")

    def docs(self, pkg):
        return [pkg.Document(id=jid, app_name=f"app-{jid}", namespace="parity",
                             strategy=strategy, start_time=to_rfc3339(NOW - 3600), end_time=end,
                             metrics={metric: pkg.MetricQueries(**urls)})
                for jid, strategy, metric, end, urls in self.jobs]

    def pages(self) -> dict:
        return {url: _body(ts, vals) for url, (ts, vals) in self.series.items()}

    def advance(self, cycle: int):
        rng = np.random.default_rng(SEED + 1000 * cycle)
        for url, (ts, vals) in self.series.items():
            if not url.endswith("/c") or not ts:
                continue
            level, sigma, shift, poisson = self.shift[url]
            v = (rng.poisson(level * STEP) / STEP if poisson
                 else level + sigma * rng.standard_normal()) + shift
            ts.append(ts[-1] + STEP)
            vals.append(float(v))


def run_port(cycles=CYCLES, fleet=None, **cfg):
    fleet = fleet or Fleet()
    store = E.JobStore()
    for d in fleet.docs(E):
        store.create(d)
    src = RawFixtureDataSource()
    an = E.Analyzer(E.EngineConfig(**cfg), src, store, VerdictExporter(), device="cpu")
    digests = []
    for c in range(cycles):
        src.pages = fleet.pages()
        an.run_cycle(worker="w", now=NOW + STEP * c)
        digests.append(verdict_digest(store))
        fleet.advance(c)
    return an, store, digests


@pytest.fixture(scope="module")
def reference_run():
    fleet = Fleet()
    store = jax_engine.JobStore()
    for d in fleet.docs(jax_engine):
        store.create(d)
    src = JaxRawSource()
    an = jax_engine.Analyzer(jax_engine.EngineConfig(), src, store, JaxExporter())
    digests, launches = [], []
    for c in range(CYCLES):
        src.pages = fleet.pages()
        d0 = an.device_launches
        an.run_cycle(worker="w", now=NOW + STEP * c)
        digests.append(jax_digest(store))
        launches.append(an.device_launches - d0)
        fleet.advance(c)
    return an, store, digests, launches


_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")


def _explained(jid, mine, theirs) -> str | None:
    """Why a job's verdict may differ, or None: the constant-history fault,
    or equal status and anomaly with reasons that differ only in printed
    numbers within float noise."""
    if jid in CONSTANT_JOBS:
        return "constant history (reference sigma is float noise)"
    if mine.status != theirs.status or mine.anomaly != theirs.anomaly:
        return None
    a, b = _NUM.split(mine.reason), _NUM.split(theirs.reason)
    na, nb = _NUM.findall(mine.reason), _NUM.findall(theirs.reason)
    if a != b or len(na) != len(nb):
        return None
    for x, y in zip(na, nb):
        x, y = float(x), float(y)
        if abs(x - y) > 2e-3 * max(abs(x), abs(y)) + 1e-4:
            return None
    return "printed numbers within float noise"


def test_digest_equals_the_reference_or_every_difference_is_explained(reference_run):
    ref_an, ref_store, ref_digests, ref_launches = reference_run
    an, store, digests = run_port(cycles=CYCLES)
    report = {}
    if digests != ref_digests:
        for d in store.by_status(*E.jobs.OPEN_STATUSES, *E.jobs.TERMINAL_STATUSES):
            theirs = ref_store.get(d.id)
            if (d.status, d.reason, d.anomaly) != (theirs.status, theirs.reason, theirs.anomaly):
                why = _explained(d.id, d, theirs)
                assert why is not None, (d.id, d.status, d.reason, theirs.status, theirs.reason)
                report[d.id] = why
    assert len(report) <= 3, report
    # the verdicts the fleet was built for
    assert store.get("pair-0").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("pair-1").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("band-0").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("cband-0").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("spike").status == E.jobs.INITIAL
    assert store.get("constant-history").status == E.jobs.INITIAL
    assert store.get("expired").status in (E.jobs.COMPLETED_HEALTH, E.jobs.COMPLETED_UNHEALTH)
    assert store.get("expired-empty").status == E.jobs.COMPLETED_UNKNOWN
    # the same launches, chunk for chunk, and the screen cleared rows
    assert an.triage_launches_total == ref_an.triage_launches_total
    assert an.triage_cleared_total == ref_an.triage_cleared_total or "constant-history" in report
    assert sum(an.triage_cleared_total.values()) > 0


def test_launch_counts_per_cycle_equal_the_reference(reference_run):
    _, _, _, ref_launches = reference_run
    """The port cuts the reference's launches, chunk for chunk: the same
    analyzer device_launches in every cycle."""
    fleet = Fleet()
    store = E.JobStore()
    for d in fleet.docs(E):
        store.create(d)
    src = RawFixtureDataSource()
    an = E.Analyzer(E.EngineConfig(), src, store, device="cpu")
    launches = []
    for c in range(len(ref_launches)):
        src.pages = fleet.pages()
        d0 = an.device_launches
        an.run_cycle(worker="w", now=NOW + STEP * c)
        launches.append(an.device_launches - d0)
        fleet.advance(c)
    assert launches == ref_launches


@pytest.mark.parametrize("z,margin", [(0.0, 0.25), (8.0, 0.25), (8.0, 100.0)])
def test_triage_threshold_sweep_is_byte_identical_to_triage_off(z, margin):
    _, _, off = run_port(triage=False)
    an, _, on = run_port(triage=True, triage_z=z, triage_margin=margin)
    assert on == off
    screened = sum(an.triage_screened_total.values())
    cleared = sum(an.triage_cleared_total.values())
    assert screened > 0
    if (z, margin) == (8.0, 0.25):
        assert cleared > 0
    elif z == 0.0:
        assert cleared == 0  # TRIAGE_Z=0 screens nothing
    else:
        # margin >= threshold: only the constant history clears, once a
        # cycle — its sigma is 0, so its shrunk band IS its band
        assert cleared == CYCLES


class _StillAfterFirst(Fleet):
    """The windows advance after the first cycle only: the third cycle sees
    the second's rows again, every one a memo hit."""

    def advance(self, cycle: int):
        if cycle == 0:
            super().advance(cycle)


def test_memo_on_and_off_give_one_digest():
    an, _, on = run_port(cycles=3, fleet=_StillAfterFirst(), score_memo=True)
    _, _, off = run_port(cycles=3, fleet=_StillAfterFirst(), score_memo=False)
    assert on == off
    assert sum(an.score_memo_hits.values()) > 0
    assert an.last_cycle_stages["device_launches"] == 0  # a no-change cycle launches nothing


def test_pipeline_and_barriered_paths_give_one_digest():
    _, _, piped = run_port(score_pipeline=True, pipeline_fire_rows=16)
    _, _, barriered = run_port(score_pipeline=False)
    assert piped == barriered


def test_megabatch_on_and_off_give_one_digest():
    an, _, mega = run_port(megabatch=True)
    _, _, rungs = run_port(megabatch=False)
    assert mega == rungs
    assert an.megabatch_launches_total > 0
    assert an.last_cycle_stages["megabatch"]["real_rows"] > 0


def test_screen_failure_escalates_the_whole_bucket(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("screen wedged")

    monkeypatch.setattr(TriageGate, "_screen", boom)
    an, _, digests = run_port(triage=True)
    monkeypatch.undo()
    _, _, off = run_port(triage=False)
    assert digests == off
    assert sum(an.triage_cleared_total.values()) == 0
    assert sum(an.triage_escalated_total.values()) > 0


def test_cycle_records_and_exporter_surface_the_triage_counters():
    an, _, _ = run_port(triage=True)
    cyc = an.last_cycle_stages["triage"]
    assert cyc["screened"] == cyc["cleared"] + cyc["escalated"] > 0
    assert cyc["launches"] >= 1 and cyc["seconds"] >= 0.0
    assert set(an.last_cycle_stages["stage_seconds"]) == {"preprocess", "dispatch", "collect",
                                                          "fold"}
    text = an.exporter.render()
    assert 'foremastbrain:triage_screened_total{family="band"}' in text
    assert 'foremastbrain:triage_cleared_total{family="band"}' in text
    assert "foremastbrain:triage_escalation_ratio" in text
    assert "foremastbrain:triage_seconds" in text
    assert "foremastbrain:latency_upper" in text


def test_families_not_ported_fail_scoring_by_name_and_are_never_judged_healthy():
    rng = np.random.default_rng(5)
    series = {}
    for url, n in (("u/hpa/tps/h", 200), ("u/hpa/tps/c", 30), ("u/hpa/lat/h", 200),
                   ("u/hpa/lat/c", 30), ("u/bi/a/h", 200), ("u/bi/a/c", 30),
                   ("u/bi/b/h", 200), ("u/bi/b/c", 30)):
        ts = NOW - 300 * STEP + STEP * np.arange(n)
        series[url] = _body(ts, 20 + rng.standard_normal(n))
    store = E.JobStore()
    store.create(E.Document(id="hpa", app_name="a", strategy="hpa", start_time="", end_time="",
                            metrics={"tps": E.MetricQueries(current="u/hpa/tps/c",
                                                            historical="u/hpa/tps/h"),
                                     "latency": E.MetricQueries(current="u/hpa/lat/c",
                                                                historical="u/hpa/lat/h")}))
    for jid, strategy in (("bi-canary", "canary"), ("bi-continuous", "continuous")):
        store.create(E.Document(
            id=jid, app_name=jid, strategy=strategy, start_time="",
            end_time="" if strategy == "continuous" else to_rfc3339(NOW + 3600),
            metrics={"cpu": E.MetricQueries(current="u/bi/a/c", historical="u/bi/a/h"),
                     "memory": E.MetricQueries(current="u/bi/b/c", historical="u/bi/b/h")}))
    for pipeline in (True, False):
        an = E.Analyzer(E.EngineConfig(score_pipeline=pipeline), RawFixtureDataSource(series),
                        store, device="cpu")
        an.run_cycle(worker="w", now=NOW)
        for jid in ("hpa", "bi-canary", "bi-continuous"):
            doc = store.get(jid)
            assert doc.status not in (E.jobs.COMPLETED_HEALTH, E.jobs.COMPLETED_UNHEALTH), jid
            assert "NotImplementedError" in doc.reason and NOT_PORTED in doc.reason, jid
        assert store.get("bi-canary").status == E.jobs.ABORT
        assert store.get("hpa").status == E.jobs.INITIAL
        store.create(E.Document(id="bi-canary", app_name="bi-canary", strategy="canary",
                                start_time="", end_time=to_rfc3339(NOW + 3600),
                                metrics=store.get("bi-continuous").metrics))


def test_the_analyzer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.Analyzer(E.EngineConfig(), RawFixtureDataSource(), E.JobStore())
    an = E.Analyzer(E.EngineConfig(), RawFixtureDataSource(), E.JobStore(), device="cpu")
    assert an.device.type == "cpu" and not an.staging.cuda


_OVERRIDES = {"ML_ALGORITHM": "holt_winters", "TRIAGE_MARGIN": "0.5", "MEGABATCH": "on",
              "HW_PERIOD_CANDIDATES": "60,1440", "metric_type_threshold_count": "1",
              "metric_type0": "latency", "threshold0": "4", "bound0": "2"}


@pytest.mark.parametrize("env", [{}, _OVERRIDES], ids=["defaults", "overrides"])
def test_from_env_reads_the_reference_s_variables_and_defaults(env):
    """Every field the port keeps reads the reference's variable with the
    reference's default; knobs of layers not ported, left at the
    reference's defaults (however spelled), are accepted."""
    import dataclasses

    from foremast_tpu.engine import config as jax_config

    env = {**env, "PROVENANCE": "yes", "QUARANTINE_AFTER": "3", "ML_SLA_MODE": " Dynamic"}
    port, ref = E.from_env(env), jax_config.from_env(env)
    for f in dataclasses.fields(port):
        if f.name != "policies":
            assert getattr(port, f.name) == getattr(ref, f.name), f.name
    assert port.policies.keys() == ref.policies.keys()
    for k, pol in port.policies.items():
        ref_pol = ref.policies[k]
        assert (pol.threshold, pol.bound, pol.min_lower_bound) == (
            ref_pol.threshold, ref_pol.bound, ref_pol.min_lower_bound), k


@pytest.mark.parametrize("key,value,item", [
    ("PROVENANCE", "0", "queue 1, item 8"), ("QUARANTINE_AFTER", "1", "queue 1, item 8"),
    ("DELTA_FETCH", "false", "queue 1, item 8"), ("CYCLE_DEADLINE_S", "5", "queue 1, item 8"),
    ("LSTM_EPOCHS", "5", "queue 1, item 7"), ("ML_SLA_MODE", "static", "queue 1, item 6"),
    ("sla_limit0", "250", "queue 1, item 6"), ("ST_ORDER", "2", "queue 2, item 11")])
def test_from_env_refuses_the_knobs_of_layers_not_ported(key, value, item):
    env = {key: value, "metric_type_threshold_count": "1", "metric_type0": "latency"}
    with pytest.raises(NotImplementedError, match=f"{key}: .*ROADMAP {item}"):
        E.from_env(env)
