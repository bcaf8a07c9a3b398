"""The port's engine cycle against the reference's, on the CPU.

One fixture fleet (~60 jobs: canary pairs, bad canaries, continuous band
monitors, a level shift beyond the latency band, a borderline spike, a
constant history, canary band jobs, thin and empty histories, expired
canaries; two-metric jobs judged under the bivariate ellipse, healthy, with
a correlation break or a joint level shift; hpa jobs steady, surging,
collapsing and violating their SLA, with and without a podCountURL, and one
without history) runs through `foremast_tpu.engine.Analyzer` and the port's
`Analyzer(device="cpu")` for two cycles with the same `now`, the windows
advancing one step between them. The verdict digests must be equal, or a
divergence report must explain every differing job: the constant-history
job (the reference's float32 moving average gives it a sigma of float
noise, ROADMAP queue 3), or a job whose status and anomaly agree and whose
reason differs only in printed numbers within float noise. The hpalogs
agree job by job: reason codes and gated scores equal, raw scores as
printed (.1f) equal or one digit apart at a rounding edge, details to 1e-5
relative.

Port-only arms pin the cycle's contracts: triage on and off (three
threshold arms, and the bivariate family opted in), memo on and off, the
pipeline and the barriered path, megabatch on and off each give one
digest; a screen failure escalates its whole bucket. The reference's engine
tests of the hpa family run on the port.

The LSTM family (jobs with three or more metrics) has its own fleet: its
verdict digest equals the reference's, or every differing job is listed
with its z on both sides and lies within 0.05 of LSTM_THRESHOLD (float
noise of training: the port's initial recurrent kernels differ from the
reference's by float32 ulps and it sums in another order, and the plateau
reads a fleet mean); the reference's LSTM engine tests (an anomaly flagged,
a healthy job cached, the train budget spread over cycles, the fleet
scoring path, one training slot for the jobs of one app) run on the port;
a job of more metrics than the kernels take fails scoring by name; the
model cache round-trips through its file, and other files (the
reference's among them) load nothing.
"""
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from foremast_tpu import engine as jax_engine
from foremast_tpu.dataplane.fetch import RawFixtureDataSource as JaxRawSource
from foremast_tpu.dataplane import FixtureDataSource as JaxFixtureSource
from foremast_tpu.dataplane import VerdictExporter as JaxExporter
from foremast_tpu.engine.jobs import verdict_digest as jax_digest
from foremast_tpu_torch import engine as E
from foremast_tpu_torch.dataplane import VerdictExporter
from foremast_tpu_torch.dataplane.fetch import FixtureDataSource, RawFixtureDataSource
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
        self.pairs: dict = {}  # first URL of a correlated pair -> its spec
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
            end = ("" if strategy in ("continuous", "hpa")
                   else to_rfc3339(NOW - 60 if expired else NOW + 3600))
            metrics = metric if isinstance(metric, dict) else {metric: urls}
            self.jobs.append((jid, strategy, metrics, end, self.pods.pop(jid, "")))

        def add_pair(u1, u2, n, start, rho, shift=0.0, amp=1.0):
            """Latency (level 50, sigma 5) and cpu (level 30, sigma 2),
            correlated at rho, amplitude amp and a joint shift in sigmas:
            the spec `advance` extends."""
            z1 = rng.standard_normal(n)
            z2 = rho * z1 + np.sqrt(1 - rho * rho) * rng.standard_normal(n)
            ts = start + STEP * np.arange(n) + rng.uniform(0, 5, n)
            for url, z, (mu, sig) in ((u1, z1, (50.0, 5.0)), (u2, z2, (30.0, 2.0))):
                keep = rng.random(n) > 0.05
                vals = mu + sig * (amp * z + shift)
                self.series[url] = [ts[keep].tolist(), vals[keep].tolist()]
            self.pairs[u1] = (u2, rho, shift, amp)

        self.pods = {}

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
        for i in range(6):  # two-metric jobs: the bivariate-normal family
            rho = 0.8 + 0.03 * i
            jid = f"bi-{i}"
            h1, h2, c1, c2 = (f"u/{jid}/{m}/{r}" for r in ("h", "c") for m in ("lat", "cpu"))
            add_pair(h1, h2, 200, t0, rho)
            # a correlation break at 2.5 sigma stays inside each metric's own
            # band (latency 10 sigma, cpu 5): only the ellipse sees it
            add_pair(c1, c2, 32, t0 + 200 * STEP, -rho if i < 2 else rho,
                     shift=4.0 if i == 2 else 0.0, amp=2.5 if i < 2 else 1.0)
            job(jid, "canary" if i == 5 else "continuous",
                {"latency": dict(historical=h1, current=c1),
                 "cpu": dict(historical=h2, current=c2)})
        for i, (tps, lat) in enumerate(((100, 5), (240, 5), (30, 5), (100, 15), (240, 5))):
            jid = f"hpa-{i}"
            th = add(f"u/{jid}/tps/h", 150, t0, 100.0, 3.0)
            tc = add(f"u/{jid}/tps/c", 30, t0 + 150 * STEP, float(tps), 3.0)
            lh = add(f"u/{jid}/lat/h", 150, t0, 5.0, 0.3)
            lc = add(f"u/{jid}/lat/c", 30, t0 + 150 * STEP, float(lat), 0.3)
            if i == 4:  # replicas already scaled 4 -> 9.6 for the surge
                url = f"u/{jid}/pods"
                self.series[url] = [(t0 + STEP * np.arange(180)).tolist(),
                                    [4.0] * 150 + [9.6] * 30]
                self.pods[jid] = url
            job(jid, "hpa", {"tps": dict(historical=th, current=tc, priority=0),
                             "latency": dict(historical=lh, current=lc, priority=1)})
        c = add("u/hpa-nohist/c", 30, t0, 100.0, 3.0)
        job("hpa-nohist", "hpa", "tps", current=c)  # no scoreable window
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
                             metrics={m: pkg.MetricQueries(**q) for m, q in metrics.items()},
                             pod_count_url=pods)
                for jid, strategy, metrics, end, pods in self.jobs]

    def pages(self) -> dict:
        return {url: _body(ts, vals) for url, (ts, vals) in self.series.items()}

    def advance(self, cycle: int):
        rng = np.random.default_rng(SEED + 1000 * cycle)
        for u1, (u2, rho, shift, amp) in self.pairs.items():
            if not u1.endswith("/c"):
                continue
            z1 = rng.standard_normal()
            z2 = rho * z1 + np.sqrt(1 - rho * rho) * rng.standard_normal()
            for url, z, (mu, sig) in ((u1, z1, (50.0, 5.0)), (u2, z2, (30.0, 2.0))):
                ts, vals = self.series[url]
                ts.append(ts[-1] + STEP)
                vals.append(float(mu + sig * (amp * z + shift)))
        for url, (ts, vals) in self.series.items():
            if not url.endswith("/c") or not ts or url not in self.shift:
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


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("pipeline", [True, False], ids=["pipelined", "barriered"])
def test_three_metric_jobs_are_judged_under_the_lstm_family(pipeline):
    """A three-metric canary (healthy, expired) and a continuous job (a
    decorrelated level shift) route to the LSTM family: each trains its
    model, scores and is judged, on the pipelined and the barriered path,
    as the reference judges them."""
    statuses = []
    for mod, src_cls, kw in ((E, FixtureDataSource, {"device": "cpu"}),
                             (jax_engine, JaxFixtureSource, {})):
        fixtures = {}
        store = mod.JobStore()
        store.create(_multi_job(mod, fixtures, bad=False, jid="lstm-canary", app="a1",
                                end=NOW - 60))
        store.create(_multi_job(mod, fixtures, bad=True, jid="lstm-continuous", app="a2",
                                strategy="continuous"))
        an = mod.Analyzer(_lstm_cfg(mod, score_pipeline=pipeline), src_cls(fixtures), store,
                          **kw)
        out = an.run_cycle(worker="w", now=NOW)
        statuses.append(out)
        assert out == {"lstm-canary": E.jobs.COMPLETED_HEALTH,
                       "lstm-continuous": E.jobs.COMPLETED_UNHEALTH}, (mod.__name__, out)
        assert "LSTM-AE reconstruction" in store.get("lstm-continuous").reason
        assert len(an._lstm_cache) == 2
    assert statuses[0] == statuses[1]


def test_the_analyzer_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.Analyzer(E.EngineConfig(), RawFixtureDataSource(), E.JobStore())
    an = E.Analyzer(E.EngineConfig(), RawFixtureDataSource(), E.JobStore(), device="cpu")
    assert an.device.type == "cpu" and not an.staging.cuda


_OVERRIDES = {"ML_ALGORITHM": "holt_winters", "TRIAGE_MARGIN": "0.5", "MEGABATCH": "on",
              "HW_PERIOD_CANDIDATES": "60,1440", "metric_type_threshold_count": "1",
              "metric_type0": "latency", "threshold0": "4", "bound0": "2",
              "sla_limit0": "250", "ML_SLA_LIMIT": "3.5", "ML_SLA_LIMIT_RELATIVE": "1",
              "SLA_HEADROOM_SAFE": "0.6"}


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
        assert (pol.threshold, pol.bound, pol.min_lower_bound, pol.sla_limit) == (
            ref_pol.threshold, ref_pol.bound, ref_pol.min_lower_bound, ref_pol.sla_limit), k


@pytest.mark.parametrize("key,value,field", [
    ("PROVENANCE", "0", "provenance"), ("QUARANTINE_AFTER", "1", "quarantine_after"),
    ("CYCLE_DEADLINE_S", "5", "cycle_deadline_seconds"), ("SLO_HPA_S", "30", "slo_hpa_seconds")])
def test_from_env_reads_the_knobs_of_the_engine_layers_as_the_reference(key, value, field):
    """The engine's own layers are ported: their knobs, set off the
    reference's defaults, are read as the reference reads them."""
    from foremast_tpu.engine import config as jax_config

    env = {key: value, "metric_type_threshold_count": "1", "metric_type0": "latency"}
    port, ref = E.from_env(env), jax_config.from_env(env)
    assert getattr(port, field) == getattr(ref, field)
    assert getattr(port, field) != getattr(E.from_env({}), field)


@pytest.mark.parametrize("key,value,item", [
    ("DELTA_FETCH", "false", "queue 1, item 8"), ("RETRY_MAX_ATTEMPTS", "5", "queue 1, item 8"),
    ("BREAKER_FAILURE_THRESHOLD", "2", "queue 1, item 8"),
    ("COMPILE_CACHE_PATH", "/var/cache/fm", "queue 1, item 8")])
def test_from_env_refuses_the_knobs_of_layers_not_ported(key, value, item):
    env = {key: value, "metric_type_threshold_count": "1", "metric_type0": "latency"}
    with pytest.raises(NotImplementedError, match=f"{key}: .*ROADMAP {item}"):
        E.from_env(env)


@pytest.mark.parametrize("env", [{}, {"ST_ORDER": "2", "ST_CHANGEPOINTS": "0"},
                                 {"ST_ORDER": "five", "ST_CHANGEPOINTS": "20"}],
                         ids=["defaults", "set", "garbage"])
def test_from_env_reads_the_seasonal_trend_knobs_as_the_reference(env):
    from foremast_tpu.engine import config as jax_config

    env = {**env, "ML_ALGORITHM": "prophet_daily"}
    port, ref = E.from_env(env), jax_config.from_env(env)
    assert (port.algorithm, port.st_order, port.st_changepoints) == (
        ref.algorithm, ref.st_order, ref.st_changepoints)


def _reference_cycles(cfg, cycles=CYCLES):
    fleet = Fleet()
    store = jax_engine.JobStore()
    for d in fleet.docs(jax_engine):
        store.create(d)
    src = JaxRawSource()
    an = jax_engine.Analyzer(jax_engine.EngineConfig(**cfg), src, store, JaxExporter())
    digests = []
    for c in range(cycles):
        src.pages = fleet.pages()
        an.run_cycle(worker="w", now=NOW + STEP * c)
        digests.append(jax_digest(store))
        fleet.advance(c)
    return store, digests


def test_seasonal_trend_digest_equals_the_reference():
    """ML_ALGORITHM=seasonal_trend on both engines: the band family runs
    period detection, the seasonal-trend fit (kernel J's twin) and the band;
    the digests are equal, or every differing job is explained as in the
    default fleet's test."""
    cfg = dict(algorithm="seasonal_trend")
    ref_store, ref_digests = _reference_cycles(cfg)
    _, store, digests = run_port(**cfg)
    report = {}
    if digests != ref_digests:
        for d in store.by_status(*E.jobs.OPEN_STATUSES, *E.jobs.TERMINAL_STATUSES):
            theirs = ref_store.get(d.id)
            if (d.status, d.reason, d.anomaly) != (theirs.status, theirs.reason, theirs.anomaly):
                why = _explained(d.id, d, theirs)
                assert why is not None, (d.id, d.status, d.reason, theirs.status, theirs.reason)
                report[d.id] = why
    assert len(report) <= 3, report
    assert store.get("band-0").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("band-1").status == E.jobs.COMPLETED_UNHEALTH


# ------------------------------------------------- bivariate and hpa families
_RAW = re.compile(r"raw (-?[0-9.]+|nan)\) via (.+?) on")


def _hpa_logs(store, jid):
    """(gated score, raw score, reason name, details) of each of a job's
    hpalogs, oldest first."""
    out = []
    for log in reversed(store.hpalogs_for(jid)):
        raw, why = _RAW.search(log.reason).groups()
        out.append((log.hpascore, float(raw), why, log.details, log.reason))
    return out


def test_hpalogs_agree_with_the_reference_job_by_job(reference_run):
    """Every hpa job writes one hpalog a cycle on both engines: gated
    scores and reason codes equal, raw scores as printed (.1f) equal or one
    digit apart at a rounding edge, details within 1e-5 relative, the
    per-pod suffix on the same jobs."""
    _, ref_store, _, _ = reference_run
    _, store, _ = run_port(cycles=CYCLES)
    hpa_jobs = [f"hpa-{i}" for i in range(5)]
    for jid in hpa_jobs:
        mine, theirs = _hpa_logs(store, jid), _hpa_logs(ref_store, jid)
        assert len(mine) == len(theirs) == CYCLES, jid
        for (g, raw, why, det, text), (g2, raw2, why2, det2, text2) in zip(mine, theirs):
            assert g == g2 and why == why2, (jid, text, text2)
            assert abs(raw - raw2) <= 0.1 + 1e-9, (jid, raw, raw2)
            assert ("per-pod" in text) == ("per-pod" in text2) == (jid == "hpa-4")
            for a, b in zip(det, det2):
                assert a["metricType"] == b["metricType"]
                for k in ("current", "upper", "lower"):
                    assert abs(a[k] - b[k]) <= 1e-5 * max(abs(b[k]), 1.0), (jid, k, a, b)
    assert not store.hpalogs_for("hpa-nohist")  # requeued without a log
    assert store.get("hpa-nohist").status == E.jobs.INITIAL
    assert store.get_state("breath") == ref_store.get_state("breath")
    raws = {jid: _hpa_logs(store, jid)[-1][1] for jid in hpa_jobs}
    assert 40 <= raws["hpa-0"] <= 60 and raws["hpa-1"] > 65 and raws["hpa-2"] < 50
    assert raws["hpa-3"] >= 75 and 35 <= raws["hpa-4"] <= 65
    assert _hpa_logs(store, "hpa-3")[-1][2] == "SLA violation"


def test_two_metric_jobs_are_judged_under_the_ellipse():
    """Under the default EngineConfig a two-metric job is judged by the
    bivariate family: the correlation breaks and the joint shift are
    unhealthy with the ellipse's reason, the healthy ones requeue, and the
    exporter carries both metrics' bounds."""
    an, store, _ = run_port(cycles=1)
    for jid in ("bi-0", "bi-1", "bi-2"):
        doc = store.get(jid)
        assert doc.status == E.jobs.COMPLETED_UNHEALTH, (jid, doc.reason)
        assert "joint bivariate-normal ellipse" in doc.reason
        assert doc.anomaly["latency&cpu"]
    for jid in ("bi-3", "bi-4", "bi-5"):
        assert store.get(jid).status == E.jobs.INITIAL, store.get(jid).reason
    text = an.exporter.render()
    assert 'foremastbrain:cpu_upper{app="app-bi-3"' in text
    assert "foremastbrain:namespace_app_per_pod:hpa_score" in text


def test_triage_with_the_bivariate_family_opted_in_keeps_the_digest():
    """TRIAGE_FAMILIES=band,bivariate gives the reference's digest under the
    same opt-in, cycle for cycle. Against triage off it differs exactly on
    the jobs whose anomaly stays inside both marginal bands (the two
    correlation breaks and the 4-sigma joint shift): the reference
    documents the opt-in as not verdict-safe for that reason
    (engine/triage.py), and both engines clear them alike. Every other job
    keeps its triage-off verdict."""
    cfg = dict(triage=True, triage_families=("band", "bivariate"))
    fleet = Fleet()
    ref_store = jax_engine.JobStore()
    for d in fleet.docs(jax_engine):
        ref_store.create(d)
    src = JaxRawSource()
    ref = jax_engine.Analyzer(jax_engine.EngineConfig(**cfg), src, ref_store, JaxExporter())
    ref_digests = []
    for c in range(CYCLES):
        src.pages = fleet.pages()
        ref.run_cycle(worker="w", now=NOW + STEP * c)
        ref_digests.append(jax_digest(ref_store))
        fleet.advance(c)
    _, off_store, _ = run_port(triage=False)
    an, store, on = run_port(**cfg)
    assert on == ref_digests
    assert an.triage_cleared_total == ref.triage_cleared_total
    assert an.triage_cleared_total.get("bivariate", 0) > 0
    differ = {d.id for d in store.by_status(*E.jobs.OPEN_STATUSES, *E.jobs.TERMINAL_STATUSES)
              if (d.status, d.reason) != (off_store.get(d.id).status, off_store.get(d.id).reason)}
    assert differ == {"bi-0", "bi-1", "bi-2"}


def test_static_sla_mode_and_limit_reach_the_hpa_launch(monkeypatch):
    """ML_SLA_MODE=static with ML_SLA_LIMIT puts the limit and the static
    mode into kernel I's inputs for every hpa row."""
    from foremast_tpu_torch.ops import hpa as hpa_ops

    seen = []
    real = hpa_ops.hpa_from_preds

    def spy(*args, **kwargs):
        seen.append((args[6].clone(), args[7].clone()))
        return real(*args, **kwargs)

    monkeypatch.setattr(hpa_ops, "hpa_from_preds", spy)
    cfg = E.from_env({"ML_SLA_MODE": "static", "ML_SLA_LIMIT": "7.5"})
    assert (cfg.sla_mode, cfg.sla_limit) == ("static", 7.5)
    _, store, _ = run_port(cycles=1, **{f: getattr(cfg, f) for f in ("sla_mode", "sla_limit")})
    limits = torch.cat([lim for lim, _ in seen])
    modes = torch.cat([mode for _, mode in seen])
    assert bool((limits == 7.5).all()) and bool((modes == hpa_ops.SLA_STATIC).all())
    # hpa-3's latency ~15 is over a static 7.5, hpa-0's ~5 is not
    assert _hpa_logs(store, "hpa-3")[-1][2] == "SLA violation"
    assert _hpa_logs(store, "hpa-0")[-1][2] != "SLA violation"


# The reference's engine tests of the hpa family (tests/test_engine.py and
# tests/test_pipeline.py), on the port's Analyzer on the CPU.
def _series(rng, level, n, spread=None):
    spread = level * 0.1 + 0.01 if spread is None else spread
    ts = np.arange(n) * STEP
    return ts.tolist(), np.clip(rng.normal(level, spread, n), 0, None).tolist()


def _mk_hpa_job(store, fixtures, job_id, *, tps_current=240.0, sla_current=5.0, pods=None,
                sla_absolute=True):
    """The reference's hpa job: history ~100 tps / ~5 latency over 90
    steps, a 30-step current window, an optional pod-count series."""
    rng = np.random.default_rng(5)
    hist_ts, hist_v = _series(rng, 100.0, 90, spread=3.0)
    cur_ts = [hist_ts[-1] + STEP + t for t in np.arange(30) * STEP]
    cur_url, hist_url = f"http://prom/{job_id}/tps_cur", f"http://prom/{job_id}/tps_hist"
    fixtures[hist_url] = (hist_ts, hist_v)
    fixtures[cur_url] = (cur_ts, rng.normal(tps_current, 5, 30).tolist())
    s_ts, s_v = _series(rng, 5.0, 90, spread=0.3)
    sla_cur_url, sla_hist_url = f"http://prom/{job_id}/sla_cur", f"http://prom/{job_id}/sla_hist"
    fixtures[sla_hist_url] = (s_ts, s_v)
    fixtures[sla_cur_url] = (cur_ts, rng.normal(sla_current, 0.3, 30).tolist())
    pod_url = ""
    if pods is not None:
        pod_url = f"http://prom/{job_id}/pods"
        fixtures[pod_url] = (hist_ts + cur_ts, [pods[0]] * 90 + [pods[1]] * 30)
    store.create(E.Document(
        id=job_id, app_name=job_id, namespace="demo", strategy="hpa",
        start_time="START_TIME", end_time="END_TIME", pod_count_url=pod_url,
        metrics={"tps": E.MetricQueries(historical=hist_url, current=cur_url, priority=0),
                 "latency": E.MetricQueries(historical=sla_hist_url, current=sla_cur_url,
                                            priority=1, is_absolute=sla_absolute)}))
    return float(cur_ts[-1] + STEP)


def _port(cfg, fixtures, store, exporter=None):
    return E.Analyzer(cfg, FixtureDataSource(fixtures), store, exporter, device="cpu")


def test_hpa_job_emits_logs_and_requeues():
    rng = np.random.default_rng(5)
    fixtures, store, exporter = {}, E.JobStore(), VerdictExporter()
    tps_url, sla_url = "http://prom/tps", "http://prom/sla"
    hist_ts, hist_v = _series(rng, 100.0, 90, spread=3.0)
    cur_ts = [t + hist_ts[-1] + STEP for t in np.arange(30) * STEP]
    fixtures[tps_url] = (hist_ts + list(cur_ts),
                         hist_v + np.random.default_rng(1).normal(240, 5, 30).tolist())
    fixtures[sla_url] = _series(rng, 5.0, 120, spread=0.3)
    store.create(E.Document(
        id="app:demo:hpa", app_name="app", namespace="demo", strategy="hpa",
        start_time="START_TIME", end_time="END_TIME",
        metrics={"tps": E.MetricQueries(historical=tps_url, current=tps_url, priority=0),
                 "latency": E.MetricQueries(historical=sla_url, current=sla_url, priority=1)}))
    out = _port(E.EngineConfig(), fixtures, store, exporter).run_cycle(now=0.0)
    assert out["app:demo:hpa"] == E.jobs.INITIAL  # hpa jobs never terminate
    logs = store.hpalogs_for("app:demo:hpa")
    assert logs and logs[0].details[0]["metricType"] == "tps"
    assert "foremastbrain:namespace_app_per_pod:hpa_score" in exporter.render()
    assert logs[0].hpascore == 50.0  # the first cycle is breath-gated to 50


def _raw_score(store, job_id):
    return _hpa_logs(store, job_id)[0][1]


def test_hpa_per_pod_score_absorbs_taken_scaleups():
    fixtures, store = {}, E.JobStore()
    now = _mk_hpa_job(store, fixtures, "nopods:demo:hpa")
    _mk_hpa_job(store, fixtures, "pods:demo:hpa", pods=(4.0, 9.6))
    _port(E.EngineConfig(), fixtures, store).run_cycle(now=now)
    assert _raw_score(store, "nopods:demo:hpa") > 65
    assert 35 <= _raw_score(store, "pods:demo:hpa") <= 65
    podded = store.hpalogs_for("pods:demo:hpa")[0]
    assert "[per-pod: 9.6 pods" in podded.reason
    assert {d["metricType"] for d in podded.details} == {"tps", "latency"}
    assert "per-pod" not in store.hpalogs_for("nopods:demo:hpa")[0].reason


def test_hpa_sla_mode_static_env_plumbed():
    fixtures, store = {}, E.JobStore()
    now = _mk_hpa_job(store, fixtures, "app:demo:hpa", tps_current=100.0)
    cfg = E.from_env({"ML_SLA_MODE": "static", "ML_SLA_LIMIT": "3.0"})
    assert cfg.sla_mode == "static" and cfg.sla_limit == 3.0
    _port(cfg, fixtures, store).run_cycle(now=now)
    assert "SLA violation" in store.hpalogs_for("app:demo:hpa")[0].reason
    fixtures2, store2 = {}, E.JobStore()
    now2 = _mk_hpa_job(store2, fixtures2, "app:demo:hpa", tps_current=100.0)
    _port(E.EngineConfig(), fixtures2, store2).run_cycle(now=now2)
    assert "SLA violation" not in store2.hpalogs_for("app:demo:hpa")[0].reason


def test_hpa_static_mode_without_limit_degrades_to_dynamic():
    fixtures, store = {}, E.JobStore()
    now = _mk_hpa_job(store, fixtures, "app:demo:hpa", tps_current=100.0)
    _port(E.EngineConfig(sla_mode="static"), fixtures, store).run_cycle(now=now)
    logs = store.hpalogs_for("app:demo:hpa")
    assert logs and "SLA violation" not in logs[0].reason
    sla_detail = [d for d in logs[0].details if d["metricType"] == "latency"]
    assert sla_detail and sla_detail[0]["upper"] < 100


def test_per_metric_sla_limit_env_override():
    cfg = E.from_env({"metric_type_threshold_count": "1", "metric_type0": "latency",
                      "sla_limit0": "250", "ML_SLA_MODE": "min"})
    assert cfg.policy_for("namespace_app_pod_latency").sla_limit == 250.0
    assert cfg.policy_for("error5xx").sla_limit == 0.0


def test_relative_sla_limit_requires_explicit_opt_in():
    fixtures, store = {}, E.JobStore()
    now = _mk_hpa_job(store, fixtures, "app:demo:hpa", tps_current=100.0)
    cfg = E.from_env({"ML_SLA_MODE": "static", "ML_SLA_LIMIT": "250"})
    _port(cfg, fixtures, store).run_cycle(now=now)
    sla_detail = [d for d in store.hpalogs_for("app:demo:hpa")[0].details
                  if d["metricType"] == "latency"]
    assert abs(sla_detail[0]["upper"] - 250.0) < 1e-3  # absolute, not 250 * mean
    fixtures2, store2 = {}, E.JobStore()
    now2 = _mk_hpa_job(store2, fixtures2, "app:demo:hpa", tps_current=100.0,
                       sla_absolute=False)
    cfg = E.from_env({"ML_SLA_MODE": "static", "ML_SLA_LIMIT": "3.0",
                      "ML_SLA_LIMIT_RELATIVE": "1"})
    _port(cfg, fixtures2, store2).run_cycle(now=now2)
    logs = store2.hpalogs_for("app:demo:hpa")
    assert "SLA violation" not in logs[0].reason  # 3x mean ~15 > current ~5
    sla_detail = [d for d in logs[0].details if d["metricType"] == "latency"]
    assert 10 < sla_detail[0]["upper"] < 20


def test_garbage_pod_count_body_never_fails_the_job():
    fixtures, store = {}, E.JobStore()
    now = _mk_hpa_job(store, fixtures, "app:demo:hpa", pods=(4.0, 9.6))
    fixtures["http://prom/app:demo:hpa/pods"] = (["<html>"], ["oops"])
    out = _port(E.EngineConfig(), fixtures, store).run_cycle(now=now)
    assert out["app:demo:hpa"] == E.jobs.INITIAL
    logs = store.hpalogs_for("app:demo:hpa")
    assert logs and "per-pod" not in logs[0].reason


def test_hpa_fleet_with_heterogeneous_history_lengths():
    fixtures, store = {}, E.JobStore()
    now = _mk_hpa_job(store, fixtures, "short:demo:hpa")
    rng = np.random.default_rng(9)
    hist_ts, hist_v = _series(rng, 100.0, 700, spread=3.0)
    cur_ts = [hist_ts[-1] + STEP + t for t in np.arange(30) * STEP]
    fixtures["u/long/th"], fixtures["u/long/tc"] = (hist_ts, hist_v), (
        cur_ts, rng.normal(240, 5, 30).tolist())
    fixtures["u/long/sh"] = _series(rng, 5.0, 700, spread=0.3)
    fixtures["u/long/sc"] = (cur_ts, rng.normal(5, 0.3, 30).tolist())
    store.create(E.Document(
        id="long:demo:hpa", app_name="long", namespace="demo", strategy="hpa",
        start_time="START_TIME", end_time="END_TIME",
        metrics={"tps": E.MetricQueries(historical="u/long/th", current="u/long/tc"),
                 "latency": E.MetricQueries(historical="u/long/sh", current="u/long/sc",
                                            priority=1)}))
    an = _port(E.EngineConfig(), fixtures, store)
    assert an.run_cycle(now=now) == {"short:demo:hpa": E.jobs.INITIAL,
                                     "long:demo:hpa": E.jobs.INITIAL}
    for job in ("short:demo:hpa", "long:demo:hpa"):
        logs = store.hpalogs_for(job)
        assert logs and 0.0 <= logs[0].hpascore <= 100.0
    assert an.last_cycle_stages["family_launches"]["hpa"] == 2  # one bucket each


def _win(rng, level, n, start, step=30):
    from foremast_tpu_torch.ops.windowing import Window

    return Window(rng.normal(level, level * 0.03, n).astype(np.float32), np.ones(n, bool),
                  start, step)


def test_hpa_bucket_scores_a_30s_step_job():
    """A 30 s-step hpa job scores through _score_hpa (the reference pins its
    step through pack_windows; the port packs the windows' values
    directly, and the job's score comes out)."""
    from foremast_tpu_torch.engine import analyzer as A

    rng = np.random.default_rng(0)
    an = _port(E.EngineConfig(), {}, E.JobStore())
    items = [A._HpaItem("j30", "tps", _win(rng, 100.0, 90, 0), _win(rng, 100.0, 30, 2700),
                        True, 0),
             A._HpaItem("j30", "latency", _win(rng, 5.0, 90, 0), _win(rng, 5.0, 30, 2700),
                        True, 1)]
    out = an._score_hpa(items)
    assert "j30" in out and 0.0 <= out["j30"]["raw_score"] <= 100.0


class _WindowSource:
    """Serves prebuilt grid Windows through the fetch_window fast path."""

    def __init__(self, windows):
        self.windows = windows

    def fetch_window(self, url):
        return self.windows[url]


def test_hpa_e2e_30s_step_job_scores():
    rng = np.random.default_rng(4)
    windows = {"u/t/c": _win(rng, 100.0, 30, 9000), "u/t/h": _win(rng, 100.0, 300, 0),
               "u/l/c": _win(rng, 5.0, 30, 9000), "u/l/h": _win(rng, 5.0, 300, 0)}
    store = E.JobStore()
    store.create(E.Document(
        id="h30", app_name="a", namespace="n", strategy="hpa",
        start_time=to_rfc3339(0.0), end_time=to_rfc3339(5_000_000.0),
        metrics={"tps": E.MetricQueries(current="u/t/c", historical="u/t/h"),
                 "latency": E.MetricQueries(current="u/l/c", historical="u/l/h", priority=1)}))
    out = E.Analyzer(E.EngineConfig(), _WindowSource(windows), store,
                     device="cpu").run_cycle(now=10_000.0)
    assert out["h30"] == E.jobs.INITIAL
    assert store.hpalogs_for("h30")


def test_exporter_renders_bounds_and_hpa_scores_as_the_reference():
    """record_bounds (per metric of a two-metric job) and record_hpa_score
    render the same exposition lines in the port and the reference."""
    def lines(exp):
        exp.record_bounds("app-bi", "ns", "latency", 61.25, 38.5, 1.0)
        exp.record_bounds("app-bi", "ns", "namespace_app_pod_cpu-usage", 33.0, 27.0, 0.0)
        exp.record_hpa_score("app-hpa", "ns", 72.5)
        return sorted(line for line in exp.render().splitlines()
                      if "_upper" in line or "_lower" in line or "_anomaly" in line
                      or "hpa_score" in line)

    assert lines(VerdictExporter()) == lines(JaxExporter())


# ------------------------------------------------------------- LSTM family
LSTM_METRICS = ("latency", "cpu", "tps")


@pytest.fixture
def one_torch_thread():
    """The LSTM twins' training is thousands of small operations: one torch
    thread runs it faster than a pool, and keeps it fast when test workers
    share the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lstm_cfg(mod, **kw):
    """The reference's small LSTM config (tests/test_engine.py: window 16,
    hidden 8, latent 4)."""
    return mod.EngineConfig(**{"algorithm": "lstm_autoencoder", "lstm_window": 16,
                               "lstm_epochs": 60, "lstm_hidden": 8, "lstm_latent": 4,
                               "policies": {}, **kw})


def _multi_job(mod, fixtures, *, bad, jid="multi", app="app", seed=11, n_h=256, n_c=16,
               strategy="canary", end=0.0, shift=6.0):
    """A three-metric job (the reference's _multi_job): phase-shifted waves
    with a little noise; `bad` adds a decorrelated level shift to tps in the
    current window."""
    t_h = np.arange(n_h)
    t_c = n_h + np.arange(n_c)
    rng = np.random.default_rng(seed)
    metrics = {}
    for i, name in enumerate(LSTM_METRICS):
        wave_h = np.sin(2 * np.pi * t_h / 32 + i) + rng.normal(0, 0.05, n_h)
        wave_c = np.sin(2 * np.pi * t_c / 32 + i) + rng.normal(0, 0.05, n_c)
        if bad and name == "tps":
            wave_c = wave_c + shift
        fixtures[f"{jid}/h{i}"] = ((t_h * STEP).tolist(), wave_h.tolist())
        fixtures[f"{jid}/c{i}"] = ((t_c * STEP).tolist(), wave_c.tolist())
        metrics[name] = mod.MetricQueries(current=f"{jid}/c{i}", historical=f"{jid}/h{i}")
    return mod.Document(id=jid, app_name=app, namespace="d", strategy=strategy,
                        start_time=to_rfc3339(0),
                        end_time="" if strategy == "continuous" else to_rfc3339(end),
                        metrics=metrics)


def _noise_jobs(mod, n, *, app=None, n_h=128, n_c=16, seed0=20):
    """The reference's budget / fleet-path jobs: n canaries of three noisy
    metrics, one app each unless `app` names one for all."""
    fixtures, docs = {}, []
    for j in range(n):
        rng = np.random.default_rng(seed0 + j)
        for i, name in enumerate(LSTM_METRICS):
            fixtures[f"h{j}{i}"] = ((np.arange(n_h) * STEP).tolist(),
                                    rng.normal(10, 1, n_h).tolist())
            fixtures[f"c{j}{i}"] = (((n_h + np.arange(n_c)) * STEP).tolist(),
                                    rng.normal(10, 1, n_c).tolist())
        docs.append(mod.Document(
            id=f"m{j}", app_name=app or f"app{j}", namespace="d", strategy="canary",
            start_time=to_rfc3339(0), end_time=to_rfc3339(1e9),
            metrics={name: mod.MetricQueries(current=f"c{j}{i}", historical=f"h{j}{i}")
                     for i, name in enumerate(LSTM_METRICS)}))
    return fixtures, docs


@pytest.mark.usefixtures("one_torch_thread")
def test_engine_lstm_mode_flags_multivariate_anomaly():
    fixtures = {}
    store = E.JobStore()
    store.create(_multi_job(E, fixtures, bad=True))
    an = E.Analyzer(_lstm_cfg(E), FixtureDataSource(fixtures), store, device="cpu")
    out = an.run_cycle(now=1_000_000.0)
    assert out["multi"] == E.jobs.COMPLETED_UNHEALTH
    assert "LSTM-AE" in store.get("multi").reason


@pytest.mark.usefixtures("one_torch_thread")
def test_engine_lstm_mode_passes_healthy_and_caches_model():
    fixtures = {}
    store = E.JobStore()
    store.create(_multi_job(E, fixtures, bad=False))
    an = E.Analyzer(_lstm_cfg(E), FixtureDataSource(fixtures), store, device="cpu")
    out = an.run_cycle(now=1_000_000.0)
    assert out["multi"] == E.jobs.COMPLETED_HEALTH
    assert len(an._lstm_cache) == 1
    (row, mu, sd, _version), = an._lstm_cache.values()
    assert row.shape == (E.analyzer.lstm_ae.param_count(3, 8, 4),) and sd > 0
    # a second job for the same app reuses the cached model (no retrain)
    store.create(_multi_job(E, fixtures, bad=False))
    trained = an.device_launches
    an.run_cycle(now=1_000_001.0)
    assert len(an._lstm_cache) == 1 and an._lstm_trained_this_cycle == 0
    assert an.device_launches == trained  # the z memo: unchanged windows, no launch
    assert an.last_cycle_stages["lstm_rescore_skips"] == 1


@pytest.mark.usefixtures("one_torch_thread")
def test_lstm_train_budget_amortizes_across_cycles():
    """A cold multi-metric fleet warms up under LSTM_MAX_TRAIN_PER_CYCLE:
    capped-out jobs stay in progress (requeued) and train later; the
    engine.score.lstm span carries the cycle's budget skips."""
    from foremast_tpu_torch.utils import tracing

    fixtures, docs = _noise_jobs(E, 3)
    store = E.JobStore()
    for d in docs:
        store.create(d)
    cfg = _lstm_cfg(E, lstm_epochs=3, lstm_max_train_per_cycle=1, lstm_threshold=1e9)
    an = E.Analyzer(cfg, FixtureDataSource(fixtures), store, device="cpu")
    for cycle, expected_models in ((1, 1), (2, 2), (3, 3)):
        out = an.run_cycle(now=100.0)
        assert len(an._lstm_cache) == expected_models, (cycle, out)
        assert all(s == E.jobs.INITIAL for s in out.values()), out
        spans = [sp for t in tracing.tracer.snapshot(limit=1) for sp in _walk(t)
                 if sp["name"] == "engine.score.lstm"]
        assert spans and spans[-1]["attrs"]["budget_skips"] == 3 - expected_models
    assert an.lstm_budget_skips == 2 + 1


def _walk(span):
    yield span
    for c in span.get("children", []):
        yield from _walk(c)


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("n,calls", [(5, 1), (3, 3)])
def test_lstm_fleet_scoring_path_engages(monkeypatch, n, calls):
    """From four same-shape jobs on, the family scores them in one
    anomaly_scores_fleet call (one kernel K launch on the card); below that,
    job by job, as the reference counts its launches."""
    lstm_ae = E.analyzer.lstm_ae
    seen = []
    real = lstm_ae.anomaly_scores_fleet

    def spy(stack, *a, **k):
        seen.append(stack.shape[0])
        return real(stack, *a, **k)

    monkeypatch.setattr(lstm_ae, "anomaly_scores_fleet", spy)
    fixtures, docs = _noise_jobs(E, n, seed0=40)
    store = E.JobStore()
    for d in docs:
        store.create(d)
    an = E.Analyzer(_lstm_cfg(E, lstm_epochs=3, lstm_threshold=1e9), FixtureDataSource(fixtures),
                    store, device="cpu")
    d0 = an.device_launches
    out = an.run_cycle(now=100.0)
    assert all(s == E.jobs.INITIAL for s in out.values()), out
    assert len(seen) == calls and sum(seen) == n
    # one training launch for the group of n, one per scoring call
    assert an.device_launches - d0 == 1 + calls
    assert an.last_cycle_stages["device_launches"] == 1 + calls


@pytest.mark.usefixtures("one_torch_thread")
def test_lstm_same_app_jobs_share_one_training_slot():
    """N jobs of one app share a cache key: a cold cycle trains ONE model
    for them (one budget slot) and all N score from it."""
    fixtures, docs = _noise_jobs(E, 1, seed0=50)
    docs = [E.Document(id=f"dup{j}", app_name="one-app", namespace="d", strategy="canary",
                       start_time=to_rfc3339(0), end_time=to_rfc3339(1e9),
                       metrics=dict(docs[0].metrics)) for j in range(3)]
    store = E.JobStore()
    for d in docs:
        store.create(d)
    cfg = _lstm_cfg(E, lstm_epochs=3, lstm_threshold=1e9, lstm_max_train_per_cycle=1)
    an = E.Analyzer(cfg, FixtureDataSource(fixtures), store, device="cpu")
    out = an.run_cycle(now=100.0)
    assert len(an._lstm_cache) == 1
    assert an._lstm_trained_this_cycle == 1
    assert all(s == E.jobs.INITIAL for s in out.values()), out


class _LstmFleet:
    """Twelve three-metric jobs over five apps, for both engines: healthy
    waves, decorrelated level shifts of 6, 1.5 and 0.6 (the last near the
    threshold's reach), canaries and continuous jobs, histories of 256 and
    200 steps (two training shapes)."""

    SPECS = [  # (jid, app, bad, shift, seed, n_h, strategy)
        ("l0", "a0", False, 0.0, 1, 256, "canary"), ("l1", "a0", True, 6.0, 2, 256, "canary"),
        ("l2", "a1", False, 0.0, 3, 256, "continuous"), ("l3", "a1", True, 1.5, 4, 256,
                                                         "continuous"),
        ("l4", "a2", False, 0.0, 5, 200, "continuous"), ("l5", "a2", True, 0.6, 6, 200,
                                                         "continuous"),
        ("l6", "a3", True, 6.0, 7, 256, "continuous"), ("l7", "a3", False, 0.0, 8, 256,
                                                        "canary"),
        ("l8", "a4", False, 0.0, 9, 200, "canary"), ("l9", "a4", True, 1.5, 10, 200, "canary"),
        ("l10", "a0", False, 0.0, 11, 256, "continuous"), ("l11", "a2", True, 0.6, 12, 200,
                                                           "canary")]

    def run(self, mod, src_cls, **kw):
        fixtures = {}
        store = mod.JobStore()
        for jid, app, bad, shift, seed, n_h, strategy in self.SPECS:
            store.create(_multi_job(mod, fixtures, bad=bad, jid=jid, app=app, seed=seed,
                                    n_h=n_h, strategy=strategy, end=NOW + 3600, shift=shift))
        an = mod.Analyzer(_lstm_cfg(mod, lstm_epochs=30, lstm_max_train_per_cycle=3),
                          src_cls(fixtures), store, **kw)
        zs = {}
        score = an._score_multi

        def record(items):
            res = score(items)
            zs.update({k[0]: float(r["z"]) for k, r in res.items()})
            return res

        an._score_multi = record
        digests = []
        for c in range(3):
            an.run_cycle(worker="w", now=NOW + c)
            digests.append((jax_digest if mod is jax_engine else verdict_digest)(store))
        return store, digests, zs


@pytest.mark.usefixtures("one_torch_thread")
def test_lstm_fleet_digest_equals_the_reference_or_differences_are_boundary_cases():
    fleet = _LstmFleet()
    ref_store, ref_digests, ref_z = fleet.run(jax_engine, JaxFixtureSource)
    store, digests, zs = fleet.run(E, FixtureDataSource, device="cpu")
    assert set(zs) == set(ref_z) == {s[0] for s in _LstmFleet.SPECS}
    report = {}
    if digests != ref_digests:
        for jid, *_ in _LstmFleet.SPECS:
            mine, theirs = store.get(jid), ref_store.get(jid)
            if (mine.status, mine.anomaly) != (theirs.status, theirs.anomaly):
                report[jid] = (zs[jid], ref_z[jid])
    thr = E.EngineConfig().lstm_threshold
    assert all(min(abs(a - thr), abs(b - thr)) <= 0.05 for a, b in report.values()), report
    for jid in zs:  # z itself: float noise of training
        assert abs(zs[jid] - ref_z[jid]) <= 1e-2 * max(1.0, abs(ref_z[jid])), (jid, zs[jid],
                                                                                 ref_z[jid])
    assert store.get("l1").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("l6").status == E.jobs.COMPLETED_UNHEALTH
    assert store.get("l2").status == E.jobs.INITIAL


@pytest.mark.parametrize("key,value", [
    ("LSTM_WINDOW", "64"), ("LSTM_EPOCHS", "5"), ("LSTM_HIDDEN", "64"), ("LSTM_LATENT", "8"),
    ("LSTM_THRESHOLD", "2.5"), ("LSTM_MAX_TRAIN_PER_CYCLE", "0"), ("MAX_CACHE_SIZE", "16")])
def test_from_env_reads_the_lstm_knobs_as_the_reference(key, value):
    from foremast_tpu.engine import config as jax_config

    field = {"MAX_CACHE_SIZE": "max_cache_size"}.get(key, key.lower())
    for env in ({key: value}, {key: "garbage"}, {}):
        port, ref = E.from_env(env), jax_config.from_env(env)
        assert getattr(port, field) == getattr(ref, field), (env, field)
    assert str(getattr(E.from_env({key: value}), field)) in (value, str(float(value)))


@pytest.mark.parametrize("env,knob", [
    ({"LSTM_HIDDEN": "0"}, "LSTM_HIDDEN"), ({"LSTM_LATENT": "0"}, "LSTM_LATENT")])
def test_config_refuses_at_startup_what_the_card_cannot_take(env, knob):
    """An LSTM width below 1, which the reference fails on (a layer of no
    units divides by zero when its model is built), is refused by name
    when the config is built, from the environment or directly."""
    from foremast_tpu.models import lstm_ae as jax_lstm

    key = knob.split("_")[1].lower()
    with pytest.raises(ZeroDivisionError):
        jax_lstm.init_state(jax_lstm.LstmAutoencoder(
            features=3, **{"hidden": 4, "latent": 4, key: 0}), jax.random.PRNGKey(0), 8)
    with pytest.raises(ValueError, match=knob):
        E.from_env(env)
    with pytest.raises(ValueError, match=knob):
        E.EngineConfig(**{f"lstm_{key}": 0})


_TAKEN_FIELDS = ("st_changepoints", "st_order", "hw_period_candidates", "lstm_hidden",
                 "lstm_latent")


@pytest.mark.parametrize("env", [
    {"ST_CHANGEPOINTS": "30"}, {"ST_ORDER": "14", "ST_CHANGEPOINTS": "3"},
    {"HW_PERIOD_CANDIDATES": ",".join(str(p) for p in range(2, 2 + 1025))},
    {"LSTM_HIDDEN": "257"}, {"LSTM_LATENT": "300"}, {"ST_ORDER": "-1"}],
    ids=["changepoints_30", "order_14", "candidates_1025", "hidden_257", "latent_300",
         "order_negative"])
def test_config_takes_what_the_reference_takes(env):
    """Values the kernels once refused (more than 32 seasonal-trend columns,
    more than 1,024 period candidates, LSTM widths past 256) and a negative
    ST_ORDER, which the reference's fit takes as 0: the port builds the
    config, from the environment and directly, with the reference's field
    values."""
    from foremast_tpu.engine import config as jax_config

    port, ref = E.from_env(env), jax_config.from_env(env)
    for f in _TAKEN_FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    direct = E.EngineConfig(**{f: getattr(ref, f) for f in _TAKEN_FIELDS})
    assert all(getattr(direct, f) == getattr(ref, f) for f in _TAKEN_FIELDS)


def test_a_negative_order_fits_as_order_zero_as_the_reference():
    """ST_ORDER=-1 (and a negative changepoint count): the reference's
    seasonal-trend fit builds no Fourier columns (no knots), as at 0."""
    from foremast_tpu.ops import forecast as jax_fc
    from foremast_tpu_torch.ops import forecast as fc

    rng = np.random.default_rng(5)
    x = rng.normal(10, 1, (3, 96)).astype(np.float32)
    m = rng.random((3, 96)) > 0.1
    for order, C in ((-1, 3), (2, -1)):
        rb, rp = (np.asarray(a) for a in jax_fc.fit_seasonal_trend(
            x, m, m, 24, order=order, n_changepoints=C))
        b, p = fc.fit_seasonal_trend(x, m, m, 24, order=order, n_changepoints=C, device="cpu")
        zb, zp = fc.fit_seasonal_trend(x, m, m, 24, order=max(order, 0),
                                       n_changepoints=max(C, 0), device="cpu")
        assert b.shape == rb.shape and torch.equal(b, zb) and torch.equal(p, zp)
        np.testing.assert_allclose(p.numpy(), rp, rtol=0, atol=1e-3)


def test_config_takes_the_kernels_limits_themselves():
    """Prophet's published defaults, n_changepoints=25 with a yearly Fourier
    order of 10 (D = 47 columns), and the engine's 25 changepoints at its
    ST_ORDER of 3 (D = 33): the port's config takes both, as the
    reference's does."""
    from foremast_tpu.engine import config as jax_config

    for env, D in (({"ST_CHANGEPOINTS": "25", "ST_ORDER": "10"}, 47),
                   ({"ST_CHANGEPOINTS": "25"}, 33)):
        cfg, ref = E.from_env(env), jax_config.from_env(env)
        assert (cfg.st_changepoints, cfg.st_order) == (ref.st_changepoints, ref.st_order)
        assert 2 + cfg.st_changepoints + 2 * cfg.st_order == D


@pytest.mark.usefixtures("one_torch_thread")
def test_a_job_of_more_metrics_than_the_kernels_take_fails_scoring_by_name():
    """A job of 40 metrics (more than the 32 a warp's lanes hold) beside a
    three-metric job: both engines judge both, with the same verdicts
    (verdict_digest); no job aborts."""
    def run(mod, src_cls, **kw):
        fixtures = {}
        store = mod.JobStore()
        store.create(_multi_job(mod, fixtures, bad=False, jid="ok", app="a", end=NOW - 60))
        rng = np.random.default_rng(3)
        metrics = {}
        for i in range(40):
            fixtures[f"w/h{i}"] = ((np.arange(64) * STEP).tolist(), rng.normal(5, 1, 64).tolist())
            fixtures[f"w/c{i}"] = (((64 + np.arange(16)) * STEP).tolist(),
                                   rng.normal(5, 1, 16).tolist())
            metrics[f"metric{i}"] = mod.MetricQueries(current=f"w/c{i}", historical=f"w/h{i}")
        store.create(mod.Document(id="wide", app_name="w", namespace="d", strategy="canary",
                                  start_time=to_rfc3339(0), end_time=to_rfc3339(NOW - 60),
                                  metrics=metrics))
        an = mod.Analyzer(_lstm_cfg(mod, lstm_epochs=3), src_cls(fixtures), store, **kw)
        return an.run_cycle(worker="w", now=NOW), store

    out, store = run(E, FixtureDataSource, device="cpu")
    ref_out, ref_store = run(jax_engine, JaxFixtureSource)
    assert out == ref_out and out["wide"] != E.jobs.ABORT, (out, ref_out)
    assert store.get("wide").reason == ref_store.get("wide").reason
    assert verdict_digest(store) == jax_digest(ref_store)


@pytest.mark.usefixtures("one_torch_thread")
def test_two_lstm_cache_writers_on_one_path_leave_a_whole_file(tmp_path, monkeypatch):
    """Two engines saving to one LSTM_CACHE_PATH at once: each writes a
    temporary file of its own (both held open together), and the file left
    behind is one writer's whole file."""
    import tempfile
    import threading

    fixtures = {}
    store = E.JobStore()
    for j, app in enumerate(("a1", "a2")):
        store.create(_multi_job(E, fixtures, bad=False, jid=f"j{j}", app=app, seed=j))
    cfg = _lstm_cfg(E, lstm_epochs=5)
    an = E.Analyzer(cfg, FixtureDataSource(fixtures), store, device="cpu")
    an.run_cycle(now=1_000_000.0)
    path = str(tmp_path / "lstm.npz")
    made, both_writing = [], threading.Barrier(2, timeout=60)
    mkstemp, savez = tempfile.mkstemp, np.savez

    def recorded_mkstemp(*a, **kw):
        fd, name = mkstemp(*a, **kw)
        made.append(name)
        return fd, name

    def savez_side_by_side(f, **payload):
        both_writing.wait()  # the other writer has its file open too
        savez(f, **payload)

    monkeypatch.setattr(tempfile, "mkstemp", recorded_mkstemp)
    monkeypatch.setattr(np, "savez", savez_side_by_side)
    wrote, errors = [], []

    def writer(n):
        try:
            wrote.append(an.save_lstm_cache(path, max_entries=n))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(n,)) for n in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors, errors
    assert sorted(wrote) == [1, 2]
    assert len(made) == 2 and made[0] != made[1]
    assert all(os.path.dirname(m) == str(tmp_path) for m in made)
    assert sorted(os.listdir(tmp_path)) == ["lstm.npz"]
    fresh = E.Analyzer(cfg, FixtureDataSource(fixtures), E.JobStore(), device="cpu")
    n = fresh.load_lstm_cache(path)
    assert n in (1, 2)
    assert list(fresh._lstm_cache) == list(an._lstm_cache)[-n:]


@pytest.mark.usefixtures("one_torch_thread")
def test_lstm_cache_round_trips_and_other_files_load_nothing(tmp_path):
    fixtures = {}
    store = E.JobStore()
    for j, app in enumerate(("a1", "a2")):
        store.create(_multi_job(E, fixtures, bad=False, jid=f"j{j}", app=app, seed=j))
    cfg = _lstm_cfg(E, lstm_epochs=5)
    an = E.Analyzer(cfg, FixtureDataSource(fixtures), store, device="cpu")
    an.run_cycle(now=1_000_000.0)
    path = str(tmp_path / "lstm.npz")
    assert an.save_lstm_cache(path) == 2
    assert not os.path.exists(path + ".tmp")
    fresh = E.Analyzer(cfg, FixtureDataSource(fixtures), E.JobStore(), device="cpu")
    assert fresh.load_lstm_cache(path) == 2
    assert list(fresh._lstm_cache) == list(an._lstm_cache)
    for k, (row, mu, sd, _v) in an._lstm_cache.items():
        row2, mu2, sd2, _ = fresh._lstm_cache[k]
        assert torch.equal(row2, row) and (mu2, sd2) == (mu, sd)
    assert an.save_lstm_cache(path, max_entries=1) == 1
    assert E.Analyzer(cfg, FixtureDataSource(fixtures), E.JobStore(),
                      device="cpu").load_lstm_cache(path) == 1
    # another architecture, an absent file, a corrupt one: 0, never an error
    other = E.Analyzer(_lstm_cfg(E, lstm_hidden=16), FixtureDataSource(fixtures), E.JobStore(),
                       device="cpu")
    assert other.load_lstm_cache(path) == 0 and not other._lstm_cache
    assert fresh.load_lstm_cache(str(tmp_path / "absent.npz")) == 0
    (tmp_path / "corrupt.npz").write_bytes(b"PK\x03\x04 not a zip")
    assert fresh.load_lstm_cache(str(tmp_path / "corrupt.npz")) == 0
    # the reference's flax msgpack file of the same models
    ref_fixtures = {}
    ref_store = jax_engine.JobStore()
    ref_store.create(_multi_job(jax_engine, ref_fixtures, bad=False, jid="r", app="a1"))
    ref_an = jax_engine.Analyzer(_lstm_cfg(jax_engine, lstm_epochs=5),
                                 JaxFixtureSource(ref_fixtures), ref_store)
    ref_an.run_cycle(now=1_000_000.0)
    ref_path = str(tmp_path / "reference.msgpack")
    assert ref_an.save_lstm_cache(ref_path) == 1
    before = dict(fresh._lstm_cache)
    assert fresh.load_lstm_cache(ref_path) == 0
    assert fresh._lstm_cache == before
