"""Verdict provenance and the incident flight recorder on the port, on the CPU.

The reference's engine cases (tests/test_provenance.py) pointed at the
port's Analyzer with `device="cpu"`: every verdict path leaves a record
naming it (scored, memo-hit, stale-served, shed-carryover, quarantined,
blast-radius), terminal Documents carry the summary, and recording only
observes the cycle — verdicts are identical with PROVENANCE off. The flight
recorder half: a bounded event ring and the dump on the transition into
OVERLOADED or STALLED, with provenance and knobs. Both recorders are also
held to the reference's own on the same sequence of calls.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from foremast_tpu.engine import flightrec as jax_flightrec
from foremast_tpu.engine import jobs as jax_jobs
from foremast_tpu.engine import provenance as jax_prov
from foremast_tpu_torch.dataplane import FixtureDataSource, VerdictExporter
from foremast_tpu_torch.dataplane.fetch import FetchError
from foremast_tpu_torch.engine import (
    Analyzer,
    Document,
    EngineConfig,
    JobStore,
    MetricQueries,
)
from foremast_tpu_torch.engine import flightrec as fr
from foremast_tpu_torch.engine import jobs as J
from foremast_tpu_torch.engine import provenance as prov
from foremast_tpu_torch.engine.flightrec import (
    EVENT_HEALTH_TRANSITION,
    EVENT_SHED,
    EVENT_STALE_SERVE,
    FlightRecorder,
)
from foremast_tpu_torch.engine.health import HealthMonitor
from foremast_tpu_torch.engine.jobs import verdict_digest
from foremast_tpu_torch.utils.timeutils import to_rfc3339

STEP = 60
SEED = 20260803


def _series(rng, level, n):
    ts = np.arange(n) * STEP
    vals = np.clip(rng.normal(level, level * 0.1 + 0.01, n), 0, None)
    return ts.tolist(), vals.tolist()


def _mk_job(store, fixtures, job_id, *, bad=False, continuous=False,
            end_time=10_000_000.0, rng=None):
    rng = rng or np.random.default_rng(SEED)
    cur = f"http://prom:9090/{job_id}/cur"
    base = f"http://prom:9090/{job_id}/base"
    fixtures[cur] = _series(rng, 5.0 if bad else 0.5, 30)
    fixtures[base] = _series(rng, 0.5, 30)
    store.create(Document(
        id=job_id, app_name=f"app-{job_id}", namespace="prov",
        strategy="continuous" if continuous else "canary",
        start_time=to_rfc3339(0.0),
        end_time="" if continuous else to_rfc3339(end_time),
        metrics={"error5xx": MetricQueries(current=cur, baseline=base)},
    ))


def _analyzer(fixtures, store, src=None, **cfg):
    cfg.setdefault("max_stuck_seconds", 1e9)
    return Analyzer(EngineConfig(**cfg), src or FixtureDataSource(fixtures), store,
                    VerdictExporter(), device="cpu")


class FailingSource:
    def __init__(self, fixtures):
        self.inner = FixtureDataSource(fixtures)
        self.failed = False

    def fetch(self, url):
        if self.failed:
            raise FetchError(f"blackout: {url}")
        return self.inner.fetch(url)


# ------------------------------------------------------------ verdict paths

def test_scored_path_records_families_and_fetch():
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store)
    _mk_job(store, fixtures, "bad-canary", bad=True, end_time=5000.0)
    out = an.run_cycle(worker="w", now=1000.0)
    assert out["bad-canary"] == J.COMPLETED_UNHEALTH

    rec = an.provenance.get("bad-canary")
    assert rec["path"] == prov.PATH_SCORED
    assert rec["status"] == J.COMPLETED_UNHEALTH
    assert rec["cycle"]["cycle_id"] == "w-c1"
    assert rec["cycle"]["jobs"] == 1
    assert rec["cycle"]["device_launches"] >= 1
    assert set(rec["cycle"]["stage_seconds"]) == {
        "preprocess", "dispatch", "collect", "fold"}
    fams = {f["family"] for f in rec["families"]}
    assert "pair" in fams
    pair = next(f for f in rec["families"] if f["family"] == "pair")
    assert pair["unhealthy"] is True
    assert pair["alpha"] == an.config.pairwise_threshold
    assert rec["fetch"]["fetches"] == 2
    assert rec["fetch"]["points"] > 0
    # terminal Documents carry the attribution
    attached = json.loads(store.get("bad-canary").processing_content)
    assert attached["path"] == prov.PATH_SCORED
    assert attached["cycle_id"] == "w-c1"


def test_memo_hit_path_on_unchanged_second_cycle():
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, score_memo=True, score_pipeline=True)
    _mk_job(store, fixtures, "watch", continuous=True)
    an.run_cycle(worker="w", now=1000.0)
    assert an.provenance.get("watch")["path"] == prov.PATH_SCORED
    an.run_cycle(worker="w", now=1010.0)
    rec = an.provenance.get("watch")
    assert rec["path"] == prov.PATH_MEMO_HIT
    assert "from memo" in rec["detail"]
    assert rec["cycle"]["cycle_id"] == "w-c2"
    assert any(f["family"] == "pair" for f in rec["families"])


def test_stale_served_path_with_age_detail():
    fixtures, store = {}, JobStore()
    src = FailingSource(fixtures)
    an = _analyzer(fixtures, store, src=src)
    _mk_job(store, fixtures, "canary", end_time=1140.0)
    an.run_cycle(worker="w", now=1000.0)
    src.failed = True
    out = an.run_cycle(worker="w", now=1010.0)
    assert out["canary"] == J.INITIAL
    rec = an.provenance.get("canary")
    assert rec["path"] == prov.PATH_STALE_SERVED
    assert rec["detail"] == "age 10s"
    assert "stale verdict" in rec["reason"]
    assert any(e["type"] == EVENT_STALE_SERVE and e["detail"]["job_id"] == "canary"
               for e in an.flight.snapshot())
    out = an.run_cycle(worker="w", now=1140.0)
    assert out["canary"] == J.COMPLETED_HEALTH
    rec = an.provenance.get("canary")
    assert rec["path"] == prov.PATH_STALE_SERVED
    assert rec["status"] == J.COMPLETED_HEALTH
    attached = json.loads(store.get("canary").processing_content)
    assert attached["path"] == prov.PATH_STALE_SERVED


def test_shed_carryover_path_with_streak():
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, cycle_deadline_seconds=1e-9)
    _mk_job(store, fixtures, "watch1", continuous=True)
    _mk_job(store, fixtures, "watch2", continuous=True)
    an.run_cycle(worker="w", now=1000.0)
    rec = an.provenance.get("watch2")
    assert rec["path"] == prov.PATH_SHED_CARRYOVER
    assert rec["detail"] == "streak 1"
    assert an.provenance.get("watch1")["path"] == prov.PATH_SCORED
    assert any(e["type"] == EVENT_SHED and e["detail"]["count"] == 1
               and "watch2" in e["detail"]["jobs"]
               for e in an.flight.snapshot())


def test_quarantined_and_blast_radius_paths():
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, quarantine_after=1, score_pipeline=False)
    _mk_job(store, fixtures, "poison", continuous=True)

    def boom(items):
        raise RuntimeError("poisoned")

    an._score_pairs = boom
    an.run_cycle(worker="w", now=1000.0)  # fails -> parked (after=1)
    rec = an.provenance.get("poison")
    assert rec["path"] == prov.PATH_BLAST_RADIUS
    assert "poisoned" in rec["reason"]
    an.run_cycle(worker="w", now=1010.0)  # parked: quarantine gate
    rec = an.provenance.get("poison")
    assert rec["path"] == prov.PATH_QUARANTINED
    assert "re-admission" in rec["detail"]


def test_triaged_path_names_the_screen():
    """A band row the tier-0 screen clears is attributed to the screen."""
    rng = np.random.default_rng(SEED)
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, triage_min_points=4)
    cur, hist = "http://prom:9090/w/cur", "http://prom:9090/w/hist"
    fixtures[cur] = _series(rng, 10.0, 30)
    fixtures[hist] = _series(rng, 10.0, 600)
    store.create(Document(
        id="w", app_name="app-w", namespace="prov", strategy="continuous",
        start_time=to_rfc3339(0.0), end_time="",
        metrics={"latency": MetricQueries(current=cur, historical=hist)}))
    an.run_cycle(worker="w", now=1000.0)
    rec = an.provenance.get("w")
    assert rec["path"] == prov.PATH_TRIAGED
    assert rec["detail"] == "1/1 screened clear"


# --------------------------------------------------------- identity (A/B)

def test_verdicts_identical_with_provenance_off():
    """PROVENANCE only observes: outcomes, reasons and anomaly payloads are
    identical across the on/off A/B — including the memo-hit second cycle
    and a stale-served blackout cycle."""
    def build(enabled):
        rng = np.random.default_rng(SEED)
        fixtures, store = {}, JobStore()
        src = FailingSource(fixtures)
        an = _analyzer(fixtures, store, src=src, provenance=enabled)
        _mk_job(store, fixtures, "bad-canary", bad=True, rng=rng, end_time=5000.0)
        _mk_job(store, fixtures, "ok-canary", rng=rng, end_time=5000.0)
        for i in range(3):
            _mk_job(store, fixtures, f"watch-{i}", continuous=True, rng=rng)
        outs = [an.run_cycle(worker="w", now=1000.0)]
        outs.append(an.run_cycle(worker="w", now=1010.0))  # memo cycle
        src.failed = True
        outs.append(an.run_cycle(worker="w", now=1020.0))  # stale cycle
        verdicts = {jid: (d.status, d.reason, sorted(d.anomaly.items()))
                    for jid, d in ((j, store.get(j)) for j in
                                   ["bad-canary", "ok-canary", "watch-0", "watch-1",
                                    "watch-2"])}
        return outs, verdicts, an, verdict_digest(store)

    outs_on, verdicts_on, an_on, dig_on = build(True)
    outs_off, verdicts_off, an_off, dig_off = build(False)
    assert outs_on == outs_off
    assert verdicts_on == verdicts_off
    assert dig_on == dig_off
    assert an_on.provenance.records_total > 0
    assert an_off.provenance.records_total == 0
    assert an_off.provenance.get("bad-canary") is None


def test_provenance_ring_and_index_bounded():
    rec = prov.ProvenanceRecorder(max_jobs=8, ring_size=16)
    rec.begin_cycle("c1")
    for i in range(100):
        rec.record(f"j{i}", prov.PATH_SCORED, status=J.INITIAL)
    assert len(rec._latest) == 8
    assert len(rec.recent(limit=100)) == 16
    assert rec.get("j99")["path"] == prov.PATH_SCORED
    assert rec.get("j0") is None  # evicted


def test_terminal_record_closes_the_hop_chain():
    """A re-submitted incarnation of a job id must NOT inherit a dead run's
    handoff history: the terminal record keeps the chain, the next record
    starts clean."""
    rec = prov.ProvenanceRecorder()
    blob = rec.handoff_json("x", replica="repA", worker="A", reason="test")
    rec.adopt("x", blob)
    rec.record("x", "scored", status=J.COMPLETED_HEALTH)
    assert rec.get("x")["hops"]
    rec.record("x", "scored", status=J.INITIAL)
    assert "hops" not in rec.get("x")


# ----------------------------------------------------------- flight recorder

def test_flight_ring_bounded_and_shed_event():
    recorder = FlightRecorder(max_events=32)
    for i in range(100):
        recorder.record_event(EVENT_SHED, count=i)
    evs = recorder.snapshot(limit=1000)
    assert len(evs) == 32
    assert evs[-1]["detail"]["count"] == 99
    assert recorder.events_total == 100

    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, cycle_deadline_seconds=1e-9)
    _mk_job(store, fixtures, "watch1", continuous=True)
    _mk_job(store, fixtures, "watch2", continuous=True)
    an.run_cycle(worker="w", now=1000.0)
    assert any(e["type"] == EVENT_SHED for e in an.flight.snapshot())


def test_auto_dump_on_stalled_transition(tmp_path):
    """A health transition into STALLED writes a self-contained dump naming
    the transition; another read does not dump again."""
    clock = {"now": 1000.0}
    recorder = FlightRecorder(dump_dir=str(tmp_path), min_dump_interval_s=0.0)
    hm = HealthMonitor(cycle_seconds=1.0, stall_grace_seconds=5.0,
                       clock=lambda: clock["now"], recorder=recorder)
    hm.begin_cycle()
    hm.end_cycle()
    assert hm.state()[0] == "ok"
    clock["now"] += 10_000.0
    state, _detail = hm.state()
    assert state == "stalled"
    assert recorder.dumps_total == 1
    with open(recorder.last_dump_path) as f:
        dump = json.load(f)
    assert dump["reason"] == "health:stalled"
    transitions = [e for e in dump["events"] if e["type"] == EVENT_HEALTH_TRANSITION]
    assert transitions and transitions[-1]["detail"]["new"] == "stalled"
    assert transitions[-1]["detail"]["old"] == "ok"
    assert dump["health"]["state"] == "stalled"
    clock["now"] += 1.0
    assert hm.state()[0] == "stalled"
    assert recorder.dumps_total == 1


def test_first_incident_dump_not_rate_limited(tmp_path):
    """The rate limiter applies between dumps, never to the first one."""
    recorder = FlightRecorder(dump_dir=str(tmp_path), min_dump_interval_s=1e12)
    recorder.on_health_transition("ok", "stalled", {"why": "born broken"})
    assert recorder.dumps_total == 1
    recorder.on_health_transition("ok", "stalled", {"why": "again"})
    assert recorder.dumps_total == 1


def test_overloaded_transition_dumps_with_provenance_and_knobs(tmp_path):
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, cycle_deadline_seconds=1e-9,
                   flight_dump_dir=str(tmp_path))
    an.flight.min_dump_interval_s = 0.0
    _mk_job(store, fixtures, "watch1", continuous=True)
    _mk_job(store, fixtures, "watch2", continuous=True)
    an.run_cycle(worker="w", now=1000.0)  # sheds watch2 -> OVERLOADED
    assert an.health.state()[0] == "overloaded"
    assert an.flight.dumps_total == 1
    with open(an.flight.last_dump_path) as f:
        dump = json.load(f)
    assert dump["reason"] == "health:overloaded"
    assert "watch2" in dump["provenance"]["affected_jobs"]
    assert (dump["provenance"]["affected_jobs"]["watch2"]["path"]
            == prov.PATH_SHED_CARRYOVER)
    assert dump["knobs"]["engine"]["cycle_deadline_seconds"] == 1e-9
    assert dump["knobs"]["engine"]["device"] == "cpu"
    assert "FOREMAST_NATIVE" in dump["knobs"]["env"]
    for i in range(fr.MAX_DUMPS + 3):
        an.flight.dump(reason=f"test-{i}")
    files = [f for f in os.listdir(tmp_path) if f.startswith("foremast-flight-")]
    assert len(files) <= fr.MAX_DUMPS
    with open(os.path.join(tmp_path, sorted(files)[-1])) as f:
        assert json.load(f)["reason"].startswith("test-")


def test_overloaded_dump_holds_every_named_shed_job_s_record(tmp_path):
    """Below the recorder's 4,096-job bound the dump holds the record of
    every job the shed event names, each on the shed path."""
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store, cycle_deadline_seconds=1e-9,
                   flight_dump_dir=str(tmp_path))
    an.flight.min_dump_interval_s = 0.0
    for i in range(40):
        _mk_job(store, fixtures, f"watch{i:02d}", continuous=True)
    an.run_cycle(worker="w", now=1000.0)
    assert an.jobs_shed_total == 39
    assert an.flight.dumps_total == 1
    with open(an.flight.last_dump_path) as f:
        dump = json.load(f)
    shed_ev = [e for e in dump["events"] if e["type"] == EVENT_SHED]
    assert len(shed_ev) == 1 and shed_ev[0]["detail"]["count"] == 39
    named = shed_ev[0]["detail"]["jobs"]
    assert len(named) == 16
    affected = dump["provenance"]["affected_jobs"]
    assert set(named) <= set(affected)
    assert all(affected[j]["path"] == prov.PATH_SHED_CARRYOVER for j in named)


# ------------------------------------------------ against the reference
def _untimed(obj):
    """`obj` without its wall-clock stamps (`ts`, a dump's path)."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k not in ("ts", "age_s")}
    if isinstance(obj, list):
        return [_untimed(v) for v in obj]
    return obj


def _drive_provenance(mod, jobs_mod, seed, enabled=True):
    """One random sequence of cycles, records, annotations, handoffs and
    adoptions through `mod`'s ProvenanceRecorder (8 jobs, a ring of 16):
    every read it answers and every spill it makes."""
    rng = np.random.default_rng(seed)
    rec = mod.ProvenanceRecorder(enabled=enabled, max_jobs=8, ring_size=16)
    spilled = []
    rec.spill = lambda jid, slim: spilled.append([jid, slim]) or jid != "j3"
    paths = sorted(mod.PATHS)
    statuses = [jobs_mod.INITIAL, jobs_mod.COMPLETED_HEALTH, jobs_mod.COMPLETED_UNHEALTH,
                jobs_mod.PREPROCESS_FAILED]
    jobs = [f"j{i}" for i in range(12)]
    reads = []
    for c in range(12):
        rec.begin_cycle(f"w-c{c}", worker="w")
        for jid in rng.choice(jobs, 5, replace=False):
            jid = str(jid)
            fams = [{"family": "pair", "metric": f"m{k}", "min_p": round(float(rng.random()), 8)}
                    for k in range(int(rng.choice([0, 2, 20])))]
            rec.record(jid, str(rng.choice(paths)), status=str(rng.choice(statuses)),
                       detail="d" * int(rng.integers(0, 3)), families=fams,
                       fetch={"points": int(rng.integers(0, 900)), "fetches": 2},
                       reason=str(rng.choice(["", "anomaly detected", "stale verdict served"])))
            if rng.random() < 0.4:
                rec.annotate(jid, detection_latency_s=float(rng.random()),
                             trace_id=f"{int(rng.integers(0, 99)):032d}", note="x")
        if rng.random() < 0.5:
            jid = str(rng.choice(jobs))
            blob = rec.handoff_json(jid, replica="r1", worker="w", reason="rebalance",
                                    max_bytes=int(rng.choice([300, 4096])))
            reads.append(_untimed(json.loads(blob)) if blob else blob)
            rec.adopt(str(rng.choice(jobs)), blob)
        rec.adopt("j0", "not json")
        rec.finish_cycle(stage_seconds={"fetch": 0.1234567, "fold": 2.0}, device_launches=c,
                         jobs=5)
        reads.append({j: _untimed(rec.get(j)) for j in jobs})
        reads.append(_untimed(rec.recent(limit=10)))
        reads.append(_untimed(rec.for_jobs(jobs[:6])))
        reads.append([_untimed(json.loads(b)) if b else b
                      for b in (rec.summary_json(j, max_bytes=int(rng.choice([200, 4096])))
                                for j in jobs)])
    return reads, _untimed(spilled), rec.records_total, rec.spills_total, rec.spill_failures_total


@pytest.mark.parametrize("seed,enabled", [(0, True), (1, True), (2, True), (3, False)])
def test_provenance_recorder_matches_the_reference(seed, enabled):
    """The same calls through the reference's ProvenanceRecorder and the
    port's: every record, the ring, the summaries, the handoff blobs, the
    inherited hop chains and the spills are equal (their wall-clock
    stamps aside), and with recording off both stay empty."""
    want = _drive_provenance(jax_prov, jax_jobs, seed, enabled)
    got = _drive_provenance(prov, J, seed, enabled)
    assert got == want
    assert (want[2] > 0) == enabled


def _drive_flight(mod, prov_mod, dump_dir, seed):
    """One random sequence of events, health transitions and dumps through
    `mod`'s FlightRecorder, with a provenance tap, knobs and health: its
    ring and the payload of every dump it writes."""
    rng = np.random.default_rng(seed)
    pr = prov_mod.ProvenanceRecorder(max_jobs=4)
    pr.begin_cycle("w-c1", worker="w")
    for i in range(6):
        pr.record(f"j{i}", prov_mod.PATH_SHED_CARRYOVER, status="initial")
    fr_ = mod.FlightRecorder(max_events=20, dump_dir=dump_dir, provenance=pr,
                             knobs_fn=lambda: {"engine": {"cycle_seconds": 10.0}},
                             health_fn=lambda: ("degraded", {"stale_served": 1}),
                             min_dump_interval_s=1e9)
    types = sorted(mod.EVENT_TYPES)
    payloads = []
    for _ in range(60):
        op = rng.integers(0, 5)
        if op <= 1:
            jid = f"j{int(rng.integers(0, 8))}"
            fr_.record_event(str(rng.choice(types)), job_id=jid,
                             jobs=[f"j{int(k)}" for k in rng.integers(0, 8, 3)])
        elif op == 2:
            fr_.on_health_transition("ok", str(rng.choice(["degraded", "overloaded", "stalled"])),
                                     {"shed": 1, "open_breakers": ["x"]})
        elif op == 3:
            path = fr_.dump(reason=f"test {int(rng.integers(0, 3))}/x")
            with open(path) as f:
                payloads.append(_untimed(json.load(f)))
        else:
            payloads.append(_untimed(fr_.snapshot(limit=int(rng.integers(1, 30)))))
    files = [f for f in os.listdir(dump_dir) if f.startswith("foremast-flight-")]
    return payloads, fr_.events_total, fr_.dumps_total, len(files) <= mod.MAX_DUMPS


@pytest.mark.parametrize("seed", [0, 1])
def test_flight_recorder_matches_the_reference(tmp_path, seed):
    """The same events, transitions and dumps through the reference's
    FlightRecorder and the port's: the ring, every dump's payload (events,
    health, the named jobs' provenance, the recent records, the knobs), the
    rate limit on auto-dumps and the pruning are equal."""
    want = _drive_flight(jax_flightrec, jax_prov, str(tmp_path / "ref"), seed)
    got = _drive_flight(fr, prov, str(tmp_path / "port"), seed)
    assert got == want
    assert want[2] >= 2 and want[3]


# ------------------------------------------------------------- histograms

def test_exporter_histogram_exposition():
    ex = VerdictExporter()
    for v in (0.003, 0.003, 0.2, 7.0):
        ex.record_histogram("foremastbrain:test_seconds", {"stage": "x"}, v,
                            help="test histogram")
    text = ex.render()
    assert "# TYPE foremastbrain:test_seconds histogram" in text
    assert 'foremastbrain:test_seconds_bucket{stage="x",le="0.005"} 2' in text
    assert 'foremastbrain:test_seconds_bucket{stage="x",le="0.25"} 3' in text
    assert 'foremastbrain:test_seconds_bucket{stage="x",le="+Inf"} 4' in text
    assert 'foremastbrain:test_seconds_count{stage="x"} 4' in text
    assert 'foremastbrain:test_seconds_sum{stage="x"} 7.206' in text


def test_cycle_and_fetch_histograms_on_the_exporter():
    fixtures, store = {}, JobStore()
    an = _analyzer(fixtures, store)
    _mk_job(store, fixtures, "watch", continuous=True)
    an.run_cycle(worker="w", now=1000.0)
    text = an.exporter.render()
    for name in ("foremastbrain:cycle_seconds", "foremastbrain:fetch_seconds",
                 "foremastbrain:cycle_stage_duration_seconds"):
        assert f"{name}_bucket" in text, name
        assert f"{name}_count" in text, name
