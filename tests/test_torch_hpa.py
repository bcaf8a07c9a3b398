"""The HPA family against the reference, on the CPU.

The port's `hpa_scores` and `hpa_from_preds` (device="cpu", the plain twins
of kernel I) and the JAX reference take the same numpy inputs, made from a
seed. Tolerances are chip_smoke's `compare_hpa`, the ones kernel I is held
to on the card: reason codes exact and scores within 1e-3 except on rows
bracketed at a decision edge (a checked point within float32 noise of a
band edge where that moves n_out * 3 across the checked count, the SLA
metric within 1e-5 of its limit, base within 1e-4 of 50 or the reward
weight within 1e-5 of 1); the means to 1e-5 relative plus 4 eps32 of the
row's scale; demand, which carries the slope, to 1e-4 relative. NaN and
+-inf where the reference has them. Then the reference's own scenarios
(tests/test_hpa.py), its breath cooldowns and their persistence, on the
port.
"""
import math

import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from foremast_tpu.ops import forecast as jfc
from foremast_tpu.ops import hpa as jhpa
from foremast_tpu_torch.dataplane import FixtureDataSource
from foremast_tpu_torch.engine import Analyzer, EngineConfig, JobStore
from foremast_tpu_torch.ops import forecast as fc
from foremast_tpu_torch.ops import hpa

jax.config.update("jax_platforms", "cpu")


def hpa_rows(B, T, seed):
    """Numpy hpa rows (the arguments of kernel I, tps_sigma included):
    chip_smoke's adversarial_hpa made on the CPU from a torch generator
    seeded with `seed`, as numpy arrays (every mode and flag, the edge rows
    at safe, at the limit and at base 50, a third of the region out of band,
    an empty region, one history point, NaN at a masked slot)."""
    saved, cs.DEV = cs.DEV, "cpu"
    try:
        a = cs.adversarial_hpa(B, T, torch.Generator().manual_seed(seed))
    finally:
        cs.DEV = saved
    return {k: v.numpy() for k, v in a.items()}


def _as_torch(out):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("optional", [False, True], ids=["core", "optional"])
@pytest.mark.parametrize("T", [64, 256, 2048])
def test_hpa_scores_match_the_reference(T, optional):
    a = hpa_rows(96, T, seed=T + optional)
    opt = {k: a[k] for k in ("pods_now", "pods_hist", "sla_absolute")} if optional else {}
    if optional:
        opt["sla_safe_fraction"] = a["safe"]
    ref = jhpa.hpa_scores(a["tps"], a["tps_mask"], a["region"], a["tps_pred"], a["tps_sigma"],
                          a["sla"], a["sla_mask"], a["sla_static_limit"], a["sla_mode"],
                          a["threshold"], **opt)
    port = hpa.hpa_scores(a["tps"], a["tps_mask"], a["region"], a["tps_pred"], a["tps_sigma"],
                          a["sla"], a["sla_mask"], a["sla_static_limit"], a["sla_mode"],
                          a["threshold"], **opt, device="cpu")
    assert port["reason"].dtype == torch.int32 and set(port) == set(ref)
    ta = {k: torch.as_tensor(v) for k, v in a.items()}
    errs, bracketed = cs.compare_hpa(ta, port, True, optional, plain=_as_torch(ref))
    assert errs["score"] <= 1e-3 and bracketed <= 96 * 3 // 16 + 4


@pytest.mark.parametrize("T", [128, 1024])
def test_hpa_from_preds_matches_the_reference_chain(T):
    """hpa_from_preds (one launch) against the reference's three programs:
    ses_predictions (alpha 0.3 on the history), residual_sigma, hpa_scores."""
    a = hpa_rows(64, T, seed=7 * T)
    hist = a["tps_mask"] & ~a["region"]
    alpha = np.full(64, 0.3, np.float32)
    preds = np.asarray(jfc.ses_predictions(a["tps"], hist, alpha))
    sigma = np.asarray(jfc.residual_sigma(a["tps"], preds, hist, ~a["region"]))
    kw = dict(pods_now=a["pods_now"], pods_hist=a["pods_hist"], sla_absolute=a["sla_absolute"])
    ref = jhpa.hpa_scores(a["tps"], a["tps_mask"], a["region"], preds, sigma, a["sla"],
                          a["sla_mask"], a["sla_static_limit"], a["sla_mode"], a["threshold"],
                          a["safe"], **kw)
    port_preds = fc.ses_predictions(a["tps"], hist, 0.3, device="cpu")
    np.testing.assert_allclose(port_preds.numpy(), preds, rtol=1e-5, atol=1e-4)
    port = hpa.hpa_from_preds(a["tps"], a["tps_mask"], a["region"], port_preds, a["sla"],
                              a["sla_mask"], a["sla_static_limit"], a["sla_mode"],
                              a["threshold"], a["safe"], **kw, device="cpu")
    ta = {k: torch.as_tensor(v) for k, v in a.items()}
    ta["tps_pred"], ta["tps_sigma"] = port_preds, torch.as_tensor(sigma)
    ref = _as_torch(ref)
    ref["tps_sigma"] = ta["tps_sigma"]
    errs, _ = cs.compare_hpa(ta, port, False, True, plain=ref)
    assert errs["tps_sigma"] <= 1e-3 * float(np.nanmax(np.abs(sigma[np.isfinite(sigma)])))


def test_non_finite_values_follow_the_reference():
    """The reference's masked means select (x * w compiles to a select): a
    NaN or inf at a masked slot leaves them alone, and sigma = +inf gives
    band means of +inf and -inf. Its slope multiplies the selected factor
    by x - xm at every slot, so a non-finite tps anywhere makes the slope,
    the anomaly demand and the score NaN. The port returns the same."""
    T = 12
    tps = np.tile((100 + np.arange(T)).astype(np.float32), (3, 1))
    tm = np.ones((3, T), bool)
    region = np.zeros((3, T), bool)
    region[:, 8:] = True
    tm[:, [3, 9]] = False
    tps[0, 9], tps[1, 9], tps[1, 3] = np.nan, np.inf, -np.inf
    pred = np.full((3, T), 100.0, np.float32)
    pred[0, 3] = np.nan
    sigma = np.asarray([1.0, 1.0, np.inf], np.float32)
    args = (tps, tm, region, pred, sigma, tps.copy(), tm.copy(), np.full(3, 1e9, np.float32),
            np.ones(3, np.int32), np.ones(3, np.float32))
    ref = {k: np.asarray(v) for k, v in jhpa.hpa_scores(*args).items()}
    port = {k: v.numpy() for k, v in hpa.hpa_scores(*args, device="cpu").items()}
    for k in ref:
        np.testing.assert_allclose(port[k], ref[k], rtol=1e-6, equal_nan=True, err_msg=k)
    assert np.isnan(port["score"][:2]).all() and np.isfinite(port["current_tps"]).all()
    assert port["tps_upper"][2] == math.inf and port["tps_lower"][2] == -math.inf


@pytest.mark.parametrize("T", [64, 2048, 16384])
def test_edge_rows_match_the_reference(T):
    """The rows kernel I's passes treat apart (chip_smoke.hpa_edge_rows),
    both entries against the reference: NaN at a valid history slot, +inf
    at a valid region slot, x - xm overflowing outside the selection (the
    slope NaN), NaN at a masked slot and at a padding slot, and at T = 16384
    the engine's layout of 10,080 history and 30 current slots."""
    saved, cs.DEV = cs.DEV, "cpu"
    try:
        ta = cs.hpa_edge_rows(32 if T < 16384 else 16, T, torch.Generator().manual_seed(T))
    finally:
        cs.DEV = saved
    a = {k: v.numpy() for k, v in ta.items()}
    kw = dict(pods_now=a["pods_now"], pods_hist=a["pods_hist"], sla_absolute=a["sla_absolute"])
    series = (a["sla"], a["sla_mask"], a["sla_static_limit"], a["sla_mode"], a["threshold"],
              a["safe"])
    ref = jhpa.hpa_scores(a["tps"], a["tps_mask"], a["region"], a["tps_pred"], a["tps_sigma"],
                          *series, **kw)
    port = hpa.hpa_scores(a["tps"], a["tps_mask"], a["region"], a["tps_pred"], a["tps_sigma"],
                          *series, **kw, device="cpu")
    cs.compare_hpa(ta, port, True, True, plain=_as_torch(ref))
    r = np.arange(len(a["tps"]))
    assert np.isnan(port["score"].numpy()[r % 16 == 9]).all()  # the slope's overflow
    sigma = np.asarray(jfc.residual_sigma(a["tps"], a["tps_pred"], a["tps_mask"] & ~a["region"],
                                          ~a["region"]))
    ref = _as_torch(jhpa.hpa_scores(a["tps"], a["tps_mask"], a["region"], a["tps_pred"], sigma,
                                    *series, **kw))
    ref["tps_sigma"] = torch.as_tensor(sigma)
    port = hpa.hpa_from_preds(a["tps"], a["tps_mask"], a["region"], a["tps_pred"], *series,
                              **kw, device="cpu")
    ta["tps_sigma"] = ref["tps_sigma"]
    cs.compare_hpa(ta, port, False, True, plain=ref)


# -------------------------------------- the reference's scenarios on the port
def _setup(tps_current_level, sla_current=5.0, T=96, region_len=30):
    """History at ~100 tps, current window at tps_current_level; the model
    is SES on the history, its sigma the history's residual RMS."""
    rng = np.random.default_rng(0)
    tps = np.concatenate([rng.normal(100, 3, T - region_len),
                          rng.normal(tps_current_level, 3, region_len)]).astype(np.float32)[None]
    mask = np.ones((1, T), bool)
    region = np.zeros((1, T), bool)
    region[:, -region_len:] = True
    sla = np.concatenate([rng.normal(5, 0.5, T - region_len),
                          rng.normal(sla_current, 0.5, region_len)]).astype(np.float32)[None]
    hist = mask & ~region
    preds = fc.ses_predictions(tps, hist, 0.3, device="cpu")
    sigma = fc.residual_sigma(torch.as_tensor(tps), preds, torch.as_tensor(hist),
                              torch.as_tensor(~region))
    return dict(tps=tps, tps_mask=mask, region=region, tps_pred=preds.numpy(),
                tps_sigma=sigma.numpy(), sla=sla, sla_mask=mask,
                sla_static_limit=np.float32([50.0]), sla_mode=np.int32([hpa.SLA_STATIC]),
                threshold=np.float32([3.0]))


def _score(**kw):
    out = hpa.hpa_scores(**kw, device="cpu")
    return float(out["score"][0]), int(out["reason"][0]), out


def test_steady_traffic_holds_replicas():
    s, why, _ = _score(**_setup(100))
    assert 35 <= s <= 65 and why == hpa.REASON_PREDICTED_TREND


def test_traffic_surge_scales_up():
    s, why, _ = _score(**_setup(300))
    assert s > 50 and why == hpa.REASON_ANOMALY_TREND


def test_traffic_collapse_scales_down():
    assert _score(**_setup(20))[0] < 50


def test_sla_violation_forces_scale_up():
    s, why, _ = _score(**_setup(100, sla_current=80.0))
    assert s >= 75 and why == hpa.REASON_SLA_VIOLATION


def test_sla_violation_floor_grows_with_overshoot():
    mild = _score(**_setup(100, sla_current=55.0))[0]
    severe = _score(**_setup(100, sla_current=95.0))[0]
    assert mild >= 75 and severe > mild


def test_thin_headroom_suppresses_scale_down_via_reward():
    base = _score(**_setup(20, sla_current=5.0))[0]
    assert base < 50
    s, why, _ = _score(**_setup(20, sla_current=47.5))  # h = 0.95 of 50
    assert s > base and 40 <= s < 50 and why == hpa.REASON_SLA_HEADROOM


def test_comfortable_headroom_is_model_driven():
    s, why, _ = _score(**_setup(20, sla_current=5.0))
    assert s < 50 and why in (hpa.REASON_PREDICTED_TREND, hpa.REASON_ANOMALY_TREND)
    s, why, _ = _score(**_setup(300, sla_current=5.0))
    assert s > 50 and why == hpa.REASON_ANOMALY_TREND


def test_scale_up_passes_through_thin_headroom():
    s, why, _ = _score(**_setup(300, sla_current=47.5))
    assert s > 50 and why == hpa.REASON_ANOMALY_TREND


def test_sla_dynamic_mode_uses_history_sigma():
    cfg = _setup(100, sla_current=9.0)
    cfg["sla_mode"] = np.int32([hpa.SLA_DYNAMIC])
    assert _score(**cfg)[1] == hpa.REASON_SLA_VIOLATION
    cfg["sla_mode"] = np.int32([hpa.SLA_STATIC])
    assert _score(**cfg)[1] != hpa.REASON_SLA_VIOLATION


def test_sla_min_mode_takes_tighter_of_static_and_dynamic():
    kw = _setup(100, sla_current=5.0)
    kw["sla_mode"] = np.int32([hpa.SLA_MIN])
    assert float(_score(**kw)[2]["sla_limit"][0]) < 10
    kw["sla_static_limit"] = np.float32([3.0])
    _, why, out = _score(**kw)
    assert abs(float(out["sla_limit"][0]) - 3.0) < 1e-5 and why == hpa.REASON_SLA_VIOLATION


def test_relative_sla_limit_scales_with_history_mean():
    kw = _setup(100, sla_current=5.0)
    kw["sla_static_limit"] = np.float32([1.5])
    kw["sla_absolute"] = np.array([False])
    assert 6.5 < float(_score(**kw)[2]["sla_limit"][0]) < 8.5
    kw["sla_absolute"] = np.array([True])
    assert _score(**kw)[1] == hpa.REASON_SLA_VIOLATION


def test_per_pod_normalization_absorbs_taken_scaleups():
    kw = _setup(200)
    assert _score(**kw)[0] > 65
    kw["pods_now"], kw["pods_hist"] = np.float32([8.0]), np.float32([4.0])
    s, _, out = _score(**kw)
    assert 35 <= s <= 65 and abs(float(out["pods_now"][0]) - 8.0) < 1e-6
    kw["pods_now"] = np.float32([4.0])
    s, _, out = _score(**kw)
    assert s > 65 and float(out["demand_per_pod"][0]) > 40


def test_closed_loop_converges_with_per_pod_normalization():
    """The autoscaler's loop: traffic steps to 2.5x, each cycle the HPA sets
    replicas' = ceil(replicas * score / 50) and the pod counts feed the next
    score. Per-pod normalization converges (~10 pods) and holds; without
    pod data the same state keeps demanding scale-up."""
    rng = np.random.default_rng(2)
    T, region_len, surge = 96, 30, 2.5

    def score_once(replicas_now, replicas_hist, with_pods=True):
        tps = np.concatenate([rng.normal(100, 2, T - region_len),
                              rng.normal(100 * surge, 2, region_len)]).astype(np.float32)[None]
        mask = np.ones((1, T), bool)
        region = np.zeros((1, T), bool)
        region[:, -region_len:] = True
        kw = {}
        if with_pods:
            kw = dict(pods_now=np.float32([replicas_now]), pods_hist=np.float32([replicas_hist]))
        preds = fc.ses_predictions(tps, mask & ~region, 0.3, device="cpu")
        sla = rng.normal(5, 0.3, (1, T)).astype(np.float32)
        out = hpa.hpa_from_preds(tps, mask, region, preds, sla, mask, np.float32([50.0]),
                                 np.int32([hpa.SLA_DYNAMIC]), np.float32([3.0]), **kw,
                                 device="cpu")
        return float(out["score"][0])

    replicas, trajectory = 4.0, [4.0]
    for _ in range(8):
        s = score_once(replicas, 4.0)
        replicas = min(max(math.ceil(replicas * s / 50.0), 1), 64)
        trajectory.append(replicas)
    assert trajectory[-1] == trajectory[-2] and 9 <= trajectory[-1] <= 12, trajectory
    assert 40 <= score_once(trajectory[-1], 4.0) <= 60
    assert score_once(trajectory[-1], 4.0, with_pods=False) > 65


# ------------------------------------------------------------ breath state
def test_breath_cooldowns():
    st = hpa.BreathState(breath_up_s=120, breath_down_s=600)
    assert st.apply("svc", 80.0, now=0.0) == 50.0
    assert st.apply("svc", 80.0, now=60.0) == 50.0
    assert st.apply("svc", 80.0, now=130.0) == 80.0
    assert st.apply("svc", 30.0, now=140.0) == 50.0
    assert st.apply("svc", 30.0, now=500.0) == 50.0
    assert st.apply("svc", 30.0, now=745.0) == 30.0
    assert st.apply("svc", 50.0, now=800.0) == 50.0
    assert st.apply("svc", 80.0, now=810.0) == 50.0


def test_breath_matches_the_reference_on_a_random_walk():
    rng = np.random.default_rng(11)
    mine, ref = hpa.BreathState(), jhpa.BreathState()
    now = 0.0
    for _ in range(400):
        now += float(rng.choice([10.0, 60.0, 300.0]))
        svc = f"svc-{int(rng.integers(3))}"
        raw = float(rng.choice([20.0, 50.0, 80.0, 95.0]))
        assert mine.apply(svc, raw, now=now) == ref.apply(svc, raw, now=now)
    assert mine.export() == ref.export()


def test_breath_state_survives_restart(tmp_path):
    snap = str(tmp_path / "jobs.json")
    store = JobStore(snapshot_path=snap)
    st = hpa.BreathState(breath_up_s=120, breath_down_s=600)
    assert st.apply("svc", 30.0, now=1000.0) == 50.0
    store.put_state("breath", st.export())
    store.flush()
    st2 = hpa.BreathState(breath_up_s=120, breath_down_s=600)
    st2.load(JobStore(snapshot_path=snap).get_state("breath") or {})
    assert st2.apply("svc", 30.0, now=1300.0) == 50.0
    assert st2.apply("svc", 30.0, now=1700.0) == 30.0


def test_breath_load_drops_corrupt_entries():
    st = hpa.BreathState()
    st.load({"good": [1, 100.0], "bad": "nope", "worse": [1], "none": None})
    assert st._since == {"good": (1, 100.0)}


def test_analyzer_hydrates_breath_from_store(tmp_path):
    snap = str(tmp_path / "jobs.json")
    store = JobStore(snapshot_path=snap)
    eng = Analyzer(EngineConfig(), FixtureDataSource({}), store, device="cpu")
    assert eng.breath.apply("app/ns", 80.0, now=2000.0) == 50.0  # arm up
    eng.run_cycle(now=2000.0)  # the cycle's end persists the armed timer
    eng2 = Analyzer(EngineConfig(), FixtureDataSource({}), JobStore(snapshot_path=snap),
                    device="cpu")
    assert eng2.breath._since == {"app/ns": (1, 2000.0)}
    assert eng2.breath.apply("app/ns", 80.0, now=2130.0) == 80.0
