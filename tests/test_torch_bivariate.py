"""The bivariate-normal family against the reference, on the CPU.

The port's `bivariate_normal_anomalies` (device="cpu", the plain twin of
kernel H) and the JAX reference take the same numpy inputs, made from a
seed. Tolerances are chip_smoke's, the ones kernel H is held to on the
card: d2 within `bivariate_tolerance` (1e-4 of d2 plus float32 noise of
the terms that cancel in the numerator and in det, and of the means); flags,
counts and first indices exact on every row with no candidate slot within
that tolerance of threshold^2 (those rows are bracketed and their counts
must lie in the bracket); checked exact; the marginal bands to 1e-5
relative plus the means' and variances' float32 noise. Then the
reference's own scenarios (tests/test_bivariate.py) on the port, and its
engine cases on the port's Analyzer.
"""
import jax
import numpy as np
import pytest
import torch

import chip_smoke as cs
from foremast_tpu.ops.bivariate import bivariate_normal_anomalies as jax_bivariate
from foremast_tpu_torch.dataplane import FixtureDataSource
from foremast_tpu_torch.engine import Analyzer, Document, EngineConfig, JobStore, MetricQueries
from foremast_tpu_torch.engine import jobs as J
from foremast_tpu_torch.engine.analyzer import _joint_grid
from foremast_tpu_torch.ops.bivariate import (bivariate_normal_anomalies,
                                              bivariate_normal_anomalies_plain)
from foremast_tpu_torch.ops.windowing import resample_to_grid
from foremast_tpu_torch.utils.timeutils import to_rfc3339

jax.config.update("jax_platforms", "cpu")

STEP = 60
BANDS = ("upper1", "lower1", "upper2", "lower2")


def pair_rows(B, T, seed):
    """Numpy metric-pair rows of ten kinds: correlated noise with gaps, a
    constant history, a perfectly correlated history with points off the
    line, one history point, an empty region, a correlation break, joint
    shifts up and down, NaN at a masked slot, all masked. The last quarter
    is the region; thresholds 2, 3, 5; every pair of bound modes."""
    rng = np.random.default_rng(seed)
    kind = np.arange(B) % 10
    t = np.arange(T)
    region = np.broadcast_to(t >= 3 * T // 4, (B, T)).copy()
    rho = rng.uniform(0.5, 0.95, (B, 1))
    z1 = rng.standard_normal((B, T))
    z2 = rho * z1 + np.sqrt(1 - rho * rho) * rng.standard_normal((B, T))
    x1, x2 = 50 + 5 * z1, 30 + 2 * z2
    m1, m2 = rng.random((B, T)) > 0.1, rng.random((B, T)) > 0.1
    k = kind == 1
    x1[k], x2[k], m1[k], m2[k] = 60.42, 5.0, True, True
    x1[k & (np.arange(B) % 20 >= 10)] += 1.0 * region[0]
    k = kind == 2
    x2[k] = 2 * x1[k] + 3 + np.where(region[k] & (t % 2 == 0), 20.0, 0.0)
    m1[kind == 3] &= region[kind == 3] | (t == T // 3)
    region[kind == 4] = False
    k = (kind == 5)[:, None] & region
    x1, x2 = np.where(k, 50 + 12.5 * z1, x1), np.where(k, 30 - 5 * z1, x2)
    for kk, d in ((6, 1.0), (7, -1.0)):
        k = (kind == kk)[:, None] & region
        x1, x2 = x1 + 30 * d * k, x2 + 12 * d * k
    k = kind == 8
    x1[k, T // 5], m1[k, T // 5] = np.nan, False
    m1[kind == 9] = False
    thr = np.asarray([2.0, 3.0, 5.0], np.float32)[np.arange(B) % 3]
    mlb1 = np.where(np.arange(B) % 5 == 0, 49.0, 0.0).astype(np.float32)
    bm1 = (np.arange(B) % 4).astype(np.int32)
    bm2 = (np.arange(B) // 4 % 4).astype(np.int32)
    return (x1.astype(np.float32), m1, x2.astype(np.float32), m2, region, thr, mlb1,
            mlb1 * 0.5, bm1, bm2)


def _torch(out, B):
    """An output dict as CPU tensors, the bands as (B,) values."""
    res = {k: torch.as_tensor(np.asarray(v)) for k, v in out.items()}
    for k in BANDS:
        if res[k].dim() == 2:
            res[k] = res[k][:, 0].contiguous()
    return res


@pytest.mark.parametrize("optional", [False, True], ids=["core", "optional"])
@pytest.mark.parametrize("T", [64, 1024, 2048])
def test_port_matches_the_reference(T, optional):
    args = pair_rows(120, T, seed=T + optional)
    if not optional:
        args = args[:6]
    ref = _torch(jax_bivariate(*args), 120)
    port = bivariate_normal_anomalies(*args, device="cpu")
    assert port["upper1"].shape == (120, T)  # the reference's (B, T) bands
    assert port["first_index"].dtype == torch.int32
    targs = tuple(torch.as_tensor(a) for a in args)
    # the reference's float32 sums (XLA on the CPU adds in sequence) may err
    # by (n - 1) eps32 / 2 of the sum of magnitudes: the port's tolerance
    # on the card, with that error on the reference's side
    n = (targs[1] & targs[3] & ~targs[4]).sum(1).double()
    err, bracketed = cs.compare_bivariate(targs, _torch(port, 120), ref,
                                          sum_eps=n * cs.EPS32 / 2)
    # bracketed: the constant and perfectly correlated rows (a mean's float32
    # noise moves d2 there by more than any margin) and near-edge points
    assert bracketed < 60


def test_the_twin_returns_the_bands_per_row():
    args = pair_rows(30, 64, seed=3)
    full = bivariate_normal_anomalies(*args, device="cpu")
    rows = bivariate_normal_anomalies_plain(*(torch.as_tensor(a) for a in args))
    for k in BANDS:
        assert rows[k].shape == (30,)
        assert torch.equal(full[k][:, 5], rows[k])


def test_non_finite_values_at_masked_slots_are_ignored_as_in_the_reference():
    """The reference's x * w compiles to a select: a NaN or inf at a masked
    history slot changes no statistic, only d2 at that slot (from the raw
    value). The port selects the same way."""
    args = list(pair_rows(20, 64, seed=4))
    args[1][0, 3], args[3][1, 7] = False, False
    clean = bivariate_normal_anomalies(*args, device="cpu")
    args[0], args[2] = args[0].copy(), args[2].copy()
    args[0][0, 3], args[2][1, 7] = np.inf, np.nan
    ref = jax_bivariate(*args)
    port = bivariate_normal_anomalies(*args, device="cpu")
    ref_d2 = np.asarray(ref["d2"])
    for r, c in ((0, 3), (1, 7)):
        assert not np.isfinite(ref_d2[r, c]) and not torch.isfinite(port["d2"][r, c])
        keep = np.arange(64) != c
        assert np.isfinite(ref_d2[r, keep]).all() and torch.isfinite(port["d2"][r, keep]).all()
        assert torch.equal(port["upper1"][r], clean["upper1"][r])
        assert torch.equal(port["count"][r], clean["count"][r])
        np.testing.assert_allclose(np.asarray(ref["upper1"])[r], port["upper1"][r].numpy(),
                                   rtol=1e-5)


def test_the_engine_packs_masked_slots_finite():
    """What the engine packs never holds a non-finite value at a masked
    slot: resample_to_grid drops non-finite samples and zero-fills, and the
    joint grid concatenates such windows."""
    rng = np.random.default_rng(6)
    ts = np.arange(50) * STEP + rng.uniform(0, 5, 50)
    vals = rng.normal(10, 1, 50)
    vals[[3, 9, 17]] = [np.nan, np.inf, -np.inf]
    keep = rng.random(50) > 0.2
    w = resample_to_grid(ts[keep], vals[keep], 0, 50 * STEP)
    h, c = resample_to_grid(ts, vals, 0, 40 * STEP), resample_to_grid(ts, vals, 40 * STEP,
                                                                      50 * STEP)
    x, m, n_h, n_c = _joint_grid([w, h], [c, c])
    assert (n_h, n_c) == (40, 10) and not m.all()
    assert np.isfinite(x).all() and (x[~m] == 0.0).all()


# -------------------------------------- the reference's scenarios on the port
def _corr_pair(rng, n, rho=0.98, mu=(10.0, 5.0), scale=(1.0, 0.5)):
    z1 = rng.normal(size=n)
    z2 = rho * z1 + np.sqrt(1 - rho**2) * rng.normal(size=n)
    return mu[0] + scale[0] * z1, mu[1] + scale[1] * z2


def _score(x1, x2, n_h, thr, *extra):
    x1 = np.asarray(x1)[None].astype(np.float32)
    x2 = np.asarray(x2)[None].astype(np.float32)
    m = np.ones_like(x1, bool)
    region = np.zeros_like(m)
    region[:, n_h:] = True
    return bivariate_normal_anomalies(x1, m, x2, m, region, np.asarray([thr], np.float32),
                                      *extra, device="cpu")


def test_joint_anomaly_invisible_to_marginals():
    rng = np.random.default_rng(0)
    x1h, x2h = _corr_pair(rng, 400)
    z1 = rng.normal(size=40)
    z2 = -0.98 * z1 + np.sqrt(1 - 0.98**2) * rng.normal(size=40)
    x1c, x2c = 10.0 + 2.0 * z1, 5.0 + 1.0 * z2
    out = _score(np.concatenate([x1h, x1c]), np.concatenate([x2h, x2c]), 400, 3.0)
    assert int(out["count"][0]) >= 5
    inside = np.abs(x1c - x1h.mean()) < 3 * x1h.std()
    assert inside.mean() > 0.5


def test_healthy_current_not_flagged():
    rng = np.random.default_rng(1)
    x1h, x2h = _corr_pair(rng, 400)
    x1c, x2c = _corr_pair(rng, 40)
    out = _score(np.concatenate([x1h, x1c]), np.concatenate([x2h, x2c]), 400, 4.0)
    assert int(out["count"][0]) <= 1


def test_fail_open_without_history():
    x = np.ones((1, 10), np.float32)
    m = np.ones((1, 10), bool)
    region = np.ones((1, 10), bool)
    region[0, 0] = False  # a single history point: not judgeable
    out = bivariate_normal_anomalies(x * 100, m, x, m, region, np.asarray([2.0], np.float32),
                                     device="cpu")
    assert int(out["count"][0]) == 0 and int(out["first_index"][0]) == -1


def test_min_lower_bound_floors_marginal_band():
    rng = np.random.default_rng(2)
    x1h, x2h = _corr_pair(rng, 200)
    out = _score(x1h, x2h, 150, 50.0, np.asarray([9.0], np.float32),
                 np.asarray([4.0], np.float32))
    assert float(out["lower1"].min()) >= 9.0
    assert float(out["lower2"].min()) >= 4.0


def test_bound_bitmask_upper_only_ignores_improvement_dips():
    rng = np.random.default_rng(5)
    x1h, x2h = _corr_pair(rng, 300)
    x1c = np.full(30, x1h.mean() - 8 * x1h.std())
    x2c = np.full(30, x2h.mean() - 8 * x2h.std())
    x1, x2 = np.concatenate([x1h, x1c]), np.concatenate([x2h, x2c])
    up, both = np.asarray([1], np.int32), np.asarray([3], np.int32)
    assert int(_score(x1, x2, 300, 3.0, None, None, up, up)["count"][0]) == 0
    assert int(_score(x1, x2, 300, 3.0, None, None, both, both)["count"][0]) == 30


def _two_metric_job(fixtures, rng, *, bad):
    n_h, n_c = 400, 40
    x1h, x2h = _corr_pair(rng, n_h)
    if bad:
        z1 = rng.normal(size=n_c)
        x1c, x2c = 10.0 + 2.0 * z1, 5.0 + 1.0 * z1 * -1.0  # correlation flipped
    else:
        x1c, x2c = _corr_pair(rng, n_c)
    h_ts = (np.arange(n_h) * STEP).tolist()
    c_ts = ((n_h + np.arange(n_c)) * STEP).tolist()
    fixtures.update({"h1": (h_ts, x1h.tolist()), "h2": (h_ts, x2h.tolist()),
                     "c1": (c_ts, x1c.tolist()), "c2": (c_ts, x2c.tolist())})
    return Document(id="bi", app_name="app", namespace="d", strategy="canary",
                    start_time=to_rfc3339(0), end_time=to_rfc3339(0),
                    metrics={"latency": MetricQueries(current="c1", historical="h1"),
                             "cpu": MetricQueries(current="c2", historical="h2")})


@pytest.mark.parametrize("bad,status", [(True, J.COMPLETED_UNHEALTH),
                                        (False, J.COMPLETED_HEALTH)], ids=["broken", "healthy"])
def test_engine_bivariate_mode(bad, status):
    rng = np.random.default_rng(3 if bad else 4)
    fixtures, store = {}, JobStore()
    store.create(_two_metric_job(fixtures, rng, bad=bad))
    cfg = EngineConfig(algorithm="bivariate_normal", threshold=4.0, policies={})
    out = Analyzer(cfg, FixtureDataSource(fixtures), store, device="cpu").run_cycle(
        now=100_000.0)
    assert out["bi"] == status
    if bad:
        assert "bivariate" in store.get("bi").reason
