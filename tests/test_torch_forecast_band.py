"""Port parity: foremast_tpu_torch.ops.forecast.forecast_band (with
device="cpu", the plain twins) against the reference engine's band launch:
Analyzer._detect_periods, Analyzer._predict under each algorithm, then the
body of _launch_bands' band_fn (residual_sigma over the history,
band_anomalies over the region), rows partitioned by period as
_launch_period_partitions does.

Tolerances, with scale = max(|x| over the row's valid slots, 1):
  * period: exact (the fleets have unambiguous periods);
  * preds: 1e-5 * scale (the smoothers' tolerance); Holt-Winters rows
    whose chosen (alpha, beta, gamma) differ must be near-ties, their two
    float64 errors within 1e-5 relative, and are not compared further;
    seasonal_trend 2e-3 * scale, the drift of the reference's float32
    normal equations from the exact solution (tests/test_torch_seasonal_trend.py
    holds the twin to a float64 solve within 1e-6 * scale);
  * sigma: the largest preds difference plus 1e-5 relative;
  * band count: bracketed, a point within the preds and sigma tolerance of
    a band edge may fall either way; flags and first index match where the
    bracket is exact; checked exactly.
"""
import inspect
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.engine.analyzer import Analyzer  # noqa: E402
from foremast_tpu.engine.config import EngineConfig  # noqa: E402
from foremast_tpu.ops import forecast as jfc  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402
from foremast_tpu_torch.ops import seqscan as tsq  # noqa: E402

ALGOS = ("exponential_smoothing", "double_exponential", "holt_winters")
KNOBS = ("algorithm", "ma_window", "long_window_steps", "hw_period", "hw_period_auto",
         "hw_period_candidates", "hw_min_seasonal_acf", "hw_alias_margin",
         "hw_contrast_margin", "st_order", "st_changepoints")


def test_defaults_are_engine_configs():
    params = inspect.signature(tfc.forecast_band).parameters
    cfg = EngineConfig()
    for k in KNOBS:
        assert params[k].default == getattr(cfg, k), k


def _reference(x, m, region, thr, mode, mlb, **cfg):
    """The reference engine's band launch for one bucket."""
    fake = types.SimpleNamespace(config=EngineConfig(**cfg))
    fake._needs_period = lambda: Analyzer._needs_period(fake)
    fake._score_chunks = lambda fn, arrays: {k: np.asarray(v) for k, v in fn(*arrays).items()}
    T = x.shape[1]

    def band_fn(idx, period):
        xv, xm, reg = x[idx], m[idx], region[idx]
        preds, hist = Analyzer._predict(fake, xv, xm, reg, T, period_override=period)
        sigma = np.asarray(jfc.residual_sigma(xv, preds, hist, ~reg))
        out = jfc.band_anomalies(xv, xm, reg, preds, sigma, thr[idx], mode[idx], mlb[idx])
        out = {k: np.asarray(v) for k, v in out.items()}
        out["preds"], out["sigma"] = np.asarray(preds), sigma
        return out

    chosen = Analyzer._detect_periods(fake, x, m, region)
    if chosen is None:
        return band_fn(np.arange(x.shape[0]), None), None
    res = {}
    for p in np.unique(chosen):
        idx = np.nonzero(chosen == p)[0]
        sub = band_fn(idx, int(p))
        for k, v in sub.items():
            res.setdefault(k, np.empty((x.shape[0],) + v.shape[1:], v.dtype))[idx] = v
    return res, chosen


def _fleet(seed, B=12, T=512, n_hist=400, n_cur=60):
    """Rows of period 24 or 48 or none (with a trend), gaps, one row with
    no history, a +6 sigma level shift in a third of the current windows."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    per = rng.choice([24, 48, 0], B)
    amp = np.where(per > 0, rng.uniform(2, 4, B), 0.0)
    x = (rng.uniform(10, 60, (B, 1))
         + amp[:, None] * np.sin(2 * np.pi * t[None] / np.maximum(per, 1)[:, None])
         + np.where(per == 0, rng.uniform(-0.005, 0.005, B), 0.0)[:, None] * t
         + rng.normal(0, 1, (B, T))).astype(np.float32)
    m = (t[None] < n_hist + n_cur) & (rng.random((B, T)) > 0.05)
    m[1, :n_hist] = False
    region = np.zeros((B, T), bool)
    region[:, n_hist:n_hist + n_cur] = True
    x[::3] += np.float32(6.0) * region[::3]
    x = np.where(m, x, np.float32(0))
    thr = rng.choice([2.0, 3.0, 5.0], B).astype(np.float32)
    mode = (np.arange(B) % 4).astype(np.int32)
    mlb = np.zeros(B, np.float32)
    return x, m, region, thr, mode, mlb


def _bracket(x, m, region, upper, lower, mode, tol):
    mode = np.where(mode == 0, 3, mode)[:, None]
    sel = m & region
    up_on, lo_on = (mode & 1) > 0, (mode & 2) > 0
    sure = ((x > upper + tol) & up_on) | ((x < lower - tol) & lo_on)
    maybe = ((x > upper - tol) & up_on) | ((x < lower + tol) & lo_on)
    return (sure & sel).sum(1), (maybe & sel).sum(1)


def _compare(got, ref, x, m, region, thr, mode, hist_period=None, rtol=1e-5):
    B = x.shape[0]
    scale = np.maximum(np.abs(np.where(m, x, 0.0)).max(1), 1.0)
    np.testing.assert_array_equal(got["checked"], ref["checked"])
    skip = np.zeros(B, bool)
    if "params" in got:
        diff = np.any(got["params"] != ref["params"], axis=1)
        if diff.any():
            # a differing choice must be a near-tie of the port's own errors
            hist = m & ~region
            P = torch.from_numpy(hist_period.astype(np.int32))
            fit = torch.from_numpy(hist & (np.arange(x.shape[1])[None] >= 2 * hist_period[:, None]))
            grid = torch.tensor(tfc.DEFAULT_GRID, dtype=torch.float32)
            mse = tfc.fit_holt_winters_plain(torch.from_numpy(x), torch.from_numpy(hist), fit,
                                             P, grid)["mse"].numpy()
            for i in np.nonzero(diff)[0]:
                a = [int(np.nonzero(np.all(grid.numpy() == p, 1))[0][0])
                     for p in (got["params"][i], ref["params"][i])]
                assert abs(mse[i, a[0]] - mse[i, a[1]]) <= 1e-5 * mse[i].min(), i
        skip = diff
    d = np.abs(got["preds"] - ref["preds"]).max(1)
    assert np.all(d[~skip] <= rtol * scale[~skip])
    for i in np.nonzero(~skip)[0]:
        rs, gs = ref["sigma"][i], got["sigma"][i]
        if not np.isfinite(rs):
            assert not np.isfinite(gs)
            assert got["count"][i] == ref["count"][i] == 0
            continue
        assert abs(gs - rs) <= d[i] + 1e-5 * rs, i
        tol = d[i] + thr[i] * (d[i] + 1e-5 * rs) + 1e-6 * scale[i]
        lo, hi = _bracket(x[i:i + 1], m[i:i + 1], region[i:i + 1], ref["upper"][i:i + 1],
                          ref["lower"][i:i + 1], mode[i:i + 1], tol)
        assert lo[0] <= got["count"][i] <= hi[0], i
        if lo[0] == hi[0]:
            np.testing.assert_array_equal(got["flags"][i], ref["flags"][i])
            assert got["first_index"][i] == ref["first_index"][i]
    return skip


@pytest.mark.parametrize("algorithm", ALGOS)
@pytest.mark.parametrize("seed", range(2))
def test_forecast_band_matches_reference_engine(algorithm, seed):
    x, m, region, thr, mode, mlb = _fleet(seed)
    cfg = dict(algorithm=algorithm, hw_period=48, hw_period_candidates=(12, 24, 48, 96))
    ref, chosen = _reference(x, m, region, thr, mode, mlb, **cfg)
    out = tfc.forecast_band(x, m, region, thr, mode, mlb, device="cpu", **cfg)
    got = {k: v.numpy() for k, v in out.items()}
    assert set(got) >= {"preds", "sigma", "upper", "lower", "flags", "count", "first_index",
                        "checked"}
    if algorithm == "holt_winters":
        np.testing.assert_array_equal(got["period"], chosen)
        ref["params"] = np.empty((x.shape[0], 3), np.float32)
        for p in np.unique(chosen):  # the reference's fit on each partition
            idx = chosen == p
            hist = m[idx] & ~region[idx]
            fit = hist.copy()
            fit[:, :2 * p] = False
            ref["params"][idx] = np.asarray(jfc.fit_holt_winters(x[idx], hist, fit, int(p))[0])
    skip = _compare(got, ref, x, m, region, thr, mode, chosen)
    assert skip.mean() <= 0.25
    assert got["count"].sum() > 0


@pytest.mark.parametrize("algorithm", ALGOS)
def test_long_window_gate_at_4096(algorithm, monkeypatch):
    """At T >= long_window_steps exponential smoothing takes the affine
    scan, below it the sequential smoother; DES and Holt-Winters stay
    sequential. Both packages, T = 4096, three rows."""
    calls = []
    real = tsq._ses_assoc
    monkeypatch.setattr(tsq, "_ses_assoc", lambda *a: calls.append(1) or real(*a))
    x, m, region, thr, mode, mlb = _fleet(11, B=3, T=4096, n_hist=3600, n_cur=60)
    cfg = dict(algorithm=algorithm)
    ref, chosen = _reference(x, m, region, thr, mode, mlb, **cfg)
    out = tfc.forecast_band(x, m, region, thr, mode, mlb, device="cpu", **cfg)
    got = {k: v.numpy() for k, v in out.items()}
    assert len(calls) == (algorithm == "exponential_smoothing")
    if algorithm == "holt_winters":
        np.testing.assert_array_equal(got["period"], chosen)
        ref["params"] = got["params"]  # compared through the predictions
    _compare(got, ref, x, m, region, thr, mode, chosen)
    calls.clear()
    tfc.forecast_band(x[:, :2048], m[:, :2048], region[:, :2048], thr, mode, mlb,
                      algorithm=algorithm, device="cpu")
    assert not calls


def test_moving_average_is_kernel_bs_chain():
    x, m, region, thr, mode, mlb = _fleet(3)
    got = tfc.forecast_band(x, m, region, thr, mode, mlb, ma_window=20, device="cpu")
    want = tfc.moving_average_band(x, m, region, 20, thr, mode, mlb, device="cpu")
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_static_period_without_auto_detection():
    x, m, region, thr, mode, mlb = _fleet(4, T=256, n_hist=180)
    for kw in (dict(hw_period_auto=False), dict(hw_period_candidates=())):
        out = tfc.forecast_band(x, m, region, thr, mode, mlb, algorithm="holt_winters",
                                hw_period=400, device="cpu", **kw)
        # the fallback: min(hw_period, max(T // 2, 2))
        np.testing.assert_array_equal(out["period"].numpy(), 128)


@pytest.mark.parametrize("algorithm", ["seasonal_trend", "prophet_daily"])
def test_unported_algorithms_raise(algorithm):
    """Once unported, now kernel J's path: seasonal_trend (the engine's
    defaults, 12 hinges) and prophet_daily (a plain trend, order 2) run the
    period per row, the fit over the whole history and the band, equal to
    the reference's band launch partitioned by period."""
    x, m, region, thr, mode, mlb = _fleet(7 + len(algorithm))
    cfg = dict(algorithm=algorithm, hw_period=48, hw_period_candidates=(12, 24, 48, 96))
    if algorithm == "prophet_daily":
        cfg.update(st_order=2, st_changepoints=0)
    ref, chosen = _reference(x, m, region, thr, mode, mlb, **cfg)
    out = tfc.forecast_band(x, m, region, thr, mode, mlb, device="cpu", **cfg)
    got = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(got["period"], chosen)
    D = 2 + cfg.get("st_changepoints", 12) + 2 * cfg.get("st_order", 3)
    assert got["beta"].shape == (x.shape[0], D)
    _compare(got, ref, x, m, region, thr, mode, rtol=2e-3)
    assert got["count"].sum() > 0


def test_band_from_preds_is_the_reference_chain():
    x, m, region, thr, mode, mlb = _fleet(5)
    preds = (x + np.random.default_rng(5).normal(0, 1, x.shape)).astype(np.float32)
    hist = m & ~region
    sigma = jfc.residual_sigma(x, preds, hist, ~region)
    ref = jfc.band_anomalies(x, m, region, preds, sigma, thr, mode, mlb)
    got = tfc.band_from_preds(x, m, region, preds, thr, mode, mlb, device="cpu")
    np.testing.assert_allclose(got["sigma"].numpy(), np.asarray(sigma), rtol=1e-6)
    for k in ("flags", "count", "first_index", "checked"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
