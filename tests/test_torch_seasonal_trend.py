"""Port parity: foremast_tpu_torch.ops.forecast.fit_seasonal_trend (with
device="cpu", the plain twin of kernel J) against the reference's
fit_seasonal_trend and a float64 numpy solve of the same normal equations.

Tolerances, with scale = max(|x| over the row's valid slots, 1):
  * columns: st_columns equals the reference's column expression as XLA
    compiles it within one float32 rounding of sin / cos (4e-7 absolute);
    the arguments themselves are equal;
  * twin vs the float64 numpy solve: preds within 1e-6 * scale (both solve
    in float64 from the same float32 columns); beta within 1e-6 relative
    where the penalised gram's condition number is below 1e6;
  * twin vs the reference: the reference sums its normal equations in
    float32 and solves them with a float32 LU, so its preds drift from the
    exact solution, by up to ~1.2e-3 * scale with 12 hinge columns at these
    shapes. Parity goes through the float64 solve, whose columns equal the
    compiled reference's: the reference's drift from it stays below
    2e-3 * scale, and so does the twin's distance to the reference;
  * ill-posed rows are bracketed: fewer fitted points than columns, or
    fitted points spanning less than one period. Their solution rests on
    the ridge alone, and the reference's float32 solve keeps no digit of
    it (off by 0.3-26 x scale at ridge 1e-8, NaN with one point: the
    system is singular in float32; its condition number reaches 1e9, so
    even the one-ulp differences of two float32 sines move the float64
    solution). The twin stays finite there (ROADMAP queue 3).
"""
from functools import partial

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from foremast_tpu.ops import forecast as jfc  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402

F32 = np.float32


def _design(T, period, order, C):
    """The design in numpy, rounded as the reference's compiled program
    rounds it (XLA turns each division by a constant into a product with
    its float32 reciprocal and folds the chain of constant factors)."""
    t = np.arange(T, dtype=F32)
    tn = t * F32(F32(1) / F32(max(T - 1, 1)))
    cols = [np.ones(T, F32), tn]
    knots = (np.arange(1, C + 1, dtype=F32) * F32(F32(1) / F32(C + 1))) * F32(0.8)
    cols += [np.maximum(tn - s, F32(0)) for s in knots]
    c1 = F32(F32(2 * np.pi) * F32(F32(1) / F32(period)))
    for k in range(1, order + 1):
        a = t * F32(c1 * F32(k))
        cols += [np.sin(a), np.cos(a)]
    return np.stack(cols, -1).astype(np.float64)


def _solve64(x, sel, X, order, C, ridge, l1_iters, cp_shrink=3e-3):
    """The reference's ridge + IRLS fit, float64 numpy, one row."""
    is_cp = np.zeros(X.shape[1])
    is_cp[2:2 + C] = 1.0
    G = (X * sel[:, None]).T @ X
    rhs = X.T @ np.where(sel, x, 0.0)
    A = G + np.diag(ridge + cp_shrink * is_cp)
    beta = np.linalg.solve(A, rhs)
    for _ in range(max(l1_iters - 1, 0) if C > 0 else 0):
        A = G + np.diag(ridge + cp_shrink * is_cp / (np.abs(beta) + 1e-3))
        beta = np.linalg.solve(A, rhs)
    return beta, X @ beta, np.linalg.cond(A)


def _rows(seed, T, period, B=10):
    """Seasonal rows with a trend and gaps, a kinked trend, a constant row,
    rows with no, one and three valid points, and a row whose history is
    shorter than one period; fit on the first 80% of the slots."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    x = (rng.uniform(10, 60, (B, 1)) + rng.uniform(1, 4, (B, 1))
         * np.sin(2 * np.pi * t / period + rng.uniform(0, 6, (B, 1)))
         + rng.uniform(-0.01, 0.01, (B, 1)) * t + rng.normal(0, 1, (B, T))).astype(F32)
    x[1] += np.where(t > T // 2, 0.05 * (t - T // 2), 0.0).astype(F32)
    x[2] = F32(42.5)
    m = rng.random((B, T)) > 0.1
    m[3] = False
    m[4] = False
    m[4, T // 3] = True
    m[5] = False
    m[5, [2, T // 2, T - 9]] = True
    m[6, max(period // 2, 2):] = False
    fit = np.zeros((B, T), bool)
    fit[:, :int(T * 0.8)] = True
    x = np.where(m, x, F32(0))
    x[7, 3] = np.nan  # a NaN at a masked slot: skipped, as the reference's select does
    m[7, 3] = False
    return x, m, fit


_PERIOD = {64: 16, 420: 60, 2048: 60}


@partial(jax.jit, static_argnames=("T", "period", "order"))
def _reference_arguments(zero, T, period, order):
    """The reference's Fourier arguments k * w, written as it writes them."""
    w = 2.0 * jnp.pi * jnp.arange(T, dtype=jnp.float32) / period
    return jnp.stack([k * w for k in range(1, order + 1)], -1) + zero


@pytest.mark.parametrize("T,period", [(64, 16), (2048, 7), (16384, 60), (16384, 1440)])
def test_columns_round_as_the_reference_compiled_program(T, period):
    X = tfc.st_columns(T, period, order=3, n_changepoints=12).double().numpy()
    want = _design(T, period, 3, 12)
    assert np.abs(X[:, :14] - want[:, :14]).max() == 0.0
    assert np.abs(X[:, 14:] - want[:, 14:]).max() <= 4e-7
    args = np.asarray(_reference_arguments(np.float32(0), T=T, period=period, order=3))
    t = np.arange(T, dtype=F32)
    c1 = F32(F32(2 * np.pi) * F32(F32(1) / F32(period)))
    mine = np.stack([t * F32(c1 * F32(k)) for k in (1, 2, 3)], -1)
    np.testing.assert_array_equal(mine, args)


@pytest.mark.parametrize("T", [64, 420, 2048])
@pytest.mark.parametrize("l1_iters", [1, 3])
@pytest.mark.parametrize("order", [1, 3])
@pytest.mark.parametrize("C", [0, 12])
def test_twin_matches_the_reference_and_a_float64_solve(C, order, l1_iters, T):
    period = _PERIOD[T]
    x, m, fit = _rows(T + 7 * C + order + l1_iters, T, period)
    B = x.shape[0]
    X = _design(T, period, order, C)
    scale = np.maximum(np.abs(np.where(m, x, 0)).max(1), 1.0)
    for ridge in (1e-4, 1e-8):
        beta, preds = tfc.fit_seasonal_trend(x, m, fit, period, order, ridge=ridge,
                                             n_changepoints=C, l1_iters=l1_iters, device="cpu")
        beta, preds = beta.numpy(), preds.numpy()
        _, ref = jfc.fit_seasonal_trend(x, m, fit, period, order, ridge=ridge,
                                        n_changepoints=C, l1_iters=l1_iters)
        ref = np.asarray(ref)
        assert beta.shape == (B, 2 + C + 2 * order) and preds.shape == (B, T)
        for i in range(B):
            b64, p64, cond = _solve64(x[i].astype(np.float64), m[i] & fit[i], X, order, C,
                                      ridge, l1_iters)
            sel = np.nonzero(m[i] & fit[i])[0]
            if sel.size < X.shape[1] or sel[-1] - sel[0] + 1 < period:
                assert np.isfinite(preds[i]).all(), (ridge, i)
                continue
            assert np.abs(preds[i] - p64).max() <= 1e-6 * scale[i], (ridge, i)
            if cond < 1e6:
                np.testing.assert_allclose(beta[i], b64, rtol=1e-6,
                                           atol=1e-6 * np.abs(b64).max())
            drift = np.abs(ref[i] - p64).max()
            assert drift <= 2e-3 * scale[i], (ridge, i, drift / scale[i])
            assert np.abs(preds[i] - ref[i]).max() <= 2e-3 * scale[i], (ridge, i)
        # no valid point: beta = 0, preds = 0
        assert not beta[3].any() and not preds[3].any()


@pytest.mark.parametrize("T", [420, 2048])
@pytest.mark.parametrize("C,order", [(25, 3), (25, 10)], ids=["D33", "D47"])
def test_twin_past_32_columns_matches_the_reference_and_a_float64_solve(C, order, T):
    """The widths past the warp path's 32 columns: ST_CHANGEPOINTS=25 at the
    engine's ST_ORDER=3 (D = 33) and Prophet's defaults, 25 changepoints
    and order 10 (D = 47), at the tolerances above; ill-posed rows (R8)
    bracketed as above, and the reference's drift where the condition
    number passes 1e6 bracketed in proportion to it."""
    period = _PERIOD[T]
    x, m, fit = _rows(T + C + order, T, period)
    X = _design(T, period, order, C)
    scale = np.maximum(np.abs(np.where(m, x, 0)).max(1), 1.0)
    beta, preds = tfc.fit_seasonal_trend(x, m, fit, period, order, n_changepoints=C,
                                         device="cpu")
    beta, preds = beta.numpy(), preds.numpy()
    ref = np.asarray(jfc.fit_seasonal_trend(x, m, fit, period, order, n_changepoints=C)[1])
    assert beta.shape == (x.shape[0], 2 + C + 2 * order)
    checked = 0
    for i in range(x.shape[0]):
        b64, p64, cond = _solve64(x[i].astype(np.float64), m[i] & fit[i], X, order, C, 1e-4, 3)
        sel = np.nonzero(m[i] & fit[i])[0]
        if sel.size < X.shape[1] or sel[-1] - sel[0] + 1 < period:
            assert np.isfinite(preds[i]).all(), i
            continue
        assert np.abs(preds[i] - p64).max() <= 1e-6 * scale[i], i
        if cond < 1e6:
            np.testing.assert_allclose(beta[i], b64, rtol=1e-6, atol=1e-6 * np.abs(b64).max())
        # R8: the reference's float32 solve drifts with the penalised
        # gram's condition number, which 25 hinges push past 1e6; there its
        # drift is bracketed at the same 2e-3 * scale per 1e6 of it
        bound = 2e-3 * scale[i] * max(1.0, cond / 1e6)
        assert np.abs(ref[i] - p64).max() <= bound, (i, cond)
        assert np.abs(preds[i] - ref[i]).max() <= bound, (i, cond)
        checked += 1
    assert checked >= 5
    assert not beta[3].any() and not preds[3].any()


def test_per_row_periods_equal_one_call_per_period():
    """Kernel J's interface takes one period per row, where the reference
    takes one per call: a mixed batch equals the per-period calls."""
    T = 420
    x, m, fit = _rows(5, T, 60, B=12)
    period = np.array([60, 24, 7, 210] * 3, np.int32)
    beta, preds = tfc.fit_seasonal_trend(x, m, fit, period, 3, n_changepoints=12, device="cpu")
    for p in np.unique(period):
        idx = period == p
        b, q = tfc.fit_seasonal_trend(x[idx], m[idx], fit[idx], int(p), 3, n_changepoints=12,
                                      device="cpu")
        np.testing.assert_array_equal(beta.numpy()[idx], b.numpy())
        np.testing.assert_array_equal(preds.numpy()[idx], q.numpy())


# ports of the reference's behaviour tests (tests/test_forecast.py:236-400)
def test_seasonal_trend_recovers_signal():
    B, T, period = 3, 256, 32
    t = np.arange(T, dtype=F32)
    rng = np.random.default_rng(0)
    x = np.stack([rng.normal(5, 1) + rng.normal(0.02, 0.01) * t
                  + rng.normal(2, 0.2) * np.sin(2 * np.pi * t / period)
                  for _ in range(B)]).astype(F32)
    mask = np.ones((B, T), bool)
    fit = mask.copy()
    fit[:, -32:] = False
    _, preds = tfc.fit_seasonal_trend(x, mask, fit, period, order=3, device="cpu")
    np.testing.assert_allclose(preds.numpy()[:, -32:], x[:, -32:], atol=0.05)


def test_seasonal_trend_matches_numpy_lstsq():
    B, T, period, order = 2, 128, 24, 2
    rng = np.random.default_rng(1)
    x = rng.normal(10, 2, (B, T)).astype(F32)
    mask = rng.random((B, T)) > 0.2
    _, preds = tfc.fit_seasonal_trend(x, mask, mask, period, order=order, ridge=1e-8,
                                      device="cpu")
    X = _design(T, period, order, 0)
    for b in range(B):
        sel = mask[b]
        beta, *_ = np.linalg.lstsq(X[sel], x[b, sel], rcond=None)
        # float64 on both sides: far tighter than the reference's 1e-2
        np.testing.assert_allclose(preds.numpy()[b], X @ beta, atol=1e-5)


def test_seasonal_trend_sparse_series_stays_finite():
    x = np.zeros((1, 64), F32)
    mask = np.zeros((1, 64), bool)
    mask[0, 5] = True
    _, preds = tfc.fit_seasonal_trend(x, mask, mask, 16, device="cpu")
    assert torch.isfinite(preds).all()


def _kinked(T=420, period=60):
    t = np.arange(T, dtype=F32)
    trend = np.where(t < 140, 10.0, np.where(t < 280, 10.0 + 0.08 * (t - 140),
                                             10.0 + 0.08 * 140 - 0.10 * (t - 280)))
    season = 1.5 * np.sin(2 * np.pi * t / period)
    rng = np.random.default_rng(0)
    return (trend + season + rng.normal(0, 0.25, T)).astype(F32)[None]


def test_changepoint_fit_recovers_kinked_trend():
    x = _kinked()
    mask = np.ones(x.shape, bool)
    _, flat = tfc.fit_seasonal_trend(x, mask, mask, 60, 3, n_changepoints=0, device="cpu")
    _, kinked = tfc.fit_seasonal_trend(x, mask, mask, 60, 3, n_changepoints=12, device="cpu")

    def rms(p):
        return float(np.sqrt(np.mean((p.numpy()[0] - x[0]) ** 2)))
    assert rms(kinked) < 0.6 * rms(flat), (rms(kinked), rms(flat))
    assert rms(kinked) < 0.6
    assert rms(flat) > 1.0


def test_changepoint_band_catches_anomaly_the_flat_fit_is_blind_to():
    T, period, region_len = 420, 60, 30
    t = np.arange(T, dtype=F32)
    trend = np.where(t < 200, 20.0, 20.0 + 0.09 * (t - 200))
    x = (trend + 1.0 * np.sin(2 * np.pi * t / period)
         + np.random.default_rng(1).normal(0, 0.2, T)).astype(F32)[None]
    x[:, -region_len:] += 1.2
    mask = np.ones((1, T), bool)
    region = np.zeros((1, T), bool)
    region[:, -region_len:] = True
    hist = mask & ~region
    policy = (np.float32([3.0]), np.int32([tfc.BOUND_BOTH]), np.float32([0.0]))

    def verdict(n_cp):
        _, preds = tfc.fit_seasonal_trend(x, hist, hist, period, 3, n_changepoints=n_cp,
                                          device="cpu")
        out = tfc.band_from_preds(x, mask, region, preds, *policy, device="cpu")
        return int(out["count"][0]), float(out["sigma"][0])

    n_kinked, sig_kinked = verdict(12)
    n_flat, sig_flat = verdict(0)
    assert sig_flat > 5 * sig_kinked
    assert n_kinked >= 10
    assert n_flat <= 2


def test_seasonal_band_verdicts_equal_the_reference_s_on_the_smoke_generator():
    """chip_smoke.py's seasonal rows (7 days of 60 s history + 60 current
    points in bucket 16384, a +8 sigma shift in 10% of the rows) through
    the reference's band launch as its engine makes it under
    ML_ALGORITHM=seasonal_trend (detect_period with the engine's knobs,
    fit_seasonal_trend once per detected period, residual_sigma,
    band_anomalies) and through the port's forecast_band: the engine's
    verdicts are equal on every row, and neither flags more than 1% of the
    healthy rows."""
    import chip_smoke as cs
    from foremast_tpu.engine.config import EngineConfig

    gen = torch.Generator().manual_seed(cs.SEED)
    args, _, shifted = cs.season_inputs(gen, rows=192, dev="cpu")
    x, m, region, thr, mode, mlb = (a.numpy() for a in args)
    shifted = shifted.numpy()
    cfg = EngineConfig(algorithm="seasonal_trend")
    hist = m & ~region
    period, _ = jfc.detect_period(
        x, hist, tuple(p for p in cfg.hw_period_candidates if p >= 2),
        np.int32(min(cfg.hw_period, max(x.shape[1] // 2, 2))),
        np.float32(cfg.hw_min_seasonal_acf), alias_margin=np.float32(cfg.hw_alias_margin),
        contrast_margin=np.float32(cfg.hw_contrast_margin))
    period = np.asarray(period)
    count, checked = np.zeros(len(x), np.int64), np.zeros(len(x), np.int64)
    for p in np.unique(period):
        i = np.nonzero(period == p)[0]
        _, preds = jfc.fit_seasonal_trend(x[i], hist[i], hist[i], int(p), cfg.st_order,
                                          n_changepoints=cfg.st_changepoints)
        sigma = jfc.residual_sigma(x[i], preds, hist[i], ~region[i])
        out = jfc.band_anomalies(x[i], m[i], region[i], preds, sigma, thr[i], mode[i], mlb[i])
        count[i], checked[i] = np.asarray(out["count"]), np.asarray(out["checked"])

    def verdicts(count, checked):
        return count >= np.maximum(cs.BAND_VIOLATION_FRACTION * checked, cs.BAND_MIN_POINTS)

    ref = verdicts(count, checked)
    out = tfc.forecast_band(*args, algorithm="seasonal_trend", device="cpu")
    np.testing.assert_array_equal(out["period"].numpy(), period)
    mine = verdicts(out["count"].numpy(), out["checked"].numpy())
    np.testing.assert_array_equal(mine, ref)
    assert shifted.sum() >= 10 and ref[shifted].mean() >= 0.99
    assert ref[~shifted].mean() <= 0.01


def test_entry_point_checks_and_runs_on_the_card_by_default():
    x, m, fit = _rows(0, 64, 16)
    with pytest.raises(ValueError, match="period"):
        tfc.fit_seasonal_trend(x, m, fit, np.int32([16, 16, 16]), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tfc.fit_seasonal_trend(x, m, fit, 16)
