"""Port parity: the sequential smoothers of foremast_tpu_torch.ops.forecast
(ses_predictions, des_predictions, holt_winters_predictions; with
device="cpu", the plain twin of kernel C) against the JAX reference on the
same numpy inputs.

Tolerance: |port - ref| <= 1e-5 * scale, scale = max(|x| over the row's
valid slots, 1). Both packages run the same float32 recurrences in the
same order; they differ only where XLA sums or fuses in another order
(Holt-Winters' initial level is a masked mean), which moves a prediction
by a few ulps of the row's scale (measured ~3e-7 * scale).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.ops import forecast as jfc  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402

RTOL = 1e-5


def _series(seed, B=10, T=96, period=12):
    """Seasonal rows with random gaps, a leading gap, a trailing gap (the
    model free-runs), an all-masked row, a one-point row, a constant row
    and a NaN at a masked slot (a masked step must not read it)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    x = (20 + 4 * np.sin(2 * np.pi * t / period)[None]
         + rng.normal(0, 1, (B, T)) + rng.uniform(-5, 5, (B, 1))).astype(np.float32)
    m = rng.random((B, T)) > 0.15
    m[1, :T // 3] = False
    m[2, -T // 4:] = False
    m[3] = False
    m[4] = False
    m[4, T // 2] = True
    x[5], m[5] = np.float32(60.42), True
    m[6, 7] = False
    x[6, 7] = np.nan
    return x, m


def _params(seed, B):
    rng = np.random.default_rng(seed + 100)
    return (rng.uniform(0.05, 0.95, B).astype(np.float32),
            rng.uniform(0.0, 0.4, B).astype(np.float32),
            rng.uniform(0.05, 0.6, B).astype(np.float32))


def _scale(x, m):
    return np.maximum(np.nanmax(np.abs(np.where(m, x, 0.0)), axis=1), 1.0)[:, None]


def _close(got, ref, x, m):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    d = np.abs(np.nan_to_num(got) - np.nan_to_num(ref))
    assert np.all(d <= RTOL * _scale(x, m)), float(d.max())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T", [64, 512])
def test_ses_matches_reference(seed, T):
    x, m = _series(seed, T=T)
    a, _, _ = _params(seed, x.shape[0])
    _close(tfc.ses_predictions(x, m, a, device="cpu").numpy(), jfc.ses_predictions(x, m, a), x, m)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T", [64, 512])
def test_des_matches_reference(seed, T):
    x, m = _series(seed, T=T)
    a, b, _ = _params(seed, x.shape[0])
    _close(tfc.des_predictions(x, m, a, b, device="cpu").numpy(),
           jfc.des_predictions(x, m, a, b), x, m)


@pytest.mark.parametrize("period", [1, 3, 12, 50, 96, 200])
def test_holt_winters_matches_reference_at_each_static_period(period):
    x, m = _series(period, T=96)
    a, b, g = _params(period, x.shape[0])
    got = tfc.holt_winters_predictions(x, m, period, a, b, g, device="cpu").numpy()
    _close(got, jfc.holt_winters_predictions(x, m, period, a, b, g), x, m)


def test_holt_winters_per_row_period_matches_reference_partitions():
    # the port takes a (B,) period; the reference runs each period as a
    # static partition
    x, m = _series(7, B=12, T=200, period=24)
    a, b, g = _params(7, 12)
    period = np.array([24, 24, 48, 5, 2, 24, 7, 100, 200, 250, 24, 33], np.int32)
    got = tfc.holt_winters_predictions(x, m, period, a, b, g, device="cpu").numpy()
    for p in np.unique(period):
        rows = period == p
        ref = jfc.holt_winters_predictions(x[rows], m[rows], int(p), a[rows], b[rows], g[rows])
        _close(got[rows], ref, x[rows], m[rows])


def test_scalar_parameters_broadcast_over_rows():
    x, m = _series(3)
    B = x.shape[0]
    full = np.full(B, 0.4, np.float32)
    np.testing.assert_array_equal(tfc.ses_predictions(x, m, 0.4, device="cpu").numpy(),
                                  tfc.ses_predictions(x, m, full, device="cpu").numpy())
    np.testing.assert_array_equal(
        tfc.holt_winters_predictions(x, m, 12, 0.4, 0.1, 0.2, device="cpu").numpy(),
        tfc.holt_winters_predictions(x, m, np.full(B, 12, np.int32), full,
                                     np.full(B, 0.1, np.float32), np.full(B, 0.2, np.float32),
                                     device="cpu").numpy())


def _np_hw(x, m, P, a, b, g):
    """Float64 loop over the documented additive Holt-Winters semantics."""
    T = len(x)
    P = min(P, T)
    first = m[:P]
    lvl = np.sum(np.where(first, x[:P], 0.0)) / max(first.sum(), 1)
    season = np.where(first, x[:P] - lvl, 0.0).astype(np.float64)
    trend, out = 0.0, np.zeros(T)
    for t in range(T):
        s = season[t % P]
        out[t] = lvl + trend + s
        if m[t]:
            ln = a * (x[t] - s) + (1 - a) * (lvl + trend)
            trend = b * (ln - lvl) + (1 - b) * trend
            season[t % P] = g * (x[t] - ln) + (1 - g) * s
            lvl = ln
        else:
            lvl = lvl + trend
    return out


def test_holt_winters_matches_a_float64_loop():
    x, m = _series(11, B=8, T=120, period=10)
    a, b, g = _params(11, 8)
    got = tfc.holt_winters_predictions(x, m, 10, a, b, g, device="cpu").numpy()
    for i in range(8):
        if not m[i].any():
            continue
        ref = _np_hw(x[i].astype(np.float64), m[i], 10, float(a[i]), float(b[i]), float(g[i]))
        np.testing.assert_allclose(got[i], ref, rtol=1e-4, atol=1e-4 * _scale(x, m)[i, 0])


def test_masked_steps_carry_the_state_and_hold_on_an_all_masked_row():
    x = np.array([[1.0, 2.0, 100.0, 4.0, 0.0, 0.0], [5.0] * 6], np.float32)
    m = np.array([[True, True, False, True, False, False], [False] * 6])
    p = tfc.ses_predictions(x, m, 0.5, device="cpu").numpy()
    np.testing.assert_allclose(p[0], [1.0, 1.0, 1.5, 1.5, 2.75, 2.75])  # 100 never enters
    np.testing.assert_array_equal(p[1], 0.0)  # no valid value: the state starts at 0
    d = tfc.des_predictions(x, m, 0.5, 0.0, device="cpu").numpy()
    np.testing.assert_array_equal(d[1], 0.0)
    assert torch.is_tensor(tfc.ses_predictions(x, m, 0.5, device="cpu"))
