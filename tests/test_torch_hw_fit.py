"""Port parity: foremast_tpu_torch.ops.forecast.fit_holt_winters (with
device="cpu", the plain twins of kernels D and C) against the JAX
reference's fit_holt_winters on the same numpy inputs.

The port carries its own copy of the reference's 60-point (alpha, beta,
gamma) grid, pinned here. Its squared errors are summed in float64, the
reference's in float32, so:
  * the chosen grid point must match exactly except on rows whose two best
    reference errors differ by less than 1e-5 relative (bracketed, as
    tests/test_triage.py:197-206 brackets band edges), or whose best error
    is float32 rounding noise (below (1e-6 * scale)^2);
  * the port's mean squared errors agree with the reference's per-candidate
    errors to 1e-5 relative, plus n * eps32 relative (the bound on the
    reference's float32 sum of n squared errors), plus (1e-6 * scale)^2;
  * on unbracketed rows the winner's predictions agree to 1e-5 * scale
    (scale = max(|x| over valid slots, 1)), as the smoothers do.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.ops import forecast as jfc  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402

REL = 1e-5


def test_grid_is_the_reference_grid():
    ref = np.asarray(jfc._default_grid())
    got = np.asarray(tfc.DEFAULT_GRID, np.float32)
    assert got.shape == ref.shape == (60, 3)
    np.testing.assert_array_equal(got, ref)


def _fleet(seed, B=8, T=240, period=12):
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    x = (rng.uniform(5, 50, (B, 1))
         + rng.uniform(0, 6, (B, 1)) * np.sin(2 * np.pi * t / period + rng.uniform(0, 6, (B, 1)))
         + rng.uniform(0.0, 0.03, (B, 1)) * t
         + rng.normal(0, 1, (B, T)) * rng.uniform(0.1, 2, (B, 1))).astype(np.float32)
    m = rng.random((B, T)) > 0.1
    m[1] = False
    x[2], m[2] = np.float32(33.25), True
    m[3, -40:] = False
    return x, m


def _reference_mse(x, m, fit, period):
    """(B, G) float32 mean squared errors of every grid candidate, as the
    reference's fit computes them."""
    B = x.shape[0]
    sel = fit & m
    n = np.maximum(sel.sum(-1), 1).astype(np.float32)
    out = []
    for a, b, g in np.asarray(jfc._default_grid()):
        p = np.asarray(jfc.holt_winters_predictions(
            x, m, period, np.full(B, a, np.float32), np.full(B, b, np.float32),
            np.full(B, g, np.float32)))
        r = np.where(sel, x - p, np.float32(0))
        out.append(np.sum(r * r, axis=-1, dtype=np.float32) / n)
    return np.stack(out, -1)


def _scale(x, m):
    return np.maximum(np.abs(np.where(m, x, 0.0)).max(1), 1.0)


def _tied(mse, scale):
    two = np.sort(mse.astype(np.float64), axis=1)[:, :2]
    return ((two[:, 1] - two[:, 0]) <= REL * two[:, 0]) | (two[:, 0] <= (1e-6 * scale) ** 2)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("period", [12, 24])
def test_fit_matches_reference(seed, period):
    x, m = _fleet(seed, period=period)
    fit = m.copy()
    fit[:, :2 * period] = False
    jparams, jpreds = jfc.fit_holt_winters(x, m, fit, period)
    params, preds = tfc.fit_holt_winters(x, m, fit, period, device="cpu")
    params, preds, jparams, jpreds = params.numpy(), preds.numpy(), np.asarray(jparams), np.asarray(jpreds)
    ref_mse = _reference_mse(x, m, fit, period)
    scale = _scale(x, m)
    tied = _tied(ref_mse, scale)
    assert tied.mean() < 0.5
    ok = ~tied
    np.testing.assert_array_equal(params[ok], jparams[ok])
    d = np.abs(preds[ok] - jpreds[ok])
    assert np.all(d <= 1e-5 * scale[ok, None])

    out = tfc.fit_holt_winters_plain(*map(torch.from_numpy, (x, m, fit)),
                                     torch.full((x.shape[0],), period, dtype=torch.int32),
                                     torch.tensor(tfc.DEFAULT_GRID, dtype=torch.float32))
    mse = out["mse"].numpy()
    n = (fit & m).sum(-1)[:, None] * np.finfo(np.float32).eps
    assert np.all(np.abs(mse - ref_mse) <= (REL + n) * np.abs(ref_mse) + (1e-6 * scale[:, None]) ** 2)
    np.testing.assert_array_equal(out["params"].numpy(), params)
    # the first minimum wins
    np.testing.assert_array_equal(out["best"].numpy(), np.argmin(mse, axis=1))


def test_per_row_period_matches_reference_partitions():
    x, m = _fleet(7, B=9, T=200, period=10)
    period = np.array([10, 10, 20, 5, 10, 20, 5, 10, 7], np.int32)
    fit = m & (np.arange(200)[None] >= 2 * period[:, None])
    params, preds = tfc.fit_holt_winters(x, m, fit, period, device="cpu")
    for p in np.unique(period):
        rows = period == p
        jparams, jpreds = jfc.fit_holt_winters(x[rows], m[rows], fit[rows], int(p))
        tied = _tied(_reference_mse(x[rows], m[rows], fit[rows], int(p)), _scale(x[rows], m[rows]))
        np.testing.assert_array_equal(params.numpy()[rows][~tied], np.asarray(jparams)[~tied])
        d = np.abs(preds.numpy()[rows][~tied] - np.asarray(jpreds)[~tied])
        assert np.all(d <= 1e-5 * _scale(x[rows], m[rows])[~tied, None])


def test_fit_beats_fixed_bad_params():
    P = 12
    t = np.arange(240)
    rng = np.random.default_rng(0)
    x = (10 + 5 * np.sin(2 * np.pi * t / P) + rng.normal(0, 0.2, t.size)).astype(np.float32)
    mask = np.ones_like(x, bool)
    fit = np.zeros_like(mask)
    fit[2 * P:] = True
    _, preds = tfc.fit_holt_winters(x[None], mask[None], fit[None], P, device="cpu")
    sse_fit = np.mean((preds.numpy()[0][fit] - x[fit]) ** 2)
    bad = tfc.holt_winters_predictions(x[None], mask[None], P, 0.9, 0.3, 0.05, device="cpu")
    assert sse_fit <= np.mean((bad.numpy()[0][fit] - x[fit]) ** 2) + 1e-6


def test_empty_fit_region_picks_the_first_candidate():
    # no fit point: every error is 0 over max(n, 1), and the first wins
    x, m = _fleet(3, B=4, T=30)
    params, _ = tfc.fit_holt_winters(x, m, np.zeros_like(m), 12, device="cpu")
    np.testing.assert_array_equal(params.numpy(), np.tile(np.float32(tfc.DEFAULT_GRID[0]), (4, 1)))


def test_nan_error_wins_the_argmin_as_in_jax():
    mse = torch.tensor([[3.0, float("nan"), 1.0, float("nan")], [2.0, 1.0, 1.0, 5.0]],
                       dtype=torch.float64)
    assert tfc._argmin_nan_first(mse).tolist() == [1, 1]
    assert np.asarray(jax.numpy.argmin(mse.numpy(), axis=1)).tolist() == [1, 1]


def test_plain_twin_in_row_chunks_equals_one_pass(monkeypatch):
    x, m = _fleet(4, B=7, T=60)
    fit = torch.from_numpy(m.copy())
    args = (torch.from_numpy(x), torch.from_numpy(m), fit,
            torch.tensor([12, 5, 12, 30, 2, 12, 7], dtype=torch.int32),
            torch.tensor(tfc.DEFAULT_GRID, dtype=torch.float32))
    whole = tfc.fit_holt_winters_plain(*args)
    monkeypatch.setattr(tfc, "_PLAIN_RING_BYTES", 2 * 60 * 30 * 4)  # chunks of 2 rows
    parts = tfc.fit_holt_winters_plain(*args)
    for k in whole:
        assert torch.equal(whole[k], parts[k]), k
