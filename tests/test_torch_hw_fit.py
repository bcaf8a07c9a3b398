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


# Kernel D walks each row only up to its last (mask & fit) slot. What rests
# on that: no slot after it enters any candidate's error, in the reference
# or in the twin, so changing x and mask there (fit stays unset) leaves every
# error and the argmin as they were, bit for bit. The first period is read
# whole whatever the fit (the initial level is its masked mean), so a row
# whose last fit slot lies inside it changes only after it.
CUT_T = 160
CUT_PERIODS = np.array([12, 24, 5, 12, 7, 12, 24], np.int32)


def _cut_rows(seed):
    """Rows of three periods, each fitted from 2 periods on up to a last
    slot of its own: the row's end, mid-row, a row whose last (and only)
    fit slot is its first slot, one with no fit slot at all."""
    x, m = _fleet(seed, B=len(CUT_PERIODS), T=CUT_T, period=12)
    m[1] = True  # _fleet masks row 1 out; keep it observed here
    t = np.arange(CUT_T)
    fit = m & (t[None] >= 2 * CUT_PERIODS[:, None])
    last = np.array([CUT_T - 1, 120, 97, 0, -1, 75, 150])
    fit &= t[None] <= last[:, None]
    fit[3] = False
    fit[3, 0] = m[3, 0] = True
    fit[4] = False
    got = np.where((fit & m).any(1), CUT_T - 1 - np.argmax((fit & m)[:, ::-1], axis=1), -1)
    np.testing.assert_array_equal(got, last)
    return x, m, fit, last


def _cut_end(last):
    """Each row's slots from here on enter nothing: after its last fit slot
    and after its first period."""
    return np.maximum(last + 1, CUT_PERIODS)


def _perturb_after(x, m, last, seed):
    """x and mask changed at random after each row's last fit slot (and
    its first period): NaN, +-inf, large values, mask set and cleared."""
    rng = np.random.default_rng(seed)
    x2, m2 = x.copy(), m.copy()
    for r, lt in enumerate(_cut_end(last) - 1):
        n = CUT_T - lt - 1
        if n == 0:
            continue
        v = rng.normal(0, 1e4, n).astype(np.float32)
        v[rng.random(n) < 0.1] = np.nan
        v[rng.random(n) < 0.05] = np.inf
        v[rng.random(n) < 0.05] = -np.inf
        x2[r, lt + 1:] = v
        m2[r, lt + 1:] = rng.random(n) < 0.5
    return x2, m2


def _reference_fit(x, m, fit):
    """The reference's per-candidate float32 errors and its chosen grid
    point, row by row under each row's period."""
    mse = np.zeros((x.shape[0], len(tfc.DEFAULT_GRID)), np.float32)
    params = np.zeros((x.shape[0], 3), np.float32)
    for p in np.unique(CUT_PERIODS):
        rows = CUT_PERIODS == p
        with np.errstate(invalid="ignore"):  # inf - inf at the scrambled, masked-out slots
            mse[rows] = _reference_mse(x[rows], m[rows], fit[rows], int(p))
        params[rows] = np.asarray(jfc.fit_holt_winters(x[rows], m[rows], fit[rows], int(p))[0])
    return mse, params


def _twin_fit(x, m, fit):
    return tfc.fit_holt_winters_plain(*map(torch.from_numpy, (x, m, fit)),
                                      torch.from_numpy(CUT_PERIODS),
                                      torch.tensor(tfc.DEFAULT_GRID, dtype=torch.float32))


@pytest.mark.parametrize("seed", range(2))
def test_slots_after_the_last_fit_slot_change_no_error_in_the_reference(seed):
    x, m, fit, last = _cut_rows(seed)
    x2, m2 = _perturb_after(x, m, last, seed + 100)
    assert not np.array_equal(np.nan_to_num(x2), np.nan_to_num(x))
    mse, params = _reference_fit(x, m, fit)
    mse2, params2 = _reference_fit(x2, m2, fit)
    np.testing.assert_array_equal(mse2.view(np.int32), mse.view(np.int32))
    np.testing.assert_array_equal(params2, params)
    # no fit slot: every error 0 and the first candidate
    assert not mse[4].any()
    np.testing.assert_array_equal(params[4], np.float32(tfc.DEFAULT_GRID[0]))
    # the row cut at its end: the same errors but for the float32 sum's
    # order (XLA reduces a shorter row in another tree)
    for r, n in enumerate(_cut_end(last)):
        cut = _reference_mse(x[r:r + 1, :n], m[r:r + 1, :n], fit[r:r + 1, :n],
                             int(CUT_PERIODS[r]))
        k = (fit[r] & m[r]).sum() * np.finfo(np.float32).eps
        assert np.all(np.abs(cut[0] - mse[r]) <= k * np.abs(mse[r])), r


@pytest.mark.parametrize("seed", range(2))
def test_slots_after_the_last_fit_slot_change_no_error_in_the_twin(seed):
    x, m, fit, last = _cut_rows(seed)
    x2, m2 = _perturb_after(x, m, last, seed + 200)
    base, moved = _twin_fit(x, m, fit), _twin_fit(x2, m2, fit)
    for k in base:
        assert torch.equal(moved[k], base[k]), k
    assert not base["mse"][4].any() and int(base["best"][4]) == 0
    # the twin cut at each row's end gives the same errors
    for r, n in enumerate(_cut_end(last)):
        part = tfc.fit_holt_winters_plain(
            *(torch.from_numpy(a[r:r + 1, :n].copy()) for a in (x, m, fit)),
            torch.from_numpy(CUT_PERIODS[r:r + 1]),
            torch.tensor(tfc.DEFAULT_GRID, dtype=torch.float32))
        assert torch.equal(part["mse"][0], base["mse"][r]), r


def test_the_twin_agrees_with_the_reference_on_rows_that_end_early():
    x, m, fit, _ = _cut_rows(3)
    mse, params = _reference_fit(x, m, fit)
    out = _twin_fit(x, m, fit)
    scale = _scale(x, m)
    n = (fit & m).sum(-1)[:, None] * np.finfo(np.float32).eps
    got = out["mse"].numpy()
    assert np.all(np.abs(got - mse) <= (REL + n) * np.abs(mse) + (1e-6 * scale[:, None]) ** 2)
    tied = _tied(mse, scale)
    np.testing.assert_array_equal(out["params"].numpy()[~tied], params[~tied])
