"""Port parity: the moving-average band family of
foremast_tpu_torch.ops.forecast against the JAX reference.

The port differences windowed sums of float64 prefix sums where the
reference differences float32 cumsums, so the reference carries the
rounding of those cumsums. Tolerances follow from it:
  * preds: |port - ref| <= 2 eps32 * sum|history x| of the row (the float32
    cumsum's rounding, measured at <= 0.64 of that), and the port matches
    a float64 loop over the documented semantics to float32 rounding;
  * sigma: the RMS residual moves by at most the largest preds difference;
  * band counts: bracketed, a point within the preds/sigma tolerance of a
    band edge may fall either way;
  * rows whose reference sigma is below 1e-5 * scale are constant-history
    rows, where the reference's sigma is cumsum noise: the port must give
    exactly 0 there.
Band logic alone, fed the same preds and sigma, matches exactly.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.ops import forecast as jfc  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def _series(seed, B=12, T=96, level=50.0):
    """Noisy rows with random gaps, a long gap (freeze-fill), a leading
    gap, an all-masked row, a one-observation row and a constant row."""
    rng = np.random.default_rng(seed)
    x = (level + rng.normal(0, 2, (B, T))).astype(np.float32)
    m = rng.random((B, T)) > 0.2
    m[1, T // 3: T // 3 + 40] = False
    m[2, :25] = False
    m[3] = False
    m[4] = False
    m[4, 10] = True
    x[5] = np.float32(60.42)
    m[5] = True
    return x, m


def _loop_ma(x, m, w):
    """Float64 loop over the documented moving-average semantics."""
    T = len(x)
    out = np.zeros(T)
    obs = np.nonzero(m)[0]
    for t in range(T):
        win = [x[u] for u in range(max(t - w, 0), t) if m[u]]
        if win:
            out[t] = np.mean(np.asarray(win, np.float64))
            continue
        prev = obs[obs < t]
        if len(prev):
            p = prev[-1] + 1
            out[t] = np.mean([x[u] for u in range(max(p - w, 0), p) if m[u]])
        else:
            out[t] = x[obs[0]] if len(obs) else 0.0
    return out


def _hist_abs_sum(x, m):
    return np.sum(np.abs(np.where(m, x, 0.0)), axis=1, dtype=np.float64)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("window", [1, 5, 30])
def test_moving_average_matches_reference_and_semantics(seed, window):
    x, m = _series(seed)
    got = tfc.moving_average_predictions(torch.from_numpy(x), torch.from_numpy(m), window).numpy()
    ref = np.asarray(jfc.moving_average_predictions(x, m, window))
    tol = 2 * EPS32 * _hist_abs_sum(x, m)[:, None] + 1e-6 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= tol)
    for i in range(x.shape[0]):
        np.testing.assert_allclose(got[i], _loop_ma(x[i], m[i], window), rtol=1e-6, atol=1e-6)


def test_moving_average_per_row_window_matches_scalar_windows():
    x, m = _series(4)
    w = np.array([1, 2, 5, 30, 7, 3, 9, 30, 4, 11, 6, 8], np.int32)
    got = tfc.moving_average_predictions(torch.from_numpy(x), torch.from_numpy(m),
                                         torch.from_numpy(w)).numpy()
    for i in range(x.shape[0]):
        one = tfc.moving_average_predictions(torch.from_numpy(x[i:i + 1]),
                                             torch.from_numpy(m[i:i + 1]), int(w[i])).numpy()
        np.testing.assert_array_equal(got[i], one[0])


def test_freeze_fill_holds_the_mean_after_the_last_observation():
    x = torch.tensor([[1.0, 2.0, 3.0, 100.0] + [0.0] * 6])
    m = torch.tensor([[True] * 4 + [False] * 6])
    p = tfc.moving_average_predictions(x, m, 3).numpy()[0]
    # slot 4's window holds (2, 3, 100); once the window is all gap (slot 7
    # on) the prediction freezes there, not at the last raw sample
    np.testing.assert_allclose(p, [1.0, 1.0, 1.5, 2.0, 35.0, 51.5, 100.0, 35.0, 35.0, 35.0])


def test_hold_last_and_first_valid_match_reference():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(6, 20)).astype(np.float32)
    f = rng.random((6, 20)) > 0.7
    f[0] = False
    for reverse in (False, True):
        got = tfc._hold_last(torch.from_numpy(v), torch.from_numpy(f), reverse=reverse).numpy()
        ref = np.asarray(jax.vmap(lambda a, b: jfc._hold_last(a, b, reverse=reverse))(v, f))
        np.testing.assert_array_equal(got, ref)
    got = tfc._first_valid(torch.from_numpy(v), torch.from_numpy(f)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.vmap(jfc._first_valid)(v, f)))


def test_masked_mean_std_matches_reference():
    x, m = _series(5)
    mean, std = tfc.masked_mean_std(torch.from_numpy(x), torch.from_numpy(m))
    jmean, jstd = jfc.masked_mean_std(x, m)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=1e-6)
    # a constant row's std is the rounding noise of its float32 mean
    np.testing.assert_allclose(std.numpy(), np.asarray(jstd), rtol=1e-4,
                               atol=4 * EPS32 * np.abs(x).max())


def _policy(B, seed):
    rng = np.random.default_rng(seed)
    thr = rng.choice([1.0, 2.0, 3.0], B).astype(np.float32)
    mode = (np.arange(B) % 4).astype(np.int32)  # bound modes 0..3
    mlb = np.where(rng.random(B) < 0.3, 49.0, 0.0).astype(np.float32)
    return thr, mode, mlb


@pytest.mark.parametrize("seed", range(3))
def test_band_anomalies_matches_reference_on_same_inputs(seed):
    x, m = _series(seed)
    x[:, 70:] += np.float32(6.0) * (np.arange(x.shape[0]) % 2)[:, None]
    region = np.zeros_like(m)
    region[:, 64:] = True
    rng = np.random.default_rng(seed)
    preds = (x + rng.normal(0, 1, x.shape)).astype(np.float32)
    sigma = rng.uniform(0.5, 3, x.shape[0]).astype(np.float32)
    sigma[0] = np.inf
    sigma[1] = 0.0
    thr, mode, mlb = _policy(x.shape[0], seed)
    got = tfc.band_anomalies(*[torch.from_numpy(a) for a in
                               (x, m, region, preds, sigma, thr, mode, mlb)])
    ref = jfc.band_anomalies(x, m, region, preds, sigma, thr, mode, mlb)
    for k in ("flags", "count", "first_index", "checked"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)
    for k in ("upper", "lower"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def _reference_chain(x, m, region, window, thr, mode, mlb):
    """The engine's band launch under moving_average_all, on the reference."""
    hist = m & ~region
    preds = jfc.moving_average_predictions(x, hist, window)
    sigma = jfc.residual_sigma(x, preds, hist, ~region)
    out = jfc.band_anomalies(x, m, region, preds, sigma, thr, mode, mlb)
    out = {k: np.asarray(v) for k, v in out.items()}
    out["preds"], out["sigma"] = np.asarray(preds), np.asarray(sigma)
    return out


def _bracket(x, m, region, upper, lower, mode, tol):
    """Bounds on the flag count when each band edge may move by tol."""
    mode = np.where(mode == 0, 3, mode)[:, None]
    sel = m & region
    up_on, lo_on = (mode & 1) > 0, (mode & 2) > 0
    sure = ((x > upper + tol) & up_on) | ((x < lower - tol) & lo_on)
    maybe = ((x > upper - tol) & up_on) | ((x < lower + tol) & lo_on)
    return (sure & sel).sum(1), (maybe & sel).sum(1)


@pytest.mark.parametrize("seed", range(3))
def test_moving_average_band_matches_reference_chain(seed):
    _band_chain_parity(seed, *_series(seed))


@pytest.mark.parametrize("T", [8192, 16384])
def test_moving_average_band_matches_reference_chain_above_4096(T):
    """At the engine's buckets of 5 and 7 days of 60 s history, where
    kernel B runs its long path on the card."""
    _band_chain_parity(T, *_series(T, B=6, T=T))


def _band_chain_parity(seed, x, m):
    B, T = x.shape
    region = np.zeros_like(m)
    region[:, T - 24:] = True
    x[::3, T - 16:] += np.float32(8.0)  # a level shift in a third of the current windows
    thr, mode, mlb = _policy(B, seed)
    got = tfc.moving_average_band(x, m, region, 20, thr, mode, mlb, device="cpu")
    got = {k: v.numpy() for k, v in got.items()}
    ref = _reference_chain(x, m, region, 20, thr, mode, mlb)

    hist = m & ~region
    d_preds = 2 * EPS32 * _hist_abs_sum(x, hist)
    assert np.all(np.abs(got["preds"] - ref["preds"]) <= d_preds[:, None] + 1e-6 * np.abs(ref["preds"]))
    np.testing.assert_array_equal(got["checked"], ref["checked"])
    scale = np.maximum(np.abs(np.where(hist, x, 0)).max(1), 1.0)
    for i in range(B):
        rs, gs = ref["sigma"][i], got["sigma"][i]
        if not np.isfinite(rs):
            assert not np.isfinite(gs), i
            np.testing.assert_array_equal(got["count"][i], ref["count"][i])
            continue
        if rs < 1e-5 * scale[i]:
            assert gs == 0.0, (i, gs)  # constant history: exactly 0 in the port
            continue
        assert abs(gs - rs) <= d_preds[i] + 1e-5 * rs, i
        tol = d_preds[i] * (1 + thr[i]) + 1e-5 * (abs(rs) * thr[i] + scale[i])
        lo, hi = _bracket(x[i:i + 1], m[i:i + 1], region[i:i + 1], ref["upper"][i:i + 1],
                          ref["lower"][i:i + 1], mode[i:i + 1], tol)
        assert lo[0] <= got["count"][i] <= hi[0], i
        if lo[0] == hi[0]:
            np.testing.assert_array_equal(got["flags"][i], ref["flags"][i])
            assert got["first_index"][i] == ref["first_index"][i]


def test_constant_history_keeps_sigma_zero_and_identical_current_is_clean():
    T, level = 128, np.float32(60.42)
    x = np.full((4, T), level, np.float32)
    m = np.ones((4, T), bool)
    region = np.zeros_like(m)
    region[:, 96:] = True
    x[1, 100] = np.nextafter(level, np.float32(100))  # one ulp up: a deviation
    x[2, 100] = np.nextafter(level, np.float32(0))  # one ulp down
    thr = np.full(4, 3.0, np.float32)
    mode = np.array([3, 3, 3, 1], np.int32)
    mlb = np.zeros(4, np.float32)
    out = tfc.moving_average_band(x, m, region, 30, thr, mode, mlb, device="cpu")
    np.testing.assert_array_equal(out["sigma"].numpy(), 0.0)
    np.testing.assert_array_equal(out["preds"].numpy(), level)
    # the identical current window is not flagged; any deviation is
    np.testing.assert_array_equal(out["count"].numpy(), [0, 1, 1, 0])
    ref = _reference_chain(x, m, region, 30, thr, mode, mlb)
    assert (ref["sigma"] >= 0).all()  # the reference's sigma is cumsum noise here


def test_no_history_fails_open():
    x = np.ones((2, 32), np.float32)
    m = np.zeros((2, 32), bool)
    m[:, 20:] = True
    m[1, 3] = True  # one history point: still below the 2 sigma needs
    region = np.zeros_like(m)
    region[:, 16:] = True
    x[:, 24:] = 50.0
    out = tfc.moving_average_band(x, m, region, 5, np.full(2, 2.0, np.float32),
                                  np.full(2, 3, np.int32), np.zeros(2, np.float32),
                                  device="cpu")
    assert np.isinf(out["sigma"].numpy()).all()
    np.testing.assert_array_equal(out["count"].numpy(), [0, 0])
    np.testing.assert_array_equal(out["first_index"].numpy(), [-1, -1])


# ----------------------------------------- detect_period's edge rows (kernel F)
def _edge_rows(B, T, seed):
    """chip_smoke's period_edge_rows made on the CPU, as numpy."""
    import chip_smoke as cs

    saved, cs.DEV = cs.DEV, "cpu"
    try:
        x, hist, cands = cs.period_edge_rows(B, T, torch.Generator().manual_seed(seed))
    finally:
        cs.DEV = saved
    return x.numpy(), hist.numpy(), cands


@pytest.mark.parametrize("T", [300, 2048, 16384])
def test_detect_period_edge_rows_match_the_reference(T):
    """The rows kernel F's sweeps treat apart, the twin against the
    reference: valid spans ending early (the last valid slot before T - p
    for the longer lags), all padding, a span of three slots (every lag at
    or past it), NaN at a masked and at a valid slot, +inf at a span's last
    valid slot, a constant span; candidates past the spans and past T.
    Scores to 1e-5 with the same -inf pattern and no NaN; periods equal but
    within 1e-5 of a margin (chip_smoke.near_decision). Constant rows are
    not compared: the port keeps their fallback (see
    tests/test_torch_period.py)."""
    import chip_smoke as cs

    B = 24 if T < 16384 else 8
    x, hist, cands = _edge_rows(B, T, seed=T)
    jp, js = jfc.detect_period(x, hist, cands, np.int32(7), np.float32(0.2))
    tp, ts = tfc.detect_period(x, hist, cands, 7, 0.2, device="cpu")
    jp, js, tp, ts = np.asarray(jp), np.asarray(js), tp.numpy(), ts.numpy()
    kind = np.arange(B) % 8
    keep = kind != 6
    assert not np.isnan(ts).any() and not np.isnan(js).any()
    np.testing.assert_array_equal(np.isneginf(ts[keep]), np.isneginf(js[keep]))
    fin = np.isfinite(js) & keep[:, None]
    assert np.all(np.abs(ts[fin] - js[fin]) <= 1e-5)
    # every candidate of an all-padding row, of the three-slot span and of
    # the non-finite rows scores -inf; those rows keep their fallback
    assert np.isneginf(ts[np.isin(kind, (1, 2, 4, 5))]).all()
    assert (tp[np.isin(kind, (1, 2, 4, 5, 6))] == 7).all()
    halves = tuple(p // 2 if p >= 4 else 2 for p in cands)
    _, hs = tfc.detect_period(x, hist, halves, 7, 0.2, device="cpu")
    near = cs.near_decision(torch.as_tensor(js), hs, cands, T).numpy()
    np.testing.assert_array_equal(tp[keep & ~near], jp[keep & ~near])
