"""Port parity: foremast_tpu_torch.parallel.fleet.score_pairs (the plain
twin of kernel A, run with device="cpu") against the JAX reference's
score_pairs, on the same numpy arguments.

Tolerances and the bracketing rule:
  * p-values: Mann-Whitney, Wilcoxon and KS to 1e-5 of the reference;
    Kruskal-Wallis and the sign test to 1e-5 of the exact value (float64
    H from exact rank sums; the binomial tail) and to the reference within
    1e-5 plus the reference's own drift from that value;
  * pairwise_unhealthy must match exactly except on rows where an enabled
    p-value lies within its tolerance of the row's threshold;
  * severity to the p tolerance over min_p * ln 10 (the slope of
    -log10), on rows whose band count is exact;
  * band_count must lie in the bracket of counts reachable when each band
    edge moves by the reference's float32 moving-average error
    (2 eps32 * sum|history| * (1 + threshold)); band_unhealthy must match
    unless that bracket straddles the 0.3 fraction; unhealthy likewise.
"""
import numpy as np
import pytest
import scipy.stats as sps
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.parallel import fleet as jfl  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402
from foremast_tpu_torch.ops import windowing as twin  # noqa: E402
from foremast_tpu_torch.parallel import fleet as tfl  # noqa: E402

P_ATOL = 1e-5
EPS32 = float(np.finfo(np.float32).eps)
ALL_TESTS = 31


def _fleet(seed, B, T):
    """A random fleet: healthy and shifted canaries, ragged masks, sparse
    and all-masked rows, every bound mode, both combinators, varied
    windows and gates."""
    rng = np.random.default_rng(seed)
    args = list(tfl.pair_arg_spec(B, T))
    level = rng.uniform(1, 100, (B, 1))
    base = level + rng.normal(0, 1, (B, T)) * level / 10
    shift = (rng.random((B, 1)) < 0.3) * rng.uniform(0.2, 1.5, (B, 1)) * level
    cur = level + rng.normal(0, 1, (B, T)) * level / 10 + shift
    ties = rng.random(B) < 0.3
    base[ties] = np.round(base[ties])
    cur[ties] = np.round(cur[ties])
    bm = rng.random((B, T)) > rng.uniform(0, 0.5, (B, 1))
    cm = rng.random((B, T)) > rng.uniform(0, 0.5, (B, 1))
    bm[0] = False
    cm[1] = False
    bm[2, 3:] = False
    args[0], args[1] = base.astype(np.float32), bm
    args[2], args[3] = cur.astype(np.float32), cm
    args[4] = rng.choice([0.01, 0.05], B).astype(np.float32)
    args[5] = np.where(rng.random(B) < 0.5, ALL_TESTS, rng.integers(1, 32, B)).astype(np.int32)
    args[6] = rng.integers(0, 2, B).astype(np.int32)
    args[7] = rng.choice([1, 5, 30], B).astype(np.int32)
    args[8] = rng.choice([1.0, 2.0, 3.0], B).astype(np.float32)
    args[9] = rng.integers(0, 4, B).astype(np.int32)
    args[10] = np.where(rng.random(B) < 0.2, level[:, 0], 0.0).astype(np.float32)
    args[11] = np.tile(np.asarray([20, 20, 5, 5], np.int32), (B, 1))
    args[11][::7] = [5, 8, 3, 3]
    return tuple(args)


def _exact_kw_sign(args):
    """Exact Kruskal-Wallis and sign-test p-values per row, float64."""
    x, xm, y, ym = args[:4]
    B = x.shape[0]
    kw, sg = np.ones(B), np.ones(B)
    for i in range(B):
        a, b = x[i][xm[i]].astype(np.float64), y[i][ym[i]].astype(np.float64)
        if len(a) and len(b) and len(np.unique(np.concatenate([a, b]))) > 1:
            kw[i] = sps.kruskal(a, b).pvalue
        pm = xm[i] & ym[i]
        wins, losses = int((y[i] > x[i])[pm].sum()), int((y[i] < x[i])[pm].sum())
        if wins + losses:
            sg[i] = min(1.0, sps.binomtest(min(wins, losses), wins + losses, 0.5).pvalue)
    return kw, sg


def _band_bracket(args):
    """Per-row bounds on the band count under the reference's float32
    moving-average error."""
    x, xm, y, ym = args[:4]
    B, T = x.shape
    concat = np.concatenate([x, y], 1)
    cm = np.concatenate([xm, ym], 1)
    region = np.zeros_like(cm)
    region[:, T:] = True
    out = tfc.moving_average_band_plain(
        torch.from_numpy(concat), torch.from_numpy(cm), torch.from_numpy(region),
        torch.from_numpy(args[7]), torch.from_numpy(args[8]), torch.from_numpy(args[9]),
        torch.from_numpy(args[10]))
    up, lo = out["upper"].numpy(), out["lower"].numpy()
    d = 2 * EPS32 * np.sum(np.abs(np.where(xm, x, 0.0)), 1, dtype=np.float64)
    tol = (d * (1 + args[8]) + 1e-5 * np.abs(concat).max(1))[:, None]
    mode = np.where(args[9] == 0, 3, args[9])[:, None]
    sel = cm & region
    sure = ((concat > up + tol) & (mode & 1 > 0)) | ((concat < lo - tol) & (mode & 2 > 0))
    maybe = ((concat > up - tol) & (mode & 1 > 0)) | ((concat < lo + tol) & (mode & 2 > 0))
    return (sure & sel).sum(1), (maybe & sel).sum(1), np.maximum(ym.sum(1), 1)


def _compare(args):
    ref = {k: np.asarray(v) for k, v in jfl.score_pairs(*args).items()}
    got = {k: v.numpy() for k, v in tfl.score_pairs(*args, device="cpu").items()}
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
    kw, sg = _exact_kw_sign(args)
    tol = np.full(ref["pvalues"].shape, P_ATOL)
    for col, exact in ((2, kw), (4, sg)):
        np.testing.assert_allclose(got["pvalues"][:, col], exact, atol=P_ATOL, rtol=0)
        tol[:, col] += np.abs(ref["pvalues"][:, col] - exact)
    assert np.all(np.abs(got["pvalues"] - ref["pvalues"]) <= tol)

    near = np.any(np.abs(ref["pvalues"] - args[4][:, None]) <= tol, axis=1)
    ok = ~near
    np.testing.assert_array_equal(got["pairwise_unhealthy"][ok], ref["pairwise_unhealthy"][ok])
    lo, hi, n_chk = _band_bracket(args)
    assert np.all((lo <= ref["band_count"]) & (ref["band_count"] <= hi))
    assert np.all((lo <= got["band_count"]) & (got["band_count"] <= hi))
    sure_band = (lo == hi) | ((lo / n_chk > 0.3) == (hi / n_chk > 0.3))
    np.testing.assert_array_equal(got["band_unhealthy"][sure_band], ref["band_unhealthy"][sure_band])
    sure = ok & sure_band
    np.testing.assert_array_equal(got["unhealthy"][sure], ref["unhealthy"][sure])
    exact_band = lo == hi
    np.testing.assert_array_equal(got["band_count"][exact_band], ref["band_count"][exact_band])
    np.testing.assert_allclose(got["min_p"], ref["min_p"], atol=tol.max(), rtol=0)
    # severity = -log10(min_p) + band fraction: the p tolerance scaled by
    # the log's slope at the smaller of the two min_p
    p_floor = np.maximum(np.minimum(got["min_p"], ref["min_p"]), 1e-12)
    sev_tol = tol.max(1) / (p_floor * np.log(10)) + 1e-5 * np.abs(ref["severity"])
    assert np.all(np.abs(got["severity"] - ref["severity"])[exact_band] <= sev_tol[exact_band])
    return ref, got, sure


@pytest.mark.parametrize("T", [16, 64, 128])
def test_score_pairs_matches_reference_on_random_fleet(T):
    args = _fleet(T, 256, T)
    ref, got, sure = _compare(args)
    assert sure.mean() > 0.9  # the bracketing leaves most rows exact
    assert 0 < ref["unhealthy"].sum() < len(ref["unhealthy"])


def _error_rate_series(rng, rate, start, minutes):
    """An ErrorGenerator-style error-rate series: per-minute Poisson error
    counts over a 60 s scrape, as err/s, with scrape jitter and lost
    samples."""
    ts = start + 60 * np.arange(minutes) + rng.uniform(-5, 5, minutes)
    vals = rng.poisson(rate * 60, minutes) / 60.0
    keep = rng.random(minutes) > 0.05
    return ts[keep], vals[keep]


def test_error_generator_scenario_same_verdicts():
    """Healthy baseline ~0.5 err/s against bad canaries at ~5 err/s over a
    10-minute window at a 60 s step: resample_to_grid -> pack_windows ->
    score_pairs in both packages gives the same verdicts."""
    rng = np.random.default_rng(17)
    start, minutes, n = 1_700_000_000, 10, 256  # the T=16 fleet's shape
    bad = np.arange(n) % 2 == 1
    bw, cw = [], []
    for i in range(n):
        ts, v = _error_rate_series(rng, 0.5, start, minutes)
        bw.append(twin.resample_to_grid(ts, v, start, start + 60 * minutes))
        ts, v = _error_rate_series(rng, 5.0 if bad[i] else 0.5, start, minutes)
        cw.append(twin.resample_to_grid(ts, v, start, start + 60 * minutes))
    T = twin.bucket_length(minutes)
    bvals, bmask = twin.pack_windows(bw, pad_to=T)
    cvals, cmask = twin.pack_windows(cw, pad_to=T)
    args = list(tfl.pair_arg_spec(n, T))
    args[:4] = bvals, bmask, cvals, cmask
    args[4][:] = 0.01
    args[5][:] = ALL_TESTS
    args[6][:] = tfl.COMBINE_ALL
    args[8][:] = 2.0
    ref, got, sure = _compare(tuple(args))
    assert sure.all()
    for k in ("unhealthy", "pairwise_unhealthy", "band_unhealthy", "band_count"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["unhealthy"][bad].all()
    assert got["unhealthy"][~bad].mean() <= 0.1


def test_pair_arg_spec_matches_reference():
    for B, T in ((1, 16), (7, 128)):
        for a, b in zip(tfl.pair_arg_spec(B, T), jfl.pair_arg_spec(B, T)):
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    for name in ("TEST_MANN_WHITNEY", "TEST_WILCOXON", "TEST_KRUSKAL", "TEST_KS",
                 "TEST_FRIEDMAN", "COMBINE_ANY", "COMBINE_ALL", "MIN_MANN_WHITNEY",
                 "MIN_WILCOXON", "MIN_KRUSKAL", "MIN_FRIEDMAN"):
        assert getattr(tfl, name) == getattr(jfl, name), name


def test_pair_args_from_numpy_keeps_dtypes_and_shapes():
    args = _fleet(3, 5, 16)
    t = tfl.pair_args_from_numpy(args, "cpu")
    for a, b in zip(args, t):
        assert tuple(b.shape) == a.shape
        assert b.numpy().dtype == a.dtype
        np.testing.assert_array_equal(b.numpy(), a)
    with pytest.raises(ValueError):
        tfl.pair_args_from_numpy(args[:11], "cpu")
    bad = list(args)
    bad[11] = bad[11][:, :2]
    with pytest.raises(ValueError):
        tfl.pair_args_from_numpy(bad, "cpu")


def test_three_wide_min_points_keeps_the_friedman_default():
    args = list(_fleet(5, 32, 16))
    three = tfl.score_pairs(*args[:11], args[11][:, :3], device="cpu")
    four = np.concatenate([args[11][:, :3], np.full((32, 1), tfl.MIN_FRIEDMAN, np.int32)], 1)
    full = tfl.score_pairs(*args[:11], four, device="cpu")
    for k in three:
        np.testing.assert_array_equal(three[k].numpy(), full[k].numpy(), err_msg=k)


def test_score_pairs_matches_reference_at_t_8192():
    """The 8192 bucket (a canary whose baseline spans more than ~2.8 days at
    60 s), which kernel A serves from device scratch: two pairs of the
    random fleet, both sides past the exact-KS bound (Stephens)."""
    full = _fleet(8192, 8, 8192)
    rows = np.array([3, 4])
    args = tuple(a[rows] for a in full)
    assert (args[1].sum(1) > 256).all() and (args[3].sum(1) > 256).all()
    ref, got, sure = _compare(args)
    assert sure.all()
    for k in ("unhealthy", "pairwise_unhealthy", "band_unhealthy", "band_count"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
