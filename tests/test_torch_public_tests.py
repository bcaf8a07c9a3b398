"""Port parity: the public test battery of foremast_tpu_torch.ops (the
*_batch entry points, all_pairwise_tests, kruskal_batch, friedman_batch,
rank_and_ties, masked_rankdata and the single-pair forms), run with
device="cpu" (the plain twins of kernels N and O), against the JAX
reference and scipy in float64 on the same numpy inputs.

Tolerances:
  * statistics to rtol 1e-6 (U1, W and D are the same float32 expressions of
    exact integers on both sides; the port's H and chi2 are float64 values
    of exact rank sums rounded once, held to scipy's float64 value);
  * p-values to atol 1e-5 of scipy in float64, and to the reference within
    1e-5 plus the reference's own drift from scipy (its float32 Kruskal and
    Friedman sums, R2), as tests/test_torch_pairwise.py states it;
  * ranks, tie terms and counts exactly.
"""
import types

import numpy as np
import pytest
import scipy.stats as sps
import torch

jax = pytest.importorskip("jax")

import foremast_tpu.ops as jops  # noqa: E402
from foremast_tpu.ops import pairwise as jpw  # noqa: E402
from foremast_tpu.ops import ranks as jranks  # noqa: E402
import foremast_tpu_torch.ops as tops  # noqa: E402
from foremast_tpu_torch.ops import pairwise as tpw  # noqa: E402

P_ATOL = 1e-5
S_RTOL = 1e-6


def _pairs(seed, B, T, ties):
    """B window pairs of T slots: 15% masked, a shift in every third row,
    values on a grid of 0.5 with signed zeros when `ties`, the last row all
    masked on one side and the one before it all tied."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T)).astype(np.float32)
    y = (rng.normal(size=(B, T)) + np.where(np.arange(B) % 3 == 0, 1.0, 0.0)[:, None]
         ).astype(np.float32)
    if ties:
        x, y = np.round(x * 2) / 2, np.round(y * 2) / 2
        x[x == 0] = -0.0
    xm, ym = rng.random((B, T)) > 0.15, rng.random((B, T)) > 0.15
    xm[-1] = False
    x[-2], y[-2] = 2.5, 2.5
    return x, xm, y, ym


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _np(out):
    return tuple(np.asarray(o) for o in out)


SHAPES = [(16, 8), (32, 30), (64, 64)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,T", SHAPES)
@pytest.mark.parametrize("name,ref_fn,port_fn", [
    ("mann_whitney", jpw.mann_whitney_u_batch, tpw.mann_whitney_u_batch),
    ("wilcoxon", jpw.wilcoxon_batch, tpw.wilcoxon_batch),
    ("ks", jpw.ks_2samp_batch, tpw.ks_2samp_batch),
])
def test_batch_entry_points_match_reference(name, ref_fn, port_fn, B, T, ties):
    x, xm, y, ym = _pairs(B + T, B, T, ties)
    rs, rp = _np(ref_fn(x, xm, y, ym))
    s, p = port_fn(x, xm, y, ym, device="cpu")
    assert s.shape == p.shape == (B,) and s.dtype == p.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), rs, rtol=S_RTOL, atol=0)
    np.testing.assert_allclose(p.numpy(), rp, atol=P_ATOL, rtol=0)


def _scipy_kruskal(groups, masks):
    """scipy's H in float64 per row and its chi-square p at df = k - 1 (the
    reference counts an empty group in k, scipy drops it), NaN where scipy
    has no value (fewer than two non-empty groups, or every value tied)."""
    k = groups.shape[1]
    H = []
    for g, m in zip(groups, masks):
        samples = [gi[mi].astype(np.float64) for gi, mi in zip(g, m) if mi.any()]
        values = np.concatenate(samples) if samples else np.zeros(0)
        ok = len(samples) >= 2 and np.unique(values).size >= 2
        H.append(sps.kruskal(*samples).statistic if ok else np.nan)
    H = np.asarray(H)
    return H, sps.chi2.sf(H, k - 1)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("B,T", SHAPES)
def test_all_pairwise_tests_match_reference(B, T, ties):
    x, xm, y, ym = _pairs(B * T, B, T, ties)
    ref = jpw.all_pairwise_tests(x, xm, y, ym)
    got = tpw.all_pairwise_tests(x, xm, y, ym, device="cpu")
    assert set(got) == {"mann_whitney", "kruskal", "wilcoxon", "ks"}
    for name in ("mann_whitney", "wilcoxon", "ks"):
        np.testing.assert_allclose(got[name][0].numpy(), np.asarray(ref[name][0]), rtol=S_RTOL)
        np.testing.assert_allclose(got[name][1].numpy(), np.asarray(ref[name][1]), atol=P_ATOL,
                                   rtol=0)
    sH, sp = _scipy_kruskal(np.stack([x, y], 1), np.stack([xm, ym], 1))
    H, p = got["kruskal"][0].numpy(), got["kruskal"][1].numpy()
    ok = ~np.isnan(sp)
    np.testing.assert_allclose(H[ok], sH[ok], rtol=S_RTOL, atol=1e-9)
    np.testing.assert_allclose(p[ok], sp[ok], atol=P_ATOL, rtol=0)
    rp = np.asarray(ref["kruskal"][1])
    drift = np.abs(rp[ok] - sp[ok])
    assert np.all(np.abs(p[ok] - rp[ok]) <= P_ATOL + drift)
    # rows scipy refuses (a side empty, or every value tied): H = 0 (to the
    # float64 rounding of a difference of equal terms) and p = 1 (to 1e-5), the exact
    # answer; the reference's float32 tie term leaves its p up to ~2e-3 below
    # 1 on the all-tied row (R2), so it is not compared there
    assert np.all(np.abs(H[~ok]) <= 1e-9) and np.all(p[~ok] >= 1.0 - P_ATOL)


def _groups(seed, B, k, T):
    """B sets of k groups: gaps, a shift of the first group in every second
    row, ties in every third, a row with one empty group, one all masked and
    one all tied."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(B, k, T)).astype(np.float32)
    g[::2, 0] += 1.0
    g[::3] = np.round(g[::3] * 2) / 2
    m = rng.random((B, k, T)) > 0.2
    m[1, -1] = False
    m[2] = False
    g[3] = 4.0
    return g, m


@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("B,T", [(16, 8), (32, 40)])
def test_kruskal_batch_matches_reference_and_scipy(k, B, T):
    g, m = _groups(k * T, B, k, T)
    H, p = tpw.kruskal_batch(g, m, device="cpu")
    assert H.shape == p.shape == (B,) and H.dtype == torch.float32
    H, p = H.numpy(), p.numpy()
    rp = np.asarray(jpw.kruskal_batch(g, m)[1])
    sH, sp = _scipy_kruskal(g, m)
    ok = ~np.isnan(sp)
    np.testing.assert_allclose(H[ok], sH[ok], rtol=S_RTOL, atol=1e-9)
    np.testing.assert_allclose(p[ok], sp[ok], atol=P_ATOL, rtol=0)
    assert np.all(np.abs(p[ok] - rp[ok]) <= P_ATOL + np.abs(rp[ok] - sp[ok]))
    # rows scipy refuses (all masked, all tied): H = 0 and p = 1, as above
    assert np.all(np.abs(H[~ok]) <= 1e-9) and np.all(p[~ok] >= 1.0 - P_ATOL)


def _tables(seed, B, n, k):
    """B tables of n blocks x k treatments on a grid of 0.5 (ties), a
    treatment effect in every second row, 75% of blocks masked in, one row
    with no block and one with a single block."""
    rng = np.random.default_rng(seed)
    d = (np.round(rng.normal(size=(B, n, k)) * 2) / 2).astype(np.float32)
    d[::2] += np.linspace(0, 1.5, k, dtype=np.float32)
    bm = rng.random((B, n)) < 0.75
    bm[0] = False
    bm[1] = False
    bm[1, 0] = True
    return d, bm


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("B,n", [(16, 10), (24, 40)])
def test_friedman_batch_matches_reference_and_scipy(k, B, n):
    d, bm = _tables(k * n, B, n, k)
    chi, p = tpw.friedman_batch(d, bm, device="cpu")
    assert chi.shape == p.shape == (B,) and chi.dtype == torch.float32
    chi, p = chi.numpy(), p.numpy()
    rc, rp = _np(jpw.friedman_batch(d, bm))
    for i in range(B):
        rows = d[i][bm[i]].astype(np.float64)
        if rows.shape[0] < 2:
            assert (chi[i], p[i]) == (rc[i], rp[i]) or rows.shape[0] == 1
            continue
        s = sps.friedmanchisquare(*rows.T)
        np.testing.assert_allclose(chi[i], s.statistic, rtol=S_RTOL, atol=1e-9)
        np.testing.assert_allclose(p[i], s.pvalue, atol=P_ATOL)
        assert abs(p[i] - rp[i]) <= P_ATOL + abs(rp[i] - s.pvalue)
    assert chi[0] == 0.0 and p[0] == 1.0 and rp[0] == 1.0


@pytest.mark.parametrize("k", [16, 17])
def test_friedman_batch_about_the_warp_limit_matches_reference(k):
    """Tables of k = kernels.WARP_FRIEDMAN_K treatments (the warp path's
    widest) and one more (the cta path's): ties on a grid of 0.5 with -0.0
    and +0.0, NaN in 3% of entries, masked-out blocks, a row with no block
    and one with a single block; chi2 within 1e-5 relative of the
    reference's (its float32 sums) and p within P_ATOL."""
    d, bm = _tables(k + 100, 12, 9, k)
    rng = np.random.default_rng(k)
    z = d == 0
    d[z] = np.where(rng.random(int(z.sum())) < 0.5, 0.0, -0.0)
    d[rng.random(d.shape) < 0.03] = np.nan
    chi, p = tpw.friedman_batch(d, bm, device="cpu")
    rc, rp = _np(jpw.friedman_batch(d, bm))
    np.testing.assert_allclose(chi.numpy(), rc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), rp, atol=P_ATOL)
    assert chi[0] == 0.0 and p[0] == 1.0 and rp[0] == 1.0


def test_friedman_ranks_nan_and_signed_zeros_as_rank_and_ties():
    """NaN ranks highest within a block, tied with the other NaNs; -0.0 and
    +0.0 tie: the reference's rank_and_ties order."""
    d = np.array([[[0.0, -0.0, 1.0, np.nan]], [[np.nan, np.nan, 2.0, -1.0]]], np.float32)
    d = np.repeat(d, 5, axis=1)
    bm = np.ones((2, 5), bool)
    chi, p = tpw.friedman_batch(d, bm, device="cpu")
    rc, rp = _np(jpw.friedman_batch(d, bm))
    np.testing.assert_allclose(chi.numpy(), rc, rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), rp, atol=P_ATOL)


def test_fully_masked_input_gives_p_one_everywhere():
    """The reference's degenerate case (tests/test_pairwise_parity.py:211-221):
    every test on fully masked input gives a finite statistic and p = 1."""
    z = np.zeros(16, np.float32)
    zm = np.zeros(16, bool)
    cpu = {"device": "cpu"}
    for stat, p in (tops.mann_whitney_u(z, zm, z, zm, **cpu),
                    tops.wilcoxon_signed_rank(z, zm, z, zm, **cpu),
                    tops.kruskal_wallis(np.stack([z, z]), np.stack([zm, zm]), **cpu),
                    tops.ks_2samp(z, zm, z, zm, **cpu),
                    tops.sign_test_exact(z, z, zm, **cpu),
                    tops.friedman_chi_square(np.zeros((8, 3), np.float32), np.zeros(8, bool),
                                             **cpu)):
        assert np.isfinite(float(stat)) and float(p) == 1.0
    H, p = tpw.kruskal_batch(np.zeros((2, 3, 16), np.float32), np.zeros((2, 3, 16), bool),
                             device="cpu")
    assert np.all(H.numpy() == 0.0) and np.all(p.numpy() == 1.0)


@pytest.mark.parametrize("ties", [False, True])
def test_two_group_kruskal_equals_the_fused_family(ties):
    """kruskal_batch at k = 2 is the fused family's two-group Kruskal-Wallis
    (tests/test_pairwise_parity.py:236-237): the same float64 H, p from the
    chi-square tail at df = 1."""
    x, xm, y, ym = _pairs(40 + ties, 24, 30, ties)
    fused = tpw.all_pairwise_tests(x, xm, y, ym, device="cpu")["kruskal"]
    H, p = tpw.kruskal_batch(np.stack([x, y], 1), np.stack([xm, ym], 1), device="cpu")
    np.testing.assert_allclose(H.numpy(), fused[0].numpy(), rtol=1e-7)
    np.testing.assert_allclose(p.numpy(), fused[1].numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_rank_and_ties_and_masked_rankdata_match_reference(seed):
    rng = np.random.default_rng(seed)
    v = (np.round(rng.normal(size=(12, 40)) * 2) / 2).astype(np.float32)
    v[rng.random(v.shape) < 0.05] = np.nan
    v[rng.random(v.shape) < 0.05] = np.inf
    m = rng.random(v.shape) > 0.2
    m[0] = False
    got = tops.rank_and_ties(v, m, device="cpu")
    want = _np(jax.vmap(jranks.rank_and_ties)(v, m))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for i in (0, 3):
        one = tops.rank_and_ties(v[i], m[i], device="cpu")
        ref = _np(jops.rank_and_ties(v[i], m[i]))
        assert one[0].shape == (40,) and one[1].shape == ()
        for g, w in zip(one, ref):
            np.testing.assert_array_equal(g.numpy(), w)
        np.testing.assert_array_equal(tops.masked_rankdata(v[i], m[i], device="cpu").numpy(),
                                      np.asarray(jops.masked_rankdata(v[i], m[i])))


@pytest.mark.parametrize("name", ["mann_whitney_u", "wilcoxon_signed_rank", "ks_2samp"])
def test_single_pair_forms_read_as_the_reference_s(name):
    x, xm, y, ym = _pairs(3, 4, 30, True)
    got = getattr(tops, name)(x[0], xm[0], y[0], ym[0], device="cpu")
    want = _np(getattr(jops, name)(x[0], xm[0], y[0], ym[0]))
    assert got[0].shape == () and got[1].shape == ()
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=S_RTOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=P_ATOL)
    fused = tops.two_sample_tests(x[0], xm[0], y[0], ym[0], device="cpu")
    assert fused["ks"][0].shape == ()


def test_single_table_forms_read_as_the_reference_s():
    g, m = _groups(9, 4, 3, 20)
    H, p = tops.kruskal_wallis(g[0], m[0], device="cpu")
    rH, rp = _np(jops.kruskal_wallis(g[0], m[0]))
    np.testing.assert_allclose(float(H), rH, rtol=1e-5)
    np.testing.assert_allclose(float(p), rp, atol=P_ATOL)
    d, bm = _tables(9, 4, 12, 4)
    chi, p = tops.friedman_chi_square(d[2], bm[2], device="cpu")
    rc, rp = _np(jops.friedman_chi_square(d[2], bm[2]))
    np.testing.assert_allclose(float(chi), rc, rtol=1e-5)
    np.testing.assert_allclose(float(p), rp, atol=P_ATOL)


def test_sign_test_single_pair_form():
    x, xm, y, ym = _pairs(5, 4, 30, True)
    n, p = tops.sign_test_exact(x[0], y[0], xm[0] & ym[0], device="cpu")
    rn, rp = _np(jops.sign_test_exact(x[0], y[0], xm[0] & ym[0]))
    assert float(n) == float(rn)
    np.testing.assert_allclose(float(p), rp, atol=1e-4)


def test_ks_past_two_to_the_24_matches_float64():
    """At T = 16384 a side, n1 n2 passes 2^24, where float32 products of
    the counts round: on these rows float32 products move D by 1.7e-5 and
    1.1e-6 of itself. ks_2samp_plain's and two_sample_tests_plain's KS
    statistic and Stephens p against numpy and scipy in float64 on the
    same inputs: D to rtol 1e-6, p to atol 1e-6. Row 0 is a near copy
    (small D), row 1 an independent draw."""
    import scipy.special as ssp

    T = 16384
    rng = np.random.default_rng(T)
    x = rng.normal(size=(2, T)).astype(np.float32)
    y = rng.normal(size=(2, T)).astype(np.float32)
    y[0] = x[0] + rng.normal(scale=0.01, size=T).astype(np.float32)
    xm, ym = rng.random((2, T)) > 0.01, rng.random((2, T)) > 0.01
    got = (tpw.ks_2samp_plain(*_t(x, xm, y, ym)),
           tpw.two_sample_tests_plain(*_t(x, xm, y, ym))["ks"])
    for i in range(2):
        a, b = np.sort(x[i][xm[i]].astype(np.float64)), np.sort(y[i][ym[i]].astype(np.float64))
        n1, n2 = len(a), len(b)
        assert n1 * n2 > 2**24 and min(n1, n2) > tpw.KS_EXACT_MAX_T
        pts = np.concatenate([a, b])
        t = np.max(np.abs(np.searchsorted(a, pts, "right") * n2
                          - np.searchsorted(b, pts, "right") * n1))
        D = t / (n1 * n2)
        en = np.sqrt(n1 * n2 / (n1 + n2))
        p = ssp.kolmogorov((en + 0.12 + 0.11 / en) * D)
        for stat, pv in got:
            np.testing.assert_allclose(float(stat[i]), D, rtol=1e-6)
            np.testing.assert_allclose(float(pv[i]), p, atol=1e-6)


@pytest.mark.parametrize("df", [1.0, 2.0, 4.0, 9.0])
def test_chi2_sf_takes_any_df(df):
    x = torch.tensor([0.0, 0.3, 1.0, 3.0, 10.0, 40.0], dtype=torch.float64)
    np.testing.assert_allclose(tops.chi2_sf(x, df).numpy(), sps.chi2.sf(x.numpy(), df),
                               rtol=1e-10, atol=1e-14)


def test_ops_exports_the_reference_s_names():
    public = {n for n in dir(jops)
              if not n.startswith("_") and not isinstance(getattr(jops, n), types.ModuleType)}
    assert len(public) == 14
    assert all(callable(getattr(tops, n, None)) for n in public)


def test_entry_points_take_tensors_and_check_shapes():
    x, xm, y, ym = _pairs(1, 6, 12, False)
    a = tpw.all_pairwise_tests(*_t(x, xm, y, ym), device="cpu")
    b = tpw.all_pairwise_tests(x, xm, y, ym, device="cpu")
    for k in a:
        assert torch.equal(a[k][1], b[k][1])
    with pytest.raises(ValueError, match="shape"):
        tpw.mann_whitney_u_batch(x, xm, y[:, :5], ym, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, k, T\)"):
        tpw.kruskal_batch(x, xm, device="cpu")
    with pytest.raises(ValueError, match=r"\(B, n, k\)"):
        tpw.friedman_batch(x, xm, device="cpu")


@pytest.mark.parametrize("test", ["kruskal", "friedman"])
@pytest.mark.parametrize("n", [5, 128])
def test_one_group_gives_p_zero_as_the_reference(test, n):
    """k = 1 (df = 0): a chi-square of no degrees of freedom is a point
    mass at 0, so p = 0 wherever the statistic is defined (p = 1 where the
    ok guard fails: no valid point, or every point tied). The reference's
    float32 statistic is rounding noise there: above 0 it gives p = 0 as
    the port does; at or below 0 it gives p = NaN (gammaincc(0, 0) of the
    clamped statistic; ROADMAP queue 3, R11), and those rows are
    bracketed."""
    rng = np.random.default_rng(n)
    B = 24
    if test == "kruskal":
        g = rng.normal(size=(B, 1, n)).astype(np.float32)
        m = rng.random((B, 1, n)) > 0.2
        m[2] = False          # no valid point: p = 1
        g[3] = 4.0            # every point tied: p = 1
        stat, p = tpw.kruskal_batch(g, m, device="cpu")
        rstat, rp = _np(jpw.kruskal_batch(g, m))
        single = tops.kruskal_wallis(g[0], m[0], device="cpu")
        ref_single = jops.kruskal_wallis(g[0], m[0])
    else:
        d = rng.normal(size=(B, n, 1)).astype(np.float32)
        bm = rng.random((B, n)) < 0.75
        bm[2] = False         # no block: p = 1
        stat, p = tpw.friedman_batch(d, bm, device="cpu")
        rstat, rp = _np(jpw.friedman_batch(d, bm))
        single = tops.friedman_chi_square(d[0], bm[0], device="cpu")
        ref_single = jops.friedman_chi_square(d[0], bm[0])
    stat, p = stat.numpy(), p.numpy()
    undefined = p == 1.0
    assert undefined[2] and (test == "friedman" or undefined[3])
    # the statistic is 0 up to float64 rounding of exact integer sums
    assert np.all(p[~undefined] == 0.0) and np.all(np.abs(stat[~undefined]) <= 1e-9)
    assert np.all(rp[undefined] == 1.0)
    # R11: the reference's statistic at or below 0 (clamped to 0)
    noise = ~undefined & np.isnan(rp)
    assert np.all(rstat[noise] <= 0.0)
    assert np.all(rp[~undefined & ~noise] == 0.0)
    assert np.all(np.abs(rstat[~undefined]) <= 1e-4)
    assert float(single[1]) == p[0]
    # the single form compiles apart: its own noise, 0 or (R11) NaN
    assert float(ref_single[1]) == p[0] or np.isnan(float(ref_single[1]))
