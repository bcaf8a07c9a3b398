"""Port parity: foremast_tpu_torch.ops.pairwise against the JAX reference
and scipy.

Tolerances: statistics to rtol 1e-6, p-values to atol 1e-5, against both
the reference and scipy run in float64 on the same samples. Two p-values
are computed more exactly by the port than by the reference (the
Kruskal-Wallis H in float64, the sign test's binomial tail through float64
lgamma); for those the port is held to 1e-5 of the exact value, and to the
reference within 1e-5 plus the reference's own drift from that value.
"""
import numpy as np
import pytest
import scipy.stats as sps
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.ops import pairwise as jpw  # noqa: E402
from foremast_tpu_torch.ops import pairwise as tpw  # noqa: E402

P_ATOL = 1e-5
S_RTOL = 1e-6

_sign_test_batch = jax.jit(jax.vmap(jpw.sign_test_exact))


def _windows(seed, B=16, T=30, ties=False, shift=0.0, keep=20):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, T)).astype(np.float32)
    y = (rng.normal(size=(B, T)) + shift).astype(np.float32)
    if ties:
        x = np.round(x * 2) / 2
        y = np.round(y * 2) / 2
    xm = rng.random((B, T)) > 0.2
    ym = rng.random((B, T)) > 0.2
    xm[:, :keep] = True
    ym[:, :keep] = True
    return x, xm, y, ym


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


CASES = [(seed, ties, shift) for seed in range(3) for ties in (False, True)
         for shift in (0.0, 1.2)]


@pytest.fixture(scope="module")
def family():
    """Both packages' fused families on every case, computed once."""
    out = {}
    for case in CASES:
        seed, ties, shift = case
        x, xm, y, ym = _windows(seed, ties=ties, shift=shift)
        ref = jpw.all_pairwise_tests(x, xm, y, ym)
        ref = {k: (np.asarray(s), np.asarray(p)) for k, (s, p) in ref.items()}
        got = tpw.all_pairwise_tests(*_t(x, xm, y, ym))
        got = {k: (s.numpy(), p.numpy()) for k, (s, p) in got.items()}
        out[case] = ((x, xm, y, ym), ref, got)
    return out


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("test", ["mann_whitney", "wilcoxon", "ks"])
def test_family_matches_reference(family, case, test):
    _, ref, got = family[case]
    np.testing.assert_allclose(got[test][0], ref[test][0], rtol=S_RTOL, atol=0)
    np.testing.assert_allclose(got[test][1], ref[test][1], atol=P_ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_family_matches_scipy(family, case):
    (x, xm, y, ym), _, got = family[case]
    for i in range(x.shape[0]):
        a, b = x[i][xm[i]].astype(np.float64), y[i][ym[i]].astype(np.float64)
        mw = sps.mannwhitneyu(a, b, alternative="two-sided", method="asymptotic",
                              use_continuity=True)
        np.testing.assert_allclose(got["mann_whitney"][0][i], mw.statistic, rtol=S_RTOL)
        np.testing.assert_allclose(got["mann_whitney"][1][i], mw.pvalue, atol=P_ATOL)
        kw = sps.kruskal(a, b)
        np.testing.assert_allclose(got["kruskal"][0][i], kw.statistic, rtol=S_RTOL, atol=1e-6)
        np.testing.assert_allclose(got["kruskal"][1][i], kw.pvalue, atol=P_ATOL)
        ks = sps.ks_2samp(a, b, method="exact")
        np.testing.assert_allclose(got["ks"][0][i], ks.statistic, rtol=S_RTOL)
        np.testing.assert_allclose(got["ks"][1][i], ks.pvalue, atol=P_ATOL)


@pytest.mark.parametrize("case", CASES)
def test_kruskal_within_reference_drift(family, case):
    (x, xm, y, ym), ref, got = family[case]
    for i in range(x.shape[0]):
        kw = sps.kruskal(x[i][xm[i]].astype(np.float64), y[i][ym[i]].astype(np.float64))
        for k, truth in ((0, kw.statistic), (1, kw.pvalue)):
            drift = abs(float(ref["kruskal"][k][i]) - truth)
            tol = (S_RTOL * abs(truth) + 1e-6) if k == 0 else P_ATOL
            assert abs(float(got["kruskal"][k][i]) - float(ref["kruskal"][k][i])) <= tol + drift


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ties", [False, True])
def test_wilcoxon_both_regimes_vs_scipy(seed, ties):
    """Untied, zero-free samples with n <= 50 take the exact null; tied
    samples the tie-corrected approximation (scipy method="approx")."""
    x, xm, y, ym = _windows(seed, ties=ties, shift=0.6)
    W, p = tpw.wilcoxon_signed_rank(*_t(x, xm, y, ym))
    jW, jp = jpw.wilcoxon_batch(x, xm, y, ym)
    np.testing.assert_allclose(W.numpy(), np.asarray(jW), rtol=S_RTOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=P_ATOL)
    n_exact = 0
    for i in range(x.shape[0]):
        both = xm[i] & ym[i]
        d_all = (x[i] - y[i])[both].astype(np.float64)
        d = d_all[d_all != 0]
        tied = len(d) < len(d_all) or len(np.unique(np.abs(d))) < len(d)
        method = "approx" if tied or len(d) > tpw.WILCOXON_EXACT_MAX_N else "exact"
        n_exact += method == "exact"
        ref = sps.wilcoxon(d, zero_method="wilcox", correction=False, method=method)
        np.testing.assert_allclose(W[i].item(), ref.statistic, rtol=S_RTOL)
        np.testing.assert_allclose(p[i].item(), ref.pvalue, atol=P_ATOL)
    assert (n_exact > 0) == (not ties)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T", [16, 128])
def test_sign_test_exact_binomial(seed, T):
    rng = np.random.default_rng(seed)
    B = 24
    x = np.round(rng.normal(size=(B, T)), 1).astype(np.float32)
    y = (np.round(rng.normal(size=(B, T)), 1) + rng.normal(0, 0.4, (B, 1))).astype(np.float32)
    pm = rng.random((B, T)) > 0.3
    pm[0] = False
    n, p = tpw.sign_test_exact(*_t(x, y, pm))
    jn, jp = _sign_test_batch(x, y, pm)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    for i in range(B):
        wins = int(((y[i] > x[i]) & pm[i]).sum())
        losses = int(((y[i] < x[i]) & pm[i]).sum())
        exact = 1.0 if wins + losses == 0 else sps.binomtest(
            min(wins, losses), wins + losses, 0.5).pvalue
        exact = min(1.0, exact)
        assert abs(p[i].item() - exact) <= P_ATOL, i
        drift = abs(float(jp[i]) - exact)
        assert abs(p[i].item() - float(jp[i])) <= P_ATOL + drift, i


def test_ks_stephens_regime_beyond_exact_bound():
    """n > KS_EXACT_MAX_T per side selects Stephens, by sample count."""
    x, xm, y, ym = _windows(5, B=6, T=512, shift=0.15, keep=400)
    assert (xm.sum(1) > tpw.KS_EXACT_MAX_T).all() and (ym.sum(1) > tpw.KS_EXACT_MAX_T).all()
    D, p = tpw.ks_2samp(*_t(x, xm, y, ym))
    jD, jp = jpw.ks_2samp_batch(x, xm, y, ym)
    np.testing.assert_allclose(D.numpy(), np.asarray(jD), rtol=S_RTOL)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=P_ATOL)
    # the fused family gives the same statistic and p from its sorted view
    fam = tpw.two_sample_tests(*_t(x, xm, y, ym))
    np.testing.assert_allclose(fam["ks"][0].numpy(), D.numpy(), rtol=S_RTOL)
    np.testing.assert_allclose(fam["ks"][1].numpy(), p.numpy(), atol=P_ATOL)


def test_ks_sparse_long_bucket_stays_exact():
    """A 512 bucket holding few valid samples is scored by the exact DP."""
    x, xm, y, ym = _windows(6, B=4, T=512, shift=0.8, keep=0)
    xm[:] = False
    ym[:] = False
    xm[:, :40] = True
    ym[:, 100:150] = True
    D, p = tpw.ks_2samp(*_t(x, xm, y, ym))
    for i in range(4):
        ref = sps.ks_2samp(x[i][xm[i]].astype(np.float64), y[i][ym[i]].astype(np.float64),
                           method="exact")
        np.testing.assert_allclose(p[i].item(), ref.pvalue, atol=P_ATOL)


def test_degenerate_rows_give_p_one():
    x, xm, y, ym = _windows(7, B=3)
    xm[0] = False  # all-masked baseline
    ym[1] = False  # all-masked current
    x[2] = 1.0     # all tied
    y[2] = 1.0
    out = tpw.all_pairwise_tests(*_t(x, xm, y, ym))
    for test in ("mann_whitney", "kruskal", "wilcoxon", "ks"):
        np.testing.assert_array_equal(out[test][1].numpy(), [1.0, 1.0, 1.0], err_msg=test)


def test_wilcoxon_pmf_table_rows_are_distributions():
    table = tpw.wilcoxon_pmf_table("cpu")
    N = tpw.WILCOXON_EXACT_MAX_N
    assert table.shape == (N, N * (N + 1) // 2 + 1)
    np.testing.assert_allclose(table.sum(1).numpy(), 1.0, atol=1e-6)


def test_all_tied_long_rows_keep_p_one():
    """At T = 4096 the tie term (~N^3) and the rank sum pass 2^24: summed in
    float32 they round, the Kruskal correction comes out as float noise
    instead of 0, and p drifts below 1. The port sums them exactly."""
    T = 4096
    x = np.full((2, T), 60.42, np.float32)
    m = np.ones((2, T), bool)
    m[1, ::7] = False
    out = tpw.two_sample_tests(*_t(x, m, x.copy(), m.copy()))
    for test in ("mann_whitney", "kruskal"):
        np.testing.assert_array_equal(out[test][1].numpy(), [1.0, 1.0], err_msg=test)
