"""Past the first designs' limits: kernels A and N at windows past 16,384
steps, kernel O past 2^20 keys a row, kernel P past 2^30 rows and 32-bit
keys, and kernel E's two paths.

Routing is plain Python and is tested here directly (meta tensors stand in
for shapes too large to allocate: the launchers refuse them before they
touch a tensor). Kernel P's split and merge is a plain function of its
per-slice top-k, driven here by the twin at a slice of 1,000 rows and held
to the twin on the whole: values and indices bit for bit, counts exactly.

Parity with the JAX reference on the CPU (the port's plain twins, which
the kernels equal on the card), at the new shapes:
  * two_sample_tests_plain and all_pairwise_tests at T = 20,000: statistics
    to rtol 1e-6 and p to atol 1e-5 of scipy in float64; the reference's
    float32 rank sums and count products drift there (its U1 by up to
    ~1e-4 relative), so it is held within 1e-5 plus its own drift from
    scipy;
  * rank_and_ties_plain past 2^20 keys: ranks and counts exactly equal to
    the reference's, the tie term exactly the integer sum (the reference's
    float32 sum rounds: held within its own drift);
  * kruskal_plain at 8 groups of 172,800 (1,382,400 keys): H to rtol 1e-6
    and p to atol 1e-5 of scipy, the reference within its drift;
  * a fully tied row of 2^21 + 1 keys: the tie term t^3 - t leaves a
    64-bit integer's t^3 range; the twin's float64 sum is held to the exact
    integer within one float32 ulp (its sum rounds past 2^53), and the
    reference's float32 sum is bracketed (it is off by far more: R2).
"""
import numpy as np
import pytest
import scipy.stats as sps
import torch

from foremast_tpu_torch import kernels
from foremast_tpu_torch.parallel import fleet as tfl

P_ATOL = 1e-5
S_RTOL = 1e-6


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("T", [16385, 43200, 1 << 20, kernels.PAIR_SORT_T])
def test_pair_path_past_the_largest_bucket_is_scratch(T):
    """Kernels A and N take any T up to PAIR_SORT_T on their scratch path
    (a 30-day window at 60 s is 43,200 steps a side)."""
    assert kernels.pair_path(T) == "scratch"
    assert kernels.pair_path(kernels.SHARED_PAIR_T + 1) == "scratch"


@pytest.mark.parametrize("launcher", ["pair_verdict", "pair_tests"])
def test_pair_launchers_refuse_t_past_the_sort_index(launcher):
    T = kernels.PAIR_SORT_T + 1
    x = torch.empty((1, T), device="meta")
    m = torch.empty((1, T), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="PAIR_SORT_T"):
        if launcher == "pair_tests":
            kernels.pair_tests(x, m, x, m, 15, wilcoxon_table=None, ks_exact_max=256,
                               wilcoxon_exact_max_n=50)
        else:
            kernels.pair_verdict(x, m, x, m, *([None] * 8), wilcoxon_table=None,
                                 ks_exact_max=256, wilcoxon_exact_max_n=50)


@pytest.mark.parametrize("k, T", [(1, (1 << 20) + 1), (8, 172_800), (1, 1 << 24), (1, 1 << 30),
                                  (2, 1 << 29)])
def test_rank_and_kruskal_paths_past_two_to_the_20_are_scratch(k, T):
    """Kernel O's scratch path serves rows up to MAX_RANK_KEYS = 2^30 keys,
    what its key's 30-bit tag holds."""
    assert kernels.MAX_RANK_KEYS == 1 << 30
    assert kernels.kruskal_path(k, T) == "scratch" and kernels.kruskal_serves("scratch", k, T)
    if k == 1:
        assert kernels.rank_path(T) == "scratch" and kernels.rank_serves("scratch", T)


@pytest.mark.parametrize("entry", ["rank_and_ties", "kruskal_groups"])
def test_kernel_o_refuses_past_the_tag(entry):
    """Past 2^30 keys a row the refusal names the key's 30-bit tag."""
    with pytest.raises(ValueError, match="30-bit"):
        if entry == "rank_and_ties":
            n = kernels.MAX_RANK_KEYS + 1
            kernels.rank_and_ties(torch.empty((1, n), device="meta"),
                                  torch.empty((1, n), dtype=torch.bool, device="meta"))
        else:
            T = kernels.MAX_RANK_KEYS // 2 + 1
            kernels.kruskal_groups(torch.empty((1, 2, T), device="meta"),
                                   torch.empty((1, 2, T), dtype=torch.bool, device="meta"))
    assert not kernels.rank_serves("scratch", kernels.MAX_RANK_KEYS + 1)


@pytest.mark.parametrize("kind, B, path", [
    (kernels.SMOOTH_SES, 1, "scan"), (kernels.SMOOTH_SES, 100_000, "scan"),
    (kernels.SMOOTH_DES, 1, "scan"), (kernels.SMOOTH_DES, kernels.WALK_ROWS - 1, "scan"),
    (kernels.SMOOTH_DES, kernels.WALK_ROWS, "walk"), (kernels.SMOOTH_DES, 100_000, "walk")])
def test_scan_path_by_kind_and_rows(kind, B, path):
    """Kernel E walks DES a lane a row from WALK_ROWS rows; SES and fewer
    DES rows take the scan."""
    assert kernels.scan_path(kind, B, 16384) == path
    assert kernels.scan_serves("scan", kind)
    assert kernels.scan_serves("walk", kind) == (kind == kernels.SMOOTH_DES)


@pytest.mark.parametrize("kind, path, match", [
    (kernels.SMOOTH_SES, "walk", "DES"), (kernels.SMOOTH_DES, "chunked", "paths")])
def test_forced_scan_paths_refuse_what_they_do_not_serve(kind, path, match):
    """Forced before it looks at a tensor: SES has no walk path."""
    x, m, al = torch.zeros(2, 8), torch.ones(2, 8, dtype=torch.bool), torch.ones(2)
    with pytest.raises(ValueError, match=match):
        kernels.affine_scan(kind, x, m, al, al, path=path)


def test_reset_launches_clears_the_scan_path_counts():
    assert kernels.SCAN_PATHS == ("scan", "walk")
    kernels.scan_path_launches["walk"] += 2
    kernels.launches["affine_scan"] += 2
    kernels.reset_launches()
    assert set(kernels.scan_path_launches) == set(kernels.SCAN_PATHS)
    assert not any(kernels.scan_path_launches.values()) and kernels.launches["affine_scan"] == 0


# ---------------------------------------------------------------------------
# kernel P's split and merge, driven by the twin
# ---------------------------------------------------------------------------
def _fleet(n, seed):
    """Severities on a coarse grid (ties within and across slices), +-NaN,
    +-inf, +-0 and a run of equal values across the 1,000-row slice edges."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=n), 1).astype(np.float32)
    v[rng.random(n) < 0.01] = np.nan
    v[rng.random(n) < 0.01] = -np.nan
    v[rng.random(n) < 0.005] = np.inf
    v[rng.random(n) < 0.005] = -np.inf
    v[rng.random(n) < 0.02] = -0.0
    v[995:1010] = 9.5
    v[2995:3003] = 9.5
    u = rng.random(n) > 0.4
    u[995:1010] = True
    return torch.from_numpy(v), torch.from_numpy(u)


def _twin(values, k, valid):
    return tfl.fleet_topk_plain(values, k, valid, 0)


def _same_topk(got, want):
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        bits = (lambda t: t.view(torch.int32)) if w.dtype == torch.float32 else (lambda t: t)
        assert torch.equal(bits(g), bits(w))


@pytest.mark.parametrize("base", [0, 7, (1 << 32) + 3, 3 * (1 << 30)])
@pytest.mark.parametrize("k", [0, 1, 8, 33, 500])
@pytest.mark.parametrize("with_valid", [True, False])
def test_fleet_topk_slices_equal_the_twin_on_the_whole(k, base, with_valid):
    """5,003 rows in slices of 1,000: the top k (ties across slices lower
    index first), the indices past 2^32 in int64, the counts summed."""
    v, u = _fleet(5003, k + base % 97)
    valid = u if with_valid else None
    got = kernels.fleet_topk_slices(v, k, valid, base, 1000, _twin)
    _same_topk(got, tfl.fleet_topk_plain(v, k, valid, base))
    if with_valid:
        assert got[0].dtype == torch.int64 and int(got[0]) == int(u.sum())


def test_fleet_topk_slices_merge_in_slices_while_candidates_outnumber_one():
    """12,000 rows at k = 300 in slices of 1,000: 3,600 candidates, merged
    again in slices (two rounds)."""
    v, u = _fleet(12_000, 3)
    _same_topk(kernels.fleet_topk_slices(v, 300, u, 11, 1000, _twin),
               tfl.fleet_topk_plain(v, 300, u, 11))


def test_fleet_topk_slices_refuse_k_past_half_a_slice():
    v, u = _fleet(2001, 4)
    with pytest.raises(ValueError, match="k <= 500"):
        kernels.fleet_topk_slices(v, 501, u, 0, 1000, _twin)
    # within one slice any k is one call
    _same_topk(kernels.fleet_topk_slices(v[:1000], 999, u[:1000], 5, 1000, _twin),
               tfl.fleet_topk_plain(v[:1000], 999, u[:1000], 5))


def test_fleet_topk_launches_slices_past_either_limit(monkeypatch):
    """kernels.fleet_topk takes one launch within MAX_FLEET_SLICE rows and
    32-bit keys, and slices (each launch keyed from 0) past either; a
    stand-in launch (the twin) records what each launch got."""
    calls = []

    def launch(values, k, valid, base, path):
        calls.append((values.shape[0], base))
        return tfl.fleet_topk_plain(values, k, valid, base)

    monkeypatch.setattr(kernels, "_fleet_topk_launch", launch)
    monkeypatch.setattr(kernels, "MAX_FLEET_SLICE", 1000)
    v, u = _fleet(2500, 5)
    _same_topk(kernels.fleet_topk(v[:1000], 8, u[:1000], 40),
               tfl.fleet_topk_plain(v[:1000], 8, u[:1000], 40))
    assert calls == [(1000, 40)]
    calls.clear()
    _same_topk(kernels.fleet_topk(v, 8, u, 40), tfl.fleet_topk_plain(v, 8, u, 40))
    assert calls == [(1000, 0), (1000, 0), (500, 0), (24, 0)]
    calls.clear()
    base = kernels.MAX_FLEET_ROWS - 100
    _same_topk(kernels.fleet_topk(v[:1000], 8, u[:1000], base),
               tfl.fleet_topk_plain(v[:1000], 8, u[:1000], base))
    assert calls == [(1000, 0)]
    with pytest.raises(ValueError, match="base >= 0"):
        kernels.fleet_topk(v, 8, u, -1)


# ---------------------------------------------------------------------------
# parity with the reference at the new shapes
# ---------------------------------------------------------------------------
def _long_pairs(T, B=3):
    """B window pairs of T steps: row 0 a null pair, row 1 a shift of 0.05,
    row 2 values on a grid of 0.5 (ties, zero differences) with a shift;
    ~2% of slots masked."""
    rng = np.random.default_rng(T)
    x = rng.normal(size=(B, T)).astype(np.float32)
    y = rng.normal(size=(B, T)).astype(np.float32)
    y[1] += 0.05
    x[2], y[2] = np.round(x[2] * 2) / 2, np.round(y[2] * 2 + 0.5) / 2
    xm, ym = rng.random((B, T)) > 0.02, rng.random((B, T)) > 0.02
    return x, xm, y, ym


def _scipy_family(x, xm, y, ym):
    """scipy in float64 on each pair: Mann-Whitney (U1, p), Kruskal (H, p),
    Wilcoxon (W, p; the normal approximation, zeros dropped) and KS (D and
    Stephens' p, as the port takes it past KS_EXACT_MAX_T)."""
    import scipy.special as ssp

    out = {k: ([], []) for k in ("mann_whitney", "kruskal", "wilcoxon", "ks")}
    for i in range(x.shape[0]):
        a, b = x[i][xm[i]].astype(np.float64), y[i][ym[i]].astype(np.float64)
        mw = sps.mannwhitneyu(a, b, alternative="two-sided", method="asymptotic",
                              use_continuity=True)
        kw = sps.kruskal(a, b)
        both = xm[i] & ym[i]
        d = (x[i] - y[i])[both].astype(np.float64)
        w = sps.wilcoxon(d[d != 0], zero_method="wilcox", correction=False, method="approx")
        sa, sb = np.sort(a), np.sort(b)
        n1, n2 = len(a), len(b)
        pts = np.concatenate([sa, sb])
        t = np.max(np.abs(np.searchsorted(sa, pts, "right") * n2
                          - np.searchsorted(sb, pts, "right") * n1))
        D = t / (n1 * n2)
        en = np.sqrt(n1 * n2 / (n1 + n2))
        for name, s, p in (("mann_whitney", mw.statistic, mw.pvalue),
                           ("kruskal", kw.statistic, kw.pvalue),
                           ("wilcoxon", w.statistic, w.pvalue),
                           ("ks", D, ssp.kolmogorov((en + 0.12 + 0.11 / en) * D))):
            out[name][0].append(s)
            out[name][1].append(p)
    return {k: (np.asarray(s), np.asarray(p)) for k, (s, p) in out.items()}


@pytest.fixture(scope="module")
def long_family():
    """Both packages' families at T = 20,000 (past the old 16,384), and
    scipy's, computed once."""
    jax = pytest.importorskip("jax")  # noqa: F841
    from foremast_tpu.ops import pairwise as jpw
    from foremast_tpu_torch.ops import pairwise as tpw

    x, xm, y, ym = _long_pairs(20_000)
    t = [torch.from_numpy(a) for a in (x, xm, y, ym)]
    ref = {k: (np.asarray(s), np.asarray(p)) for k, (s, p) in
           jpw.all_pairwise_tests(x, xm, y, ym).items()}
    plain = tpw.two_sample_tests_plain(*t)
    battery = tpw.all_pairwise_tests(x, xm, y, ym, device="cpu")
    return _scipy_family(x, xm, y, ym), ref, plain, battery


@pytest.mark.parametrize("entry", ["two_sample_tests_plain", "all_pairwise_tests"])
@pytest.mark.parametrize("test", ["mann_whitney", "kruskal", "wilcoxon", "ks"])
def test_two_sample_family_past_16384_matches_scipy_and_the_reference(long_family, entry,
                                                                      test):
    exact, ref, plain, battery = long_family
    got = plain if entry == "two_sample_tests_plain" else battery
    s, p = got[test][0].numpy().astype(np.float64), got[test][1].numpy().astype(np.float64)
    es, ep = exact[test]
    np.testing.assert_allclose(s, es, rtol=S_RTOL, atol=1e-6)
    np.testing.assert_allclose(p, ep, atol=P_ATOL, rtol=0)
    rs, rp = ref[test]
    assert np.all(np.abs(s - rs) <= S_RTOL * np.abs(es) + 1e-6 + np.abs(rs - es))
    assert np.all(np.abs(p - rp) <= P_ATOL + np.abs(rp - ep))
    # the shifted rows are found at this length, the null row is not
    assert p[1] < 0.01 and p[2] < 0.01 and p[0] > 1e-3


def _tie_term(v, m):
    """The exact sum over tie groups of t^3 - t (Python integers)."""
    _, counts = np.unique(v[m], return_counts=True)
    return sum(int(c) ** 3 - int(c) for c in counts)


def test_rank_and_ties_past_two_to_the_20_matches_the_reference():
    """One row of 2^20 + 4,099 keys on a grid of 0.01 (ties), -0.0, NaN,
    +inf and 3% masked."""
    jax = pytest.importorskip("jax")
    from foremast_tpu.ops import ranks as jranks
    from foremast_tpu_torch.ops import ranks as tranks

    T = (1 << 20) + 4099
    rng = np.random.default_rng(T)
    v = np.round(rng.normal(size=T), 2).astype(np.float32)
    v[v == 0] = -0.0
    v[rng.random(T) < 0.001] = np.nan
    v[rng.random(T) < 0.001] = np.inf
    m = rng.random(T) > 0.03
    r, tie, n = tranks.rank_and_ties_plain(torch.from_numpy(v[None]), torch.from_numpy(m[None]))
    jr, jtie, jn = (np.asarray(a) for a in jax.jit(jranks.rank_and_ties)(v, m))
    np.testing.assert_array_equal(r[0].numpy(), jr)
    assert float(n[0]) == float(jn) == float(m.sum())
    # -0.0 and +0.0 one group, the NaNs one group of their own
    exact = _tie_term(np.where(np.isnan(v), np.float32(3e38), np.where(v == 0, 0.0, v)), m)
    assert float(tie[0]) == float(np.float32(exact))
    assert abs(float(jtie) - exact) <= 1e-3 * exact  # the reference's float32 sum


def test_kruskal_past_two_to_the_20_matches_scipy_and_the_reference():
    """8 groups of 172,800 (30 days at a 15 s scrape): 1,382,400 keys a
    row, values on a grid of 0.1, 2% masked, a shift of the first group in
    row 1."""
    jax = pytest.importorskip("jax")  # noqa: F841
    from foremast_tpu.ops import pairwise as jpw
    from foremast_tpu_torch.ops import pairwise as tpw

    B, k, T = 2, 8, 172_800
    rng = np.random.default_rng(k * T)
    g = np.round(rng.normal(size=(B, k, T)), 1).astype(np.float32)
    g[1, 0] += 0.02
    m = rng.random((B, k, T)) > 0.02
    H, p = (a.numpy().astype(np.float64) for a in tpw.kruskal_plain(torch.from_numpy(g),
                                                                    torch.from_numpy(m)))
    rH, rp = (np.asarray(a).astype(np.float64) for a in jpw.kruskal_batch(g, m))
    for i in range(B):
        s = sps.kruskal(*[gi[mi].astype(np.float64) for gi, mi in zip(g[i], m[i])])
        np.testing.assert_allclose(H[i], s.statistic, rtol=S_RTOL)
        np.testing.assert_allclose(p[i], s.pvalue, atol=P_ATOL)
        assert abs(p[i] - rp[i]) <= P_ATOL + abs(rp[i] - s.pvalue)
        assert abs(H[i] - rH[i]) <= S_RTOL * s.statistic + abs(rH[i] - s.statistic)
    assert p[1] < 0.01


def test_fully_tied_row_past_2097151_keys_gives_the_exact_tie_term():
    """2^21 + 1 equal valid keys: t^3 - t = 9,223,385,230,998,503,424 is past
    a signed 64-bit t^3 (kernel O sums such rows in limbs). The twin's
    float64 sum rounds past 2^53, so its float32 tie term is the exact
    value's to within one float32 ulp; the ranks are all (t + 1) / 2. The
    reference's float32 sum is bracketed: it drifts (R2)."""
    jax = pytest.importorskip("jax")
    from foremast_tpu.ops import ranks as jranks
    from foremast_tpu_torch.ops import ranks as tranks

    t = (1 << 21) + 1
    v, m = np.full(t, 2.5, np.float32), np.ones(t, bool)
    r, tie, n = tranks.rank_and_ties_plain(torch.from_numpy(v[None]), torch.from_numpy(m[None]))
    exact = t ** 3 - t
    assert t ** 3 > (1 << 63) - 1 > 2_097_151 ** 3
    want = np.float32(exact)
    assert abs(float(tie[0]) - float(want)) <= float(np.spacing(want))
    assert bool((r == (t + 1) / 2).all()) and float(n[0]) == t
    jr, jtie, _ = (np.asarray(a) for a in jax.jit(jranks.rank_and_ties)(v, m))
    np.testing.assert_array_equal(jr, r[0].numpy())
    assert np.isfinite(jtie) and jtie > 0
