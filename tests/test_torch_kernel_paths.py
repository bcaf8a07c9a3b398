"""Kernel H's path choice, kernels A and N's path choice and warp-path grid,
kernel O's Kruskal-Wallis, rank and Friedman paths and warp-path grid, kernel
B's ma_band paths, kernel P's paths, and kernel C's Holt-Winters launch size,
at their boundaries. Plain Python
on the library's size formulas (the mirrors are held to their C functions
by card tests in test_torch_kernels.py), so these run on the CPU."""
import pytest
import torch

from foremast_tpu_torch import kernels


@pytest.mark.parametrize("T, path, cl", [
    (1, "cta", 1), (16, "cta", 1), (2048, "cta", 1), (4095, "cta", 1), (4096, "cta", 1),
    (4097, "cluster", 2), (4112, "cluster", 2), (8192, "cluster", 2), (8193, "cluster", 3),
    (4098, "cluster", 2), (12288, "cluster", 3), (12289, "cluster", 4), (16383, "cluster", 4),
    (16384, "cluster", 4)])
def test_bivariate_path_by_shape(T, path, cl):
    assert kernels.bivariate_path(T) == path
    assert kernels.bivariate_cluster(T) == cl
    assert kernels.bivariate_cluster(T, path) == cl


@pytest.mark.parametrize("T, cl, slice_t", [
    (16384, 4, 4096), (4112, 2, 2064), (4097, 2, 2064), (100, 1, 112), (100, 2, 64),
    (16384, 1, 16384), (5, 8, 16), (8193, 3, 2736), (16384, 8, 2048)])
def test_bivariate_slices_are_shares_rounded_to_16(T, cl, slice_t):
    s = kernels.bivariate_slice(T, cl)
    assert s == slice_t and s % 16 == 0 and s * cl >= T
    assert kernels.bivariate_smem_bytes(T, cl) == 896 + 11 * s


def test_bivariate_forced_paths_serve_what_they_hold():
    # the cluster path is at least two CTAs, at any T
    assert kernels.bivariate_cluster(128, "cluster") == 2
    assert kernels.bivariate_cluster(16384, "cluster") == 4
    # one CTA holds a row of 16384 (180 KB), not one past its shared memory
    assert kernels.bivariate_cluster(16384, "cta") == 1
    limit = (kernels.CTA_SMEM_BYTES - 896) // 11 // 16 * 16
    assert kernels.bivariate_cluster(limit, "cta") == 1
    with pytest.raises(ValueError):
        kernels.bivariate_cluster(limit + 16, "cta")
    with pytest.raises(ValueError):
        kernels.bivariate_cluster(2048, "warp")
    # a cluster slice never passes BI_SLICE_T at the largest T
    assert kernels.bivariate_slice(kernels.MAX_BI_T, kernels.bivariate_cluster(
        kernels.MAX_BI_T)) <= kernels.BI_SLICE_T


@pytest.mark.parametrize("B, stride, warps", [
    (1, 1440, 4), (32, 1440, 4), (129, 1440, 8), (100_000, 1440, 3128),
    (100_000, 16384, 512), (100_000, 8192, 1024), (1_000_000, 1440, 5824),
    (100_000, 1, 3128), (10, 16384, 4), (100_000, 2048, 3128), (500_000, 2048, 4096)])
def test_smooth_hw_warps_by_rows_and_ring(B, stride, warps):
    """A warp a group of 32 rows while the rings (32 stride floats a warp)
    fit SCRATCH_BYTES, in whole CTAs of four."""
    n = kernels.smooth_hw_warps(B, stride)
    assert n == warps and n % 4 == 0
    assert n * 32 * stride * 4 <= max(kernels.SCRATCH_BYTES, 4 * 32 * stride * 4)


def test_reset_launches_clears_the_path_counts():
    kernels.bivariate_path_launches["cluster"] += 3
    kernels.reset_launches()
    assert set(kernels.bivariate_path_launches) == set(kernels.BIVARIATE_PATHS)
    assert not any(kernels.bivariate_path_launches.values())


@pytest.mark.parametrize("T, path", [
    (1, "warp"), (16, "warp"), (128, "warp"), (256, "warp"), (257, "cta"), (4096, "cta"),
    (4097, "scratch"), (16384, "scratch")])
def test_pair_path_by_window(T, path):
    assert kernels.pair_path(T) == path


def _pair_verdict_args(B, T):
    f, b, i = torch.float32, torch.bool, torch.int32
    return ([torch.zeros(B, T, dtype=f), torch.ones(B, T, dtype=b),
             torch.zeros(B, T, dtype=f), torch.ones(B, T, dtype=b)]
            + [torch.zeros(B, dtype=d) for d in (f, i, i, i, f, i, f)]
            + [torch.zeros(B, 4, dtype=i)])


def _pair_tests_args(B, T):
    return (torch.zeros(B, T), torch.ones(B, T, dtype=torch.bool), torch.zeros(B, T),
            torch.ones(B, T, dtype=torch.bool))


_KW = dict(wilcoxon_table=torch.zeros(1, 2), ks_exact_max=256, wilcoxon_exact_max_n=1)


@pytest.mark.parametrize("T, path, limit", [
    (257, "warp", "WARP_PAIR_T = 256"), (16384, "warp", "WARP_PAIR_T = 256"),
    (4097, "cta", "SHARED_PAIR_T = 4096"), (16384, "cta", "SHARED_PAIR_T = 4096"),
    (128, "block", "paths")])
def test_forced_pair_paths_refuse_a_window_they_do_not_serve(T, path, limit):
    """Kernels A and N refuse a forced path that does not serve T, naming
    the limit, before they look at a tensor (these are CPU tensors)."""
    with pytest.raises(ValueError, match=limit):
        kernels.pair_verdict(*_pair_verdict_args(2, T), **_KW, path=path)
    with pytest.raises(ValueError, match=limit):
        kernels.pair_tests(*_pair_tests_args(2, T), 15, **_KW, path=path)


@pytest.mark.parametrize("path", ["cta", "scratch"])
def test_pair_tests_phase_stamps_are_the_warp_path_s(path):
    clocks = torch.zeros(2, len(kernels.TESTS_PHASES) + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="warp path"):
        kernels.pair_tests(*_pair_tests_args(2, 128), 15, **_KW, path=path, phase_clocks=clocks)


def test_tests_phases_are_kernel_a_s_without_its_band():
    assert kernels.TESTS_PHASES == kernels.PAIR_PHASES[:-1]
    assert kernels.PAIR_PHASES[-1] == "gates_band"


_W = kernels.PAIR_WARPS


@pytest.mark.parametrize("B, grid", [(1, 1), (_W - 1, 1), (_W, 1), (_W + 1, 2),
                                     (100_000, -(-100_000 // _W))])
def test_pair_warp_grid_holds_a_warp_a_pair(B, grid):
    assert kernels.pair_warp_grid(B) == grid
    assert (grid - 1) * _W < B <= grid * _W


def test_reset_launches_clears_the_pair_path_counts():
    kernels.pair_path_launches["warp"] += 2
    kernels.pair_tests_path_launches["scratch"] += 1
    kernels.reset_launches()
    for counts in (kernels.pair_path_launches, kernels.pair_tests_path_launches):
        assert set(counts) == set(kernels.PAIR_PATHS)
        assert not any(counts.values())


@pytest.mark.parametrize("k, T, path", [
    (2, 64, "warp"), (3, 128, "warp"), (5, 64, "warp"), (4, 128, "warp"), (512, 1, "warp"),
    (1, 512, "warp"), (1, 1, "warp"), (513, 1, "cta"), (3, 171, "cta"), (8192, 1, "cta"),
    (2, 4096, "cta"), (8193, 1, "scratch"), (3, 16384, "scratch")])
def test_kruskal_path_by_shape(k, T, path):
    assert kernels.WARP_RANK_KEYS == 512
    assert kernels.kruskal_path(k, T) == path
    assert kernels.kruskal_serves(path, k, T)
    for other in kernels.KRUSKAL_PATHS[kernels.KRUSKAL_PATHS.index(path):]:
        assert kernels.kruskal_serves(other, k, T)


def _groups(B, k, T):
    return torch.zeros(B, k, T), torch.ones(B, k, T, dtype=torch.bool)


@pytest.mark.parametrize("k, T, path, limit", [
    (3, 171, "warp", "WARP_RANK_KEYS = 512"), (3, 16384, "warp", "WARP_RANK_KEYS = 512"),
    (8193, 1, "cta", "SHARED_RANK_KEYS = 8192"), (3, 16384, "cta", "SHARED_RANK_KEYS = 8192"),
    (3, 128, "block", "paths")])
def test_forced_kruskal_paths_refuse_a_row_they_do_not_serve(k, T, path, limit):
    """kruskal_groups refuses a forced path that does not serve k T, naming
    the limit, before it looks at a tensor (these are CPU tensors)."""
    with pytest.raises(ValueError, match=limit):
        kernels.kruskal_groups(*_groups(2, k, T), path=path)


_KW_W = kernels.KRUSKAL_WARPS


@pytest.mark.parametrize("B, grid", [(1, 1), (_KW_W - 1, 1), (_KW_W, 1), (_KW_W + 1, 2),
                                     (100_000, -(-100_000 // _KW_W))])
def test_kruskal_warp_grid_holds_a_warp_a_row(B, grid):
    assert kernels.kruskal_warp_grid(B) == grid
    assert (grid - 1) * _KW_W < B <= grid * _KW_W


@pytest.mark.parametrize("T, path", [
    (1, "staged"), (128, "staged"), (1000, "staged"), (1024, "staged"), (2048, "staged"),
    (4095, "staged"), (4096, "staged"), (4097, "long"), (5000, "long"), (8192, "long"),
    (16383, "long"), (16384, "long")])
def test_band_path_by_window(T, path):
    assert kernels.STAGED_BAND_T == 4096
    assert kernels.band_path(T) == path
    assert kernels.band_serves(path, T) and kernels.band_serves("unstaged", T)
    # each of the two staging paths serves its own side of STAGED_BAND_T alone
    other = {"staged": "long", "long": "staged"}[path]
    assert not kernels.band_serves(other, T)


def _band_args(B, T):
    return (torch.zeros(B, T), torch.ones(B, T, dtype=torch.bool),
            torch.zeros(B, T, dtype=torch.bool), 30, torch.ones(B),
            torch.zeros(B, dtype=torch.int32), torch.zeros(B))


@pytest.mark.parametrize("T, path, limit", [
    (4097, "staged", "STAGED_BAND_T = 4096"), (4096, "long", "STAGED_BAND_T = 4096 < T"),
    (100, "long", "MAX_BAND_T = 16384"), (16385, "long", "16384"),
    (1024, "warp", "paths"), (16385, "unstaged", "16384")])
def test_forced_band_paths_refuse_a_window_they_do_not_serve(T, path, limit):
    with pytest.raises(ValueError, match=limit):
        kernels.ma_band(*_band_args(2, T), path=path)


def test_reset_launches_clears_the_kruskal_and_band_path_counts():
    kernels.kruskal_path_launches["warp"] += 2
    kernels.band_path_launches["staged"] += 1
    kernels.reset_launches()
    assert set(kernels.kruskal_path_launches) == set(kernels.KRUSKAL_PATHS)
    assert set(kernels.band_path_launches) == set(kernels.BAND_PATHS)
    assert not any(kernels.kruskal_path_launches.values())
    assert not any(kernels.band_path_launches.values())


@pytest.mark.parametrize("T, path", [
    (1, "warp"), (8, "warp"), (100, "warp"), (256, "warp"), (511, "warp"), (512, "warp"),
    (513, "cta"), (4096, "cta"), (8192, "cta"), (8193, "scratch"), (1 << 20, "scratch"),
    ((1 << 20) + 1, "scratch"), (1 << 30, "scratch")])
def test_rank_path_by_window(T, path):
    """rank_and_ties' path: a warp a row up to WARP_RANK_KEYS (Kruskal's
    limit), then a CTA a row in shared memory, then device scratch; every
    path serves what a shorter-limit path serves."""
    assert kernels.WARP_RANK_KEYS == 512 and kernels.RANK_PATHS == kernels.KRUSKAL_PATHS
    assert kernels.rank_path(T) == path
    served = [p for p in kernels.RANK_PATHS if kernels.rank_serves(p, T)]
    assert served == list(kernels.RANK_PATHS[kernels.RANK_PATHS.index(path):])


def _rank_args(B, T, device="cpu"):
    return torch.zeros(B, T, device=device), torch.ones(B, T, dtype=torch.bool, device=device)


@pytest.mark.parametrize("T, path, limit", [
    (513, "warp", "WARP_RANK_KEYS = 512"), (8193, "cta", "SHARED_RANK_KEYS = 8192"),
    (256, "block", "paths"), ((1 << 30) + 1, "scratch", "30-bit")])
def test_forced_rank_paths_refuse_a_row_they_do_not_serve(T, path, limit):
    """rank_and_ties refuses a forced path that does not serve T, naming
    the limit, before it looks at a tensor (CPU tensors; meta tensors past
    the scratch path's 2^30 keys, the key's tag)."""
    with pytest.raises(ValueError, match=limit):
        kernels.rank_and_ties(*_rank_args(1, T, "meta" if T > 1 << 20 else "cpu"), path=path)


@pytest.mark.parametrize("T, path", [(600, None), (256, "cta"), (256, "scratch")])
def test_rank_phase_clocks_are_the_warp_path_s_alone(T, path):
    clocks = torch.zeros(1, len(kernels.RANK_PHASES) + 1, dtype=torch.int64)
    with pytest.raises(ValueError, match="warp path alone"):
        kernels.rank_and_ties(*_rank_args(1, T), phase_clocks=clocks, path=path)


def test_rank_phases_name_the_stamps_between_six_clocks():
    assert kernels.RANK_PHASES == ("load", "sort", "bounds", "ranks", "tail")
    assert len(kernels.RANK_PHASES) == len(kernels.KRUSKAL_PHASES)


def test_reset_launches_clears_the_rank_path_counts():
    kernels.rank_path_launches["warp"] += 3
    kernels.launches["rank_and_ties"] += 3
    kernels.reset_launches()
    assert set(kernels.rank_path_launches) == set(kernels.RANK_PATHS)
    assert not any(kernels.rank_path_launches.values())
    assert kernels.launches["rank_and_ties"] == 0


@pytest.mark.parametrize("n, k, path", [
    (128, 3, "warp"), (1, 1, "warp"), (20, 6, "warp"), (7, 16, "warp"), (1000, 2, "warp"),
    (1 << 20, 16, "warp"), ((1 << 20) + 1, 3, "cta"), (0, 3, "cta"), (7, 17, "cta"),
    (7, 200, "cta"), (5, 0, "cta")])
def test_friedman_path_by_shape(n, k, path):
    """friedman's path: a warp for FRIEDMAN_ROWS rows up to WARP_FRIEDMAN_K
    treatments and WARP_FRIEDMAN_N blocks, the first design's CTA a row
    beyond; the cta path serves every shape."""
    assert kernels.WARP_FRIEDMAN_K == 16 and kernels.WARP_FRIEDMAN_N == 1 << 20
    assert kernels.FRIEDMAN_PATHS == ("warp", "cta")
    assert kernels.friedman_path(n, k) == path
    assert kernels.friedman_serves(path, n, k) and kernels.friedman_serves("cta", n, k)
    assert kernels.friedman_serves("warp", n, k) == (path == "warp")


def _tables(B, n, k):
    return torch.zeros(B, n, k), torch.ones(B, n, dtype=torch.bool)


@pytest.mark.parametrize("n, k, path, limit", [
    (7, 17, "warp", "WARP_FRIEDMAN_K = 16"), (7, 0, "warp", "WARP_FRIEDMAN_K = 16"),
    (0, 3, "warp", "WARP_FRIEDMAN_N"), (128, 3, "block", "paths")])
def test_forced_friedman_paths_refuse_a_table_they_do_not_serve(n, k, path, limit):
    """friedman refuses a forced path that does not serve the shape, naming
    the limit, before it looks at a tensor (these are CPU tensors)."""
    with pytest.raises(ValueError, match=limit):
        kernels.friedman(*_tables(2, n, k), path=path)


@pytest.mark.parametrize("n, k, path", [
    (100_000, 8, "select"), (100_000, 0, "select"), (100_000, 1, "select"),
    (100_000, 32, "select"), (5, 33, "select"), (33, 100, "chunked"), (100_000, 33, "chunked"),
    (100_000, 500, "chunked"), (4096, 3000, "chunked")])
def test_fleet_topk_path_by_k(n, k, path):
    """fleet_topk's path: the selection by warp minima while min(k, n) <=
    FLEET_SELECT_K, the first design's chunk sorts above it; the chunked
    path serves every k."""
    assert kernels.FLEET_SELECT_K == 32 and kernels.FLEET_TOPK_PATHS == ("select", "chunked")
    assert kernels.fleet_topk_path(n, k) == path
    assert kernels.fleet_topk_serves(path, n, k) and kernels.fleet_topk_serves("chunked", n, k)
    assert kernels.fleet_topk_serves("select", n, k) == (path == "select")


@pytest.mark.parametrize("n, k, path, limit", [
    (100, 33, "select", "FLEET_SELECT_K = 32"), (100_000, 500, "select", "FLEET_SELECT_K = 32"),
    (100, 8, "sort", "paths")])
def test_forced_fleet_topk_paths_refuse_a_k_they_do_not_serve(n, k, path, limit):
    with pytest.raises(ValueError, match=limit):
        kernels.fleet_topk(torch.zeros(n), k, path=path)


def test_reset_launches_clears_the_friedman_and_fleet_topk_path_counts():
    kernels.friedman_path_launches["warp"] += 2
    kernels.fleet_topk_path_launches["select"] += 2
    kernels.launches["friedman"] += 2
    kernels.reset_launches()
    assert set(kernels.friedman_path_launches) == set(kernels.FRIEDMAN_PATHS)
    assert set(kernels.fleet_topk_path_launches) == set(kernels.FLEET_TOPK_PATHS)
    assert not any(kernels.friedman_path_launches.values())
    assert not any(kernels.fleet_topk_path_launches.values())
    assert kernels.launches["friedman"] == 0


@pytest.mark.parametrize("D, path", [(2, "warp"), (20, "warp"), (32, "warp"), (33, "cta"),
                                     (47, "cta"), (160, "cta")])
def test_st_path_by_columns(D, path):
    assert kernels.st_path(D) == path


@pytest.mark.parametrize("C, path", [(0, "table"), (4, "table"), (1024, "table"),
                                     (1025, "tiled"), (2048, "tiled")])
def test_period_path_by_candidates(C, path):
    assert kernels.period_path(C) == path


@pytest.mark.parametrize("F, H, path", [(3, 32, "group"), (32, 256, "group"), (33, 32, "wide"),
                                        (40, 32, "wide"), (4, 257, "wide"), (4, 320, "wide")])
def test_lstm_bptt_path_by_width(F, H, path):
    assert kernels.lstm_bptt_path(F, H) == path


@pytest.mark.parametrize("K, F, H, Z, KB", [
    (45, 4, 32, 16, 8), (45, 32, 256, 256, 8), (45, 40, 32, 16, 6), (2, 40, 32, 16, 2),
    (45, 300, 8, 4, 1), (45, 4, 320, 64, 8), (45, 4, 1024, 64, 5)])
def test_lstm_train_blocks_keep_the_first_design_s_windows_and_fit_a_cta(K, F, H, Z, KB):
    """At the widths the first design served (F and H up to 256) a CTA runs
    min(K, 8, 256 // F) windows as before; above them as many as a CTA's
    shared memory holds."""
    got, nkb = kernels.lstm_train_blocks(K, F, H, Z)
    assert (got, nkb) == (KB, -(-K // KB))
    assert got * 4 * (2 * F + 10 * H + Z + 4 * F) <= kernels.CTA_SMEM_BYTES


def test_lstm_train_blocks_refuse_a_window_past_a_cta():
    with pytest.raises(ValueError, match="shared memory"):
        kernels.lstm_train_blocks(2, 4, 6000, 64)


def test_reset_launches_clears_the_st_period_and_bptt_path_counts():
    for counts in (kernels.st_path_launches, kernels.period_path_launches,
                   kernels.bptt_path_launches):
        for k in counts:
            counts[k] = 3
    kernels.reset_launches()
    assert not any(kernels.st_path_launches.values())
    assert not any(kernels.period_path_launches.values())
    assert not any(kernels.bptt_path_launches.values())


def test_forced_paths_refuse_by_name_on_the_cpu():
    x = torch.zeros(2, 64)
    m = torch.ones(2, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="no path"):
        kernels.st_fit(x, m, m, torch.full((2,), 8, dtype=torch.int32), 3, 0, 1e-4, 3e-3, 3,
                       path="block")
    with pytest.raises(ValueError, match="WARP_ST_D"):
        kernels.st_fit(x, m, m, torch.full((2,), 8, dtype=torch.int32), 3, 30, 1e-4, 3e-3, 3,
                       path="warp")
    with pytest.raises(ValueError, match="TILE_CANDIDATES"):
        kernels.detect_period(x, m, torch.arange(2, 1027, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32), 0.2, 0.05, 0.01, path="table")
