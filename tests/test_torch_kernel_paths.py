"""Kernel H's path choice and kernel C's Holt-Winters launch size, at their
boundaries. Plain Python on the library's size formulas (the shared-memory
mirror is held to its C function by a card test in test_torch_kernels.py),
so these run on the CPU."""
import pytest

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
