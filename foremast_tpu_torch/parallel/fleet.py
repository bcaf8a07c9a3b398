"""Fleet canary scoring: one launch judges B (baseline, current) pairs.

Counterpart of the reference's ``parallel/fleet.py`` (`_pair_verdict`,
`score_pairs`, `pair_arg_spec`). `score_pairs` takes the reference's exact
12-argument signature and runs kernel A (``csrc/pair_verdict.cu``) on the
card, or its plain twin `pair_verdict_plain` on the CPU.

A pair is unhealthy if the enabled pairwise tests reject under the ALL/ANY
combinator, or the moving-average band over baseline ++ current flags more
than 30% of the current window. Multi-card scoring (`make_fleet_scorer`,
`fleet_summary`) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._device import as_tensor, resolve_device
from ..ops import forecast as fc
from ..ops.pairwise import (KS_EXACT_MAX_T, WILCOXON_EXACT_MAX_N, sign_test_exact,
                            two_sample_tests, wilcoxon_pmf_table)

__all__ = ["score_pairs", "pair_verdict_plain", "pair_arg_spec",
           "pair_args_from_numpy", "COMBINE_ANY", "COMBINE_ALL"]

_F = torch.float32

# test-enable bitmask positions
TEST_MANN_WHITNEY = 1
TEST_WILCOXON = 2
TEST_KRUSKAL = 4
TEST_KS = 8
TEST_FRIEDMAN = 16  # paired blocks, k=2 treatments: the exact sign test

COMBINE_ANY = 0  # unhealthy if ANY enabled test rejects
COMBINE_ALL = 1  # unhealthy only if ALL enabled tests reject

# minimum valid points per test
MIN_MANN_WHITNEY = 20
MIN_WILCOXON = 20
MIN_KRUSKAL = 5
MIN_FRIEDMAN = 5  # complete (both-sides-valid) blocks

# the band flags a pair when more than this share of the current window
# lies outside it
BAND_FRACTION = 0.3

# dtypes of score_pairs' 12 arguments, in order
_ARG_DTYPES = (torch.float32, torch.bool, torch.float32, torch.bool,
               torch.float32, torch.int32, torch.int32, torch.int32,
               torch.float32, torch.int32, torch.float32, torch.int32)
_ARG_NAMES = ("baseline", "b_mask", "current", "c_mask", "pvalue_threshold",
              "test_mask", "combine", "ma_window", "band_threshold",
              "bound_mode", "min_lower_bound", "min_points")


def pair_arg_spec(B: int, T: int):
    """Zeroed argument tuple matching score_pairs' signature (shapes and
    dtypes as the engine packs them)."""
    return (
        np.zeros((B, T), np.float32), np.zeros((B, T), bool),
        np.zeros((B, T), np.float32), np.zeros((B, T), bool),
        np.zeros(B, np.float32),                    # pairwise p threshold
        np.zeros(B, np.int32),                      # enabled-test bitmask
        np.zeros(B, np.int32),                      # ANY/ALL combinator
        np.full(B, 30, np.int32),                   # ma_window
        np.zeros(B, np.float32),                    # band threshold
        np.ones(B, np.int32),                       # bound mode
        np.zeros(B, np.float32),                    # min lower bound
        np.tile(np.asarray(
            [MIN_MANN_WHITNEY, MIN_WILCOXON, MIN_KRUSKAL, MIN_FRIEDMAN],
            np.int32), (B, 1)),
    )


def pair_args_from_numpy(args, device) -> tuple:
    """The 12-tuple score_pairs takes, as tensors on `device`.

    Carries the reference's packing across: (B, T) float32 and bool
    windows, the (B,) float32 / int32 policy arrays and the (B, 3|4) int32
    min_points, each with the same dtype. Tensors must already be on
    `device`. min_points of width 3 keeps Friedman at MIN_FRIEDMAN.
    """
    if len(args) != 12:
        raise ValueError(f"score_pairs takes 12 arguments, got {len(args)}")
    dev = torch.device(device)
    baseline = as_tensor(args[0], _F, dev, "baseline")
    B, T = baseline.shape
    out = [baseline]
    for a, dt, name in zip(args[1:], _ARG_DTYPES[1:], _ARG_NAMES[1:]):
        if name == "min_points":
            t = as_tensor(a, dt, dev, name)
            if t.shape[0] != B or t.shape[1] not in (3, 4):
                raise ValueError(f"min_points must be (B, 3) or (B, 4), got {tuple(t.shape)}")
        else:
            shape = (B, T) if name in ("b_mask", "current", "c_mask") else (B,)
            t = as_tensor(a, dt, dev, name, shape)
        out.append(t)
    return tuple(out)


def pair_verdict_plain(baseline, b_mask, current, c_mask, pvalue_threshold,
                       test_mask, combine, ma_window, band_threshold,
                       bound_mode, min_lower_bound, min_points):
    """Plain twin of kernel A on tensors: the reference's `_pair_verdict`
    with the batch written out."""
    B, Tb = baseline.shape
    dev = baseline.device
    if min_points.shape[-1] >= 4:
        friedman_gate = min_points[:, 3].to(_F)
    else:
        friedman_gate = torch.full((B,), float(MIN_FRIEDMAN), device=dev)
    mp = min_points.to(_F)
    n_b = b_mask.to(_F).sum(-1)
    n_c = c_mask.to(_F).sum(-1)
    n_min = torch.minimum(n_b, n_c)

    tests = two_sample_tests(baseline, b_mask, current, c_mask)
    paired = b_mask & c_mask
    n_blocks = paired.to(_F).sum(-1)
    _, p_friedman = sign_test_exact(baseline, current, paired)
    pvals = torch.stack([tests["mann_whitney"][1], tests["wilcoxon"][1],
                         tests["kruskal"][1], tests["ks"][1], p_friedman], dim=-1)

    enough = torch.stack([n_min >= mp[:, 0], n_min >= mp[:, 1], n_min >= mp[:, 2],
                          n_min >= 2, n_blocks >= friedman_gate], dim=-1)
    bits = torch.tensor([TEST_MANN_WHITNEY, TEST_WILCOXON, TEST_KRUSKAL, TEST_KS,
                         TEST_FRIEDMAN], dtype=torch.int32, device=dev)
    enabled = ((test_mask[:, None] & bits) > 0) & enough
    rejects = (pvals < pvalue_threshold[:, None]) & enabled
    n_enabled = enabled.sum(-1)
    any_reject = rejects.any(-1)
    all_reject = (rejects | ~enabled).all(-1) & (n_enabled > 0)
    pairwise_unhealthy = torch.where(combine == COMBINE_ALL, all_reject, any_reject)

    # band: the baseline drives a moving-average band; the current window
    # is judged against it
    concat = torch.cat([baseline, current], dim=1)
    concat_m = torch.cat([b_mask, c_mask], dim=1)
    region = torch.zeros_like(concat_m)
    region[:, Tb:] = True
    band = fc.moving_average_band_plain(concat, concat_m, region, ma_window,
                                        band_threshold, bound_mode, min_lower_bound)
    band_count = band["count"]
    n_checked = torch.clamp(band["checked"].to(_F), min=1.0)
    band_frac = band_count.to(_F) / n_checked
    band_unhealthy = band_frac > BAND_FRACTION

    min_p = torch.where(enabled, pvals, 1.0).amin(-1)
    severity = -torch.log10(torch.clamp(min_p, min=1e-12)) + band_frac
    return {
        "unhealthy": pairwise_unhealthy | band_unhealthy,
        "severity": severity,
        "pvalues": pvals,
        "band_count": band_count,
        "min_p": min_p,
        "pairwise_unhealthy": pairwise_unhealthy,
        "band_unhealthy": band_unhealthy,
    }


def score_pairs(*args, device=None):
    """Judge B (baseline, current) pairs: the reference's 12 arguments (see
    `pair_arg_spec`), as numpy arrays or tensors.

    Runs kernel A on `device` (default "cuda") or the plain twin for
    device="cpu". Returns unhealthy, severity, pvalues (B, 5: Mann-Whitney,
    Wilcoxon, Kruskal, KS, sign test), band_count, min_p,
    pairwise_unhealthy and band_unhealthy.
    """
    dev = resolve_device(device)
    t = pair_args_from_numpy(args, dev)
    if dev.type == "cpu":
        return pair_verdict_plain(*t)
    return kernels.pair_verdict(*t, wilcoxon_table=wilcoxon_pmf_table(dev),
                                ks_exact_max=KS_EXACT_MAX_T,
                                wilcoxon_exact_max_n=WILCOXON_EXACT_MAX_N)
