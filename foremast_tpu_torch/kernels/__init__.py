"""Launchers of the port's hand-written CUDA kernels.

Kernel A, `pair_verdict` (``csrc/pair_verdict.cu``), judges B canary pairs
in one launch; kernel B, `ma_band` (``csrc/ma_band.cu``), runs the
moving-average band chain for B rows in one launch. Each launcher checks
device, dtype, shape and contiguity, allocates the outputs, launches on
PyTorch's current stream without synchronising, raises if the launch
failed, and adds one to its entry of `launches`. They take CUDA tensors
only; the entry points (``parallel.fleet.score_pairs``,
``ops.forecast.moving_average_band``) send CPU tensors to the plain twins.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

__all__ = ["launches", "reset_launches", "pair_verdict", "ma_band",
           "MAX_PAIR_T", "MAX_BAND_T", "PAIR_PHASES"]

# kernel A keeps a pair's 2T sort entries in shared memory: 2 x 4096 x 16 B
MAX_PAIR_T = 4096
# kernel B keeps 12 B of prefix sums per slot: MAX_WINDOW_STEPS
MAX_BAND_T = 16384

# kernel A's phases, in order, as its optional clock stamps split it
PAIR_PHASES = ("counts", "sort", "rank_scans", "wilcoxon_sort", "wilcoxon_scans",
               "mw_kw_ks", "exact_tails", "gates_band")

launches = {"pair_verdict": 0, "ma_band": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device):
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the others on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _raise_on(rc: int, kernel: str, lib) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: {lib.fm_error_string(rc).decode()}")


def pair_verdict(baseline, b_mask, current, c_mask, pvalue_threshold, test_mask,
                 combine, ma_window, band_threshold, bound_mode, min_lower_bound,
                 min_points, *, wilcoxon_table, ks_exact_max: int,
                 wilcoxon_exact_max_n: int, phase_clocks=None):
    """Launch kernel A on score_pairs' 12 tensors; returns its 7 outputs.

    phase_clocks, an int64 (B, len(PAIR_PHASES) + 1) tensor, receives each
    pair's SM clock at the start and after each phase of PAIR_PHASES.
    """
    B, T = baseline.shape
    dev = baseline.device
    if not 1 <= T <= MAX_PAIR_T:
        raise ValueError(
            f"pair_verdict supports 1 <= T <= {MAX_PAIR_T} (a pair's sort lives in "
            f"shared memory); got T = {T}")
    mpw = min_points.shape[-1] if min_points.dim() == 2 else 0
    if mpw not in (3, 4):
        raise ValueError(f"min_points must be (B, 3) or (B, 4), got {tuple(min_points.shape)}")
    W = wilcoxon_exact_max_n * (wilcoxon_exact_max_n + 1) // 2 + 1
    for t, name, dt, shape in (
            (baseline, "baseline", torch.float32, (B, T)),
            (b_mask, "b_mask", torch.bool, (B, T)),
            (current, "current", torch.float32, (B, T)),
            (c_mask, "c_mask", torch.bool, (B, T)),
            (pvalue_threshold, "pvalue_threshold", torch.float32, (B,)),
            (test_mask, "test_mask", torch.int32, (B,)),
            (combine, "combine", torch.int32, (B,)),
            (ma_window, "ma_window", torch.int32, (B,)),
            (band_threshold, "band_threshold", torch.float32, (B,)),
            (bound_mode, "bound_mode", torch.int32, (B,)),
            (min_lower_bound, "min_lower_bound", torch.float32, (B,)),
            (min_points, "min_points", torch.int32, (B, mpw)),
            (wilcoxon_table, "wilcoxon_table", torch.float32, (wilcoxon_exact_max_n, W))):
        _check(t, name, dt, shape, dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(PAIR_PHASES) + 1), dev)
    out = {
        "unhealthy": torch.empty(B, dtype=torch.bool, device=dev),
        "severity": torch.empty(B, dtype=torch.float32, device=dev),
        "pvalues": torch.empty((B, 5), dtype=torch.float32, device=dev),
        "band_count": torch.empty(B, dtype=torch.int32, device=dev),
        "min_p": torch.empty(B, dtype=torch.float32, device=dev),
        "pairwise_unhealthy": torch.empty(B, dtype=torch.bool, device=dev),
        "band_unhealthy": torch.empty(B, dtype=torch.bool, device=dev),
    }
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_pair_verdict(
            _ptr(baseline), _ptr(b_mask), _ptr(current), _ptr(c_mask),
            _ptr(pvalue_threshold), _ptr(test_mask), _ptr(combine), _ptr(ma_window),
            _ptr(band_threshold), _ptr(bound_mode), _ptr(min_lower_bound),
            _ptr(min_points), mpw, _ptr(wilcoxon_table), wilcoxon_exact_max_n,
            ks_exact_max, B, T,
            _ptr(out["unhealthy"]), _ptr(out["severity"]), _ptr(out["pvalues"]),
            _ptr(out["band_count"]), _ptr(out["min_p"]),
            _ptr(out["pairwise_unhealthy"]), _ptr(out["band_unhealthy"]),
            None if phase_clocks is None else _ptr(phase_clocks), ctypes.c_void_p(stream))
    _raise_on(rc, "pair_verdict", lib)
    launches["pair_verdict"] += 1
    return out


def ma_band(x, mask, region, window: int, threshold, bound_mode, min_lower_bound):
    """Launch kernel B: moving average -> residual sigma -> band, B rows."""
    B, T = x.shape
    dev = x.device
    if not 1 <= T <= MAX_BAND_T:
        raise ValueError(f"ma_band supports 1 <= T <= {MAX_BAND_T}; got T = {T}")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (region, "region", torch.bool, (B, T)),
            (threshold, "threshold", torch.float32, (B,)),
            (bound_mode, "bound_mode", torch.int32, (B,)),
            (min_lower_bound, "min_lower_bound", torch.float32, (B,))):
        _check(t, name, dt, shape, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = {
        "preds": torch.empty((B, T), **f32),
        "sigma": torch.empty(B, **f32),
        "upper": torch.empty((B, T), **f32),
        "lower": torch.empty((B, T), **f32),
        "flags": torch.empty((B, T), dtype=torch.bool, device=dev),
        "count": torch.empty(B, **i32),
        "first_index": torch.empty(B, **i32),
        "checked": torch.empty(B, **i32),
    }
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_ma_band(
            _ptr(x), _ptr(mask), _ptr(region), int(window), _ptr(threshold),
            _ptr(bound_mode), _ptr(min_lower_bound), B, T,
            _ptr(out["preds"]), _ptr(out["sigma"]), _ptr(out["upper"]), _ptr(out["lower"]),
            _ptr(out["flags"]), _ptr(out["count"]), _ptr(out["first_index"]),
            _ptr(out["checked"]), ctypes.c_void_p(stream))
    _raise_on(rc, "ma_band", lib)
    launches["ma_band"] += 1
    return out
