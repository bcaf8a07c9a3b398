"""Launchers of the port's hand-written CUDA kernels.

- Kernel A, `pair_verdict` (``csrc/pair_verdict.cu``), judges B canary
  pairs in one launch.
- Kernel B (``csrc/ma_band.cu``) runs the band chain for B rows: `ma_band`
  under moving_average_all, `band_from_preds` from given predictions.
- Kernel C, `smooth` (``csrc/smoothers.cu``), runs SES, DES or additive
  Holt-Winters one-step predictions; kernel D, `hw_fit` (same file), the
  Holt-Winters grid fit.
- Kernel E, `affine_scan` (``csrc/seqscan.cu``), runs SES or DES as a scan
  of affine maps (the long-window forms).
- Kernel F, `detect_period` (``csrc/period.cu``), elects each row's
  seasonal period.
- Kernel G, `triage_screen` (``csrc/triage.cu``), runs the tier-0 triage
  screen: band counts under the policy band and a shrunk band, and the
  robust z of each row's current region.
- Kernel H, `bivariate` (``csrc/bivariate.cu``), judges B metric pairs
  under the bivariate-normal ellipse of their joint history.
- Kernel I, `hpa_score` (``csrc/hpa.cu``), scores B HPA rows from their
  traffic predictions, with sigma given or computed from the history.
- Kernel J, `st_fit` (``csrc/seasonal_trend.cu``), fits the seasonal-trend
  (Prophet-core) ridge model of B rows, each with its own period.
- Kernel K, `lstm_ae` (``csrc/lstm_ae.cu``), runs the LSTM autoencoder of
  J jobs, each with its own parameters, over K windows a job and writes
  each window's masked reconstruction error (and its z-score).
- Kernel L (``csrc/lstm_train.cu``) trains it: `lstm_train_forward` runs
  the recurrences, stores the activations and sums each window block's
  squared errors; `lstm_train_backward` backpropagates through time into
  per-(job, window block) partial gradients.
- Kernel M, `adam` (``csrc/adam.cu``), sums L's partials in block order and
  applies optax's Adam to the J parameter rows in place.
- Kernel N, `pair_tests` (``csrc/pair_tests.cu``), runs the public
  two-sample test battery (Mann-Whitney, two-group Kruskal-Wallis,
  Wilcoxon, KS) and the exact sign test on B window pairs, on kernel A's
  device code (``csrc/pair_common.cuh``).
- Kernel O (``csrc/rank_groups.cu``): `rank_and_ties` ranks B masked rows,
  `kruskal_groups` gives the Kruskal-Wallis H of B sets of k groups and
  `friedman` the Friedman chi-square of B (n blocks x k treatments) tables.
- Kernel P, `fleet_topk` (``csrc/fleet_topk.cu``), counts a fleet's
  unhealthy rows and finds its k worst severities with their global indices.

Each launcher checks device, dtype, shape and contiguity, allocates the
outputs (and the scratch a kernel needs), launches on PyTorch's current
stream without synchronising, raises if the launch failed, and adds one to
its entry of `launches` per launch. They take CUDA tensors only; the entry
points (``parallel.fleet.score_pairs``, ``ops.forecast``,
``ops.seqscan``, ``ops.triage``, ``ops.bivariate``, ``ops.hpa``,
``ops.pairwise``, ``ops.ranks``, ``models.lstm_ae``, ``parallel.fleet``'s
scorer) send CPU tensors to the plain twins.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["launches", "reset_launches", "pair_verdict", "ma_band", "band_from_preds",
           "smooth", "hw_fit", "affine_scan", "detect_period", "triage_screen", "bivariate",
           "hpa_score", "st_fit", "lstm_ae", "lstm_train_forward", "lstm_train_backward",
           "adam", "pair_tests", "rank_and_ties", "kruskal_groups", "friedman", "fleet_topk",
           "lstm_train_blocks", "PAIR_TEST_BITS", "MAX_RANK_KEYS", "SHARED_RANK_KEYS",
           "MAX_FLEET_ROWS", "MAX_FLEET_SLICE", "MAX_PAIR_T", "SHARED_PAIR_T", "MAX_BAND_T",
           "MAX_PERIOD_T", "MAX_SCREEN_T", "MAX_BI_T", "MAX_HPA_T", "MAX_CANDIDATES",
           "MAX_GRID", "MAX_ST_D", "MAX_ST_T", "MAX_LSTM_HIDDEN", "MAX_LSTM_LATENT",
           "MAX_LSTM_FEATURES", "LSTM_SMEM_PARAMS_BYTES", "LSTM_TRAIN_SMEM_BYTES",
           "PAIR_PHASES", "SMOOTH_SES", "SMOOTH_DES", "SMOOTH_HW"]

# kernel A: up to this T a pair's 2T sort entries (16 B each) live in
# shared memory; above it, in device scratch
SHARED_PAIR_T = 4096
MAX_PAIR_T = 16384  # MAX_WINDOW_STEPS
# kernel B keeps 12 B of prefix sums per slot: MAX_WINDOW_STEPS
MAX_BAND_T = 16384
# kernel G keeps the same 12 B per slot, then 4 B order keys in that space
MAX_SCREEN_T = 16384
# kernel F keeps 5 B per slot (residual, mask) and 5 B per candidate (score,
# eligibility) in shared memory
MAX_PERIOD_T = 16384
MAX_CANDIDATES = 1024
# kernel H stages 9 B per slot (two floats, a byte of flags) in shared memory
MAX_BI_T = 16384
# kernel I stages 13 B per slot (three floats, a byte of masks)
MAX_HPA_T = 16384
# kernel D runs two candidates per lane of a warp
MAX_GRID = 64
# kernel J solves with one lane of a warp per column; t is exact in float32
MAX_ST_D = 32
MAX_ST_T = 1 << 24
# kernel K: a CTA's gate products, states and per-window partial sums live
# in shared memory; its parameters join them there up to this many bytes,
# above it they are read through the caches (L1, L2)
MAX_LSTM_HIDDEN = 256
MAX_LSTM_LATENT = 256
MAX_LSTM_FEATURES = 32
LSTM_SMEM_PARAMS_BYTES = 96 * 1024
# kernel L keeps K's limits (a thread per window and feature of the head:
# KB F <= 256); its backward holds the parameters and the CTA's gradient
# sums in shared memory up to this many bytes (two CTAs an SM at the
# engine's width), in device memory above it
LSTM_TRAIN_SMEM_BYTES = 113 * 1024

# kernel N: each test's bit in its `tests` mask, in the column order of its
# outputs (the first four are all_pairwise_tests' family)
PAIR_TEST_BITS = {"mann_whitney": 1, "kruskal": 2, "wilcoxon": 4, "ks": 8, "sign": 16}
# kernel O: a row's sort keys (T for the ranks, k T for Kruskal-Wallis, 16 B
# each with the scan arrays) live in shared memory up to this many, in
# device scratch above it, up to MAX_RANK_KEYS (16 MB of scratch a CTA)
SHARED_RANK_KEYS = 8192
MAX_RANK_KEYS = 1 << 20
# kernel P keys a row by its global index in 32 bits, and takes at most
# MAX_FLEET_SLICE rows a launch (its C entry counts rows and kept keys in
# int)
MAX_FLEET_ROWS = (1 << 32) - 1
MAX_FLEET_SLICE = 1 << 30

SMOOTH_SES, SMOOTH_DES, SMOOTH_HW = 1, 2, 3

# kernel G's outputs, in the order its C entry takes them
SCREEN_INT_OUTPUTS = ("count", "shrunk_count", "checked", "n_hist")
SCREEN_FLOAT_OUTPUTS = ("upper_mean", "lower_mean", "resid_z", "robust_z", "sigma")
# kernel H's (B,) outputs after flags and d2, and kernel I's, in C order
BI_INT_OUTPUTS = ("count", "first_index", "checked")
BI_BAND_OUTPUTS = ("upper1", "lower1", "upper2", "lower2")
HPA_OUTPUTS = ("score", "reason", "demand", "demand_per_pod", "pods_now", "current_tps",
               "sla_current", "sla_limit", "tps_pred", "tps_upper", "tps_lower")

# device scratch that kernels A (T > SHARED_PAIR_T), C (HW) and D may hold
# at once; each bounds the CTAs or warps in flight to stay under it
SCRATCH_BYTES = 1 << 30

# kernel A's phases, in order, as its optional clock stamps split it
PAIR_PHASES = ("counts", "sort", "rank_scans", "wilcoxon_sort", "wilcoxon_scans",
               "mw_kw_ks", "exact_tails", "gates_band")

launches = {"pair_verdict": 0, "ma_band": 0, "band_from_preds": 0, "smooth": 0,
            "hw_fit": 0, "affine_scan": 0, "detect_period": 0, "triage_screen": 0,
            "bivariate": 0, "hpa_score": 0, "st_fit": 0, "lstm_ae": 0,
            "lstm_train_forward": 0, "lstm_train_backward": 0, "adam": 0, "pair_tests": 0,
            "rank_and_ties": 0, "kruskal_groups": 0, "friedman": 0, "fleet_topk": 0}


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
            f"pair_verdict supports 1 <= T <= {MAX_PAIR_T} (the largest window "
            f"bucket); got T = {T}")
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
    scratch, stride, grid = None, 0, B
    if T > SHARED_PAIR_T:
        # one slot of device scratch per CTA; the CTAs walk pairs grid-stride
        stride = lib.fm_pair_verdict_scratch_stride(T)
        grid = max(1, min(B, SCRATCH_BYTES // stride))
        scratch = torch.empty(grid * stride, dtype=torch.uint8, device=dev)
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
            None if phase_clocks is None else _ptr(phase_clocks),
            None if scratch is None else _ptr(scratch), stride, grid, ctypes.c_void_p(stream))
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


def _band_outputs(B: int, T: int, dev) -> dict:
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    return {
        "sigma": torch.empty(B, **f32),
        "upper": torch.empty((B, T), **f32),
        "lower": torch.empty((B, T), **f32),
        "flags": torch.empty((B, T), dtype=torch.bool, device=dev),
        "count": torch.empty(B, **i32),
        "first_index": torch.empty(B, **i32),
        "checked": torch.empty(B, **i32),
    }


def band_from_preds(x, mask, region, preds, threshold, bound_mode, min_lower_bound):
    """Launch kernel B's second entry: residual sigma over mask & ~region
    and the band over mask & region, from given predictions."""
    B, T = x.shape
    dev = x.device
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (region, "region", torch.bool, (B, T)),
            (preds, "preds", torch.float32, (B, T)),
            (threshold, "threshold", torch.float32, (B,)),
            (bound_mode, "bound_mode", torch.int32, (B,)),
            (min_lower_bound, "min_lower_bound", torch.float32, (B,))):
        _check(t, name, dt, shape, dev)
    out = _band_outputs(B, T, dev)
    if B == 0 or T == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_band_from_preds(
            _ptr(x), _ptr(mask), _ptr(region), _ptr(preds), _ptr(threshold),
            _ptr(bound_mode), _ptr(min_lower_bound), B, T,
            *(_ptr(out[k]) for k in ("sigma", "upper", "lower", "flags", "count",
                                     "first_index", "checked")),
            ctypes.c_void_p(stream))
    _raise_on(rc, "band_from_preds", lib)
    launches["band_from_preds"] += 1
    return out


def _row_params(B: int, dev, named) -> None:
    for t, name, dt in named:
        _check(t, name, dt, (B,), dev)


def smooth(kind: int, x, mask, alpha, beta=None, gamma=None, period=None,
           max_period: int | None = None):
    """Launch kernel C: one-step predictions (B, T) of SES (kind
    SMOOTH_SES), DES (SMOOTH_DES, with beta) or additive Holt-Winters
    (SMOOTH_HW, with beta, gamma and a (B,) int32 period). max_period, an
    upper bound on the periods, sizes HW's ring scratch; without it the
    launcher reads the largest period from the card."""
    B, T = x.shape
    dev = x.device
    _check(x, "x", torch.float32, (B, T), dev)
    _check(mask, "mask", torch.bool, (B, T), dev)
    named = [(alpha, "alpha", torch.float32)]
    if kind in (SMOOTH_DES, SMOOTH_HW):
        named.append((beta, "beta", torch.float32))
    if kind == SMOOTH_HW:
        named += [(gamma, "gamma", torch.float32), (period, "period", torch.int32)]
    elif kind != SMOOTH_SES and kind != SMOOTH_DES:
        raise ValueError(f"unknown smoother kind {kind}")
    _row_params(B, dev, named)
    preds = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return preds
    groups = (B + 31) // 32
    ring, stride = None, 0
    n_warps = groups
    if kind == SMOOTH_HW:
        if max_period is None:
            max_period = int(period.max())
        stride = max(1, min(int(max_period), T))
        n_warps = max(1, min(groups, SCRATCH_BYTES // (32 * stride * 4)))
    n_warps = -(-n_warps // 4) * 4  # whole CTAs of 4 warps
    if kind == SMOOTH_HW:
        ring = torch.empty(n_warps * 32 * stride, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_smooth(
            kind, _ptr(x), _ptr(mask), _ptr(alpha),
            None if beta is None or kind == SMOOTH_SES else _ptr(beta),
            None if kind != SMOOTH_HW else _ptr(gamma),
            None if kind != SMOOTH_HW else _ptr(period), B, T,
            None if ring is None else _ptr(ring), stride, n_warps, _ptr(preds),
            ctypes.c_void_p(stream))
    _raise_on(rc, "smooth", lib)
    launches["smooth"] += 1
    return preds


def hw_fit(x, mask, fit_mask, period, grid, max_period: int | None = None):
    """Launch kernel D: each row's mean squared one-step Holt-Winters error
    over fit_mask & mask for every (alpha, beta, gamma) row of grid (G <=
    MAX_GRID), and the argmin. Returns params (B, 3), best (B,) int32 and
    mse (B, G) float64."""
    B, T = x.shape
    dev = x.device
    G = grid.shape[0] if grid.dim() == 2 else 0
    if not 1 <= G <= MAX_GRID:
        raise ValueError(f"hw_fit takes a (G, 3) grid with 1 <= G <= {MAX_GRID}")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (fit_mask, "fit_mask", torch.bool, (B, T)),
            (period, "period", torch.int32, (B,)),
            (grid, "grid", torch.float32, (G, 3))):
        _check(t, name, dt, shape, dev)
    out = {
        "params": torch.empty((B, 3), dtype=torch.float32, device=dev),
        "best": torch.empty(B, dtype=torch.int32, device=dev),
        "mse": torch.empty((B, G), dtype=torch.float64, device=dev),
    }
    if B == 0 or T == 0:
        return out
    if max_period is None:
        max_period = int(period.max())
    stride = max(1, min(int(max_period), T))
    slot = stride * 64 * 4  # (period, 64 candidates) floats per warp
    n_warps = max(1, min(B, SCRATCH_BYTES // slot))
    n_warps = -(-n_warps // 4) * 4
    ring = torch.empty(n_warps * stride * 64, dtype=torch.float32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_hw_fit(
            _ptr(x), _ptr(mask), _ptr(fit_mask), _ptr(period), _ptr(grid), G, B, T,
            _ptr(ring), stride, n_warps, _ptr(out["params"]), _ptr(out["best"]),
            _ptr(out["mse"]), ctypes.c_void_p(stream))
    _raise_on(rc, "hw_fit", lib)
    launches["hw_fit"] += 1
    return out


def affine_scan(kind: int, x, mask, alpha, beta=None):
    """Launch kernel E: SES (SMOOTH_SES) or DES (SMOOTH_DES, with beta)
    one-step predictions (B, T) as a scan of affine maps."""
    B, T = x.shape
    dev = x.device
    _check(x, "x", torch.float32, (B, T), dev)
    _check(mask, "mask", torch.bool, (B, T), dev)
    named = [(alpha, "alpha", torch.float32)]
    if kind == SMOOTH_DES:
        named.append((beta, "beta", torch.float32))
    elif kind != SMOOTH_SES:
        raise ValueError(f"affine_scan runs SES or DES, not kind {kind}")
    _row_params(B, dev, named)
    preds = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return preds
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_affine_scan(kind, _ptr(x), _ptr(mask), _ptr(alpha),
                                None if kind == SMOOTH_SES else _ptr(beta), B, T,
                                _ptr(preds), ctypes.c_void_p(stream))
    _raise_on(rc, "affine_scan", lib)
    launches["affine_scan"] += 1
    return preds


def detect_period(x, mask, candidates, fallback, min_acf: float, alias_margin: float,
                  contrast_margin: float):
    """Launch kernel F: each row's period among `candidates` ((C,) int32,
    C <= MAX_CANDIDATES) or its `fallback` ((B,) int32). Returns period
    (B,) int32 and scores (B, C) float32."""
    B, T = x.shape
    dev = x.device
    if not 1 <= T <= MAX_PERIOD_T:
        raise ValueError(f"detect_period supports 1 <= T <= {MAX_PERIOD_T}; got T = {T}")
    C = candidates.shape[0] if candidates.dim() == 1 else -1
    if not 0 <= C <= MAX_CANDIDATES:
        raise ValueError(f"detect_period takes at most {MAX_CANDIDATES} candidates")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (candidates, "candidates", torch.int32, (C,)),
            (fallback, "fallback", torch.int32, (B,))):
        _check(t, name, dt, shape, dev)
    period = torch.empty(B, dtype=torch.int32, device=dev)
    scores = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0:
        return period, scores
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_detect_period(
            _ptr(x), _ptr(mask), _ptr(candidates), C, _ptr(fallback), float(min_acf),
            float(alias_margin), float(contrast_margin), B, T, _ptr(period), _ptr(scores),
            ctypes.c_void_p(stream))
    _raise_on(rc, "detect_period", lib)
    launches["detect_period"] += 1
    return period, scores


def triage_screen(x, mask, region, window: int, threshold, bound_mode, min_lower_bound, margin):
    """Launch kernel G: the triage screen of B rows. Returns count,
    shrunk_count, checked, n_hist (int32) and upper_mean, lower_mean,
    resid_z, robust_z, sigma (float32), each (B,)."""
    B, T = x.shape
    dev = x.device
    if not 1 <= T <= MAX_SCREEN_T:
        raise ValueError(f"triage_screen supports 1 <= T <= {MAX_SCREEN_T}; got T = {T}")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (region, "region", torch.bool, (B, T)),
            (threshold, "threshold", torch.float32, (B,)),
            (bound_mode, "bound_mode", torch.int32, (B,)),
            (min_lower_bound, "min_lower_bound", torch.float32, (B,)),
            (margin, "margin", torch.float32, (B,))):
        _check(t, name, dt, shape, dev)
    out = {k: torch.empty(B, dtype=torch.int32, device=dev) for k in SCREEN_INT_OUTPUTS}
    out.update({k: torch.empty(B, dtype=torch.float32, device=dev)
                for k in SCREEN_FLOAT_OUTPUTS})
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_triage_screen(
            _ptr(x), _ptr(mask), _ptr(region), _ptr(threshold), _ptr(bound_mode),
            _ptr(min_lower_bound), _ptr(margin), int(window), B, T,
            *(_ptr(out[k]) for k in SCREEN_INT_OUTPUTS + SCREEN_FLOAT_OUTPUTS),
            ctypes.c_void_p(stream))
    _raise_on(rc, "triage_screen", lib)
    launches["triage_screen"] += 1
    return out


def _opt(t):
    return None if t is None else _ptr(t)


def bivariate(x1, m1, x2, m2, region, threshold, min_lower_bound1=None,
              min_lower_bound2=None, bound_mode1=None, bound_mode2=None):
    """Launch kernel H: the bivariate-normal ellipse of B metric pairs.
    Returns flags (B, T) bool, d2 (B, T) float32, count, first_index,
    checked (B,) int32 and the marginal bands upper1, lower1, upper2,
    lower2 as (B,) float32 (constant in t). A bound floor or bound mode
    left out is absent, as in the reference."""
    B, T = x1.shape
    dev = x1.device
    if not 1 <= T <= MAX_BI_T:
        raise ValueError(f"bivariate supports 1 <= T <= {MAX_BI_T}; got T = {T}")
    named = [(x1, "x1", torch.float32, (B, T)), (m1, "m1", torch.bool, (B, T)),
             (x2, "x2", torch.float32, (B, T)), (m2, "m2", torch.bool, (B, T)),
             (region, "region", torch.bool, (B, T)), (threshold, "threshold", torch.float32, (B,))]
    for t, name, dt in ((min_lower_bound1, "min_lower_bound1", torch.float32),
                        (min_lower_bound2, "min_lower_bound2", torch.float32),
                        (bound_mode1, "bound_mode1", torch.int32),
                        (bound_mode2, "bound_mode2", torch.int32)):
        if t is not None:
            named.append((t, name, dt, (B,)))
    for t, name, dt, shape in named:
        _check(t, name, dt, shape, dev)
    out = {"flags": torch.empty((B, T), dtype=torch.bool, device=dev),
           "d2": torch.empty((B, T), dtype=torch.float32, device=dev)}
    out.update({k: torch.empty(B, dtype=torch.int32, device=dev) for k in BI_INT_OUTPUTS})
    out.update({k: torch.empty(B, dtype=torch.float32, device=dev) for k in BI_BAND_OUTPUTS})
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_bivariate(
            _ptr(x1), _ptr(m1), _ptr(x2), _ptr(m2), _ptr(region), _ptr(threshold),
            _opt(min_lower_bound1), _opt(min_lower_bound2), _opt(bound_mode1),
            _opt(bound_mode2), B, T, _ptr(out["flags"]), _ptr(out["d2"]),
            *(_ptr(out[k]) for k in BI_INT_OUTPUTS + BI_BAND_OUTPUTS), ctypes.c_void_p(stream))
    _raise_on(rc, "bivariate", lib)
    launches["bivariate"] += 1
    return out


def hpa_score(tps, tps_mask, region, tps_pred, sla, sla_mask, sla_static_limit, sla_mode,
              threshold, *, tps_sigma=None, safe=None, pods_now=None, pods_hist=None,
              sla_absolute=None):
    """Launch kernel I: the HPA scores of B rows. With tps_sigma ((B,)
    float32) it is the reference's hpa_scores; without it, it first takes
    sigma as the RMS residual of tps_pred over tps_mask & ~region (+inf
    below 2 points) and returns it too, as "tps_sigma". Returns the (B,)
    outputs of HPA_OUTPUTS (reason int32, the rest float32)."""
    B, T = tps.shape
    dev = tps.device
    if not 1 <= T <= MAX_HPA_T:
        raise ValueError(f"hpa_score supports 1 <= T <= {MAX_HPA_T}; got T = {T}")
    named = [(tps, "tps", torch.float32, (B, T)), (tps_mask, "tps_mask", torch.bool, (B, T)),
             (region, "region", torch.bool, (B, T)), (tps_pred, "tps_pred", torch.float32, (B, T)),
             (sla, "sla", torch.float32, (B, T)), (sla_mask, "sla_mask", torch.bool, (B, T)),
             (sla_static_limit, "sla_static_limit", torch.float32, (B,)),
             (sla_mode, "sla_mode", torch.int32, (B,)),
             (threshold, "threshold", torch.float32, (B,))]
    for t, name, dt in ((tps_sigma, "tps_sigma", torch.float32), (safe, "safe", torch.float32),
                        (pods_now, "pods_now", torch.float32),
                        (pods_hist, "pods_hist", torch.float32),
                        (sla_absolute, "sla_absolute", torch.bool)):
        if t is not None:
            named.append((t, name, dt, (B,)))
    for t, name, dt, shape in named:
        _check(t, name, dt, shape, dev)
    out = {k: torch.empty(B, dtype=torch.int32 if k == "reason" else torch.float32, device=dev)
           for k in HPA_OUTPUTS}
    if tps_sigma is None:
        out["tps_sigma"] = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = build.library()
    common = (_ptr(tps), _ptr(tps_mask), _ptr(region), _ptr(tps_pred))
    rest = (_ptr(sla), _ptr(sla_mask), _ptr(sla_static_limit), _ptr(sla_mode), _ptr(threshold),
            _opt(safe), _opt(pods_now), _opt(pods_hist), _opt(sla_absolute), B, T,
            *(_ptr(out[k]) for k in HPA_OUTPUTS))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if tps_sigma is None:
            rc = lib.fm_hpa_from_preds(*common, *rest, _ptr(out["tps_sigma"]), stream)
        else:
            rc = lib.fm_hpa_scores(*common, _ptr(tps_sigma), *rest, stream)
    _raise_on(rc, "hpa_score", lib)
    launches["hpa_score"] += 1
    return out


def st_fit(x, mask, fit_mask, period, order: int, n_changepoints: int, ridge: float,
           cp_shrink: float, l1_iters: int):
    """Launch kernel J: the seasonal-trend fit of B rows over fit_mask &
    mask, each row with its (B,) int32 period. Returns beta (B, D) and
    preds (B, T) float32, D = 2 + n_changepoints + 2 order <= MAX_ST_D."""
    B, T = x.shape
    dev = x.device
    D = 2 + int(n_changepoints) + 2 * int(order)
    if order < 0 or n_changepoints < 0 or D > MAX_ST_D:
        raise ValueError(f"st_fit takes order >= 0, n_changepoints >= 0 and at most "
                         f"{MAX_ST_D} columns (2 + n_changepoints + 2 order); got {D}")
    if not 1 <= T <= MAX_ST_T:
        raise ValueError(f"st_fit supports 1 <= T <= {MAX_ST_T}; got T = {T}")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (fit_mask, "fit_mask", torch.bool, (B, T)),
            (period, "period", torch.int32, (B,))):
        _check(t, name, dt, shape, dev)
    beta = torch.empty((B, D), dtype=torch.float32, device=dev)
    preds = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0:
        return beta, preds
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_st_fit(_ptr(x), _ptr(mask), _ptr(fit_mask), _ptr(period), int(order),
                           int(n_changepoints), float(ridge), float(cp_shrink), int(l1_iters),
                           B, T, _ptr(beta), _ptr(preds), ctypes.c_void_p(stream))
    _raise_on(rc, "st_fit", lib)
    launches["st_fit"] += 1
    return beta, preds


def lstm_ae(params, x, mask, hidden: int, latent: int, mu=None, sigma=None):
    """Launch kernel K: the LSTM autoencoder's masked reconstruction error
    of K windows for each of J jobs. params is (J, P) float32 in the flat
    layout of models.lstm_ae.flat_params, x (J, K, W, F) float32, mask
    (J, K, W, F) bool. Returns err (J, K); with mu and sigma ((J,) float32)
    also z = (err - mu) / sigma, as (err, z)."""
    J, K, W, F = x.shape
    dev = x.device
    H, Z = int(hidden), int(latent)
    if not (1 <= H <= MAX_LSTM_HIDDEN and 1 <= Z <= MAX_LSTM_LATENT
            and 1 <= F <= MAX_LSTM_FEATURES):
        raise ValueError(f"lstm_ae supports hidden <= {MAX_LSTM_HIDDEN}, latent <= "
                         f"{MAX_LSTM_LATENT} and features <= {MAX_LSTM_FEATURES}; got "
                         f"{H}, {Z}, {F}")
    if (mu is None) != (sigma is None):
        raise ValueError("lstm_ae takes mu and sigma together")
    named = [(x, "x", torch.float32, (J, K, W, F)), (mask, "mask", torch.bool, (J, K, W, F))]
    if mu is not None:
        named += [(mu, "mu", torch.float32, (J,)), (sigma, "sigma", torch.float32, (J,))]
    for t, name, dt, shape in named:
        _check(t, name, dt, shape, dev)
    lib = build.library()
    P = lib.fm_lstm_ae_param_count(F, H, Z)
    _check(params, "params", torch.float32, (J, P), dev)
    err = torch.empty((J, K), dtype=torch.float32, device=dev)
    z = None if mu is None else torch.empty((J, K), dtype=torch.float32, device=dev)
    if J == 0 or K == 0:
        return err if z is None else (err, z)
    if W < 1:
        raise ValueError("lstm_ae needs windows of W >= 1 steps")
    KB = lstm_train_blocks(K, F)[0]
    smem_params = int(lib.fm_lstm_ae_smem_bytes(F, H, Z, KB, 1) <= LSTM_SMEM_PARAMS_BYTES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_lstm_ae(_ptr(params), P, _ptr(x), _ptr(mask), _opt(mu), _opt(sigma), J, K,
                            W, F, H, Z, KB, smem_params, _ptr(err), _opt(z),
                            ctypes.c_void_p(stream))
    _raise_on(rc, "lstm_ae", lib)
    launches["lstm_ae"] += 1
    return err if z is None else (err, z)


def lstm_train_blocks(K: int, F: int) -> tuple:
    """(KB, nkb): the windows a CTA of kernels K and L runs and the window
    blocks of a job (nkb = ceil(K / KB))."""
    KB = max(1, min(int(K), 8, 256 // max(int(F), 1)))
    return KB, -(-int(K) // KB)


def _lstm_train_check(params, x, mask, hidden: int, latent: int, what: str):
    J, K, W, F = x.shape
    dev = x.device
    H, Z = int(hidden), int(latent)
    if not (1 <= H <= MAX_LSTM_HIDDEN and 1 <= Z <= MAX_LSTM_LATENT
            and 1 <= F <= MAX_LSTM_FEATURES):
        raise ValueError(f"{what} supports hidden <= {MAX_LSTM_HIDDEN}, latent <= "
                         f"{MAX_LSTM_LATENT} and features <= {MAX_LSTM_FEATURES}; got "
                         f"{H}, {Z}, {F}")
    if W < 1 or K < 1:
        raise ValueError(f"{what} needs K >= 1 windows of W >= 1 steps")
    _check(x, "x", torch.float32, (J, K, W, F), dev)
    _check(mask, "mask", torch.bool, (J, K, W, F), dev)
    lib = build.library()
    P = lib.fm_lstm_ae_param_count(F, H, Z)
    _check(params, "params", torch.float32, (J, P), dev)
    return lib, J, K, W, F, H, Z, P, dev


def _lstm_train_launch(lib, backward: int, params, x, mask, dims, act, num, cnt, gpart):
    J, K, W, F, H, Z, P = dims
    KB, _ = lstm_train_blocks(K, F)
    budget = LSTM_TRAIN_SMEM_BYTES if backward else LSTM_SMEM_PARAMS_BYTES
    smem_params = int(lib.fm_lstm_train_smem_bytes(F, H, Z, KB, 1, backward) <= budget)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return lib.fm_lstm_train(backward, _ptr(params), P, _ptr(x), _ptr(mask), J, K, W, F, H,
                                 Z, KB, smem_params, _ptr(act), _opt(num), _opt(cnt),
                                 _opt(gpart), ctypes.c_void_p(stream))


def lstm_train_forward(params, x, mask, hidden: int, latent: int):
    """Launch kernel L's forward entry on J jobs' (J, P) parameter rows and
    their windows x (J, K, W, F) float32, mask bool. Returns num and cnt
    (J, nkb) float64, each window block's sum of squared errors over the
    mask and its count of valid slots, and act (J, K, 2, W, 5H) float32, the
    activations the backward entry reads."""
    lib, J, K, W, F, H, Z, P, dev = _lstm_train_check(params, x, mask, hidden, latent,
                                                      "lstm_train_forward")
    nkb = lstm_train_blocks(K, F)[1]
    num = torch.empty((J, nkb), dtype=torch.float64, device=dev)
    cnt = torch.empty((J, nkb), dtype=torch.float64, device=dev)
    act = torch.empty((J, K, 2, W, 5 * H), dtype=torch.float32, device=dev)
    if J == 0:
        return num, cnt, act
    rc = _lstm_train_launch(lib, 0, params, x, mask, (J, K, W, F, H, Z, P), act, num, cnt, None)
    _raise_on(rc, "lstm_train_forward", lib)
    launches["lstm_train_forward"] += 1
    return num, cnt, act


def lstm_train_backward(params, x, mask, act, hidden: int, latent: int):
    """Launch kernel L's backward entry: from the forward's activations, the
    gradient of each window block's sum of squared errors in the job's
    parameters. Returns gpart (J, nkb, P) float32 (kernel M sums and
    scales it)."""
    lib, J, K, W, F, H, Z, P, dev = _lstm_train_check(params, x, mask, hidden, latent,
                                                      "lstm_train_backward")
    _check(act, "act", torch.float32, (J, K, 2, W, 5 * H), dev)
    nkb = lstm_train_blocks(K, F)[1]
    gpart = torch.empty((J, nkb, P), dtype=torch.float32, device=dev)
    if J == 0:
        return gpart
    rc = _lstm_train_launch(lib, 1, params, x, mask, (J, K, W, F, H, Z, P), act, None, None,
                            gpart)
    _raise_on(rc, "lstm_train_backward", lib)
    launches["lstm_train_backward"] += 1
    return gpart


def adam(params, mu, nu, step, gpart, num, cnt, lr: float, b1: float, b2: float, eps: float):
    """Launch kernel M: the gradient of each job from kernel L's partials
    (gpart (J, nkb, P) summed in block order, times 1 / max(sum cnt, 1)),
    then optax's Adam on params, mu, nu (J, P) float32 in place, at each
    job's step (J,) int32 (after the increment). Returns each job's loss
    (J,) float32 from num and cnt (J, nkb) float64."""
    J, P = params.shape
    dev = params.device
    nkb = gpart.shape[1] if gpart.dim() == 3 else -1
    for t, name, dt, shape in (
            (params, "params", torch.float32, (J, P)), (mu, "mu", torch.float32, (J, P)),
            (nu, "nu", torch.float32, (J, P)), (step, "step", torch.int32, (J,)),
            (gpart, "gpart", torch.float32, (J, nkb, P)), (num, "num", torch.float64, (J, nkb)),
            (cnt, "cnt", torch.float64, (J, nkb))):
        _check(t, name, dt, shape, dev)
    if nkb < 1:
        raise ValueError("adam needs at least one block of partial gradients")
    loss = torch.empty(J, dtype=torch.float32, device=dev)
    if J == 0:
        return loss
    lib = build.library()
    f32 = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_adam(_ptr(params), _ptr(mu), _ptr(nu), _ptr(step), _ptr(gpart), _ptr(num),
                         _ptr(cnt), _ptr(loss), P, J, nkb, float(f32(lr)), float(f32(b1)),
                         float(f32(b2)), float(f32(1 - b1)), float(f32(1 - b2)),
                         float(f32(eps)), ctypes.c_void_p(stream))
    _raise_on(rc, "adam", lib)
    launches["adam"] += 1
    return loss


def pair_tests(x, x_mask, y, y_mask, tests: int, *, wilcoxon_table, ks_exact_max: int,
               wilcoxon_exact_max_n: int):
    """Launch kernel N on B window pairs ((B, T) float32 values, bool
    masks): the tests whose bits (PAIR_TEST_BITS) are set in `tests`.
    Returns stat and p, (B, 5) float32 in PAIR_TEST_BITS' order: U1, H, W,
    D and the sign test's untied count (0 and p = 1 for a test not
    asked). The sign test counts the slots where both masks hold."""
    B, T = x.shape
    dev = x.device
    if not 1 <= T <= MAX_PAIR_T:
        raise ValueError(f"pair_tests supports 1 <= T <= {MAX_PAIR_T} (kernel A's window "
                         f"buckets); got T = {T}")
    if not 0 < tests < 1 << len(PAIR_TEST_BITS):
        raise ValueError(f"pair_tests takes a mask of PAIR_TEST_BITS, got {tests}")
    W = wilcoxon_exact_max_n * (wilcoxon_exact_max_n + 1) // 2 + 1
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)), (x_mask, "x_mask", torch.bool, (B, T)),
            (y, "y", torch.float32, (B, T)), (y_mask, "y_mask", torch.bool, (B, T)),
            (wilcoxon_table, "wilcoxon_table", torch.float32, (wilcoxon_exact_max_n, W))):
        _check(t, name, dt, shape, dev)
    stat = torch.empty((B, len(PAIR_TEST_BITS)), dtype=torch.float32, device=dev)
    p = torch.empty((B, len(PAIR_TEST_BITS)), dtype=torch.float32, device=dev)
    if B == 0:
        return stat, p
    lib = build.library()
    scratch, stride, grid = None, 0, B
    if T > SHARED_PAIR_T:
        stride = lib.fm_pair_tests_scratch_stride(T)
        grid = max(1, min(B, SCRATCH_BYTES // stride))
        scratch = torch.empty(grid * stride, dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_pair_tests(_ptr(x), _ptr(x_mask), _ptr(y), _ptr(y_mask), B, T, int(tests),
                               _ptr(wilcoxon_table), wilcoxon_exact_max_n, ks_exact_max,
                               _ptr(stat), _ptr(p), _opt(scratch), stride, grid,
                               ctypes.c_void_p(stream))
    _raise_on(rc, "pair_tests", lib)
    launches["pair_tests"] += 1
    return stat, p


def _rank_scratch(lib, B: int, n_keys: int, what: str, dev):
    """(scratch, stride, grid) for kernel O's sorting entries: none up to
    SHARED_RANK_KEYS keys a row, else one device slot per CTA."""
    if n_keys > MAX_RANK_KEYS:
        raise ValueError(f"{what} sorts at most {MAX_RANK_KEYS} keys a row; got {n_keys}")
    if n_keys <= SHARED_RANK_KEYS:
        return None, 0, B
    stride = lib.fm_rank_work_bytes(n_keys)
    grid = max(1, min(B, SCRATCH_BYTES // stride))
    return torch.empty(grid * stride, dtype=torch.uint8, device=dev), stride, grid


def rank_and_ties(values, mask):
    """Launch kernel O's rank entry on B rows ((B, T) float32, bool mask).
    Returns ranks (B, T) float32 in input order (0 at masked slots), the
    tie term and the valid count, (B,) float32 each."""
    B, T = values.shape
    dev = values.device
    _check(values, "values", torch.float32, (B, T), dev)
    _check(mask, "mask", torch.bool, (B, T), dev)
    ranks = torch.empty((B, T), dtype=torch.float32, device=dev)
    tie = torch.empty(B, dtype=torch.float32, device=dev)
    n = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return ranks, tie.zero_(), n.zero_()
    lib = build.library()
    scratch, stride, grid = _rank_scratch(lib, B, T, "rank_and_ties", dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_rank_and_ties(_ptr(values), _ptr(mask), B, T, _ptr(ranks), _ptr(tie),
                                  _ptr(n), _opt(scratch), stride, grid, ctypes.c_void_p(stream))
    _raise_on(rc, "rank_and_ties", lib)
    launches["rank_and_ties"] += 1
    return ranks, tie, n


def kruskal_groups(groups, masks):
    """Launch kernel O's Kruskal-Wallis entry on B sets of k masked groups
    ((B, k, T) float32, bool masks). Returns H and p, (B,) float32."""
    B, k, T = groups.shape
    dev = groups.device
    _check(groups, "groups", torch.float32, (B, k, T), dev)
    _check(masks, "masks", torch.bool, (B, k, T), dev)
    H = torch.empty(B, dtype=torch.float32, device=dev)
    p = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return H, p
    if k * T == 0:
        return H.zero_(), p.fill_(1.0)
    lib = build.library()
    scratch, stride, grid = _rank_scratch(lib, B, k * T, "kruskal_groups", dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_kruskal_groups(_ptr(groups), _ptr(masks), B, k, T, _ptr(H), _ptr(p),
                                   _opt(scratch), stride, grid, ctypes.c_void_p(stream))
    _raise_on(rc, "kruskal_groups", lib)
    launches["kruskal_groups"] += 1
    return H, p


def friedman(data, block_mask):
    """Launch kernel O's Friedman entry on B tables of n blocks x k
    treatments ((B, n, k) float32, block_mask (B, n) bool). Returns chi2
    and p, (B,) float32."""
    B, n, k = data.shape
    dev = data.device
    _check(data, "data", torch.float32, (B, n, k), dev)
    _check(block_mask, "block_mask", torch.bool, (B, n), dev)
    chi2 = torch.empty(B, dtype=torch.float32, device=dev)
    p = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return chi2, p
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_friedman(_ptr(data), _ptr(block_mask), B, n, k, _ptr(chi2), _ptr(p),
                             ctypes.c_void_p(stream))
    _raise_on(rc, "friedman", lib)
    launches["friedman"] += 1
    return chi2, p


def fleet_topk(values, k: int, valid=None, base: int = 0):
    """Launch kernel P on n rows' (n,) float32 values: the min(k, n) largest
    in lax.top_k's order (IEEE total order descending, lower index first),
    a row's value taken as -inf where `valid` ((n,) bool) is False, row i
    keyed by the index base + i. Returns count (a 0-d int64 tensor, the
    valid rows; None without `valid`), top_v (min(k, n),) float32 and top_i
    (min(k, n),) int64. Indices past MAX_FLEET_ROWS and more than
    MAX_FLEET_SLICE rows are refused."""
    n = values.shape[0] if values.dim() == 1 else -1
    if n > MAX_FLEET_SLICE:
        raise ValueError(f"fleet_topk takes at most {MAX_FLEET_SLICE} rows a launch; got {n}")
    if base < 0 or base + n - 1 > MAX_FLEET_ROWS:
        raise ValueError(f"fleet_topk keys rows by a 32-bit index; got base {base}, n {n}")
    if k < 0:
        raise ValueError(f"fleet_topk takes k >= 0, got {k}")
    dev = values.device
    _check(values, "values", torch.float32, (n,), dev)
    if valid is not None:
        _check(valid, "valid", torch.bool, (n,), dev)
    kk = min(int(k), n)
    top_v = torch.empty(kk, dtype=torch.float32, device=dev)
    top_i = torch.empty(kk, dtype=torch.int64, device=dev)
    count = None if valid is None else torch.zeros((), dtype=torch.int64, device=dev)
    if n == 0 or kk == 0 and valid is None:
        return count, top_v, top_i
    lib = build.library()
    scratch = torch.empty(lib.fm_fleet_topk_scratch_bytes(n, max(kk, 1)), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_fleet_topk(_ptr(values), _opt(valid), int(base), n, kk,
                               _ptr(top_v), _ptr(top_i), _opt(count), _ptr(scratch),
                               ctypes.c_void_p(stream))
    _raise_on(rc, "fleet_topk", lib)
    launches["fleet_topk"] += 1
    return count, top_v, top_i
