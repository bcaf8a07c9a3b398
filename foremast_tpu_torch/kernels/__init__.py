"""Launchers of the port's hand-written CUDA kernels.

- Kernel A, `pair_verdict` (``csrc/pair_verdict.cu``), judges B canary
  pairs in one launch, on the path `pair_path` picks by T: a warp a pair
  (T <= WARP_PAIR_T), a CTA a pair, or a CTA a pair from device scratch.
- Kernel B (``csrc/ma_band.cu``) runs the band chain for B rows: `ma_band`
  under moving_average_all, on the path `band_path` picks by T (the row
  staged once in registers up to STAGED_BAND_T, in shared memory above it;
  the first design when forced; all with the same bits), `band_from_preds`
  from given predictions.
- Kernel C, `smooth` (``csrc/smoothers.cu``), runs SES, DES or additive
  Holt-Winters one-step predictions; kernel D, `hw_fit` (same file), the
  Holt-Winters grid fit.
- Kernel E, `affine_scan` (``csrc/seqscan.cu``), runs SES or DES as a scan
  of affine maps (the long-window forms), on the path `scan_path` picks by
  kind and rows (DES over many rows walks a lane a row, the twin's bits).
- Kernel F, `detect_period` (``csrc/period.cu``), elects each row's
  seasonal period, on the path `period_path` picks by the candidates (one
  lag table a CTA, or tiles of candidates past TILE_CANDIDATES).
- Kernel G, `triage_screen` (``csrc/triage.cu``), runs the tier-0 triage
  screen: band counts under the policy band and a shrunk band, and the
  robust z of each row's current region.
- Kernel H, `bivariate` (``csrc/bivariate.cu``), judges B metric pairs
  under the bivariate-normal ellipse of their joint history.
- Kernel I, `hpa_score` (``csrc/hpa.cu``), scores B HPA rows from their
  traffic predictions, with sigma given or computed from the history.
- Kernel J, `st_fit` (``csrc/seasonal_trend.cu``), fits the seasonal-trend
  (Prophet-core) ridge model of B rows, each with its own period, on the
  path `st_path` picks by the columns (a warp a row up to WARP_ST_D, a CTA
  a row above).
- Kernel K, `lstm_ae` (``csrc/lstm_ae.cu``), runs the LSTM autoencoder of
  J jobs, each with its own parameters, over K windows a job and writes
  each window's masked reconstruction error (and its z-score), on the
  path `lstm_ae_path` picks: a warp, a thread block cluster or a CTA a
  chunk of a job's windows, with the same bits.
- Kernel L (``csrc/lstm_train.cu``) trains it: `lstm_train_forward` runs
  the recurrences, stores the activations and sums each window block's
  squared errors; `lstm_train_backward` runs its two backward entries,
  `lstm_train_recurrence` (backpropagation through time of each window,
  rewriting the activations as the weight gradients' rows) and
  `lstm_train_wgrad` (those rows' GEMMs and the per-window records' sums
  into one gradient row a job); the recurrence's path is
  `lstm_bptt_path`'s (a group of warps, or a CTA a window for wider rows).
- Kernel M, `adam` (``csrc/adam.cu``), scales L's gradient and applies
  optax's Adam to the J parameter rows in place.
- Kernel N, `pair_tests` (``csrc/pair_tests.cu``), runs the public
  two-sample test battery (Mann-Whitney, two-group Kruskal-Wallis,
  Wilcoxon, KS) and the exact sign test on B window pairs, on kernel A's
  device code (``csrc/pair_common.cuh``) and its paths.
- Kernel O (``csrc/rank_groups.cu``): `rank_and_ties` ranks B masked rows
  (on the path `rank_path` picks by T) and `kruskal_groups` gives the
  Kruskal-Wallis H of B sets of k groups (on the path `kruskal_path` picks
  by k T): each a warp, a CTA or a CTA from device scratch a row, with the
  same bits; `friedman` gives the Friedman chi-square of B (n blocks x k
  treatments) tables, on the path `friedman_path` picks by k (a warp for
  32 rows, or a CTA a row), with the same bits.
- Kernel P, `fleet_topk` (``csrc/fleet_topk.cu``), counts a fleet's
  unhealthy rows and finds its k worst severities with their global
  indices, on the path `fleet_topk_path` picks by k (a selection by warp
  minima, or chunk sorts), with the same outputs.

Each launcher checks device, dtype, shape and contiguity, allocates the
outputs (and the scratch a kernel needs), launches on PyTorch's current
stream without synchronising, raises if the launch failed, and adds one to
its entry of `launches` per launch (`lstm_train_backward` launches kernel
L's two backward entries, counted as `lstm_train_recurrence` and
`lstm_train_wgrad`; `lstm_ae`, `bivariate`, `pair_verdict`,
`pair_tests`, `kruskal_groups`, `rank_and_ties`, `ma_band`, `friedman`,
`fleet_topk`, `st_fit`, `detect_period`, `lstm_train_recurrence` and
`affine_scan` also count by path, in `lstm_ae_path_launches`,
`bivariate_path_launches`, `pair_path_launches`,
`pair_tests_path_launches`, `kruskal_path_launches`, `rank_path_launches`,
`band_path_launches`, `friedman_path_launches`,
`fleet_topk_path_launches`, `st_path_launches`, `period_path_launches`,
`bptt_path_launches` and `scan_path_launches`).
They take CUDA tensors only; the entry points
(``parallel.fleet.score_pairs``, ``ops.forecast``, ``ops.seqscan``,
``ops.triage``, ``ops.bivariate``, ``ops.hpa``, ``ops.pairwise``,
``ops.ranks``, ``models.lstm_ae``, ``parallel.fleet``'s scorer) send CPU
tensors to the plain twins.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

__all__ = ["launches", "reset_launches", "pair_verdict", "ma_band", "band_from_preds",
           "smooth", "hw_fit", "affine_scan", "detect_period", "triage_screen", "bivariate",
           "hpa_score", "st_fit", "lstm_ae", "lstm_train_forward", "lstm_train_backward",
           "lstm_train_recurrence", "lstm_train_wgrad", "adam", "pair_tests", "rank_and_ties",
           "kruskal_groups", "friedman", "fleet_topk", "lstm_train_blocks", "lstm_bptt_blocks",
           "lstm_train_forward_path", "lstm_ae_path", "lstm_ae_serves", "lstm_ae_path_launches",
           "lstm_ae_chunk_windows", "lstm_ae_warp_smem_bytes", "lstm_ae_cluster_smem_bytes",
           "LSTM_AE_PATHS", "LSTM_AE_SMEM_BYTES", "bivariate_path", "bivariate_cluster",
           "bivariate_slice", "bivariate_smem_bytes", "bivariate_path_launches",
           "BIVARIATE_PATHS", "BI_SLICE_T", "BI_MAX_CLUSTER", "CTA_SMEM_BYTES", "smooth_hw_warps",
           "pair_path", "pair_warp_grid", "pair_path_launches", "pair_tests_path_launches",
           "PAIR_PATHS", "WARP_PAIR_T", "PAIR_WARPS", "TESTS_PHASES",
           "PAIR_TEST_BITS", "MAX_RANK_KEYS", "SHARED_RANK_KEYS", "WARP_RANK_KEYS",
           "KRUSKAL_PATHS", "KRUSKAL_WARPS", "kruskal_path", "kruskal_serves",
           "kruskal_warp_grid", "kruskal_path_launches", "RANK_PATHS", "rank_path",
           "rank_serves", "rank_path_launches", "STAGED_BAND_T", "BAND_PATHS",
           "band_path", "band_serves", "band_path_launches", "FRIEDMAN_PATHS",
           "WARP_FRIEDMAN_K", "WARP_FRIEDMAN_N", "FRIEDMAN_WARPS", "FRIEDMAN_ROWS", "friedman_path",
           "friedman_serves", "friedman_path_launches", "FLEET_TOPK_PATHS", "FLEET_SELECT_K",
           "fleet_topk_path", "fleet_topk_serves", "fleet_topk_path_launches", "empty_launches",
           "fleet_topk_slices",
           "MAX_FLEET_ROWS", "MAX_FLEET_SLICE", "PAIR_SORT_T", "SHARED_PAIR_T", "MAX_BAND_T",
           "MAX_PERIOD_T", "MAX_SCREEN_T", "MAX_BI_T", "MAX_HPA_T", "TILE_CANDIDATES",
           "PERIOD_PATHS", "period_path", "period_max_candidates", "period_path_launches",
           "MAX_GRID", "WARP_ST_D", "ST_PATHS", "st_path", "st_path_launches", "MAX_ST_T",
           "CLUSTER_LSTM_HIDDEN", "GROUP_BPTT_H", "GROUP_BPTT_F", "BPTT_PATHS",
           "lstm_bptt_path", "bptt_path_launches", "SCAN_PATHS", "WALK_ROWS",
           "scan_path", "scan_serves", "scan_path_launches",
           "LSTM_SMEM_PARAMS_BYTES", "LSTM_TRAIN_SMEM_BYTES",
           "LSTM_FORWARD_SMEM_BYTES", "st_sincos_check", "ks_division_check",
           "PAIR_PHASES", "KRUSKAL_PHASES", "RANK_PHASES", "BAND_PHASES", "TRIAGE_PHASES",
           "HW_FIT_PHASES", "ST_FIT_PHASES", "PERIOD_PHASES", "HPA_PHASES", "BI_PHASES", "SMOOTH_HW_PHASES",
           "LSTM_FORWARD_PHASES", "LSTM_AE_PHASES", "SMOOTH_SES", "SMOOTH_DES", "SMOOTH_HW"]

# kernels A and N run one of three paths (pair_path): up to WARP_PAIR_T a
# warp a pair, PAIR_WARPS pairs a CTA, the 2T rank keys in registers; up to
# SHARED_PAIR_T a CTA a pair, its 2T sort entries (16 B each) in shared
# memory; above it a CTA a pair from device scratch (a slot of
# next_pow2(2T) x 16 B, 2 MB at a 30-day window of 43,200 steps), as many
# CTAs as SCRATCH_BYTES holds, at least one. All three give the same bits.
# A launcher's path= forces one where it serves T (tests, timing). The sort
# indexes its next_pow2(2T) keys in int, which bounds T at PAIR_SORT_T.
WARP_PAIR_T = 256
SHARED_PAIR_T = 4096
PAIR_SORT_T = 1 << 29
PAIR_PATHS = ("warp", "cta", "scratch")
PAIR_WARPS = 4  # the warp path's pairs a CTA (fm_pair_warps)
# kernel B serves rows up to MAX_WINDOW_STEPS. ma_band runs one of three
# paths (band_path), with the same bits: up to STAGED_BAND_T the row staged
# once (x in registers and shared memory, mask and region as bit words, up
# to 16 slots a thread); above it, up to MAX_BAND_T, the long path (the row
# staged once, x in shared memory, S rebuilt from each chunk's offset, three
# CTAs an SM); the unstaged path, the first design (12 B of prefix sums a
# slot, its inputs read from device memory in each pass), serves every T
# and is taken only when forced. Its path= forces one where it serves T
# (tests, timing).
MAX_BAND_T = 16384
STAGED_BAND_T = 4096
BAND_PATHS = ("staged", "long", "unstaged")
# kernel G keeps 12 B a slot (x and the prefix sums) and bit words in shared
# memory, and a select thread's keys (T / 256) in registers
MAX_SCREEN_T = 16384
# kernel F keeps 4.1 B per slot (the residual, the mask as bits) and up to
# 29 B per candidate (its lag and half-lag indices, its score and
# eligibility, two distinct lags and their scores) in shared memory
MAX_PERIOD_T = 16384
# up to TILE_CANDIDATES candidates kernel F builds its lag table once a CTA
# ("table", the first design); above it ("tiled") it sweeps them in tiles of
# TILE_CANDIDATES, a tile's lag table built for each row, every candidate's
# score and eligibility kept for the pick (5 B each, so a CTA's shared
# memory bounds the candidates: period_max_candidates)
TILE_CANDIDATES = 1024
PERIOD_PATHS = ("table", "tiled")
# kernel H stages 11 B a slot (two floats, three mask bytes) in shared
# memory, a CTA a slice of at most BI_SLICE_T slots: a row up to BI_SLICE_T
# is one CTA ("cta" path), a longer one a thread block cluster of
# ceil(T / BI_SLICE_T) CTAs ("cluster" path). The choice is made here
# alone: the launch passes the CTAs a row (bivariate_cluster) to the C
# entry, which stages ceil(T / cl) slots a CTA, rounded up to 16.
# BIVARIATE_FORCE, a path's name, makes bivariate take that path where it
# serves the shape (the cta path while one CTA's shared memory holds the
# row; the cluster path as at least two CTAs): tests hold the paths against
# each other.
MAX_BI_T = 16384
BI_SLICE_T = 4096
CTA_SMEM_BYTES = 232_448  # the most shared memory an H100 CTA may take
BI_MAX_CLUSTER = 8
BIVARIATE_PATHS = ("cta", "cluster")
BIVARIATE_FORCE = None
# kernel I keeps 4.4 B per slot in shared memory (the SLA history, three bit
# planes)
MAX_HPA_T = 16384
# kernel D runs two candidates per lane of a warp
MAX_GRID = 64
# kernel J runs one of two paths (st_path): up to WARP_ST_D columns a warp a
# row (one lane per column in the solve), above it a CTA a row (any D; the
# gram in shared memory while it fits, else in device scratch). path=
# forces one where it serves D (tests, timing). t is exact in float32.
WARP_ST_D = 32
ST_PATHS = ("warp", "cta")
MAX_ST_T = 1 << 24
# kernel K's wide path: a CTA's gate products, states and per-window
# partial sums live in shared memory; its parameters join them there up to
# this many bytes, above it they are read through the caches (L1, L2)
LSTM_SMEM_PARAMS_BYTES = 96 * 1024
# kernel K's cluster path takes at most CLUSTER_LSTM_HIDDEN units (8 CTAs of
# 32); wider rows take the wide path
CLUSTER_LSTM_HIDDEN = 256
# kernel L's recurrence runs one of two paths (lstm_bptt_path): "group"
# (the first design) where a group of 32 ceil(H / 32) threads holds a
# window's units (H <= GROUP_BPTT_H) and a warp's lanes its features (F <=
# GROUP_BPTT_F); "wide" (a CTA a window, threads striding units and
# features; any width) above. The group path holds the recurrent weights
# (rows of 4H + 1 floats) in shared memory beside its windows' state while
# the CTA needs at most LSTM_TRAIN_SMEM_BYTES (two CTAs an SM), in device
# memory above it (H above about 80)
GROUP_BPTT_H = 256
GROUP_BPTT_F = 32
BPTT_PATHS = ("group", "wide")
LSTM_TRAIN_SMEM_BYTES = 113 * 1024
# kernel L's forward runs its tile path (a job's windows a CTA, the
# parameter row in shared memory) where that CTA's shared memory fits this
# budget (two CTAs an SM), else the wide path (8 windows a CTA, parameters
# read from device memory above LSTM_SMEM_PARAMS_BYTES)
LSTM_FORWARD_SMEM_BYTES = 113 * 1024
# kernel K's paths (lstm_ae_path), in the order they are tried: "warp" (H <=
# 32, the engine's width: a warp a chunk of a job's windows, each lane's
# recurrent weights in registers and the warp's shared memory), "cluster"
# (32 < H <= 256: a cluster of ceil(H / 32) CTAs a chunk, Wh split over
# them), "wide" (the first design: a CTA of up to eight windows; every
# width). A path serves a shape while its CTA's shared memory fits
# LSTM_AE_SMEM_BYTES (an H100 CTA's most). LSTM_AE_FORCE, a path's name,
# makes lstm_ae take that path (raising where it does not serve): tests
# hold the paths against one another.
LSTM_AE_PATHS = ("warp", "cluster", "wide")
LSTM_AE_FORCE = None
LSTM_AE_SMEM_BYTES = 232_448

# kernel N: each test's bit in its `tests` mask, in the column order of its
# outputs (the first four are all_pairwise_tests' family)
PAIR_TEST_BITS = {"mann_whitney": 1, "kruskal": 2, "wilcoxon": 4, "ks": 8, "sign": 16}
# kernel O: a row's sort keys (T for the ranks, k T for Kruskal-Wallis, 16 B
# each with the scan arrays) live in shared memory up to this many, in
# device scratch above it, up to MAX_RANK_KEYS, what the key's 30-bit
# position or group tag holds (a slot of up to 16 GB; past SCRATCH_BYTES
# one CTA a launch, its one slot). One CTA sorts a row, so a row of
# millions of keys takes seconds (PERF.md).
# kruskal_groups runs one of three paths (kruskal_path): up to
# WARP_RANK_KEYS keys a row a warp a row, KRUSKAL_WARPS rows a CTA, the
# 32-bit keys in registers; up to SHARED_RANK_KEYS a CTA a row in shared
# memory; above it a CTA a row from device scratch. All three give the same
# bits. Its path= forces one where it serves the row (tests, timing).
# rank_and_ties likewise (rank_path, by T): the same three paths and
# limits, the warp path on Kruskal's machinery with one group.
SHARED_RANK_KEYS = 8192
MAX_RANK_KEYS = 1 << 30  # 2^kTagBits (csrc/rank_groups.cu)
WARP_RANK_KEYS = 512
KRUSKAL_PATHS = ("warp", "cta", "scratch")
RANK_PATHS = KRUSKAL_PATHS
KRUSKAL_WARPS = 4  # the warp path's rows a CTA (fm_kruskal_warps), for both entries
# friedman runs one of two paths (friedman_path), with the same bits: up to
# WARP_FRIEDMAN_K treatments and WARP_FRIEDMAN_N blocks (its sums in 32-bit
# integers) a warp for FRIEDMAN_ROWS rows (FRIEDMAN_WARPS warps a CTA), a
# block's k keys in a lane's registers, each lane finishing one row's chi2
# and p; the cta path (the first design, a CTA a row) at any shape. Its
# path= forces one where it serves the shape (tests, timing).
WARP_FRIEDMAN_K = 16
WARP_FRIEDMAN_N = 1 << 20
FRIEDMAN_WARPS = 4
FRIEDMAN_ROWS = 32
FRIEDMAN_PATHS = ("warp", "cta")
# kernel P keys a row by its index in 32 bits (base + i up to
# MAX_FLEET_ROWS), and takes at most MAX_FLEET_SLICE rows a launch (its C
# entry counts rows and kept keys in int). fleet_topk serves any n and base:
# past either limit it launches slices of at most MAX_FLEET_SLICE rows, each
# keyed from its own 0, and merges their candidates (fleet_topk_slices). It
# runs one of two paths (fleet_topk_path), with the same outputs: up to
# FLEET_SELECT_K kept keys a selection by rounds of warp minima; the chunked
# path (the first design: chunk sorts) at any k. Its path= forces one where
# it serves k (tests, timing).
MAX_FLEET_ROWS = (1 << 32) - 1
MAX_FLEET_SLICE = 1 << 30
FLEET_SELECT_K = 32
FLEET_TOPK_PATHS = ("select", "chunked")

SMOOTH_SES, SMOOTH_DES, SMOOTH_HW = 1, 2, 3
# kernel E runs one of two paths (scan_path), by kind and rows: "scan" (a
# CTA a row composing the steps' affine maps; SES at any B, DES below
# WALK_ROWS rows) and "walk" (DES at WALK_ROWS rows and more: a lane a row
# stepping the twin's float64 maps in order, 32 rows a warp, tiles of 64
# steps staged in shared memory; the twin's bits). A row walked
# alone is ~16k dependent steps (0.64 ms at T = 16384 on an H100, the scan
# 0.08 ms), so few rows take the scan: the walk's time stays ~0.78 ms up to
# ~8k rows while the scan's grows with the rows, and the walk wins from
# between 4,224 and 8,448 rows (PERF.md). path= forces one where it serves
# the kind (tests, timing).
SCAN_PATHS = ("scan", "walk")
WALK_ROWS = 2 * 132 * 32  # two warps for each of an H100's SMs

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

# kernel G's phases, as its optional per-row cycle counts split it (stage,
# then the predictor group's scan, sigma and bands beside the select group's
# key loads, both selections' parts and the MAD's keys, then the row's
# total); kernel D's, as its optional per-row cycle sums split it
TRIAGE_PHASES = ("stage", "scan", "sigma", "bands", "keys", "minmax", "passes", "pair",
                 "mad_keys", "total")
HW_FIT_PHASES = ("level0", "stage", "walk", "store")  # level0 includes the row's end
# kernel J's phases, as its optional per-row cycle counts split it; kernel L's
# forward's, as its optional per-job cycle sums split it
ST_FIT_PHASES = ("gram", "solve", "preds")
# kernel F's and kernel I's phases, as their optional per-row cycle counts
# split them
PERIOD_PHASES = ("stage", "detrend", "sweeps", "reductions", "pick")
HPA_PHASES = ("pass_a", "reduce_a", "pass_b", "tail")
# kernel H's phases, as its optional per-row cycle counts split them; kernel
# C's Holt-Winters kind's, as its optional cycle counts a group of 32 rows
# split them
BI_PHASES = ("stage", "moments", "flags", "reductions")
SMOOTH_HW_PHASES = ("level0", "stage", "ring", "walk", "store")
LSTM_FORWARD_PHASES = ("stage", "encoder", "latent", "decoder", "sums")
LSTM_AE_PHASES = LSTM_FORWARD_PHASES  # kernel K's split is its forward's

# kernel A's phases, in order, as its optional clock stamps split it; kernel
# N's (its warp path's stamps), A's without the gates and band
PAIR_PHASES = ("counts", "sort", "rank_scans", "wilcoxon_sort", "wilcoxon_scans",
               "mw_kw_ks", "exact_tails", "gates_band")
TESTS_PHASES = PAIR_PHASES[:-1]
# kernel O's Kruskal-Wallis and rank entries' phases and kernel B's
# ma_band's, as their optional clock stamps split them
KRUSKAL_PHASES = ("load", "sort", "bounds", "group_sums", "tail")
RANK_PHASES = ("load", "sort", "bounds", "ranks", "tail")  # the warp path's stamps
BAND_PHASES = ("load", "scan", "predict_sigma", "band", "reduce")

# kernel K's launches by path (each also counts in launches["lstm_ae"]);
# kernel H's likewise
lstm_ae_path_launches = {"warp": 0, "cluster": 0, "wide": 0}
bivariate_path_launches = {"cta": 0, "cluster": 0}
# kernels A and N's launches by path (each also counts in launches)
pair_path_launches = {path: 0 for path in PAIR_PATHS}
pair_tests_path_launches = {path: 0 for path in PAIR_PATHS}
# kernel O's kruskal_groups and rank_and_ties launches by path and kernel
# B's ma_band's (each also counts in launches)
kruskal_path_launches = {path: 0 for path in KRUSKAL_PATHS}
rank_path_launches = {path: 0 for path in RANK_PATHS}
band_path_launches = {path: 0 for path in BAND_PATHS}
# kernel O's friedman and kernel P's launches by path (each also counts in
# launches)
friedman_path_launches = {path: 0 for path in FRIEDMAN_PATHS}
fleet_topk_path_launches = {path: 0 for path in FLEET_TOPK_PATHS}
# kernel J's, kernel F's and kernel L's recurrence's launches by path (each
# also counts in launches)
st_path_launches = {path: 0 for path in ST_PATHS}
period_path_launches = {path: 0 for path in PERIOD_PATHS}
bptt_path_launches = {path: 0 for path in BPTT_PATHS}
# kernel E's launches by path (each also counts in launches)
scan_path_launches = {path: 0 for path in SCAN_PATHS}

launches = {"pair_verdict": 0, "ma_band": 0, "band_from_preds": 0, "smooth": 0,
            "hw_fit": 0, "affine_scan": 0, "detect_period": 0, "triage_screen": 0,
            "bivariate": 0, "hpa_score": 0, "st_fit": 0, "lstm_ae": 0, "lstm_train_forward": 0,
            "lstm_train_recurrence": 0, "lstm_train_wgrad": 0, "adam": 0, "pair_tests": 0,
            "rank_and_ties": 0, "kruskal_groups": 0, "friedman": 0, "fleet_topk": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for counts in (lstm_ae_path_launches, bivariate_path_launches, pair_path_launches,
                   pair_tests_path_launches, kruskal_path_launches, rank_path_launches,
                   band_path_launches, friedman_path_launches, fleet_topk_path_launches,
                   st_path_launches, period_path_launches, bptt_path_launches,
                   scan_path_launches):
        for k in counts:
            counts[k] = 0


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


def pair_path(T: int) -> str:
    """Kernels A and N's path for windows of T slots."""
    if T <= WARP_PAIR_T:
        return "warp"
    return "cta" if T <= SHARED_PAIR_T else "scratch"


def _check_pair_t(T: int, kernel: str) -> None:
    if not 1 <= T <= PAIR_SORT_T:
        raise ValueError(f"{kernel} supports 1 <= T <= PAIR_SORT_T = {PAIR_SORT_T} (its sort's "
                         f"int index); got T = {T}")


def pair_warp_grid(B: int) -> int:
    """CTAs of the warp path for B pairs: a warp a pair, PAIR_WARPS a CTA."""
    return -(-B // PAIR_WARPS)


def _pair_launch_path(T: int, path, kernel: str) -> str:
    """The path a launch of kernel A or N takes: pair_path's, or the one
    forced, which must serve T."""
    if path is None:
        return pair_path(T)
    if path not in PAIR_PATHS:
        raise ValueError(f"{kernel} has the paths {PAIR_PATHS}; got {path!r}")
    if path == "warp" and T > WARP_PAIR_T:
        raise ValueError(f"{kernel}'s warp path serves T <= WARP_PAIR_T = {WARP_PAIR_T}; "
                         f"got T = {T}")
    if path == "cta" and T > SHARED_PAIR_T:
        raise ValueError(f"{kernel}'s cta path serves T <= SHARED_PAIR_T = {SHARED_PAIR_T}; "
                         f"got T = {T}")
    return path


_LGAMMA_TABLES = {}


def _lgamma_table(lib, dev) -> torch.Tensor:
    """lgamma(m) for m below the library's table size (float64, on dev),
    built by the library's own lgamma once a process a card (and waited
    for, so that launches on any stream may read it): the warp path's sign
    test reads its terms from it."""
    table = _LGAMMA_TABLES.get(dev)
    if table is None:
        table = torch.empty(lib.fm_lgamma_table_size(), dtype=torch.float64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            rc = lib.fm_lgamma_table(_ptr(table), ctypes.c_void_p(stream.cuda_stream))
            _raise_on(rc, "lgamma_table", lib)
            stream.synchronize()
        _LGAMMA_TABLES[dev] = table
    return table


def pair_verdict(baseline, b_mask, current, c_mask, pvalue_threshold, test_mask,
                 combine, ma_window, band_threshold, bound_mode, min_lower_bound,
                 min_points, *, wilcoxon_table, ks_exact_max: int,
                 wilcoxon_exact_max_n: int, phase_clocks=None, path=None):
    """Launch kernel A on score_pairs' 12 tensors; returns its 7 outputs.

    phase_clocks, an int64 (B, len(PAIR_PHASES) + 1) tensor, receives each
    pair's SM clock at the start and after each phase of PAIR_PHASES. path
    forces one of PAIR_PATHS (ValueError where it does not serve T).
    """
    B, T = baseline.shape
    dev = baseline.device
    _check_pair_t(T, "pair_verdict")
    path = _pair_launch_path(T, path, "pair_verdict")
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
    if path == "scratch":
        # one slot of device scratch per CTA; the CTAs walk pairs grid-stride
        stride = lib.fm_pair_verdict_scratch_stride(T)
        grid = max(1, min(B, SCRATCH_BYTES // stride))
        scratch = torch.empty(grid * stride, dtype=torch.uint8, device=dev)
    args = (_ptr(baseline), _ptr(b_mask), _ptr(current), _ptr(c_mask),
            _ptr(pvalue_threshold), _ptr(test_mask), _ptr(combine), _ptr(ma_window),
            _ptr(band_threshold), _ptr(bound_mode), _ptr(min_lower_bound),
            _ptr(min_points), mpw, _ptr(wilcoxon_table), wilcoxon_exact_max_n,
            ks_exact_max, B, T,
            _ptr(out["unhealthy"]), _ptr(out["severity"]), _ptr(out["pvalues"]),
            _ptr(out["band_count"]), _ptr(out["min_p"]),
            _ptr(out["pairwise_unhealthy"]), _ptr(out["band_unhealthy"]), _opt(phase_clocks))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if path == "warp":
            rc = lib.fm_pair_verdict_warp(*args, _ptr(_lgamma_table(lib, dev)),
                                          pair_warp_grid(B), stream)
        else:
            rc = lib.fm_pair_verdict(*args, _opt(scratch), stride, grid, stream)
    _raise_on(rc, "pair_verdict", lib)
    launches["pair_verdict"] += 1
    pair_path_launches[path] += 1
    return out


def band_path(T: int) -> str:
    """ma_band's path for rows of T slots."""
    return "staged" if T <= STAGED_BAND_T else "long"


def band_serves(path: str, T: int) -> bool:
    """Whether an ma_band path serves rows of T slots."""
    if path == "long":
        return STAGED_BAND_T < T <= MAX_BAND_T
    return T <= {"staged": STAGED_BAND_T, "unstaged": MAX_BAND_T}[path]


def ma_band(x, mask, region, window: int, threshold, bound_mode, min_lower_bound,
            phase_clocks=None, path=None):
    """Launch kernel B: moving average -> residual sigma -> band, B rows.

    phase_clocks, an int64 (B, len(BAND_PHASES) + 1) tensor, receives each
    row's SM clock at its start and after each phase of BAND_PHASES. path
    forces one of BAND_PATHS (ValueError where it does not serve T).
    """
    B, T = x.shape
    dev = x.device
    if not 1 <= T <= MAX_BAND_T:
        raise ValueError(f"ma_band supports 1 <= T <= {MAX_BAND_T}; got T = {T}")
    if path is not None:
        if path not in BAND_PATHS:
            raise ValueError(f"ma_band has the paths {BAND_PATHS}; got {path!r}")
        if not band_serves(path, T):
            serves = {"staged": f"T <= STAGED_BAND_T = {STAGED_BAND_T}",
                      "long": f"STAGED_BAND_T = {STAGED_BAND_T} < T <= MAX_BAND_T = "
                              f"{MAX_BAND_T}"}[path]
            raise ValueError(f"ma_band's {path} path serves {serves}; got T = {T}")
    path = path or band_path(T)
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (region, "region", torch.bool, (B, T)),
            (threshold, "threshold", torch.float32, (B,)),
            (bound_mode, "bound_mode", torch.int32, (B,)),
            (min_lower_bound, "min_lower_bound", torch.float32, (B,))):
        _check(t, name, dt, shape, dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(BAND_PHASES) + 1), dev)
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
        launch = {"staged": lib.fm_ma_band_staged, "long": lib.fm_ma_band_long,
                  "unstaged": lib.fm_ma_band}[path]
        rc = launch(
            _ptr(x), _ptr(mask), _ptr(region), int(window), _ptr(threshold),
            _ptr(bound_mode), _ptr(min_lower_bound), B, T,
            _ptr(out["preds"]), _ptr(out["sigma"]), _ptr(out["upper"]), _ptr(out["lower"]),
            _ptr(out["flags"]), _ptr(out["count"]), _ptr(out["first_index"]),
            _ptr(out["checked"]), _opt(phase_clocks), ctypes.c_void_p(stream))
    _raise_on(rc, "ma_band", lib)
    launches["ma_band"] += 1
    band_path_launches[path] += 1
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


def smooth_hw_warps(B: int, stride: int) -> int:
    """Warps of a launch of kernel C's Holt-Winters kind over B rows with
    season rings of `stride` floats: a warp a group of 32 rows, in whole
    CTAs of four, as many as the rings (32 stride floats a warp) fit in
    SCRATCH_BYTES, and at least one CTA. The C entry takes no more than the
    card holds at once; the groups go grid-stride over them."""
    groups = -(-int(B) // 32)
    budget = SCRATCH_BYTES // (32 * int(stride) * 4)
    return max(4, min(-(-groups // 4) * 4, budget // 4 * 4))


def smooth(kind: int, x, mask, alpha, beta=None, gamma=None, period=None,
           max_period: int | None = None, phase_clocks=None):
    """Launch kernel C: one-step predictions (B, T) of SES (kind
    SMOOTH_SES), DES (SMOOTH_DES, with beta) or additive Holt-Winters
    (SMOOTH_HW, with beta, gamma and a (B,) int32 period). max_period, an
    upper bound on the periods, sizes HW's season rings (device scratch
    for the warps in flight); without it the launcher reads the largest
    period from the card.

    phase_clocks (SMOOTH_HW only), an int64 (ceil(B / 32),
    len(SMOOTH_HW_PHASES)) tensor, receives the SM cycles each group of 32
    rows' warp spent in each phase of SMOOTH_HW_PHASES."""
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
    groups = (B + 31) // 32
    if phase_clocks is not None:
        if kind != SMOOTH_HW:
            raise ValueError("phase_clocks are kept for the Holt-Winters kind only")
        _check(phase_clocks, "phase_clocks", torch.int64, (groups, len(SMOOTH_HW_PHASES)), dev)
    preds = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return preds
    lib = build.library()
    if kind != SMOOTH_HW:
        n_warps = -(-groups // 4) * 4  # whole CTAs of 4 warps
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.fm_smooth(kind, _ptr(x), _ptr(mask), _ptr(alpha),
                               None if kind == SMOOTH_SES else _ptr(beta), B, T, n_warps,
                               _ptr(preds), ctypes.c_void_p(stream))
        _raise_on(rc, "smooth", lib)
        launches["smooth"] += 1
        return preds
    if max_period is None:
        max_period = int(period.max())
    stride = max(1, min(int(max_period), T))
    n_warps = smooth_hw_warps(B, stride)
    ring = torch.empty(n_warps * 32 * stride, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_smooth_hw(_ptr(x), _ptr(mask), _ptr(alpha), _ptr(beta), _ptr(gamma),
                              _ptr(period), B, T, stride, _ptr(ring), n_warps, _ptr(preds),
                              _opt(phase_clocks), ctypes.c_void_p(stream))
    _raise_on(rc, "smooth", lib)
    launches["smooth"] += 1
    return preds


def hw_fit(x, mask, fit_mask, period, grid, max_period: int | None = None,
           phase_clocks=None):
    """Launch kernel D: each row's mean squared one-step Holt-Winters error
    over fit_mask & mask for every (alpha, beta, gamma) row of grid (G <=
    MAX_GRID), and the argmin. Returns params (B, 3), best (B,) int32 and
    mse (B, G) float64.

    phase_clocks, an int64 (B, len(HW_FIT_PHASES)) tensor, receives the SM
    cycles each row's warp spent in each phase of HW_FIT_PHASES."""
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
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(HW_FIT_PHASES)), dev)
    out = {
        "params": torch.empty((B, 3), dtype=torch.float32, device=dev),
        "best": torch.empty(B, dtype=torch.int32, device=dev),
        "mse": torch.empty((B, G), dtype=torch.float64, device=dev),
    }
    if B == 0 or T == 0:
        return out
    if max_period is None:
        max_period = int(period.max())
    lib = build.library()
    stride = max(1, min(int(max_period), T))
    row = lib.fm_hw_fit_ring_row(G)  # floats a ring slot: the candidates, rounded up to even
    slot = stride * row * 4  # (period, row) floats per warp
    n_warps = max(1, min(B, SCRATCH_BYTES // slot))
    n_warps = -(-n_warps // 4) * 4
    ring = torch.empty(n_warps * stride * row, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_hw_fit(
            _ptr(x), _ptr(mask), _ptr(fit_mask), _ptr(period), _ptr(grid), G, B, T,
            _ptr(ring), stride, n_warps, _ptr(out["params"]), _ptr(out["best"]),
            _ptr(out["mse"]), _opt(phase_clocks), ctypes.c_void_p(stream))
    _raise_on(rc, "hw_fit", lib)
    launches["hw_fit"] += 1
    return out


def scan_path(kind: int, B: int, T: int) -> str:
    """Kernel E's path for B rows of T steps of `kind`: "walk" (a lane a
    row) for DES at WALK_ROWS rows or more, else "scan" (a CTA a row)."""
    return "walk" if kind == SMOOTH_DES and B >= WALK_ROWS else "scan"


def scan_serves(path: str, kind: int) -> bool:
    """Whether a path of kernel E serves `kind` (the walk runs DES alone)."""
    return path == "scan" or (path == "walk" and kind == SMOOTH_DES)


def affine_scan(kind: int, x, mask, alpha, beta=None, path=None):
    """Launch kernel E: SES (SMOOTH_SES) or DES (SMOOTH_DES, with beta)
    one-step predictions (B, T), on the path scan_path picks: a scan of
    affine maps a CTA a row, or (DES) the twin's walk a lane a row, its
    bits. path forces one of SCAN_PATHS (ValueError where it does not serve
    the kind)."""
    B, T = x.shape
    dev = x.device
    if path is not None and path not in SCAN_PATHS:
        raise ValueError(f"affine_scan has the paths {SCAN_PATHS}; got {path!r}")
    if path is not None and not scan_serves(path, kind):
        raise ValueError(f"affine_scan's walk path runs DES (SMOOTH_DES) alone; got kind {kind}")
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
    path = path or scan_path(kind, B, T)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if path == "walk":
            rc = lib.fm_affine_scan_walk(_ptr(x), _ptr(mask), _ptr(alpha), _ptr(beta), B, T,
                                         _ptr(preds), stream)
        else:
            rc = lib.fm_affine_scan(kind, _ptr(x), _ptr(mask), _ptr(alpha),
                                    None if kind == SMOOTH_SES else _ptr(beta), B, T,
                                    _ptr(preds), stream)
    _raise_on(rc, "affine_scan", lib)
    launches["affine_scan"] += 1
    scan_path_launches[path] += 1
    return preds


def period_path(C: int) -> str:
    """Kernel F's path for C candidates: "table" up to TILE_CANDIDATES,
    else "tiled"."""
    return "table" if C <= TILE_CANDIDATES else "tiled"


def period_max_candidates(T: int) -> int:
    """The most candidates kernel F takes at T slots (the tiled path keeps
    5 B a candidate in a CTA's shared memory: about 29,000 at T = 16384)."""
    return int(build.library().fm_period_max_candidates(int(T)))


def detect_period(x, mask, candidates, fallback, min_acf: float, alias_margin: float,
                  contrast_margin: float, phase_clocks=None, path=None):
    """Launch kernel F: each row's period among `candidates` ((C,) int32,
    C <= period_max_candidates(T)) or its `fallback` ((B,) int32), on the
    path period_path(C) picks (path= forces one of PERIOD_PATHS: "tiled"
    serves any C, "table" up to TILE_CANDIDATES). Returns period (B,) int32
    and scores (B, C) float32.

    phase_clocks, an int64 (B, len(PERIOD_PHASES)) tensor, receives the SM
    cycles each row spent in each phase of PERIOD_PHASES."""
    B, T = x.shape
    dev = x.device
    if not 1 <= T <= MAX_PERIOD_T:
        raise ValueError(f"detect_period supports 1 <= T <= {MAX_PERIOD_T}; got T = {T}")
    C = candidates.shape[0] if candidates.dim() == 1 else -1
    if C < 0:
        raise ValueError("detect_period takes a (C,) tensor of candidates")
    if path is None:
        path = period_path(C)
    elif path not in PERIOD_PATHS:
        raise ValueError(f"kernel F has no path {path!r}; its paths are {PERIOD_PATHS}")
    elif path == "table" and C > TILE_CANDIDATES:
        raise ValueError(f"detect_period's table path takes at most TILE_CANDIDATES = "
                         f"{TILE_CANDIDATES} candidates; got {C}")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (candidates, "candidates", torch.int32, (C,)),
            (fallback, "fallback", torch.int32, (B,))):
        _check(t, name, dt, shape, dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(PERIOD_PHASES)), dev)
    period = torch.empty(B, dtype=torch.int32, device=dev)
    scores = torch.empty((B, C), dtype=torch.float32, device=dev)
    if B == 0:
        return period, scores
    lib = build.library()
    if C > TILE_CANDIDATES and C > lib.fm_period_max_candidates(T):
        raise ValueError(f"detect_period takes at most {lib.fm_period_max_candidates(T)} "
                         f"candidates at T = {T}; got {C}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_detect_period(
            _ptr(x), _ptr(mask), _ptr(candidates), C, _ptr(fallback), float(min_acf),
            float(alias_margin), float(contrast_margin), B, T, _ptr(period), _ptr(scores),
            _opt(phase_clocks), int(path == "tiled"), ctypes.c_void_p(stream))
    _raise_on(rc, "detect_period", lib)
    launches["detect_period"] += 1
    period_path_launches[path] += 1
    return period, scores


def triage_screen(x, mask, region, window: int, threshold, bound_mode, min_lower_bound, margin,
                  phase_clocks=None):
    """Launch kernel G: the triage screen of B rows. Returns count,
    shrunk_count, checked, n_hist (int32) and upper_mean, lower_mean,
    resid_z, robust_z, sigma (float32), each (B,).

    phase_clocks, an int64 (B, len(TRIAGE_PHASES)) tensor, receives the SM
    cycles each row spent in each phase of TRIAGE_PHASES."""
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
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(TRIAGE_PHASES)), dev)
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
            _opt(phase_clocks), ctypes.c_void_p(stream))
    _raise_on(rc, "triage_screen", lib)
    launches["triage_screen"] += 1
    return out


def _opt(t):
    return None if t is None else _ptr(t)


def bivariate_slice(T: int, cl: int) -> int:
    """Slots a CTA of kernel H stages when a row of T slots is cl CTAs: a
    share rounded up to 16 (csrc/bivariate.cu: bi_slice)."""
    return (-(-int(T) // int(cl)) + 15) & ~15


def bivariate_smem_bytes(T: int, cl: int) -> int:
    """Dynamic shared memory of a CTA of kernel H (csrc/bivariate.cu:
    bi_smem_bytes): the reductions' scratch and 11 B a staged slot."""
    return 896 + 11 * bivariate_slice(T, cl)


def bivariate_path(T: int) -> str:
    """Kernel H's path for rows of T slots: "cta" up to BI_SLICE_T, else
    "cluster"."""
    return "cta" if T <= BI_SLICE_T else "cluster"


def bivariate_cluster(T: int, path: str | None = None) -> int:
    """CTAs a row of T slots on kernel H's path (bivariate_path's when None):
    1 on the cta path, ceil(T / BI_SLICE_T) and at least 2 on the cluster
    path. Raises ValueError where the path does not serve T."""
    path = path or bivariate_path(T)
    if path == "cta":
        if bivariate_smem_bytes(T, 1) > CTA_SMEM_BYTES:
            raise ValueError(f"kernel H's cta path does not hold a row of T = {T}")
        return 1
    if path != "cluster":
        raise ValueError(f"kernel H has no path {path!r}; its paths are {BIVARIATE_PATHS}")
    cl = max(2, -(-int(T) // BI_SLICE_T))
    if cl > BI_MAX_CLUSTER:
        raise ValueError(f"kernel H's cluster path takes at most {BI_MAX_CLUSTER} CTAs a row")
    return cl


def bivariate(x1, m1, x2, m2, region, threshold, min_lower_bound1=None,
              min_lower_bound2=None, bound_mode1=None, bound_mode2=None, phase_clocks=None):
    """Launch kernel H: the bivariate-normal ellipse of B metric pairs.
    Returns flags (B, T) bool, d2 (B, T) float32, count, first_index,
    checked (B,) int32 and the marginal bands upper1, lower1, upper2,
    lower2 as (B,) float32 (constant in t). A bound floor or bound mode
    left out is absent, as in the reference.

    phase_clocks, an int64 (B, len(BI_PHASES)) tensor, receives the SM
    cycles each row's first thread spent in each phase of BI_PHASES."""
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
    if phase_clocks is not None:
        named.append((phase_clocks, "phase_clocks", torch.int64, (B, len(BI_PHASES))))
    for t, name, dt, shape in named:
        _check(t, name, dt, shape, dev)
    out = {"flags": torch.empty((B, T), dtype=torch.bool, device=dev),
           "d2": torch.empty((B, T), dtype=torch.float32, device=dev)}
    out.update({k: torch.empty(B, dtype=torch.int32, device=dev) for k in BI_INT_OUTPUTS})
    out.update({k: torch.empty(B, dtype=torch.float32, device=dev) for k in BI_BAND_OUTPUTS})
    if B == 0:
        return out
    path = BIVARIATE_FORCE or bivariate_path(T)
    cl = bivariate_cluster(T, path)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_bivariate(
            _ptr(x1), _ptr(m1), _ptr(x2), _ptr(m2), _ptr(region), _ptr(threshold),
            _opt(min_lower_bound1), _opt(min_lower_bound2), _opt(bound_mode1),
            _opt(bound_mode2), B, T, cl, _ptr(out["flags"]), _ptr(out["d2"]),
            *(_ptr(out[k]) for k in BI_INT_OUTPUTS + BI_BAND_OUTPUTS), _opt(phase_clocks),
            ctypes.c_void_p(stream))
    _raise_on(rc, "bivariate", lib)
    launches["bivariate"] += 1
    bivariate_path_launches[path] += 1
    return out


def hpa_score(tps, tps_mask, region, tps_pred, sla, sla_mask, sla_static_limit, sla_mode,
              threshold, *, tps_sigma=None, safe=None, pods_now=None, pods_hist=None,
              sla_absolute=None, phase_clocks=None):
    """Launch kernel I: the HPA scores of B rows. With tps_sigma ((B,)
    float32) it is the reference's hpa_scores; without it, it first takes
    sigma as the RMS residual of tps_pred over tps_mask & ~region (+inf
    below 2 points) and returns it too, as "tps_sigma". Returns the (B,)
    outputs of HPA_OUTPUTS (reason int32, the rest float32).

    phase_clocks, an int64 (B, len(HPA_PHASES)) tensor, receives the SM
    cycles each row spent in each phase of HPA_PHASES."""
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
    if phase_clocks is not None:
        named.append((phase_clocks, "phase_clocks", torch.int64, (B, len(HPA_PHASES))))
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
            rc = lib.fm_hpa_from_preds(*common, *rest, _ptr(out["tps_sigma"]),
                                       _opt(phase_clocks), stream)
        else:
            rc = lib.fm_hpa_scores(*common, _ptr(tps_sigma), *rest, _opt(phase_clocks), stream)
    _raise_on(rc, "hpa_score", lib)
    launches["hpa_score"] += 1
    return out


def st_path(D: int) -> str:
    """Kernel J's path for D columns: "warp" up to WARP_ST_D, else "cta"."""
    return "warp" if D <= WARP_ST_D else "cta"


def st_fit(x, mask, fit_mask, period, order: int, n_changepoints: int, ridge: float,
           cp_shrink: float, l1_iters: int, phase_clocks=None, path=None):
    """Launch kernel J: the seasonal-trend fit of B rows over fit_mask &
    mask, each row with its (B,) int32 period. Returns beta (B, D) and
    preds (B, T) float32, D = 2 + n_changepoints + 2 order, on the path
    st_path(D) picks (path= forces one of ST_PATHS; ValueError where the
    warp path does not serve D).

    phase_clocks, an int64 (B, len(ST_FIT_PHASES)) tensor, receives the SM
    cycles each row spent in each phase of ST_FIT_PHASES."""
    B, T = x.shape
    dev = x.device
    D = 2 + int(n_changepoints) + 2 * int(order)
    if order < 0 or n_changepoints < 0:
        raise ValueError(f"st_fit takes order >= 0 and n_changepoints >= 0; got {order}, "
                         f"{n_changepoints}")
    if path is None:
        path = st_path(D)
    elif path not in ST_PATHS:
        raise ValueError(f"kernel J has no path {path!r}; its paths are {ST_PATHS}")
    elif path == "warp" and D > WARP_ST_D:
        raise ValueError(f"st_fit's warp path takes D <= WARP_ST_D = {WARP_ST_D} columns; "
                         f"got {D}")
    if not 1 <= T <= MAX_ST_T:
        raise ValueError(f"st_fit supports 1 <= T <= {MAX_ST_T}; got T = {T}")
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)),
            (mask, "mask", torch.bool, (B, T)),
            (fit_mask, "fit_mask", torch.bool, (B, T)),
            (period, "period", torch.int32, (B,))):
        _check(t, name, dt, shape, dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(ST_FIT_PHASES)), dev)
    beta = torch.empty((B, D), dtype=torch.float32, device=dev)
    preds = torch.empty((B, T), dtype=torch.float32, device=dev)
    if B == 0:
        return beta, preds
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (_ptr(x), _ptr(mask), _ptr(fit_mask), _ptr(period), int(order),
                int(n_changepoints), float(ridge), float(cp_shrink), int(l1_iters), B, T,
                _ptr(beta), _ptr(preds), _opt(phase_clocks))
        if path == "warp":
            rc = lib.fm_st_fit(*args, ctypes.c_void_p(stream))
        else:
            grid = lib.fm_st_cta_grid(int(order), int(n_changepoints), B)
            if grid < 1:
                raise RuntimeError("st_fit: the cta path's grid could not be sized")
            per = lib.fm_st_cta_scratch_doubles(int(order), int(n_changepoints))
            scratch = (torch.empty(grid * per, dtype=torch.float64, device=dev)
                       if per > 0 else None)
            rc = lib.fm_st_fit_cta(*args, _opt(scratch), grid, ctypes.c_void_p(stream))
    _raise_on(rc, "st_fit", lib)
    launches["st_fit"] += 1
    st_path_launches[path] += 1
    return beta, preds


def st_sincos_check(device="cuda") -> int:
    """The float32 arguments (of all 2^32 bit patterns) at which the card's
    sincosf differs in its bits from its sinf or cosf: kernel J takes both
    Fourier columns of a pair from one sincosf, which rounds as the twin's
    columns only while this is 0. Not a kernel of any path."""
    lib = build.library()
    out = torch.zeros(1, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        rc = lib.fm_st_sincos_check(_ptr(out),
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(rc, "st_sincos_check", lib)
    return int(out.item())


def ks_division_check(device="cuda") -> dict:
    """Every float32 a in [0, 512] against every integer d in [1, 512]:
    where the warp path's KS lattice division (a times the correctly
    rounded 1 / d, corrected once by the exact remainder) differs in its
    bits from IEEE a / d. `above`, the count at a >= 2^-100, must be 0 for
    the warp path's lattice to equal the CTA path's bit for bit (below it
    the lattice divides); `below` and `largest` (the largest such a) say
    where the shortcut fails. Not a kernel of any path; about 1 s on the
    card."""
    lib = build.library()
    out = torch.zeros(3, dtype=torch.int64, device=device)
    with torch.cuda.device(out.device):
        rc = lib.fm_ks_division_check(_ptr(out),
                                      ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    _raise_on(rc, "ks_division_check", lib)
    above, below, largest = out.tolist()
    return {"above": above, "below": below,
            "largest": float(np.array([largest], np.uint32).view(np.float32)[0])}


def lstm_ae(params, x, mask, hidden: int, latent: int, mu=None, sigma=None, phase_clocks=None):
    """Launch kernel K: the LSTM autoencoder's masked reconstruction error
    of K windows for each of J jobs. params is (J, P) float32 in the flat
    layout of models.lstm_ae.flat_params, x (J, K, W, F) float32, mask
    (J, K, W, F) bool. Returns err (J, K); with mu and sigma ((J,) float32)
    also z = (err - mu) / sigma, as (err, z).

    phase_clocks, an int64 (J, len(LSTM_AE_PHASES)) tensor of zeros,
    receives the SM cycles each job's CTAs spent in each phase of
    LSTM_AE_PHASES, summed over its CTAs."""
    J, K, W, F = x.shape
    dev = x.device
    H, Z = int(hidden), int(latent)
    if min(H, Z, F) < 1:
        raise ValueError(f"lstm_ae takes hidden, latent and features >= 1; got {H}, {Z}, {F}")
    if (mu is None) != (sigma is None):
        raise ValueError("lstm_ae takes mu and sigma together")
    named = [(x, "x", torch.float32, (J, K, W, F)), (mask, "mask", torch.bool, (J, K, W, F))]
    if mu is not None:
        named += [(mu, "mu", torch.float32, (J,)), (sigma, "sigma", torch.float32, (J,))]
    if phase_clocks is not None:
        named.append((phase_clocks, "phase_clocks", torch.int64, (J, len(LSTM_AE_PHASES))))
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
    path = lstm_ae_path(K, F, H, Z, W)
    KB = lstm_train_blocks(K, F, H, Z)[0]
    smem_params = int(lib.fm_lstm_ae_smem_bytes(F, H, Z, KB, 1) <= LSTM_SMEM_PARAMS_BYTES)
    NW = _lstm_ae_windows(path, K, W, F, H, Z)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_lstm_ae(_ptr(params), P, _ptr(x), _ptr(mask), _opt(mu), _opt(sigma), J, K,
                            W, F, H, Z, {"wide": 0, "warp": 1, "cluster": 2}[path], KB,
                            smem_params, NW, _ptr(err), _opt(z), _opt(phase_clocks),
                            ctypes.c_void_p(stream))
    _raise_on(rc, "lstm_ae", lib)
    launches["lstm_ae"] += 1
    lstm_ae_path_launches[path] += 1
    return err if z is None else (err, z)


def _align4(n: int) -> int:
    return (n + 3) & ~3


def lstm_ae_chunk_windows(J: int, K: int, NW: int) -> int:
    """Windows a chunk of kernel K's warp and cluster paths (a warp's or a
    cluster's share of a job): groups of NW windows, at most four a chunk,
    fewer where the jobs alone give fewer than 16,384 groups' worth of work
    (csrc/lstm_ae.cu: chunk_windows)."""
    groups = -(-int(K) // NW)
    per = min(max(-(-int(J) * groups // 16384), 1), 4)
    return min(per, groups) * NW


def lstm_ae_warp_smem_bytes(F: int, H: int, Z: int, NW: int, KW: int) -> int:
    """Shared memory of a CTA (four warps) of kernel K's warp path
    (csrc/lstm_ae.cu: warp_layout, with kWarpRegRows = 16)."""
    floats = (2 * F * 32 * 4 + (32 - 16) * 32 * 4 + 2 * 32 * NW + _align4(4 * F * NW)
              + _align4(Z * KW) + _align4(H * F) + _align4(F) + 4 * NW * F)
    return 4 * 4 * floats


def lstm_ae_cluster_smem_bytes(W: int, F: int, H: int, Z: int, NW: int, KW: int) -> int:
    """Shared memory of a CTA of kernel K's cluster path (csrc/lstm_ae.cu:
    cluster_layout)."""
    hs = ((H + 1) & ~1) * NW
    floats = (max(H - 64, 0) * 128 + 2 * F * 128 + _align4((W + 1) * hs) + _align4(W * 2 * F * NW)
              + 4 * NW * 32 + _align4(Z * KW) + _align4(W * NW * F) + 4 * NW * F)
    return 4 * floats


def _lstm_ae_windows(path: str, K: int, W: int, F: int, H: int, Z: int) -> int:
    """The windows a group (NW) of kernel K's path at this shape, or 0
    where the path does not serve it (the wide path: always, NW unused)."""
    if path == "wide":
        return 2
    if path == "warp" and H > 32 or path == "cluster" and not 32 < H <= CLUSTER_LSTM_HIDDEN:
        return 0
    for NW in ((4, 2) if K > 2 else (2,)):
        KW = min(-(-K // NW), 4) * NW  # the largest chunk the launch may take
        smem = (lstm_ae_warp_smem_bytes(F, H, Z, NW, KW) if path == "warp" else
                lstm_ae_cluster_smem_bytes(W, F, H, Z, NW, KW))
        if (path == "cluster" or NW * F <= 32) and smem <= LSTM_AE_SMEM_BYTES:
            return NW
    return 0


def lstm_ae_serves(path: str, K: int, F: int, H: int, Z: int, W: int = 32) -> bool:
    """Whether kernel K's `path` takes K windows of W steps a job at these
    widths."""
    if path not in LSTM_AE_PATHS:
        raise ValueError(f"kernel K has no path {path!r}; its paths are {LSTM_AE_PATHS}")
    return _lstm_ae_windows(path, int(K), int(W), int(F), int(H), int(Z)) > 0


def lstm_ae_path(K: int, F: int, H: int, Z: int, W: int = 32) -> str:
    """Which path kernel K takes for K windows of W steps a job at these
    widths: LSTM_AE_FORCE where set (it raises where that path does not
    serve), else the first of LSTM_AE_PATHS that serves."""
    if LSTM_AE_FORCE is not None:
        if not lstm_ae_serves(LSTM_AE_FORCE, K, F, H, Z, W):
            raise ValueError(f"lstm_ae: the {LSTM_AE_FORCE} path does not take K={K}, W={W}, "
                             f"F={F}, H={H}, Z={Z}")
        return LSTM_AE_FORCE
    return next(p for p in LSTM_AE_PATHS if lstm_ae_serves(p, K, F, H, Z, W))


def _lstm_window_bytes(F: int, H: int, Z: int) -> int:
    """Shared bytes of one window of kernel K's wide path and of kernel
    L's wide forward (csrc/lstm_ae.cu: lstm_window_floats)."""
    return 4 * (2 * F + 2 * H + 8 * H + Z + 4 * F)


def lstm_train_blocks(K: int, F: int, H: int, Z: int) -> tuple:
    """(KB, nkb): the windows a CTA of kernel K's wide path and of kernel
    L's wide forward runs and the window blocks of a job (nkb = ceil(K /
    KB)): at most 8, at most 256 // F while F <= 256, and as many as a
    CTA's shared memory holds (which binds only above the widths that the
    first design served, H or F past 256). ValueError where one window does
    not fit."""
    fit = (CTA_SMEM_BYTES - 8) // _lstm_window_bytes(int(F), int(H), int(Z))
    if fit < 1:
        raise ValueError(f"the LSTM kernels' wide paths hold a window's state in shared "
                         f"memory: F={F}, H={H}, Z={Z} takes {_lstm_window_bytes(F, H, Z)} B, "
                         f"more than a CTA's {CTA_SMEM_BYTES}")
    KB = max(1, min(int(K), 8, max(256 // max(int(F), 1), 1), fit))
    return KB, -(-int(K) // KB)


def lstm_train_forward_path(K: int, F: int, H: int, Z: int) -> str:
    """Which path kernel L's forward takes for K windows a job at these
    widths under LSTM_FORWARD_SMEM_BYTES: "tile" (a CTA for a job's
    windows) or "wide" (lstm_train_blocks' 8 windows a CTA)."""
    lib = build.library()
    KC = lib.fm_lstm_forward_tile_windows(int(K), int(F), int(H),
                                          lstm_train_blocks(K, F, H, Z)[0])
    fits = KC > 0 and lib.fm_lstm_forward_tile_smem_bytes(int(F), int(H), int(Z), KC) \
        <= LSTM_FORWARD_SMEM_BYTES
    return "tile" if fits else "wide"


def _lstm_train_check(params, x, mask, hidden: int, latent: int, what: str):
    J, K, W, F = x.shape
    dev = x.device
    H, Z = int(hidden), int(latent)
    if min(H, Z, F) < 1:
        raise ValueError(f"{what} takes hidden, latent and features >= 1; got {H}, {Z}, {F}")
    if W < 1 or K < 1:
        raise ValueError(f"{what} needs K >= 1 windows of W >= 1 steps")
    _check(x, "x", torch.float32, (J, K, W, F), dev)
    _check(mask, "mask", torch.bool, (J, K, W, F), dev)
    lib = build.library()
    P = lib.fm_lstm_ae_param_count(F, H, Z)
    _check(params, "params", torch.float32, (J, P), dev)
    return lib, J, K, W, F, H, Z, P, dev


def lstm_train_forward(params, x, mask, hidden: int, latent: int, phase_clocks=None):
    """Launch kernel L's forward entry on J jobs' (J, P) parameter rows and
    their windows x (J, K, W, F) float32, mask bool. Returns num and cnt
    (J, nkb) float64, each window block's sum of squared errors over the
    mask and its count of valid slots, and act (J, K, 2, W, 5H) float32, the
    activations the backward entries read.

    phase_clocks, an int64 (J, len(LSTM_FORWARD_PHASES)) tensor of zeros,
    receives the SM cycles each job's CTAs spent in each phase of
    LSTM_FORWARD_PHASES, summed over its CTAs."""
    lib, J, K, W, F, H, Z, P, dev = _lstm_train_check(params, x, mask, hidden, latent,
                                                      "lstm_train_forward")
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (J, len(LSTM_FORWARD_PHASES)), dev)
    KB, nkb = lstm_train_blocks(K, F, H, Z)
    num = torch.empty((J, nkb), dtype=torch.float64, device=dev)
    cnt = torch.empty((J, nkb), dtype=torch.float64, device=dev)
    act = torch.empty((J, K, 2, W, 5 * H), dtype=torch.float32, device=dev)
    if J == 0:
        return num, cnt, act
    smem_params = int(lib.fm_lstm_train_smem_bytes(F, H, Z, KB, 1) <= LSTM_SMEM_PARAMS_BYTES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_lstm_train_forward(_ptr(params), P, _ptr(x), _ptr(mask), J, K, W, F, H, Z,
                                       KB, smem_params, LSTM_FORWARD_SMEM_BYTES, _ptr(act),
                                       _ptr(num), _ptr(cnt), _opt(phase_clocks),
                                       ctypes.c_void_p(stream))
    _raise_on(rc, "lstm_train_forward", lib)
    launches["lstm_train_forward"] += 1
    return num, cnt, act


def lstm_bptt_blocks(K: int, H: int) -> tuple:
    """(KR, nkr): the windows a CTA of kernel L's recurrence entry runs on
    its group path (groups of 32 ceil(H / 32) threads, each over a few
    windows side by side, at most 256 threads a CTA) and the window blocks
    of a job (nkr = ceil(K / KR))."""
    KR = build.library().fm_lstm_bptt_windows(int(K), int(H))
    return KR, -(-int(K) // KR)


def lstm_bptt_path(F: int, H: int) -> str:
    """Kernel L's recurrence path: "group" for H <= GROUP_BPTT_H and F <=
    GROUP_BPTT_F, else "wide" (a CTA a window)."""
    return "group" if H <= GROUP_BPTT_H and F <= GROUP_BPTT_F else "wide"


def lstm_train_recurrence(params, x, mask, act, hidden: int, latent: int, path=None):
    """Launch kernel L's recurrence entry: backpropagation through time of
    each window's squared error from the forward's activations act (J, K, 2,
    W, 5H), which it overwrites in place, each step's slot with the gates'
    pre-activation gradient and the previous h (da_t, h_{t-1}). Returns the
    per-window record (J, K, S) float32 that lstm_train_wgrad reads (the
    latent, its gradient, the decoder's sum of da, Dense_1's gradient
    summed over the window's steps, the encoder's input as floats). The
    path is lstm_bptt_path(F, H)'s; path= forces one of BPTT_PATHS
    (ValueError where the group path does not serve)."""
    lib, J, K, W, F, H, Z, P, dev = _lstm_train_check(params, x, mask, hidden, latent,
                                                      "lstm_train_recurrence")
    if path is None:
        path = lstm_bptt_path(F, H)
    elif path not in BPTT_PATHS:
        raise ValueError(f"kernel L's recurrence has no path {path!r}; its paths are "
                         f"{BPTT_PATHS}")
    elif path == "group" and lstm_bptt_path(F, H) != "group":
        raise ValueError(f"the recurrence's group path takes H <= GROUP_BPTT_H = "
                         f"{GROUP_BPTT_H} and F <= GROUP_BPTT_F = {GROUP_BPTT_F}; got H={H}, "
                         f"F={F}")
    if path == "wide" and lib.fm_lstm_bptt_wide_smem_bytes(F, H, Z) > CTA_SMEM_BYTES:
        raise ValueError(f"the recurrence's wide path holds a window's state in shared "
                         f"memory: F={F}, H={H}, Z={Z} does not fit a CTA")
    _check(act, "act", torch.float32, (J, K, 2, W, 5 * H), dev)
    rec = torch.empty((J, K, lib.fm_lstm_rec_floats(F, H, Z, W)), dtype=torch.float32,
                      device=dev)
    if J == 0:
        return rec
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "group":
            rc = lib.fm_lstm_bptt(_ptr(params), P, _ptr(x), _ptr(mask), J, K, W, F, H, Z,
                                  LSTM_TRAIN_SMEM_BYTES, _ptr(act), _ptr(rec),
                                  ctypes.c_void_p(stream))
        else:
            rc = lib.fm_lstm_bptt_wide(_ptr(params), P, _ptr(x), _ptr(mask), J, K, W, F, H, Z,
                                       _ptr(act), _ptr(rec), ctypes.c_void_p(stream))
    _raise_on(rc, "lstm_train_recurrence", lib)
    launches["lstm_train_recurrence"] += 1
    bptt_path_launches[path] += 1
    return rec


def lstm_train_wgrad(params, x, mask, act, rec, hidden: int, latent: int):
    """Launch kernel L's weight-gradient entry on the recurrence's rewritten
    act and its records rec: the gradient of each job's sum of squared
    errors in its parameters, one row a job, gpart (J, 1, P) float32
    (kernel M scales it)."""
    lib, J, K, W, F, H, Z, P, dev = _lstm_train_check(params, x, mask, hidden, latent,
                                                      "lstm_train_wgrad")
    _check(act, "act", torch.float32, (J, K, 2, W, 5 * H), dev)
    _check(rec, "rec", torch.float32, (J, K, lib.fm_lstm_rec_floats(F, H, Z, W)), dev)
    gpart = torch.empty((J, 1, P), dtype=torch.float32, device=dev)
    if J == 0:
        return gpart
    vec = int(H % 4 == 0 and act.data_ptr() % 16 == 0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_lstm_wgrad(_ptr(act), _ptr(rec), _ptr(gpart), P, J, K, W, F, H, Z, vec,
                               ctypes.c_void_p(stream))
    _raise_on(rc, "lstm_train_wgrad", lib)
    launches["lstm_train_wgrad"] += 1
    return gpart


def lstm_train_backward(params, x, mask, act, hidden: int, latent: int):
    """Kernel L's backward: the recurrence entry (which overwrites act),
    then the weight-gradient entry. Returns gpart (J, 1, P) float32, the
    gradient of each job's sum of squared errors (kernel M scales it)."""
    rec = lstm_train_recurrence(params, x, mask, act, hidden, latent)
    return lstm_train_wgrad(params, x, mask, act, rec, hidden, latent)


def adam(params, mu, nu, step, gpart, num, cnt, lr: float, b1: float, b2: float, eps: float):
    """Launch kernel M: the gradient of each job from kernel L's gradient
    blocks (gpart (J, NG, P), summed in block order, times 1 / max(sum cnt,
    1)), then optax's Adam on params, mu, nu (J, P) float32 in place, at each
    job's step (J,) int32 (after the increment). Returns each job's loss
    (J,) float32 from num and cnt (J, NC) float64, the forward's window
    blocks."""
    J, P = params.shape
    dev = params.device
    NG = gpart.shape[1] if gpart.dim() == 3 else -1
    NC = num.shape[1] if num.dim() == 2 else -1
    for t, name, dt, shape in (
            (params, "params", torch.float32, (J, P)), (mu, "mu", torch.float32, (J, P)),
            (nu, "nu", torch.float32, (J, P)), (step, "step", torch.int32, (J,)),
            (gpart, "gpart", torch.float32, (J, NG, P)), (num, "num", torch.float64, (J, NC)),
            (cnt, "cnt", torch.float64, (J, NC))):
        _check(t, name, dt, shape, dev)
    if NG < 1 or NC < 1:
        raise ValueError("adam needs at least one gradient block and one count block")
    loss = torch.empty(J, dtype=torch.float32, device=dev)
    if J == 0:
        return loss
    lib = build.library()
    vec = int(P % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (params, mu, nu, gpart)))
    f32 = np.float32
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_adam(_ptr(params), _ptr(mu), _ptr(nu), _ptr(step), _ptr(gpart), _ptr(num),
                         _ptr(cnt), _ptr(loss), P, J, NG, NC, vec, float(f32(lr)),
                         float(f32(b1)), float(f32(b2)), float(f32(1 - b1)), float(f32(1 - b2)),
                         float(f32(eps)), ctypes.c_void_p(stream))
    _raise_on(rc, "adam", lib)
    launches["adam"] += 1
    return loss


def pair_tests(x, x_mask, y, y_mask, tests: int, *, wilcoxon_table, ks_exact_max: int,
               wilcoxon_exact_max_n: int, phase_clocks=None, path=None):
    """Launch kernel N on B window pairs ((B, T) float32 values, bool
    masks): the tests whose bits (PAIR_TEST_BITS) are set in `tests`.
    Returns stat and p, (B, 5) float32 in PAIR_TEST_BITS' order: U1, H, W,
    D and the sign test's untied count (0 and p = 1 for a test not
    asked). The sign test counts the slots where both masks hold.

    path forces one of PAIR_PATHS (ValueError where it does not serve T).
    phase_clocks, an int64 (B, len(TESTS_PHASES) + 1) tensor, receives each
    pair's SM clock at the start and after each phase of TESTS_PHASES; the
    warp path alone has the stamps.
    """
    B, T = x.shape
    dev = x.device
    _check_pair_t(T, "pair_tests")
    if not 0 < tests < 1 << len(PAIR_TEST_BITS):
        raise ValueError(f"pair_tests takes a mask of PAIR_TEST_BITS, got {tests}")
    path = _pair_launch_path(T, path, "pair_tests")
    if phase_clocks is not None and path != "warp":
        raise ValueError(f"pair_tests' phase stamps are on its warp path (T <= {WARP_PAIR_T}); "
                         f"this launch takes the {path} path")
    W = wilcoxon_exact_max_n * (wilcoxon_exact_max_n + 1) // 2 + 1
    for t, name, dt, shape in (
            (x, "x", torch.float32, (B, T)), (x_mask, "x_mask", torch.bool, (B, T)),
            (y, "y", torch.float32, (B, T)), (y_mask, "y_mask", torch.bool, (B, T)),
            (wilcoxon_table, "wilcoxon_table", torch.float32, (wilcoxon_exact_max_n, W))):
        _check(t, name, dt, shape, dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(TESTS_PHASES) + 1), dev)
    stat = torch.empty((B, len(PAIR_TEST_BITS)), dtype=torch.float32, device=dev)
    p = torch.empty((B, len(PAIR_TEST_BITS)), dtype=torch.float32, device=dev)
    if B == 0:
        return stat, p
    lib = build.library()
    scratch, stride, grid = None, 0, B
    if path == "scratch":
        stride = lib.fm_pair_tests_scratch_stride(T)
        grid = max(1, min(B, SCRATCH_BYTES // stride))
        scratch = torch.empty(grid * stride, dtype=torch.uint8, device=dev)
    args = (_ptr(x), _ptr(x_mask), _ptr(y), _ptr(y_mask), B, T, int(tests),
            _ptr(wilcoxon_table), wilcoxon_exact_max_n, ks_exact_max, _ptr(stat), _ptr(p))
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if path == "warp":
            rc = lib.fm_pair_tests_warp(*args, _opt(phase_clocks), _ptr(_lgamma_table(lib, dev)),
                                        pair_warp_grid(B), stream)
        else:
            rc = lib.fm_pair_tests(*args, _opt(scratch), stride, grid, stream)
    _raise_on(rc, "pair_tests", lib)
    launches["pair_tests"] += 1
    pair_tests_path_launches[path] += 1
    return stat, p


# kernel O's sorting entries: each path's limit on a row's keys
_KEY_LIMITS = {"warp": "WARP_RANK_KEYS", "cta": "SHARED_RANK_KEYS", "scratch": "MAX_RANK_KEYS"}


def _keys_path(n: int) -> str:
    if n <= WARP_RANK_KEYS:
        return "warp"
    return "cta" if n <= SHARED_RANK_KEYS else "scratch"


def _keys_serve(path: str, n: int) -> bool:
    return n <= globals()[_KEY_LIMITS[path]]


def _check_keys(what: str, path, n: int, of: str) -> None:
    """Refuse a row of more than MAX_RANK_KEYS keys (its key's 30-bit tag),
    and a forced path that does not serve n keys (naming its limit)."""
    if n > MAX_RANK_KEYS:
        raise ValueError(f"{what} sorts at most MAX_RANK_KEYS = {MAX_RANK_KEYS} keys a row, "
                         f"what its key's 30-bit position or group tag holds; got {n}")
    if path is None:
        return
    if path not in KRUSKAL_PATHS:
        raise ValueError(f"{what} has the paths {KRUSKAL_PATHS}; got {path!r}")
    if not _keys_serve(path, n):
        limit = _KEY_LIMITS[path]
        raise ValueError(f"{what}' {path} path serves {of} <= {limit} = {globals()[limit]}; "
                         f"got {of} = {n}")


def _rank_scratch(lib, path: str, B: int, n: int, dev):
    """(scratch, stride, grid) of kernel O's CTA entries: on the scratch path
    one device slot a CTA, as many CTAs as SCRATCH_BYTES holds (B at most)."""
    if path != "scratch":
        return None, 0, B
    stride = lib.fm_rank_work_bytes(n)
    grid = max(1, min(B, SCRATCH_BYTES // stride))
    return torch.empty(grid * stride, dtype=torch.uint8, device=dev), stride, grid


def rank_path(T: int) -> str:
    """rank_and_ties' path for rows of T slots."""
    return _keys_path(T)


def rank_serves(path: str, T: int) -> bool:
    """Whether a rank_and_ties path serves rows of T slots."""
    return _keys_serve(path, T)


def rank_and_ties(values, mask, phase_clocks=None, path=None):
    """Launch kernel O's rank entry on B rows ((B, T) float32, bool mask).
    Returns ranks (B, T) float32 in input order (0 at masked slots), the
    tie term and the valid count, (B,) float32 each.

    phase_clocks, an int64 (B, len(RANK_PHASES) + 1) tensor, receives each
    row's SM clock at its start and after each phase of RANK_PHASES (the
    warp path's stamps; ValueError on the others). path forces one of
    RANK_PATHS (ValueError where it does not serve T).
    """
    B, T = values.shape
    _check_keys("rank_and_ties", path, T, "T")
    path = path or rank_path(T)
    if phase_clocks is not None and path != "warp":
        raise ValueError(f"rank_and_ties stamps its warp path alone; got the {path} path")
    dev = values.device
    _check(values, "values", torch.float32, (B, T), dev)
    _check(mask, "mask", torch.bool, (B, T), dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(RANK_PHASES) + 1), dev)
    ranks = torch.empty((B, T), dtype=torch.float32, device=dev)
    tie = torch.empty(B, dtype=torch.float32, device=dev)
    n = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0 or T == 0:
        return ranks, tie.zero_(), n.zero_()
    lib = build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if path == "warp":
            rc = lib.fm_rank_and_ties_warp(_ptr(values), _ptr(mask), B, T, _ptr(ranks),
                                           _ptr(tie), _ptr(n), _opt(phase_clocks),
                                           kruskal_warp_grid(B), stream)
        else:
            scratch, stride, grid = _rank_scratch(lib, path, B, T, dev)
            rc = lib.fm_rank_and_ties(_ptr(values), _ptr(mask), B, T, _ptr(ranks), _ptr(tie),
                                      _ptr(n), _opt(scratch), stride, grid, stream)
    _raise_on(rc, "rank_and_ties", lib)
    launches["rank_and_ties"] += 1
    rank_path_launches[path] += 1
    return ranks, tie, n


def kruskal_path(k: int, T: int) -> str:
    """kruskal_groups' path for rows of k groups of T slots."""
    return _keys_path(k * T)


def kruskal_serves(path: str, k: int, T: int) -> bool:
    """Whether a kruskal_groups path serves rows of k groups of T slots."""
    return _keys_serve(path, k * T)


def kruskal_warp_grid(B: int) -> int:
    """CTAs of kernel O's warp paths for B rows: a warp a row, KRUSKAL_WARPS
    a CTA."""
    return -(-B // KRUSKAL_WARPS)


def kruskal_groups(groups, masks, phase_clocks=None, path=None):
    """Launch kernel O's Kruskal-Wallis entry on B sets of k masked groups
    ((B, k, T) float32, bool masks). Returns H and p, (B,) float32.

    phase_clocks, an int64 (B, len(KRUSKAL_PHASES) + 1) tensor, receives
    each row's SM clock at its start and after each phase of KRUSKAL_PHASES.
    path forces one of KRUSKAL_PATHS (ValueError where it does not serve k T).
    """
    B, k, T = groups.shape
    _check_keys("kruskal_groups", path, k * T, "k T")
    dev = groups.device
    _check(groups, "groups", torch.float32, (B, k, T), dev)
    _check(masks, "masks", torch.bool, (B, k, T), dev)
    if phase_clocks is not None:
        _check(phase_clocks, "phase_clocks", torch.int64, (B, len(KRUSKAL_PHASES) + 1), dev)
    H = torch.empty(B, dtype=torch.float32, device=dev)
    p = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return H, p
    if k * T == 0:
        return H.zero_(), p.fill_(1.0)
    path = path or kruskal_path(k, T)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        if path == "warp":
            rc = lib.fm_kruskal_groups_warp(_ptr(groups), _ptr(masks), B, k, T, _ptr(H), _ptr(p),
                                            _opt(phase_clocks), kruskal_warp_grid(B), stream)
        else:
            scratch, stride, grid = _rank_scratch(lib, path, B, k * T, dev)
            rc = lib.fm_kruskal_groups(_ptr(groups), _ptr(masks), B, k, T, _ptr(H), _ptr(p),
                                       _opt(phase_clocks), _opt(scratch), stride, grid, stream)
    _raise_on(rc, "kruskal_groups", lib)
    launches["kruskal_groups"] += 1
    kruskal_path_launches[path] += 1
    return H, p


def friedman_path(n: int, k: int) -> str:
    """friedman's path for tables of n blocks x k treatments."""
    return "warp" if friedman_serves("warp", n, k) else "cta"


def friedman_serves(path: str, n: int, k: int) -> bool:
    """Whether a friedman path serves tables of n blocks x k treatments."""
    return path == "cta" or (path == "warp" and 1 <= k <= WARP_FRIEDMAN_K
                             and 1 <= n <= WARP_FRIEDMAN_N)


def friedman(data, block_mask, path=None):
    """Launch kernel O's Friedman entry on B tables of n blocks x k
    treatments ((B, n, k) float32, block_mask (B, n) bool). Returns chi2
    and p, (B,) float32. path forces one of FRIEDMAN_PATHS (ValueError
    where it does not serve the shape)."""
    B, n, k = data.shape
    if path is not None and path not in FRIEDMAN_PATHS:
        raise ValueError(f"friedman has the paths {FRIEDMAN_PATHS}; got {path!r}")
    if path is not None and not friedman_serves(path, n, k):
        raise ValueError(f"friedman's {path} path serves 1 <= k <= WARP_FRIEDMAN_K = "
                         f"{WARP_FRIEDMAN_K} and 1 <= n <= WARP_FRIEDMAN_N = {WARP_FRIEDMAN_N}; "
                         f"got n = {n}, k = {k}")
    dev = data.device
    _check(data, "data", torch.float32, (B, n, k), dev)
    _check(block_mask, "block_mask", torch.bool, (B, n), dev)
    chi2 = torch.empty(B, dtype=torch.float32, device=dev)
    p = torch.empty(B, dtype=torch.float32, device=dev)
    if B == 0:
        return chi2, p
    path = path or friedman_path(n, k)
    lib = build.library()
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        entry = lib.fm_friedman_warp if path == "warp" else lib.fm_friedman
        rc = entry(_ptr(data), _ptr(block_mask), B, n, k, _ptr(chi2), _ptr(p), stream)
    _raise_on(rc, "friedman", lib)
    launches["friedman"] += 1
    friedman_path_launches[path] += 1
    return chi2, p


def fleet_topk_path(n: int, k: int) -> str:
    """fleet_topk's path for the min(k, n) largest of n rows."""
    return "select" if min(k, n) <= FLEET_SELECT_K else "chunked"


def fleet_topk_serves(path: str, n: int, k: int) -> bool:
    """Whether a fleet_topk path serves the min(k, n) largest of n rows."""
    return path == "chunked" or (path == "select" and min(k, n) <= FLEET_SELECT_K)


def fleet_topk(values, k: int, valid=None, base: int = 0, path=None):
    """Launch kernel P on n rows' (n,) float32 values: the min(k, n) largest
    in lax.top_k's order (IEEE total order descending, lower index first),
    a row's value taken as -inf where `valid` ((n,) bool) is False, row i
    keyed by the index base + i. Returns count (a 0-d int64 tensor, the
    valid rows; None without `valid`), top_v (min(k, n),) float32 and top_i
    (min(k, n),) int64. Up to MAX_FLEET_SLICE rows keyed below
    MAX_FLEET_ROWS it is one launch; past either it runs fleet_topk_slices
    over slices of MAX_FLEET_SLICE rows (k up to half of that). path forces
    one of FLEET_TOPK_PATHS for every launch (ValueError where it does not
    serve min(k, n))."""
    n = values.shape[0] if values.dim() == 1 else -1
    if base < 0:
        raise ValueError(f"fleet_topk keys rows from base >= 0; got base {base}")
    if k < 0:
        raise ValueError(f"fleet_topk takes k >= 0, got {k}")
    if path is not None and path not in FLEET_TOPK_PATHS:
        raise ValueError(f"fleet_topk has the paths {FLEET_TOPK_PATHS}; got {path!r}")
    if path is not None and not fleet_topk_serves(path, n, k):
        raise ValueError(f"fleet_topk's {path} path serves min(k, n) <= FLEET_SELECT_K = "
                         f"{FLEET_SELECT_K}; got {min(k, n)}")
    if n <= MAX_FLEET_SLICE and base + n - 1 <= MAX_FLEET_ROWS:
        return _fleet_topk_launch(values, k, valid, base, path)
    return fleet_topk_slices(values, k, valid, base, MAX_FLEET_SLICE,
                             lambda v, kk, ok: _fleet_topk_launch(v, kk, ok, 0, path))


def fleet_topk_slices(values, k: int, valid, base: int, slice_rows: int, topk):
    """Kernel P's split and merge past one launch, on any `topk(values, k,
    valid)` that keys rows from 0 and returns (count, top_v, top_i) as
    fleet_topk does (kernel P, or its twin in tests): the n rows in slices
    of at most slice_rows, each through topk; the slices' candidates
    concatenated in slice order and through topk again (keyed by position;
    again in slices while they outnumber slice_rows), each position mapped
    back to its slice's offset plus its index there, plus base, in int64;
    the slices' counts summed in int64. A slice's candidates precede a later
    slice's, so among equal values the lower index still comes first, as in
    fleet_summary's merge of ranks' candidates. Past one slice k is at most
    slice_rows / 2, so that each merge at least halves the rows."""
    n = values.shape[0]
    if n <= slice_rows:
        count, top_v, top_i = topk(values, k, valid)
        return count, top_v, top_i + base
    if 2 * k > slice_rows:
        raise ValueError(f"fleet_topk merges slices of {slice_rows} rows: past one slice it "
                         f"takes k <= {slice_rows // 2}; got k = {k}")
    counts, cand_v, cand_i = [], [], []
    for s in range(0, n, slice_rows):
        e = min(n, s + slice_rows)
        count, top_v, top_i = topk(values[s:e], k, None if valid is None else valid[s:e])
        counts.append(count)
        cand_v.append(top_v)
        cand_i.append(top_i + s)
    count = None if valid is None else torch.stack(counts).sum(dtype=torch.int64)
    cand_v, cand_i = torch.cat(cand_v), torch.cat(cand_i)
    _, top_v, pos = fleet_topk_slices(cand_v, k, None, 0, slice_rows, topk)
    return count, top_v, cand_i[pos] + base


def _fleet_topk_launch(values, k: int, valid, base: int, path):
    """One launch of kernel P: n <= MAX_FLEET_SLICE, base + n - 1 <=
    MAX_FLEET_ROWS."""
    n = values.shape[0] if values.dim() == 1 else -1
    dev = values.device
    _check(values, "values", torch.float32, (n,), dev)
    if valid is not None:
        _check(valid, "valid", torch.bool, (n,), dev)
    kk = min(int(k), n)
    top_v = torch.empty(kk, dtype=torch.float32, device=dev)
    top_i = torch.empty(kk, dtype=torch.int64, device=dev)
    if n == 0:
        count = None if valid is None else torch.zeros((), dtype=torch.int64, device=dev)
        return count, top_v, top_i
    # both paths write the count (a sum, not an accumulation)
    count = None if valid is None else torch.empty((), dtype=torch.int64, device=dev)
    if kk == 0 and valid is None:
        return count, top_v, top_i
    path = path or fleet_topk_path(n, k)
    lib = build.library()
    scratch = torch.empty(lib.fm_fleet_topk_scratch_bytes(n, max(kk, 1)), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
        entry = lib.fm_fleet_topk_select if path == "select" else lib.fm_fleet_topk
        rc = entry(_ptr(values), _opt(valid), int(base), n, kk, _ptr(top_v), _ptr(top_i),
                   _opt(count), _ptr(scratch), stream)
    _raise_on(rc, "fleet_topk", lib)
    launches["fleet_topk"] += 1
    fleet_topk_path_launches[path] += 1
    return count, top_v, top_i


def empty_launches(count: int, device) -> None:
    """Launch `count` empty one-warp kernels on `device`'s current stream:
    the launch floor a short kernel's time is read against (not counted in
    `launches`)."""
    lib = build.library()
    with torch.cuda.device(device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
        rc = lib.fm_empty_launches(int(count), stream)
    _raise_on(rc, "empty_launches", lib)
