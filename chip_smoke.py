#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (foremast_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
nvcc and PyTorch built for CUDA. It imports nothing of JAX or of the JAX
package. Phases, each printed as it starts with its wall time when it
ends; any failure exits non-zero:

  1. build   compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
             and load the library;
  2. device  the card's name and power limit, from nvidia-smi;
  3. kernels each kernel against its plain PyTorch twin on the card, on
             adversarial rows (ties, +-0, NaN, +inf, masked and all-masked
             slots, both KS and both Wilcoxon regimes): kernel A at
             T in {16, 128, 1024, 4096, 8192, 16384} (a warp a pair up to
             256, the last two from device scratch), and forced onto each
             of its paths (warp, cta, scratch) at T in {16, 128, 256}, the
             warp and scratch paths' outputs equal to the cta path's bit for
             bit, after kernels.ks_division_check (the warp path's lattice
             division equal to IEEE division on every float32 in [2^-100,
             512] and divisor 1-512); kernel B at T in {128, 1024, 5000,
             8192, 16384} (its staged and long paths' outputs equal to the
             unstaged path's bit for bit where they serve T); kernels
             C (SES, DES, Holt-Winters on each of its paths, shared and
             device, held equal bit for bit, at the rows' periods and cut to
             1440), D, E (SES, DES), F and B's
             band_from_preds at T in {128, 1024, 4096, 16384} on rows that
             are all-masked, single-point, constant, with leading or
             trailing gaps, with a period >= T/2 or below 4; kernel G at
             T in {128, 1000, 1024, 4096, 16384} on rows that are all-masked,
             single-point, constant, +-0, with NaN in a valid slot, with an
             empty region, quantized or shifted; kernels H and I at
             T in {128, 1024, 2048, 16384}, the optional arguments given and
             left out (H on each of its paths, cta and cluster, forced, also
             at T in {4096, 4112, 4100} across its path boundary): H on
             constant, perfectly correlated, one-point, empty-region,
             broken, shifted, all-masked rows, every bound-mode pair and
             points planted on the ellipse's edge (bracketed); I on
             every sla_mode x sla_absolute pair, steady, surging, collapsing
             and violating rows, the SLA at exactly `safe` and at the limit,
             base at exactly 50, a third of the region out of band, an empty
             region and one history point, with sigma given and computed;
             kernel J at T in {128, 2048, 16384}, without and with the
             engine's 12 hinges, on rows with no, one or a constant history,
             a kink, a long gap, history shorter than one period, NaN / inf
             at masked slots and periods from the candidates, the fallback
             and 2; kernel K at (F, H, Z) in {(3, 32, 16), (4, 32, 16),
             (8, 32, 16), (4, 128, 64)}, W = 32, on windows with gaps, fully
             masked and with a masked head; kernel L (loss and gradient)
             against torch autograd through the twin at the same widths,
             (2, 10, 6) and H = Z = 256, W in {8, 32}, on windows with gaps, fully masked,
             with a masked head and NaN at a masked slot, its backward twice
             and equal bit for bit; kernel M against the written-out Adam
             bit for bit on L's gradient rows; kernel F also with 40
             candidates at T in {1024, 16384}; kernel N (all four tests in
             one launch, and each alone) against two_sample_tests at T from
             8 to 16384 (device scratch above 4096) on kernel A's
             adversarial rows plus one-point and all-tied rows; kernel O's
             ranks at T in {8, 100, 256, 512, 513, 4096, 16384} (each path
             that serves T forced, equal bit for bit), Kruskal-Wallis at k in
             {2, 3, 5} (k T = 49,152 in scratch; each path that serves a
             shape forced, the warp path equal to the cta path bit for bit)
             and Friedman at (n, k) in
             {(128, 3), (20, 6), (7, 200)} on ties, +-0, NaN, +inf,
             all-masked, one-point and all-tied rows and masked blocks;
             kernel P against its twin bit for bit at n in {5, 4096,
             100,000}, k in {1, 8, 64, 3000, n + 5}, with ties, +-NaN, +-0
             and +-inf; kernel E's DES on both of its paths at T in {128,
             1000, 4096, 16383, 16384} on 1,000 rows (the walk forced equal
             to the twin bit for bit, the scan forced within
             compare_scan's limit; all-masked rows, masked prefixes, NaN and
             inf at masked slots, alpha and beta at 0 and 1), and on P4's
             16 draws of 1,024 rows at T = 16384 (the walk, taken by
             default there, the twin's bits; the scan within half of the
             limit); past the first designs' limits: kernels A and N at
             T = 43,200 (a 30-day window at 60 s) on 1,024 pairs, kernel O's
             Kruskal-Wallis and ranks at 8 groups of 172,800 (1,382,400
             keys a row), a fully tied row of 2^21 + 1 keys (the tie term
             equal to the float32 of the exact integer) and one row of 2^24
             keys (timed), kernel P on 2^30 + 7 rows keyed from 3 x 2^30
             (two launches and a merge; the twin in slices of 2^26), each
             against its twin;
  4. pairs   the pair path at full size: 100,000 ErrorGenerator-style
             (baseline, canary) pairs at T = 128 through resample_to_grid ->
             pack_windows -> score_pairs on the card (kernel A's warp path,
             which its path counter shows); every bad canary flagged,
             healthy false positives under 1%;
 4b. tests   the public test battery at the same width on those windows:
             all_pairwise_tests and each *_batch (kernel N), kruskal_batch
             at k = 3 (baseline, current, the previous row's current),
             friedman_batch over 128 blocks x those 3 windows and
             rank_and_ties at T = 256 (kernel O); every bad canary rejected
             at 0.01 by Mann-Whitney, Kruskal-Wallis and KS, each kernel
             against its twin on 2,048 rows, times beside the twins, kernel
             N's four launches on its warp path and kernel O's Kruskal and
             rank launches on their warp paths (their path counters), each of N's
             timed alone; then kernel N forced onto each of its paths at
             T in {16, 128, 256}, stat and p of every test mask on the warp
             and scratch paths equal to the cta path's bit for bit;
 4c. fleet   make_fleet_scorer at B = 100,000, T = 128, k = 8 in a world of
             one process over NCCL (kernel A on its warp path, then kernel
             P, all_gathers
             of the counts and candidates, kernel P again): per-pair
             outputs equal to score_pairs', total and top-k equal to kernel
             P's twin, the tie order and the -inf tail on built batches,
             fleet_summary alone;
             the scorer's wall time, canary_pairs_scored_per_sec_per_chip
             and the reduction's time beside the scoring's; a hung
             collective ends the run after 300 s;
  5. bands   the band path at full size: 100,000 rows of 512 history + 128
             current slots (bucket 1024), 10% with a level shift;
             moving_average_band on the card (kernel B's ma_band on its
             staged path, its path counter; every output equal to the
             unstaged path's bit for bit); recall 1.0, false positives
             under 1%;
  6. seasonal the seasonal band path at full size: 100,000 rows of 7 days
             of history at 60 s (10,080 points) + 60 current points in
             bucket 16384, made on the card (40% daily cycle, 30% 8-hour
             shift cycle, 30% aperiodic with a trend, 5% lost scrapes, a
             +8 sigma level shift in 10% of the current windows), through
             forecast_band under moving_average_all (kernel B's ma_band on
             its long path, its path counter; every output equal to the
             unstaged path's bit for bit on every row; timed alone beside
             its bound and twin), holt_winters, exponential_smoothing,
             double_exponential and seasonal_trend (kernels F, J, B); recall,
             false positives, planted-period recovery, times and launches per
             algorithm; then each of its kernels alone and its twin on the
             same inputs (kernel C's Holt-Winters refit with each row's
             fitted parameters and period on the path it took, equal bit
             for bit to the other path), and beside kernel J a Cholesky
             solve of the same systems; then seqscan.des_predictions_assoc
             on the same rows (kernel E's DES on its walk path, its path
             counter; the twin's bits on 2,048 rows), timed beside its
             bound, the scan path forced on the same rows and on one row,
             and the twin.
  7. families the bivariate and hpa families at full size: 100,000 rows
             made on the card at bucket 2048 (1 day of 60 s history) and
             16384 (7 days). Kernel H through bivariate_normal_anomalies on
             correlated latency / cpu pairs, 10% with a correlation break
             inside both metrics' own bands and 5% with a joint shift: recall
             1.0 on both, healthy rows flagged under 1% by the engine's
             gate. The HPA launch (kernel C's SES, then kernel I's
             hpa_from_preds) on steady, surging, collapsing and
             SLA-violating rows: each class on its side of 50 on 99% of its
             rows. Each kernel's time, bound and twin's time.
  8. lstm    kernel K through the LSTM autoencoder's scoring entry
             points: the reference-trained fixture (tests/data/lstm_ae_ref.npz)
             against the reference's recorded z; the scoring pass of 100,000
             jobs (the fixture's parameters, 4.87 GB) x 2 windows of 32 steps
             x 4 metrics through anomaly_scores_fleet; the normalizer pass of
             10,000 jobs x 45 windows (a day); the module's default width,
             H = 128, Z = 64, on 10,000 jobs of seeded parameters (7.1 GB).
             Then training (kernels L and M): train_fleet from the
             reference's fixture (tests/data/lstm_ae_train_ref.npz) against
             its initial row, per-epoch losses, stop epoch, mu, sigma and z;
             train_fleet over 1,024 jobs (MAX_CACHE_SIZE) x a day of 45
             windows at the engine's width, with one epoch's L forward, L
             backward (its recurrence and weight-gradient entries apart, the
             latter against its twin, two runs equal bit for bit) and M
             timed alone beside their bounds, their twins and, beside M,
             torch.optim.Adam(fused=True); for the record cuDNN's
             torch.nn.LSTM over the same recurrences.
  9. engine  the engine cycle at fleet size: 11,500 jobs (6,000 canaries
             with a 128-step baseline and current window of http_errors_5xx,
             4,000 continuous latency monitors with 1 day of history and 60
             current steps, 1,000 two-metric monitors, 10% of them with a
             correlation break, and 500 hpa jobs of four classes, 20% with a
             podCountURL) as Prometheus query_range bodies made from the
             seed, through the port's Analyzer on the card under the default
             EngineConfig for two cycles (the second on windows advanced by
             one step): claim, fetch and parse, pack, the triage screen
             (kernel G), the pair family (kernel A), the band family (kernel
             B), the bivariate family (kernel H), the hpa family (kernels C
             and I), fold. Every bad canary, shifted monitor and broken pair
             ends unhealthy, healthy jobs are flagged under 1%, no job fails
             scoring, every hpa job writes one hpalog and one hpa_score
             sample a cycle with its raw score on its class's side of 50 and
             its gated score as the breath rules, kernels A, B, G, H, C and I
             launch in each cycle and the screen clears rows, the second
             cycle builds nothing, and the same fleet with triage off (and
             again under torch.profiler, which gives the card's idle share by
             host stage) ends with the same verdict digest. Then one cycle
             under ML_ALGORITHM=seasonal_trend (kernels F, J, B in the band
             family): every shifted monitor unhealthy, healthy ones flagged
             under 1%, kernel J against its twin on the engine's rows. Then
             the arm engine_lstm: 575 continuous three-metric jobs over 32
             apps (10% with a joint anomaly) under the default EngineConfig,
             on the card and with device="cpu", cycles until one trains no
             model: no job fails scoring, every job judged, kernels L, M and
             K launch, verdicts equal to the twins' but within 0.01 of the
             threshold in z.

Kernel G (the triage screen) is held against its twin in phase 3, beside
kernel B's ma_band there, on the 100,000 rows of phases 5 and 6 and at the
engine's shape in phase 9 (sigma equal to B's bit for bit on every row, equal
counts but at band edges, shrunk count >= count), and timed alone at the
engine's shape.

Each path (the tests battery, the fleet scorer, each algorithm of the
seasonal phase, each family call, the LSTM scoring and training passes, each
engine cycle) resets
the launch counters just before it runs and reads them just after: a kernel
of the path that did not launch fails the run. The second-to-last line is a JSON object with each
kernel's launches, error against its twin, times on the card and bound; the
last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261017
DEV = "cuda"
P_ATOL = 1e-5  # kernel vs twin p-values: float32 math-library rounding
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# H100 SXM, outside the tensor cores: 67 TFLOP/s counts an FMA as two
# operations, so one fp32 (or int32) instruction per lane per clock is half
FP32_OPS_PER_S = 67e12 / 2
STEP = 60
PAIRS, PAIR_T = 100_000, 128
BAND_ROWS, BAND_HIST, BAND_CUR, BAND_T = 100_000, 512, 128, 1024
SEASON_ROWS, SEASON_HIST, SEASON_CUR, SEASON_T = 100_000, 10_080, 60, 16384
SEASON_ALGOS = ("holt_winters", "exponential_smoothing", "double_exponential", "seasonal_trend")
TIMED_RUNS = 20
SEASON_RUNS = 5
CHECK_ROWS = 2048  # rows per kernel-vs-twin comparison
SERIES_CHECK_ROWS = 256  # rows per smoother / fit comparison (the twins step in Python)


_PHASE = {}


def phase(name=None):
    """Print the wall time of the phase that ends, then the name of the one
    that starts (None: the last phase ends)."""
    now = time.perf_counter()
    if _PHASE:
        print(f"  phase {_PHASE['name']}: {now - _PHASE['t0']:.1f} s wall", flush=True)
    if name is not None:
        print(f"[{name}]", flush=True)
        _PHASE.update(name=name, t0=now)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, runs, warm=True):
    """Mean time of fn on the card over `runs` launches, by CUDA events,
    after one untimed call unless warm is False (for the slow twins)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


SPIN_CYCLES = 20_000_000  # ~11 ms of an H100's SM clock


def queued_ms(fn, runs):
    """Mean device time of fn over `runs` calls enqueued behind a spin
    kernel (torch.cuda._sleep), so that the card reaches them only after
    the host has launched them all: the time of kernels shorter than their
    launcher's host work, which cuda_ms would measure instead."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def chunked_ms(fn, B, rows=25_000):
    """Time on the card of fn(rows slice) over every chunk of `rows` rows,
    summed: one pass of a memory-hungry twin over B rows."""
    return sum(cuda_ms(lambda s=slice(lo, min(B, lo + rows)): fn(s), 1, warm=False)
               for lo in range(0, B, rows))


def wall_ms(fn, runs):
    """Host wall times (ms) of fn, each ending in a synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(out)


def band_bracket(x, mask, region, upper, lower, mode, tol):
    """(lo, hi) flag counts per row when each band edge may move by tol."""
    mode = torch.where(mode == 0, 3, mode)[:, None]
    up_on, lo_on = (mode & 1) > 0, (mode & 2) > 0
    sel = mask & region
    sure = ((x > upper + tol) & up_on) | ((x < lower - tol) & lo_on)
    maybe = ((x > upper - tol) & up_on) | ((x < lower + tol) & lo_on)
    return (sure & sel).sum(1), (maybe & sel).sum(1)


def least_time(nbytes, ops):
    """The least time (ms) the card could take for work that moves nbytes
    through HBM and does ops fp32 operations, and which of the two bounds
    it."""
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(tb, to) * 1e3, "bound_by": "bytes" if tb >= to else "operations"}


def max_abs_err(a, b):
    both_nan = torch.isnan(a) & torch.isnan(b)
    same_inf = torch.isinf(a) & (a == b)
    d = torch.where(both_nan | same_inf, 0.0, (a.double() - b.double()).abs())
    return float(torch.nan_to_num(d, nan=math.inf).max()) if d.numel() else 0.0


# ---------------------------------------------------------------------------
# kernel A vs its twin
# ---------------------------------------------------------------------------
def adversarial_pairs(B, T, rng):
    """score_pairs' 12 arguments for B rows of eight kinds: dense continuous,
    tied with +-0, NaN and +inf, sparse (exact KS with n1 != n2 and exact
    Wilcoxon at any T), all-masked baseline, all-masked current, shifted
    canary, constant baseline with an identical current."""
    from foremast_tpu_torch.parallel import fleet as fl

    kind = np.arange(B) % 8
    x = rng.normal(10, 1, (B, T)).astype(np.float32)
    y = rng.normal(10, 1, (B, T)).astype(np.float32)
    xm = rng.random((B, T)) > 0.1
    ym = rng.random((B, T)) > 0.1
    k = kind == 1
    x[k], y[k] = np.round(x[k] * 2) / 2 - 10, np.round(y[k] * 2) / 2 - 10
    zeros = (rng.random((B, T)) < 0.2) & k[:, None]
    x[zeros] = np.where(rng.random(zeros.sum()) < 0.5, 0.0, -0.0)
    k = kind == 2
    for a in (x, y):
        a[(rng.random((B, T)) < 0.03) & k[:, None]] = np.nan
        a[(rng.random((B, T)) < 0.03) & k[:, None]] = np.inf
    k = kind == 3
    sparse = np.zeros((B, T), bool)
    extra = np.zeros((B, T), bool)
    for i in np.nonzero(k)[0]:
        sparse[i, rng.choice(T, min(T, int(rng.integers(8, 46))), replace=False)] = True
        extra[i, rng.choice(T, min(T, int(rng.integers(0, 200))), replace=False)] = True
    # the paired points stay <= 45 (exact Wilcoxon); one side gains up to
    # 200 more, n1 > n2 on half the rows and n1 < n2 on the others
    more = sparse | extra
    flip = (np.arange(B) % 16 == 3)[:, None]
    xm[k], ym[k] = np.where(flip, more, sparse)[k], np.where(flip, sparse, more)[k]
    xm[kind == 4] = False
    ym[kind == 5] = False
    y[kind == 6] += 1.5
    k = kind == 7
    x[k], y[k] = np.float32(60.42), np.float32(60.42)
    args = list(fl.pair_arg_spec(B, T))
    args[:4] = x, xm, y, ym
    args[4] = rng.choice([0.01, 0.05], B).astype(np.float32)
    args[5] = np.where(rng.random(B) < 0.5, 31, rng.integers(1, 32, B)).astype(np.int32)
    args[6] = rng.integers(0, 2, B).astype(np.int32)
    args[7] = rng.choice([1, 5, 30], B).astype(np.int32)
    args[8] = rng.choice([1.0, 2.0, 3.0], B).astype(np.float32)
    args[9] = rng.integers(0, 4, B).astype(np.int32)
    args[10] = np.where(rng.random(B) < 0.2, 9.0, 0.0).astype(np.float32)
    args[11] = np.tile(np.asarray([20, 20, 5, 5], np.int32), (B, 1))
    return tuple(args)


def compare_pair_verdict(t, kern, plain):
    """Hold kernel A's outputs against the twin's; returns the largest
    p-value difference. Booleans and counts must match except on rows
    bracketed at a boundary: an enabled p within P_ATOL of the threshold,
    or a band point within float32 noise of an edge."""
    from foremast_tpu_torch.ops import forecast as fc

    err = max_abs_err(kern["pvalues"], plain["pvalues"])
    check(err <= P_ATOL, f"pair_verdict p-values differ by {err}")
    near_p = ((plain["pvalues"] - t[4][:, None]).abs() <= P_ATOL).any(1)
    B, T = t[0].shape
    concat = torch.cat([t[0], t[2]], 1)
    cm = torch.cat([t[1], t[3]], 1)
    region = torch.zeros_like(cm)
    region[:, T:] = True
    band = fc.moving_average_band_plain(concat, cm, region, t[7], t[8], t[9], t[10])
    scale = torch.nan_to_num(concat.abs(), posinf=0.0).amax(1)
    sig = torch.nan_to_num(band["sigma"], posinf=0.0)
    tol = (4 * torch.finfo(torch.float32).eps * (scale + t[8] * sig))[:, None]
    lo, hi = band_bracket(concat, cm, region, band["upper"], band["lower"], t[9], tol)
    check(bool(((lo <= kern["band_count"]) & (kern["band_count"] <= hi)).all()),
          "pair_verdict band counts outside their bracket")
    exact = (lo == hi) & ~near_p
    for key in ("unhealthy", "pairwise_unhealthy", "band_unhealthy", "band_count"):
        check(bool((kern[key][exact] == plain[key][exact]).all()), f"pair_verdict {key} differs")
    check(bool((kern["pairwise_unhealthy"][~near_p] == plain["pairwise_unhealthy"][~near_p]).all()),
          "pair_verdict pairwise verdict differs")
    check(max_abs_err(kern["min_p"], plain["min_p"]) <= P_ATOL, "pair_verdict min_p differs")
    return err, int((~exact).sum())


def kernel_a_vs_twin(rng):
    from foremast_tpu_torch.parallel import fleet as fl
    from foremast_tpu_torch.ops.pairwise import KS_EXACT_MAX_T

    worst = 0.0
    for T in (16, 128, 1024, 4096, 8192, 16384):
        # above 4096 the pairs' sorts run in device scratch: fewer rows
        B = CHECK_ROWS if T <= 4096 else 512
        args = adversarial_pairs(B, T, rng)
        t = fl.pair_args_from_numpy(args, DEV)
        kern = fl.score_pairs(*t, device=DEV)
        plain = fl.pair_verdict_plain(*t)
        torch.cuda.synchronize()
        err, bracketed = compare_pair_verdict(t, kern, plain)
        const = torch.arange(B, device=DEV) % 8 == 7
        check(bool((kern["band_count"][const] == 0).all()),
              "a current window identical to a constant baseline was flagged")
        worst = max(worst, err)
        n1, n2 = args[1].sum(1), args[3].sum(1)
        stephens = int(((n1 > KS_EXACT_MAX_T) | (n2 > KS_EXACT_MAX_T)).sum())
        scratch = ""
        if T > 4096:
            ms = cuda_ms(lambda: fl.score_pairs(*t, device=DEV), 3)
            bd = pair_bound(args)
            scratch = (f"; from device scratch: {ms:.3f} ms for {B} pairs, bound "
                       f"{bd['bound_ms']:.4f} ms ({bd['bound_by']})")
        print(f"  pair_verdict T={T}: max |dp| = {err:.3g} (tol {P_ATOL}), "
              f"{bracketed} of {B} rows bracketed, {stephens} in the Stephens regime"
              + scratch, flush=True)
    return max(worst, pair_verdict_paths(rng))


PAIR_PATH_T = (16, 128, 256)  # kernels A and N's three paths forced at each


def same_bits(a, b):
    """Equal bit for bit (float32 compared as its bits)."""
    view = (lambda t: t.view(torch.int32)) if a.dtype == torch.float32 else (lambda t: t)
    return a.dtype == b.dtype and torch.equal(view(a), view(b))


def same_bits_nan(a, b):
    """Equal bit for bit but for NaN payloads and signs (a NaN matches a
    NaN), which a host and a card produce differently."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and same_bits(torch.where(na, 0.0, a), torch.where(nb, 0.0, b))


def pair_verdict_paths(rng):
    """Kernel A forced onto each of its paths at PAIR_PATH_T (all three
    serve these windows), on CHECK_ROWS - 1 adversarial rows (the warp
    path's last CTA part full): each against the twin, and every output of
    the warp and scratch paths equal to the cta path's bit for bit. First
    the premise of the warp path's KS lattice: its division by a shared
    reciprocal equals IEEE division wherever it is used."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    t0 = time.perf_counter()
    div = kernels.ks_division_check()
    check(div["above"] == 0, f"the warp path's KS division differs from IEEE division: {div}")
    print(f"  the warp path's KS division (a reciprocal, one correction) against IEEE a / d "
          f"for every float32 a in [0, 512], d in 1-512: {div['above']} differ at a >= 2^-100 "
          f"(where it is used), {div['below']} below (largest {div['largest']:.3g}), "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    worst = 0.0
    for T in PAIR_PATH_T:
        t = fl.pair_args_from_numpy(adversarial_pairs(CHECK_ROWS - 1, T, rng), DEV)
        kw = dict(wilcoxon_table=fl.wilcoxon_pmf_table(DEV), ks_exact_max=fl.KS_EXACT_MAX_T,
                  wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N)
        out = {path: kernels.pair_verdict(*t, **kw, path=path) for path in kernels.PAIR_PATHS}
        plain = fl.pair_verdict_plain(*t)
        torch.cuda.synchronize()
        for path in kernels.PAIR_PATHS:
            worst = max(worst, compare_pair_verdict(t, out[path], plain)[0])
            for key, v in out["cta"].items():
                check(same_bits(out[path][key], v),
                      f"pair_verdict T={T}: the {path} path's {key} differs from the cta path's")
        print(f"  pair_verdict T={T}, each path forced ({', '.join(kernels.PAIR_PATHS)}) on "
              f"{CHECK_ROWS - 1} rows: each within the twin's tolerance, all 7 outputs equal to "
              f"the cta path's bit for bit", flush=True)
    return worst


# ---------------------------------------------------------------------------
# kernel B vs its twin
# ---------------------------------------------------------------------------
def adversarial_bands(B, T, gen):
    """Band rows on the card: noisy with gaps, a leading gap, a long gap
    (freeze-fill), all-masked, constant with an identical current, NaN and
    +inf, one observation, a shifted current."""
    dev = DEV
    kind = torch.arange(B, device=dev) % 8
    x = 50 + 2 * torch.randn((B, T), generator=gen, device=dev)
    m = torch.rand((B, T), generator=gen, device=dev) > 0.15
    region = torch.zeros((B, T), dtype=torch.bool, device=dev)
    region[:, 3 * T // 4:] = True
    t = torch.arange(T, device=dev)
    m[kind == 1] &= t >= T // 5
    m[kind == 2] &= ~((t >= T // 3) & (t < T // 3 + T // 8))
    m[kind == 3] = False
    x[kind == 4] = 60.42
    m[kind == 4] = True
    r5 = kind == 5
    x[r5] = torch.where(torch.rand((int(r5.sum()), T), generator=gen, device=dev) < 0.02,
                        torch.inf, x[r5])
    x[r5 & (torch.arange(B, device=dev) % 16 == 5)] = torch.nan
    m[kind == 6] = t == T // 2
    x[kind == 7] += 12.0 * region[kind == 7]
    thr = torch.tensor([1.0, 2.0, 3.0], device=dev)[torch.arange(B, device=dev) % 3]
    mode = (torch.arange(B, device=dev) % 4).to(torch.int32)
    mlb = torch.where(torch.arange(B, device=dev) % 5 == 0, 49.0, 0.0)
    return x.contiguous(), m, region, thr.contiguous(), mode, mlb.contiguous()


def compare_ma_band(args, window, kern, plain):
    x, m, region, thr, mode, mlb = args
    eps = torch.finfo(torch.float32).eps
    err = max_abs_err(kern["preds"], plain["preds"])
    scale = torch.nan_to_num(torch.where(m, x, 0).abs(), posinf=0.0).amax(1, keepdim=True)
    fin = torch.isfinite(plain["preds"])
    d = (kern["preds"] - plain["preds"]).abs()
    check(bool((d[fin] <= (4 * eps * scale.expand_as(d))[fin]).all()), "ma_band preds differ")
    check(bool((torch.isnan(kern["preds"]) == torch.isnan(plain["preds"])).all()),
          "ma_band preds NaN pattern differs")
    ks, ps = kern["sigma"], plain["sigma"]
    fs = torch.isfinite(ps)
    check(bool((torch.isfinite(ks) == fs).all()), "ma_band sigma finiteness differs")
    check(bool(((ks[fs] - ps[fs]).abs() <= 1e-5 * ps[fs] + 4 * eps * scale[:, 0][fs]).all()),
          "ma_band sigma differs")
    sig = torch.nan_to_num(ps, posinf=0.0)
    tol = (4 * eps * (scale[:, 0] + thr * sig) + 1e-5 * thr * sig)[:, None]
    lo, hi = band_bracket(x, m, region, plain["upper"], plain["lower"], mode, tol)
    check(bool(((lo <= kern["count"]) & (kern["count"] <= hi)).all()), "ma_band counts outside bracket")
    exact = lo == hi
    for key in ("count", "first_index"):
        check(bool((kern[key][exact] == plain[key][exact]).all()), f"ma_band {key} differs")
    check(bool((kern["flags"][exact] == plain["flags"][exact]).all()), "ma_band flags differ")
    check(bool((kern["checked"] == plain["checked"]).all()), "ma_band checked differs")
    return err, int((~exact).sum())


def kernel_b_vs_twin(gen):
    from foremast_tpu_torch.ops import forecast as fc

    worst = 0.0
    for T, B in ((128, CHECK_ROWS), (1024, CHECK_ROWS), (5000, CHECK_ROWS // 4),
                 (8192, CHECK_ROWS // 2), (16384, CHECK_ROWS // 2)):
        # the long path's two added shapes draw from a generator of their
        # own: the later checks' rows do not depend on them
        own = T in (5000, 8192)
        args = adversarial_bands(B, T, torch.Generator(device=DEV).manual_seed(SEED + T)
                                 if own else gen)
        kern = fc.moving_average_band(*args[:3], 30, *args[3:], device=DEV)
        plain = fc.moving_average_band_plain(*args[:3], 30, *args[3:])
        torch.cuda.synchronize()
        err, bracketed = compare_ma_band(args, 30, kern, plain)
        const = torch.arange(B, device=DEV) % 8 == 4
        check(bool((kern["sigma"][const] == 0).all()), "constant history must keep sigma 0")
        check(bool((kern["count"][const] == 0).all()), "an identical constant current was flagged")
        worst = max(worst, err)
        same = band_paths_agree(args, 30)
        print(f"  ma_band T={T}: max |d preds| = {err:.3g}, {bracketed} of {B} rows bracketed; "
              f"{same}", flush=True)
    return worst


def band_paths_agree(args, window):
    """ma_band on every path that serves T: all 8 outputs equal to the
    unstaged path's (the first design's) bit for bit."""
    from foremast_tpu_torch import kernels

    T = args[0].shape[1]
    first = kernels.ma_band(*args[:3], window, *args[3:6], path="unstaged")
    for path in kernels.BAND_PATHS:
        if path != "unstaged" and kernels.band_serves(path, T):
            got = kernels.ma_band(*args[:3], window, *args[3:6], path=path)
            for key in first:
                check(same_bits(got[key], first[key]),
                      f"ma_band T={T}: the {path} path's {key} differs from the unstaged path's")
    return (f"paths {[p for p in kernels.BAND_PATHS if kernels.band_serves(p, T)]} equal bit for "
            f"bit")


# ---------------------------------------------------------------------------
# kernels C, D, E, F and band_from_preds vs their twins
# ---------------------------------------------------------------------------
EPS32 = float(np.finfo(np.float32).eps)
PERIOD_CANDIDATES = (60, 480, 720, 1440)  # EngineConfig.hw_period_candidates
# 40 candidates: every multiple of 12 steps up to 8 hours, and a day
MANY_CANDIDATES = tuple(range(12, 480, 12)) + (1440,)


def adversarial_series(B, T, gen):
    """Smoother and period rows on the card, ten kinds: a 24-step cycle
    with gaps, a leading gap, a trailing gap (the models free-run), all
    masked, one observation, constant, a cycle longer than T/2, a 3-step
    cycle, a trend, and NaN and +inf at masked slots (a masked step must
    not read them). Per-row alpha, beta, gamma over the engine's grid
    ranges; periods from 2 to past T. The last eighth is the scored region;
    the band policy runs every bound mode. Returns (x, mask, region, alpha,
    beta, gamma, period, threshold, bound_mode, min_lower_bound)."""
    dev = DEV
    kind = torch.arange(B, device=dev) % 10
    t = torch.arange(T, device=dev, dtype=torch.float32)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def on(k, v):
        return torch.where((kind == k)[:, None], v, 0.0)

    x = 30 + 2 * torch.randn((B, T), generator=gen, device=dev)
    x = (x + on(0, 4 * torch.sin(2 * math.pi * t / 24)) + on(6, 5 * torch.sin(2 * math.pi * t / (0.6 * T)))
         + on(7, 3 * torch.sin(2 * math.pi * t / 3)) + on(8, 20 * t / T))
    m = u(B, T) > 0.1
    m[kind == 1] &= t >= T // 5
    m[kind == 2] &= t < T - T // 4
    m[kind == 3] = False
    m[kind == 4] = t == T // 2
    x[kind == 5] = 60.42
    m[kind == 5] = True
    hole = ~m & (kind == 9)[:, None]
    x = torch.where(hole, torch.where(u(B, T) < 0.5, torch.nan, torch.inf), x)
    region = (t >= T - T // 8).expand(B, T).contiguous()
    choices = torch.tensor([2, 3, 24, 31, 32, 33, T // 2 + 1, T + 5, 480, 1440],
                           dtype=torch.int32, device=dev)
    period = choices[torch.randint(0, len(choices), (B,), generator=gen, device=dev)]
    thr = torch.tensor([1.0, 2.0, 3.0], device=dev)[torch.arange(B, device=dev) % 3]
    mode = (torch.arange(B, device=dev) % 4).to(torch.int32)
    mlb = torch.where(torch.arange(B, device=dev) % 5 == 0, 31.0, 0.0)
    return (x.contiguous(), m.contiguous(), region, 0.1 + 0.8 * u(B), 0.3 * u(B),
            0.05 + 0.45 * u(B), period, thr.contiguous(), mode, mlb.contiguous())


def row_scale(x, m):
    return torch.nan_to_num(torch.where(m, x, 0.0).abs(), posinf=0.0).amax(1).clamp(min=1.0)


def close_rows(got, want, rtol, atol_rows, what):
    """|got - want| <= rtol |want| + atol_rows per row, NaN where the other
    is NaN and equal infinities; returns the largest difference."""
    check(bool((torch.isnan(got) == torch.isnan(want)).all()), f"{what}: NaN pattern differs")
    same = torch.isnan(want) | (torch.isinf(want) & (got == want))
    d = torch.where(same, 0.0, (got.double() - want.double()).abs())
    lim = rtol * torch.nan_to_num(want.double().abs(), posinf=0.0) + atol_rows.double()[:, None]
    check(bool((d <= lim).all()), f"{what}: differs by {float(d.max()):.3g}")
    return float(d.max()) if d.numel() else 0.0


def compare_smooth(kind, x, hist, params, kern):
    """Kernel C against smooth_plain: the same float32 recurrences in the
    same order (-fmad=false), HW's initial level a float64 mean: equal to
    4 eps32 of the row's scale."""
    from foremast_tpu_torch.ops import forecast as fc

    plain = fc.smooth_plain(kind, x, hist, *params)
    return close_rows(kern, plain, 4 * EPS32, 4 * EPS32 * row_scale(x, hist), f"smooth {kind}")


def smooth_hw_agrees(x, hist, al, be, ga, period):
    """Kernel C's Holt-Winters kind at these rows' periods and again with
    them cut to 1440, each against the twin, and each with rings as long as
    the row (max_period = T) equal bit for bit to the launch sized by the
    largest period. Returns the largest difference from the twin."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    T = x.shape[1]
    errs = {}
    for what, per in (("", period), ("_p1440", period.clamp(max=1440))):
        plain = fc.smooth_plain(3, x, hist, al, be, ga, per)
        got = kernels.smooth(kernels.SMOOTH_HW, x, hist, al, be, ga, per)
        errs[f"smooth3{what}"] = close_rows(got, plain, 4 * EPS32,
                                            4 * EPS32 * row_scale(x, hist), f"smooth 3{what}")
        longer = kernels.smooth(kernels.SMOOTH_HW, x, hist, al, be, ga, per, max_period=T)
        check(bool(torch.equal(got.view(torch.int32), longer.view(torch.int32))),
              f"smooth HW at T={T}{what}: rings of {T} floats change the predictions")
    return errs


def compare_scan(kind, x, hist, params, kern):
    """Kernel E against its twin, which applies the same maps one step at a
    time: the combine order differs, so the reference's own tolerances for
    its scan forms, SES 1e-5 and DES 1e-4, relative and of the row's scale."""
    from foremast_tpu_torch.ops import seqscan as sq

    plain = (sq.ses_predictions_assoc_plain if kind == 1 else sq.des_predictions_assoc_plain)(
        x, hist, *params)
    tol = 1e-5 if kind == 1 else 1e-4
    return close_rows(kern, plain, tol, tol * row_scale(x, hist), f"affine_scan {kind}")


def scan_limit_share(got, want, x, hist, tol=1e-4):
    """Each row's largest |got - want| as a share of compare_scan's limit
    for DES (tol |want| + tol of the row's scale), NaN and equal infinities
    matching; (B,) float64."""
    same = torch.isnan(want) | (torch.isinf(want) & (got == want))
    d = torch.where(same, 0.0, (got.double() - want.double()).abs())
    lim = (tol * torch.nan_to_num(want.double().abs(), posinf=0.0)
           + tol * row_scale(x, hist).double()[:, None])
    return (d / lim).amax(1)


def des_walk(x, hist, alpha, beta, dtype):
    """Kernel E's DES maps stepped one at a time in `dtype`, predictions
    rounded to float32: in float64 the twin's arithmetic
    (ops.seqscan.des_predictions_assoc_plain), in float32 the first twin's.
    For the record of P4 (how far a float32 walk drifts) from checkouts of
    either."""
    B, T = x.shape
    first = torch.where(hist.any(1), torch.where(hist, x, 0.0).gather(
        1, hist.to(torch.int8).argmax(1, keepdim=True))[:, 0], 0.0)
    x, m = x.to(dtype), hist.to(dtype)
    alpha, beta = alpha.to(dtype), beta.to(dtype)
    oma = 1.0 - alpha
    o10, o11 = -beta * alpha, beta * oma + (1.0 - beta)
    ba = beta * alpha
    lvl, trend = first.to(dtype), torch.zeros(B, dtype=dtype, device=x.device)
    preds = torch.empty((B, T), dtype=dtype, device=x.device)
    for t in range(T):
        mt = m[:, t]
        g = 1.0 - mt
        a00 = mt * oma + g * 1.0
        a10, a11 = mt * o10 + g * 0.0, mt * o11 + g * 1.0
        c0, c1 = (alpha * mt) * x[:, t], (ba * mt) * x[:, t]
        preds[:, t] = lvl + trend
        lvl, trend = (a00 * lvl + a00 * trend) + c0, (a10 * lvl + a11 * trend) + c1
    return preds.to(torch.float32)


WALK_CHECK_T = (128, 1000, 4096, 16383, 16384)  # kernel E's walk: staged tiles or not
WALK_CHECK_ROWS = 1000  # not a multiple of 32
P4_DRAWS, P4_ROWS, P4_T = 16, 1024, 16384


def walk_rows(B, T, gen):
    """adversarial_series' DES rows (all masked, a masked prefix, a masked
    tail, NaN and inf at masked slots, constant, one point) with alpha and
    beta at (0, 1), (1, 0), (1, 1) and (0, 0) on four rows of each 16.
    Returns (x, hist, alpha, beta)."""
    x, m, region, al, be = adversarial_series(B, T, gen)[:5]
    r = torch.arange(B, device=DEV) % 16
    for j, (a, b) in enumerate(((0.0, 1.0), (1.0, 0.0), (1.0, 1.0), (0.0, 0.0))):
        al = torch.where(r == 11 + j, a, al)
        be = torch.where(r == 11 + j, b, be)
    return x, (m & ~region).contiguous(), al.contiguous(), be.contiguous()


def kernel_e_paths():
    """Kernel E's DES on both of its paths against its twin: the walk
    (forced) equal to the twin bit for bit and the scan (forced) within
    compare_scan's limit at WALK_CHECK_T on WALK_CHECK_ROWS walk_rows; then
    P4's 16 draws of 1,024 adversarial rows at T = 16384, where the default
    path is the walk (the twin's bits) and the forced scan stays within half
    of compare_scan's limit. Returns the largest share of that limit."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import seqscan as sq

    des = kernels.SMOOTH_DES
    gen = torch.Generator(device=DEV).manual_seed(SEED + 19)
    worst = 0.0
    for T in WALK_CHECK_T:
        x, hist, al, be = walk_rows(WALK_CHECK_ROWS, T, gen)
        twin = sq.des_predictions_assoc_plain(x, hist, al, be)
        walk = kernels.affine_scan(des, x, hist, al, be, path="walk")
        check(same_bits_nan(walk, twin), f"affine_scan's walk at T = {T}: not the twin's bits "
              f"(max |err| {max_abs_err(walk, twin):.3g})")
        scan = kernels.affine_scan(des, x, hist, al, be, path="scan")
        close_rows(scan, twin, 1e-4, 1e-4 * row_scale(x, hist), f"affine_scan 2 scan T={T}")
        share = float(scan_limit_share(scan, twin, x, hist).max())
        worst = max(worst, share)
        print(f"  affine_scan DES T={T}, {WALK_CHECK_ROWS} rows: the walk the twin's bits; the "
              f"scan at {share:.3g} of compare_scan's limit", flush=True)
    draws = [adversarial_series(P4_ROWS, P4_T, torch.Generator(device=DEV).manual_seed(
        SEED + 1000 + d))[:5] for d in range(P4_DRAWS)]
    x = torch.cat([a[0] for a in draws])
    hist = torch.cat([a[1] & ~a[2] for a in draws])
    al, be = torch.cat([a[3] for a in draws]), torch.cat([a[4] for a in draws])
    del draws
    twin = sq.des_predictions_assoc_plain(x, hist, al, be)
    kernels.reset_launches()
    walk = kernels.affine_scan(des, x, hist, al, be)
    check(kernels.scan_path_launches == {"scan": 0, "walk": 1},
          f"P4's {x.shape[0]} rows did not take the walk: {kernels.scan_path_launches}")
    check(same_bits_nan(walk, twin), "P4: the walk is not the twin's bits")
    shares = scan_limit_share(kernels.affine_scan(des, x, hist, al, be, path="scan"), twin, x,
                              hist).view(P4_DRAWS, P4_ROWS).amax(1)
    check(float(shares.max()) <= 0.5, f"P4: the scan at {float(shares.max()):.3g} of "
          f"compare_scan's limit (more than half)")
    print(f"  P4, {P4_DRAWS} draws of {P4_ROWS} rows at T = {P4_T}: the walk (default at "
          f"{x.shape[0]} rows) the twin's bits; the scan's worst row of each draw "
          + " ".join(f"{v:.3g}" for v in shares.tolist()) + " of compare_scan's limit",
          flush=True)
    return max(worst, float(shares.max()))


def compare_hw_fit(x, hist, fit, period, grid, kern):
    """Kernel D against its twin: float64 sums in the same order, so the
    errors agree to 1e-9 relative and the chosen candidates exactly."""
    from foremast_tpu_torch.ops import forecast as fc

    plain = fc.fit_holt_winters_plain(x, hist, fit, period, grid)
    err = close_rows(kern["mse"], plain["mse"], 1e-9, torch.zeros(x.shape[0], device=x.device),
                     "hw_fit mse")
    check(bool(torch.equal(kern["best"], plain["best"])), "hw_fit best differs")
    check(bool(torch.equal(kern["params"], plain["params"])), "hw_fit params differ")
    return err


def period_edge_rows(B, T, gen):
    """Kernel F's edge rows on the card: a cycle of T // 8 steps (at least
    4) with noise and 10% lost slots, each row's valid span ending at a
    random slot from 0.3 T on (so the last valid slot lies before T - p for
    the longer lags), and one row in eight each: all padding, a valid span
    of three slots (every lag at or beyond it), NaN at a masked slot, NaN at
    a valid slot, +inf at the span's last valid slot, a constant span, a
    span ending at T // 2. Returns (x, hist) and candidates that reach past
    the spans: 2, 3, the cycle, twice it, T // 2 - 1, T - 1, T + 3."""
    dev = DEV
    kind = torch.arange(B, device=dev) % 8
    t = torch.arange(T, device=dev)
    cyc = max(T // 8, 4)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    x = (50 + 5 * torch.sin(2 * math.pi * t / cyc)
         + torch.randn((B, T), generator=gen, device=dev))
    end = (T * (0.3 + 0.7 * u(B))).long()
    end[kind == 7] = T // 2
    m = (u(B, T) > 0.1) & (t < end[:, None])
    m[kind == 1] = False
    m[kind == 2] &= t < 3
    m[kind == 2, :3] = True
    last = torch.where(m, t, -1).amax(1)
    x = torch.where((kind == 3)[:, None] & ~m & (t < end[:, None]), torch.nan, x)
    nan_at = (kind == 4)[:, None] & (t == last[:, None] // 2)
    m |= nan_at
    x = torch.where(nan_at, torch.nan, x)
    x = torch.where((kind == 5)[:, None] & (t == last[:, None]), torch.inf, x)
    x[kind == 6] = 42.5
    cands = (2, 3, cyc, 2 * cyc, T // 2 - 1, T - 1, T + 3)
    return x.contiguous(), m.contiguous(), cands


def near_decision(S, H, cands, T, alias_margin=0.05, contrast_margin=0.01, min_acf=0.2):
    """Rows whose period choice sits within 1e-5 of a margin, from scores S
    (B, C) and the scores H (B, C) at each candidate's half lag."""
    ok = torch.zeros_like(S, dtype=torch.bool)
    near = torch.zeros(S.shape[0], dtype=torch.bool, device=S.device)
    for c, p in enumerate(cands):
        if not 2 <= p < T:
            continue
        if p >= 4:
            d = S[:, c].double() + contrast_margin - H[:, c].double()
            ok[:, c] = d >= 0
            near |= torch.isfinite(d) & (d.abs() < 1e-5)
        else:
            ok[:, c] = True
    best = torch.where(ok, S.double(), -math.inf).amax(1)
    cut = torch.clamp(best - alias_margin, min=min_acf)
    near |= (ok & torch.isfinite(S) & ((S.double() - cut[:, None]).abs() < 1e-5)).any(1)
    return near


def compare_detect_period(x, hist, cands, fallback, kern):
    """Kernel F against its twin: float64 sums in another order, so the
    scores agree to 1e-6 (correlations, scale 1) with the same -inf
    pattern, and the periods exactly except on rows within 1e-5 of a
    margin. Returns (largest score difference, rows bracketed)."""
    from foremast_tpu_torch.ops import forecast as fc

    T = x.shape[1]
    pp, ps = fc.detect_period_plain(x, hist, cands, fallback, 0.2, 0.05, 0.01)
    kp, ks = kern
    err = close_rows(ks, ps, 0.0, torch.full((x.shape[0],), 1e-6, device=x.device),
                     "detect_period scores")
    check(bool((torch.isneginf(ks) == torch.isneginf(ps)).all()), "detect_period -inf differs")
    halves = tuple(p // 2 if p >= 4 else 2 for p in cands)
    _, hs = fc.detect_period_plain(x, hist, halves, fallback, 0.2, 0.05, 0.01)
    near = near_decision(ps, hs, cands, T)
    check(bool((kp[~near] == pp[~near]).all()), "detect_period periods differ")
    return err, int(near.sum())


def compare_band_from_preds(x, m, region, preds, thr, mode, mlb, kern):
    """band_from_preds against residual_sigma + band_anomalies: sigma to
    1e-5 relative plus 4 eps32 of the row's scale, counts within the
    bracket of a band edge moving by that much, flags, first index and
    count exact where the bracket is, checked exact. Returns (largest band
    edge difference, rows bracketed)."""
    from foremast_tpu_torch.ops import forecast as fc

    plain = fc.band_from_preds_plain(x, m, region, preds, thr, mode, mlb)
    scale = row_scale(x, m)
    ks, ps = kern["sigma"], plain["sigma"]
    fs = torch.isfinite(ps)
    check(bool((torch.isfinite(ks) == fs).all()), "band_from_preds sigma finiteness differs")
    check(bool(((ks[fs] - ps[fs]).abs() <= 1e-5 * ps[fs] + 4 * EPS32 * scale[fs]).all()),
          "band_from_preds sigma differs")
    sig = torch.nan_to_num(ps, posinf=0.0)
    tol = (4 * EPS32 * (scale + thr * sig) + 1e-5 * thr * sig)[:, None]
    lo, hi = band_bracket(x, m, region, plain["upper"], plain["lower"], mode, tol)
    check(bool(((lo <= kern["count"]) & (kern["count"] <= hi)).all()),
          "band_from_preds counts outside bracket")
    exact = lo == hi
    for key in ("count", "first_index"):
        check(bool((kern[key][exact] == plain[key][exact]).all()), f"band_from_preds {key} differs")
    check(bool((kern["flags"][exact] == plain["flags"][exact]).all()), "band_from_preds flags differ")
    check(bool((kern["checked"] == plain["checked"]).all()), "band_from_preds checked differs")
    err = max(max_abs_err(kern["upper"], plain["upper"]), max_abs_err(kern["lower"], plain["lower"]))
    return err, int((~exact).sum())


PERIOD_WIDE_CHECK = (1025, 2048)  # candidates past kernels.TILE_CANDIDATES


def kernels_c_to_f_vs_twin(gen):
    """Kernels C, D, E, F and band_from_preds against their twins on
    adversarial rows at T in {128, 1024, 4096, 16384}; F also on
    period_edge_rows at each T and with TILE_CANDIDATES candidates at 4096
    (and PERIOD_WIDE_CHECK's on the tiled path)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    grid = torch.tensor(fc.DEFAULT_GRID, dtype=torch.float32, device=DEV)
    cands = (2, 3, 24) + PERIOD_CANDIDATES
    for T in (128, 1024, 4096, 16384):
        B = 1024
        x, m, region, al, be, ga, period, thr, mode, mlb = adversarial_series(B, T, gen)
        hist = m & ~region
        n = SERIES_CHECK_ROWS
        xs, hs = x[:n], hist[:n]
        errs = {}
        for kind, params in ((1, (al,)), (2, (al, be))):
            sub = tuple(p[:n].contiguous() for p in params)
            errs[f"smooth{kind}"] = compare_smooth(kind, xs, hs, sub,
                                                   kernels.smooth(kind, xs, hs, *sub))
        errs.update(smooth_hw_agrees(xs, hs, al[:n], be[:n], ga[:n], period[:n]))
        for kind, params in ((1, (al,)), (2, (al, be))):
            errs[f"scan{kind}"] = compare_scan(kind, x, hist, params,
                                               kernels.affine_scan(kind, x, hist, *params))
        fit = hs & (torch.arange(T, device=DEV) >= 2 * period[:n, None])
        errs["hw_fit"] = compare_hw_fit(xs, hs, fit, period[:n], grid,
                                        kernels.hw_fit(xs, hs, fit, period[:n], grid))
        fb = torch.full((B,), 7, dtype=torch.int32, device=DEV)
        candt = torch.tensor(cands, dtype=torch.int32, device=DEV)
        errs["detect_period"], near = compare_detect_period(
            x, hist, cands, fb, kernels.detect_period(x, hist, candt, fb, 0.2, 0.05, 0.01))
        if T in (1024, 16384):
            # past the 16 candidates kernel F once took, and past its cache
            # of 32 lags (each computed again there)
            many = MANY_CANDIDATES
            manyt = torch.tensor(many, dtype=torch.int32, device=DEV)
            errs["detect_period_40"], near40 = compare_detect_period(
                x[:n], hist[:n], many, fb[:n],
                kernels.detect_period(x[:n], hist[:n], manyt, fb[:n], 0.2, 0.05, 0.01))
        # spans ending before T - p, all padding, non-finite values under
        # and outside the mask, lags past the spans: the rows that take the
        # parent's full sweep and the early stop
        xe, he, ce = period_edge_rows(256 if T < 16384 else 64, T, gen)
        Be = xe.shape[0]
        ke = kernels.detect_period(xe, he, torch.tensor(ce, dtype=torch.int32, device=DEV),
                                   fb[:Be], 0.2, 0.05, 0.01)
        errs["detect_period_edge"], near_e = compare_detect_period(xe, he, ce, fb[:Be], ke)
        check(bool((ke[0][torch.arange(Be, device=DEV) % 8 == 6] == 7).all()),
              "a constant span did not keep its fallback")
        if T == 4096:
            # TILE_CANDIDATES candidates, 2 to 1025: 1,536 distinct lags, the
            # table path's most
            allc = tuple(range(2, 2 + kernels.TILE_CANDIDATES))
            errs["detect_period_max"], _ = compare_detect_period(
                x[:64], hist[:64], allc, fb[:64],
                kernels.detect_period(x[:64], hist[:64],
                                      torch.tensor(allc, dtype=torch.int32, device=DEV), fb[:64],
                                      0.2, 0.05, 0.01))
            # past it, the tiled path: 1,025 and 2,048 candidates
            for C in PERIOD_WIDE_CHECK:
                wide = tuple(range(2, 2 + C))
                kernels.reset_launches()
                got = kernels.detect_period(x[:64], hist[:64],
                                            torch.tensor(wide, dtype=torch.int32, device=DEV),
                                            fb[:64], 0.2, 0.05, 0.01)
                check(kernels.period_path_launches == {"table": 0, "tiled": 1},
                      f"detect_period with {C} candidates: {kernels.period_path_launches}")
                errs[f"detect_period_{C}"], _ = compare_detect_period(x[:64], hist[:64], wide,
                                                                      fb[:64], got)
        preds = torch.where(torch.isfinite(x), x, 30.0) + torch.randn((B, T), generator=gen,
                                                                       device=DEV)
        errs["band_from_preds"], bracketed = compare_band_from_preds(
            x, m, region, preds, thr, mode, mlb,
            kernels.band_from_preds(x, m, region, preds, thr, mode, mlb))
        const = torch.arange(B, device=DEV) % 10 == 5
        check(bool((fc.detect_period(x[const], hist[const], cands, 7, 0.2, device=DEV)[0]
                    == 7).all()), "a constant row did not keep its fallback")
        torch.cuda.synchronize()
        print(f"  T={T}: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
              + f"; periods: {near} of {B} rows bracketed ({near_e} of {Be} edge rows); band: {bracketed} of {B} rows "
              f"bracketed", flush=True)


# ---------------------------------------------------------------------------
# kernel G vs its twin, and beside kernel B
# ---------------------------------------------------------------------------
TRIAGE_WINDOW, TRIAGE_MARGIN = 30, 0.25  # EngineConfig.ma_window, triage_margin


def adversarial_screen(B, T, gen):
    """Screen rows on the card, ten kinds: noisy with gaps, all masked, a
    single point, constant with an identical current, +-0, NaN in a valid
    history slot, an empty region, quantized around 0, NaN at masked slots,
    a shifted current. The last quarter is the region; thresholds 2, 3, 10; every
    bound mode; some rows with a lower clamp. Returns (x, mask, region,
    threshold, bound_mode, min_lower_bound, margin)."""
    dev = DEV
    kind = torch.arange(B, device=dev) % 10
    t = torch.arange(T, device=dev)
    x = 50 + 3 * torch.randn((B, T), generator=gen, device=dev)
    m = torch.rand((B, T), generator=gen, device=dev) > 0.1
    region = (t >= 3 * T // 4).expand(B, T).clone()
    m[kind == 1] = False
    m[kind == 2] = t == T // 3
    x[kind == 3], m[kind == 3] = 60.42, True
    zeros = kind == 4
    x[zeros] = torch.where(torch.rand((int(zeros.sum()), T), generator=gen, device=dev) < 0.5,
                           0.0, -0.0)
    nan_row = kind == 5
    x[nan_row, T // 5], m[nan_row, T // 5] = torch.nan, True
    region[kind == 6] = False
    x[kind == 7] = torch.round(x[kind == 7]) - 50.0  # ties of both signs
    hole = (kind == 8)[:, None] & (t >= T // 2) & (t < 3 * T // 4)
    x[hole], m[hole] = torch.nan, False
    x[kind == 9] += 20.0 * region[kind == 9]
    thr = torch.tensor([2.0, 3.0, 10.0], device=dev)[torch.arange(B, device=dev) % 3]
    mode = (torch.arange(B, device=dev) % 4).to(torch.int32)
    mlb = torch.where(torch.arange(B, device=dev) % 5 == 0, 49.0, 0.0)
    margin = torch.full((B,), TRIAGE_MARGIN, device=dev)
    return x.contiguous(), m.contiguous(), region.contiguous(), thr, mode, mlb, margin


def close_or_same(got, want, rtol, atol, what):
    """|got - want| <= rtol |want| + atol, NaN where the other is NaN and
    equal infinities; returns the largest difference."""
    check(bool((torch.isnan(got) == torch.isnan(want)).all()), f"{what}: NaN pattern differs")
    same = torch.isnan(want) | (torch.isinf(want) & (got == want))
    d = torch.where(same, 0.0, (got.double() - want.double()).abs())
    lim = rtol * torch.nan_to_num(want.double().abs(), posinf=0.0) + atol.double()
    check(bool((d <= lim).all()), f"{what}: differs by {float(d.max()):.3g}")
    return float(d.max()) if d.numel() else 0.0


def compare_triage(args, kern, plain):
    """Kernel G against screen_rows_plain: n_hist and checked exact; both
    counts exact except rows with a point within float noise of a band edge
    (bracketed as compare_ma_band brackets them, for the policy band and the
    shrunk one); shrunk_count >= count everywhere; the statistics to 1e-5
    relative plus float32 noise of the row's scale (the sums run in another
    order). Returns (largest statistic difference, rows bracketed)."""
    from foremast_tpu_torch.ops import forecast as fc

    x, m, region, thr, mode, mlb, margin = args
    for key in ("n_hist", "checked"):
        check(bool(torch.equal(kern[key], plain[key])), f"triage_screen {key} differs")
    check(bool((kern["shrunk_count"] >= kern["count"]).all()), "triage_screen shrunk < count")
    scale = row_scale(x, m)
    sig = torch.nan_to_num(plain["sigma"], posinf=0.0)
    exact = torch.ones_like(mode, dtype=torch.bool)
    for key, width in (("count", thr), ("shrunk_count", thr - margin)):
        band = fc.moving_average_band_plain(x, m, region, TRIAGE_WINDOW, width, mode, mlb)
        tol = (4 * EPS32 * (scale + width * sig) + 1e-5 * width * sig)[:, None]
        lo, hi = band_bracket(x, m, region, band["upper"], band["lower"], mode, tol)
        check(bool(((lo <= kern[key]) & (kern[key] <= hi)).all()),
              f"triage_screen {key} outside its bracket")
        exact &= lo == hi
        check(bool((kern[key][lo == hi] == plain[key][lo == hi]).all()), f"triage_screen {key} differs")
    ks, ps = kern["sigma"], plain["sigma"]
    fs = torch.isfinite(ps)
    check(bool((torch.isfinite(ks) == fs).all()), "triage_screen sigma finiteness differs")
    err = close_or_same(ks, ps, 1e-5, 4 * EPS32 * scale, "triage_screen sigma")
    width = torch.abs(thr) * sig
    for key in ("upper_mean", "lower_mean"):
        err = max(err, close_or_same(kern[key], plain[key], 1e-5, 1e-5 * width + 4 * EPS32 * scale,
                                     f"triage_screen {key}"))
    for key in ("resid_z", "robust_z"):
        err = max(err, close_or_same(kern[key], plain[key], 1e-4, torch.full_like(scale, 1e-6),
                                     f"triage_screen {key}"))
    return err, int((~exact).sum())


def check_band_sigma(g_sigma, b_sigma, what):
    """Kernel G's sigma against kernel B's on the same rows: equal bit for
    bit on every row (the same prefix sums and the same order of sums), inf
    where both are inf."""
    same = g_sigma.view(torch.int32) == b_sigma.view(torch.int32)
    check(bool(same.all()), f"{what}: triage_screen sigma differs from ma_band's on "
          f"{int((~same).sum())} rows")


def kernel_g_vs_twin(gen):
    """Kernel G against its twin on adversarial rows at T in {128, 1000,
    1024, 4096, 16384} (1000: not a multiple of 256): ints exact but for
    bracketed rows, NaN in a valid slot ordered after +inf (the rows agree on
    robust_z), constant rows at sigma 0, sigma equal to kernel B's bit for
    bit."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import triage as tr

    worst = 0.0
    for T, B in ((128, 1024), (1000, 1024), (1024, 1024), (4096, 512), (16384, 256)):
        args = adversarial_screen(B, T, gen)
        kern = kernels.triage_screen(args[0], args[1], args[2], TRIAGE_WINDOW, *args[3:])
        plain = tr.screen_rows_plain(*args, TRIAGE_WINDOW)
        band = kernels.ma_band(args[0], args[1], args[2], TRIAGE_WINDOW, *args[3:6])
        torch.cuda.synchronize()
        check_band_sigma(kern["sigma"], band["sigma"], f"adversarial rows at T={T}")
        err, bracketed = compare_triage(args, kern, plain)
        const = torch.arange(B, device=DEV) % 10 == 3
        check(bool((kern["sigma"][const] == 0).all()), "triage_screen: a constant history's sigma")
        check(bool((kern["count"][const] == 0).all()), "triage_screen flagged an identical current")
        worst = max(worst, err)
        print(f"  triage_screen T={T}: max |err| of its statistics {err:.3g}, {bracketed} of {B} "
              f"rows bracketed", flush=True)
    return worst


def triage_bound(mask, region):
    """Least time for kernel G's work on these inputs (ms, bound_by): each
    input read once (6 B a slot, 16 B a row) and each output written once
    (36 B a row) over HBM, against the operations at the fp32 instruction
    rate: ~35 a slot (float64 prefix sums counted twice, two predictions,
    the residual, both bands, the region sums, the deviations) and the two
    order statistics of each of the two selections, ~2 compares a valid
    history value each."""
    B, T = mask.shape
    n_hist = float((mask & ~region).sum())
    return least_time(6 * B * T + 52 * B, 35.0 * B * T + 8.0 * n_hist)


def sort_ms(x, mask, region, chunk_rows):
    """torch.sort of the history values (masked as +inf) row by row, in
    row chunks: the one PyTorch call that computes part of the screen (its
    order statistics), timed for the record; the port never calls it."""
    B = x.shape[0]
    total = 0.0
    for lo in range(0, B, chunk_rows):
        s = slice(lo, min(B, lo + chunk_rows))
        v = torch.where(mask[s] & ~region[s], x[s], torch.inf)
        total += cuda_ms(lambda: torch.sort(v, dim=-1), 1)
        del v
    return total


def triage_beside_band(args, what, runs):
    """Kernel G on a band phase's rows with its policy and margin 0.25,
    beside kernel B's ma_band on the same rows: sigma equal to B's bit for
    bit on every row, count equal to B's on every row but those with a point
    within float noise of a band edge, shrunk_count >= count everywhere;
    then its time (median of `runs`), its bound, its twin's and
    torch.sort's."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import triage as tr

    x, mask, region, thr, mode, mlb = args
    B, T = x.shape
    margin = torch.full((B,), TRIAGE_MARGIN, device=DEV)

    def run():
        return kernels.triage_screen(x, mask, region, TRIAGE_WINDOW, thr, mode, mlb, margin)

    g = run()
    b = kernels.ma_band(x, mask, region, TRIAGE_WINDOW, thr, mode, mlb)
    torch.cuda.synchronize()
    check_band_sigma(g["sigma"], b["sigma"], what)
    check(bool((g["shrunk_count"] >= g["count"]).all()), f"{what}: shrunk_count < count")
    differ = torch.nonzero(g["count"] != b["count"]).flatten()
    if differ.numel():
        rows = differ
        sig = torch.nan_to_num(b["sigma"][rows], posinf=0.0)
        tol = (4 * EPS32 * (row_scale(x[rows], mask[rows]) + thr[rows] * sig))[:, None]
        lo, hi = band_bracket(x[rows], mask[rows], region[rows], b["upper"][rows],
                              b["lower"][rows], mode[rows], tol)
        gc = g["count"][rows]
        check(bool(((lo < hi) & (lo <= gc) & (gc <= hi)).all()),
              f"{what}: triage_screen count differs from ma_band's away from a band edge")
    sigma_err = max_abs_err(g["sigma"], b["sigma"])
    del b
    times = []
    for _ in range(runs):
        times.append(cuda_ms(run, 1, warm=False))
    ms = float(np.median(times))
    plain_ms = cuda_ms(lambda: tr.screen_rows_plain(x, mask, region, thr, mode, mlb, margin,
                                                    TRIAGE_WINDOW), 1, warm=False)
    s_ms = sort_ms(x, mask, region, max(1, (1 << 27) // T))
    bound = triage_bound(mask, region)
    cleared = int((g["shrunk_count"] < torch.clamp(0.1 * g["checked"].float(), min=2.0)).sum())
    print(f"  triage_screen on these rows: counts equal to ma_band's on {B - differ.numel()} of {B} "
          f"rows ({differ.numel()} bracketed at a band edge), sigma equal to ma_band's bit for "
          f"bit on every row (max |d| {sigma_err:.3g}); shrunk count under the band gate on {cleared} rows; kernel "
          f"{ms:.3f} ms (median of {runs}), bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}), plain twin {plain_ms:.1f} ms, torch.sort of the history "
          f"{s_ms:.3f} ms", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "sort_ms": s_ms, **bound}


# ---------------------------------------------------------------------------
# kernels H (bivariate) and I (hpa_score) vs their twins
# ---------------------------------------------------------------------------
def adversarial_bivariate(B, T, gen):
    """Metric-pair rows on the card, twelve kinds: correlated noise with
    gaps; constant history (the ridge alone, det at its 1e-12 floor) with
    an identical or a shifted current; a perfectly correlated history
    (x2 = 2 x1 + 3: var1 var2 - cov^2 cancels to the ridge) with some current
    points off the line; one history point (fail-open); an empty region; a
    correlation break in the current window; joint shifts up and down;
    NaN at a masked history slot (it poisons the row, as x * w does in the
    reference); points planted on the ellipse's edge; all masked; a tiny
    perfectly correlated history with +inf at a valid current slot. The
    last quarter is the region; thresholds 2, 3, 5; every pair of bound
    modes; a lower floor on some rows. Returns kernels.bivariate's ten
    arguments."""
    dev = DEV
    kind = torch.arange(B, device=dev) % 12
    t = torch.arange(T, device=dev)
    region = (t >= 3 * T // 4).expand(B, T).clone()
    rho = (0.5 + 0.45 * torch.rand(B, generator=gen, device=dev))[:, None]
    z1 = torch.randn((B, T), generator=gen, device=dev)
    z2 = rho * z1 + torch.sqrt(1 - rho * rho) * torch.randn((B, T), generator=gen, device=dev)
    x1, x2 = 50 + 5 * z1, 30 + 2 * z2
    m1 = torch.rand((B, T), generator=gen, device=dev) > 0.1
    m2 = torch.rand((B, T), generator=gen, device=dev) > 0.1
    odd = (torch.arange(B, device=dev) % 24 >= 12)[:, None]
    k = (kind == 1)[:, None]
    x1 = torch.where(k, torch.where(odd & region, 61.42, 60.42), x1)
    x2 = torch.where(k, 5.0, x2)
    m1 |= k
    m2 |= k
    k = (kind == 2)[:, None]
    x2 = torch.where(k, 2 * x1 + 3 + torch.where(region & (t % 2 == 0), 20.0, 0.0), x2)
    m1[kind == 3] &= region[kind == 3] | (t == T // 3)
    region[kind == 4] = False
    k = (kind == 5)[:, None] & region
    x2 = torch.where(k, 30 - 2 * 2.5 * z1, x2)
    x1 = torch.where(k, 50 + 5 * 2.5 * z1, x1)
    x1 = torch.where((kind == 6)[:, None] & region, x1 + 30, x1)
    x2 = torch.where((kind == 6)[:, None] & region, x2 + 12, x2)
    x1 = torch.where((kind == 7)[:, None] & region, x1 - 30, x1)
    x2 = torch.where((kind == 7)[:, None] & region, x2 - 12, x2)
    hole = (kind == 8)[:, None] & (t == T // 5)
    x1, m1 = torch.where(hole, torch.nan, x1), m1 & ~hole
    m1[kind == 10] = False
    k = (kind == 11)[:, None]
    x1 = torch.where(k, 1e-5 * z1, x1)
    x2 = torch.where(k, 2 * x1, x2)
    m1 |= k & (t == T - 2)
    m2 |= k & (t == T - 2)
    x1 = torch.where(k & (t == T - 2), torch.inf, x1)
    thr = torch.tensor([2.0, 3.0, 5.0], device=dev)[torch.arange(B, device=dev) % 3]
    # points on the ellipse's edge: along x1 at radius thr from the
    # history's float64 statistics
    edge = kind == 9
    if bool(edge.any()):
        s = bivariate_stats(x1[edge], m1[edge], x2[edge], m2[edge], region[edge])
        r = thr[edge].double() * torch.sqrt(s["det"] / s["v2"])
        cols = region[edge] & (t % 3 == 0)
        x1[edge] = torch.where(cols, (s["mu1"] + r)[:, None].float(), x1[edge])
        x2[edge] = torch.where(cols, s["mu2"][:, None].float(), x2[edge])
        m1[edge] |= cols
        m2[edge] |= cols
    mlb = torch.where(torch.arange(B, device=dev) % 5 == 0, 49.0, 0.0)
    bm1 = (torch.arange(B, device=dev) % 4).to(torch.int32)
    bm2 = (torch.arange(B, device=dev) // 4 % 4).to(torch.int32)
    return (x1.contiguous(), m1.contiguous(), x2.contiguous(), m2.contiguous(),
            region.contiguous(), thr, mlb.contiguous(), (mlb * 0.5).contiguous(), bm1, bm2)


def bivariate_stats(x1, m1, x2, m2, region):
    """The pair's history statistics in float64 (masked slots skipped, not
    multiplied): n, the means, the ridged variances, cov and det."""
    w = (m1 & m2 & ~region).double()
    n = w.sum(1)
    den = n.clamp(min=1.0)
    a1 = torch.where(w > 0, x1.double(), 0.0)
    a2 = torch.where(w > 0, x2.double(), 0.0)
    mu1, mu2 = a1.sum(1) / den, a2.sum(1) / den
    d1, d2 = (a1 - mu1[:, None]) * w, (a2 - mu2[:, None]) * w
    v1, v2 = (d1 * d1).sum(1) / den, (d2 * d2).sum(1) / den
    cov = (d1 * d2).sum(1) / den
    ridge = 1e-6 * torch.clamp(torch.maximum(v1, v2), min=1.0)
    v1, v2 = v1 + ridge, v2 + ridge
    det = torch.clamp(v1 * v2 - cov * cov, min=1e-12)
    return {"n": n, "mu1": mu1, "mu2": mu2, "v1": v1, "v2": v2, "cov": cov, "det": det}


def bivariate_tolerance(args, d2, sum_eps):
    """Per slot, how far two float32 evaluations of the reference's d2 may
    lie apart, when each of their float32 sums may err by sum_eps (relative
    to the sum of magnitudes; a scalar or (B,)): 1e-4 of d2, plus the error
    of the terms that cancel in the numerator and in det (relative to det),
    plus the numerator's response (to second order) to the means moving by
    sum_eps of their scale. Large where the history is (nearly) perfectly
    correlated: there det is the ridge left after var1 var2 - cov^2 cancels.
    Returns (tolerance, float64 statistics, da, db, a, b)."""
    x1, m1, x2, m2, region = args[:5]
    s = bivariate_stats(x1, m1, x2, m2, region)
    se = torch.as_tensor(sum_eps, dtype=torch.float64, device=x1.device)
    se = (se[:, None] if se.dim() else se) + 16 * EPS32
    a = x1.double() - s["mu1"][:, None]
    b = x2.double() - s["mu2"][:, None]
    v1, v2, cov, det = (s[k][:, None] for k in ("v1", "v2", "cov", "det"))
    nabs = v2 * a * a + 2 * (cov * a * b).abs() + v1 * b * b
    da = se * (s["mu1"].abs()[:, None] + v1.sqrt()) + 2 * EPS32 * a.abs()
    db = se * (s["mu2"].abs()[:, None] + v2.sqrt()) + 2 * EPS32 * b.abs()
    dn = (2 * (v2 * a.abs() + cov.abs() * b.abs()) * da + 2 * (v1 * b.abs() + cov.abs() * a.abs())
          * db + v2 * da * da + 2 * cov.abs() * da * db + v1 * db * db)
    d = torch.nan_to_num(d2.double().abs(), nan=0.0, posinf=0.0)
    rel = 4 * se + 8 * EPS32
    tol = 1e-4 * d + (rel * nabs + dn + rel * d * (v1 * v2 + cov * cov)) / det
    return torch.nan_to_num(tol, nan=math.inf, posinf=math.inf), s, da, db, a, b


def compare_bivariate(args, kern, plain, sum_eps=16 * EPS32):
    """Kernel H against bivariate_normal_anomalies_plain: checked exact;
    d2 within bivariate_tolerance (NaN where the twin's is NaN); flags,
    count and first index exact on every row with no candidate slot within
    that tolerance of threshold^2 (nor an excursion within the means' noise
    of 0, where a bound mode's direction could flip), and counts inside
    the bracket elsewhere; the marginal bands to 1e-5 relative plus the
    means' and variances' float32 noise. sum_eps is the relative error of
    a float32 sum of the two sides (scalar or per row). Returns (largest
    band difference, rows bracketed)."""
    x1, m1, x2, m2, region, thr = args[:6]
    check(bool(torch.equal(kern["checked"], plain["checked"])), "bivariate checked differs")
    tol, s, da, db, a, b = bivariate_tolerance(args, plain["d2"], sum_eps)
    pd, kd = plain["d2"].double(), kern["d2"].double()
    check(bool((torch.isnan(kd) == torch.isnan(pd)).all()), "bivariate d2 NaN pattern differs")
    same = torch.isnan(pd) | (torch.isinf(pd) & (kd == pd))
    dd = torch.where(same, 0.0, (kd - pd).abs())
    check(bool((dd <= tol).all()), f"bivariate d2 differs beyond its tolerance "
                                   f"({float((dd - tol).max()):.3g} over)")
    cand = m1 & m2 & region & (s["n"] >= 2)[:, None]
    t2 = (thr.double() ** 2)[:, None]
    near = cand & (((pd - t2).abs() <= tol)
                   | ((pd > t2 - tol) & ((a.abs() <= da) | (b.abs() <= db))))
    exact = ~near.any(1)
    for key in ("count", "first_index"):
        check(bool((kern[key][exact] == plain[key][exact]).all()), f"bivariate {key} differs")
    check(bool((kern["flags"][exact] == plain["flags"][exact]).all()), "bivariate flags differ")
    lo = (plain["flags"] & ~near).sum(1)
    hi = (plain["flags"] | near).sum(1)
    check(bool(((lo <= kern["count"]) & (kern["count"] <= hi)).all()),
          "bivariate counts outside their bracket")
    se = torch.as_tensor(sum_eps, dtype=torch.float64, device=x1.device) + 16 * EPS32
    err = 0.0
    for key, i in (("upper1", "1"), ("lower1", "1"), ("upper2", "2"), ("lower2", "2")):
        v, mu = s["v" + i], s["mu" + i]
        dmu = se * (mu.abs() + v.sqrt())
        dvar = 4 * se * v + dmu ** 2 + 2 * dmu * v.sqrt()
        atol = (dmu + thr.double().abs() * dvar / (2 * v.sqrt())
                + 4 * EPS32 * plain[key].double().abs())
        err = max(err, close_or_same(kern[key], plain[key], 1e-5,
                                     torch.nan_to_num(atol, nan=math.inf), f"bivariate {key}"))
    return err, int((~exact).sum())


def hpa_rows_layout(T):
    """(history length, current length) of an hpa row in a bucket of T:
    1 day (or 7 at T = 16384) of 60 s history and 30 current points, or
    in a small bucket three quarters of it and a quarter cut to a multiple
    of 3."""
    if T >= 2048:
        hist = 10_080 if T >= 16384 else 1_440
        return hist, 30
    return 3 * T // 4 - 8, T // 12 * 3


def adversarial_hpa(B, T, gen):
    """HPA rows on the card: traffic at a level in [50, 500] with 3% noise
    and its one-step model (the level with 1% noise), latency at ~5 as the
    SLA metric; every sla_mode x sla_absolute pair; steady, surging (x2),
    collapsing (x0.3) and SLA-violating (latency x3) rows; and, one in 16
    each: the SLA at exactly `safe` of a static limit, at exactly the limit,
    base at exactly 50 (constant traffic), exactly a third of the region out
    of band, an empty region, one history point (sigma +inf), NaN at a
    masked slot. Returns a dict of kernel I's arguments and tps_sigma (the
    twin's residual sigma)."""
    from foremast_tpu_torch.ops import forecast as fc

    dev = DEV
    n_h, n_c = hpa_rows_layout(T)
    r = torch.arange(B, device=dev)
    t = torch.arange(T, device=dev)
    region = ((t >= n_h) & (t < n_h + n_c)).expand(B, T).clone()
    valid = t < n_h + n_c
    level = (50 + 450 * torch.rand(B, generator=gen, device=dev))[:, None]
    cls = (r // 6 % 4)[:, None]
    factor = torch.where(cls == 1, 2.0, torch.where(cls == 2, 0.3, 1.0))
    tps = level * (1 + 0.03 * torch.randn((B, T), generator=gen, device=dev))
    tps = torch.where(region, tps * factor, tps)
    pred = level * (1 + 0.01 * torch.randn((B, T), generator=gen, device=dev))
    sla = 5 + 0.3 * torch.randn((B, T), generator=gen, device=dev)
    sla = torch.where(region & (cls == 3), sla * 3, sla)
    tm = valid & (torch.rand((B, T), generator=gen, device=dev) > 0.05)
    sm = valid & (torch.rand((B, T), generator=gen, device=dev) > 0.05)
    mode = (r % 3).to(torch.int32)
    absolute = r // 3 % 2 == 0
    limit = torch.where(absolute, torch.tensor([6.0, 50.0], device=dev)[r % 2],
                        torch.tensor([1.5, 3.0], device=dev)[r % 2])
    safe = torch.where(r % 7 == 0, 0.5, 0.7)
    special = r % 16
    for s_, lim_frac in ((0, 0.7), (1, 1.0)):  # h at safe, h at 1
        k = special == s_
        mode[k], absolute[k], limit[k], safe[k] = 0, True, 10.0, 0.7
        sla[k] = torch.where(region[k], float(np.float32(10.0) * np.float32(lim_frac)), sla[k])
        sm[k] |= region[k]
    k = special == 2  # base at 50: constant traffic and model
    tps[k], pred[k] = 100.0, 100.0
    tm[k] = valid
    k = special == 3  # exactly a third of the region out of band
    rows = torch.nonzero(k).flatten()
    tps[rows] = torch.where(region[rows], pred[rows], tps[rows])
    tm[rows] |= region[rows]
    out_cols = region[0] & ((t - n_h) % 3 == 0)
    tps[rows[:, None], torch.nonzero(out_cols).flatten()[None, :]] += 1e4
    region[special == 4] = False
    k = special == 5  # one history point
    tm[k] &= region[k] | (t == n_h // 2)
    hole = (special == 6)[:, None] & (t == n_h // 3)
    tps = torch.where(hole, torch.nan, torch.where(valid, tps, 0.0))
    tm &= ~hole
    a = {"tps": tps.contiguous(), "tps_mask": tm.contiguous(), "region": region.contiguous(),
         "tps_pred": pred.contiguous(), "sla": sla.contiguous(), "sla_mask": sm.contiguous(),
         "sla_static_limit": limit.contiguous(), "sla_mode": mode,
         "threshold": torch.full((B,), 3.0, device=dev), "safe": safe.contiguous(),
         "pods_now": torch.tensor([1.0, 4.0, 8.0], device=dev)[r % 3],
         "pods_hist": torch.full((B,), 4.0, device=dev), "sla_absolute": absolute.contiguous()}
    hist = a["tps_mask"] & ~a["region"]
    a["tps_sigma"] = fc.residual_sigma(a["tps"], a["tps_pred"], hist, ~a["region"])
    return a


def hpa_edge_rows(B, T, gen):
    """adversarial_hpa's rows with non-finite and extreme values where
    kernel I's passes treat slots apart, one row in 16 each: NaN at a valid
    history slot, +inf at a valid region slot, tps of -1e36 over the region
    with 3.4e38 at the first history slot (x - xm overflows outside the
    selection: the slope, and the anomaly trend's demand, are NaN), NaN at a
    padding slot after the current window. tps_sigma is the twin's residual
    sigma of the edited rows, 1 on the overflowing ones (theirs is +inf,
    which would leave every point in band)."""
    from foremast_tpu_torch.ops import forecast as fc

    a = adversarial_hpa(B, T, gen)
    n_h, n_c = hpa_rows_layout(T)
    r = torch.arange(B, device=a["tps"].device)
    tps, tm, region = a["tps"], a["tps_mask"], a["region"]
    for k, (slot, value) in ((7, (n_h // 2, math.nan)), (8, (n_h + 1, math.inf))):
        rows = r[r % 16 == k]
        tps[rows, slot], tm[rows, slot] = value, True
    rows = r[r % 16 == 9]
    tps[rows] = torch.where(region[rows], -1e36, tps[rows])
    tps[rows, 0], tm[rows, 0] = 3.4e38, True
    if n_h + n_c < T:
        tps[r[r % 16 == 10], T - 1] = math.nan
        tm[r[r % 16 == 10], T - 1] = False
    sigma = fc.residual_sigma(tps, a["tps_pred"], tm & ~region, ~region)
    a["tps_sigma"] = torch.where(r % 16 == 9, 1.0, sigma)
    return a


HPA_SERIES = ("tps", "tps_mask", "region", "tps_pred", "sla", "sla_mask", "sla_static_limit",
              "sla_mode", "threshold")
HPA_OPTIONAL = ("safe", "pods_now", "pods_hist", "sla_absolute")


def hpa_series(a):
    """kernels.hpa_score's nine positional arguments from an hpa dict."""
    return tuple(a[k] for k in HPA_SERIES)


def hpa_edges(a, plain, with_optional):
    """Rows whose reason could flip on float32 noise: a checked slot within
    noise of a band edge where that moves n_out * 3 across max(checked, 1);
    sla_current within 1e-5 of the limit; base within 1e-4 of 50 or w
    within 1e-5 of 1 (scale-down suppression)."""
    tps, tm, region, pred = a["tps"], a["tps_mask"], a["region"], a["tps_pred"]
    sigma = plain.get("tps_sigma", a["tps_sigma"]).double()
    w = a["threshold"].double() * sigma
    sel = tm & region
    x, p = tps.double(), pred.double()
    tol = (4 * EPS32 * (x.abs() + p.abs() + torch.nan_to_num(w, posinf=0.0)[:, None])
           + 1e-5 * torch.nan_to_num(w, posinf=0.0)[:, None])
    up, lo = p + w[:, None], p - w[:, None]
    sure = sel & ((x > up + tol) | (x < lo - tol))
    maybe = sel & ((x > up - tol) | (x < lo + tol))
    nc = sel.sum(1).clamp(min=1)
    flip = (sure.sum(1) * 3 >= nc) != (maybe.sum(1) * 3 >= nc)
    cur, lim = plain["sla_current"].double(), plain["sla_limit"].double()
    viol = (cur - lim).abs() <= 1e-5 * (cur.abs() + lim.abs()) + 1e-6
    hist = tm & ~region
    prov = (torch.where(hist, x, 0.0).sum(1) / hist.sum(1).clamp(min=1))
    ph = a["pods_hist"].double().clamp(min=1e-6) if with_optional else 1.0
    base = 50 * plain["demand_per_pod"].double() / (prov / ph).clamp(min=1e-6)
    safe = a["safe"].double() if with_optional else torch.full_like(cur, 0.7)
    h = cur / lim.clamp(min=1e-9)
    ww = (1 - h) / torch.clamp(1 - safe, min=1e-6)
    supp = ((base - 50).abs() <= 1e-4 * 50) | ((ww - 1).abs() <= 1e-5)
    return flip | viol | supp


def compare_hpa(a, kern, with_sigma, with_optional=True, plain=None):
    """Kernel I against its twin (hpa_scores_plain with the given sigma, or
    hpa_from_preds_plain): NaN patterns equal everywhere; reason and score
    (to 1e-3) exact but on rows hpa_edges brackets; the means (current and
    predicted traffic, the band means, sla_current, sla_limit, pods_now,
    sigma) to 1e-5 relative plus 4 eps32 of the row's scale; demand and
    demand per pod, which carry the slope, to 1e-4 relative. `plain`, when
    given, stands for the twin (the reference's outputs, in the CPU tests).
    Returns ({output: largest difference}, rows bracketed)."""
    from foremast_tpu_torch.ops import hpa as hp

    opt = [a[k] for k in HPA_OPTIONAL] if with_optional else [None] * 4
    if plain is not None:
        pass
    elif with_sigma:
        s = hpa_series(a)
        plain = hp.hpa_scores_plain(*s[:4], a["tps_sigma"], *s[4:], *opt)
    else:
        plain = hp.hpa_from_preds_plain(*hpa_series(a), *opt)
    edge = hpa_edges(a, plain, with_optional)
    ok = ~edge
    check(bool(torch.equal(kern["reason"][ok], plain["reason"][ok])), "hpa_score reason differs")
    errs = {"score": close_or_same(kern["score"][ok], plain["score"][ok], 0.0,
                                   torch.full_like(plain["score"][ok], 1e-3), "hpa_score score")}
    scale = torch.maximum(row_scale(a["tps"], a["tps_mask"]), row_scale(a["sla"], a["sla_mask"]))
    for key in ("current_tps", "tps_pred", "tps_upper", "tps_lower", "sla_current", "sla_limit",
                "pods_now", "tps_sigma"):
        if key in kern:
            want = plain[key] if key in plain else a["tps_sigma"]
            errs[key] = close_or_same(kern[key], want, 1e-5, 4 * EPS32 * scale,
                                      f"hpa_score {key}")
    for key in ("demand", "demand_per_pod"):
        errs[key] = close_or_same(kern[key][ok], plain[key][ok], 1e-4, 1e-4 * scale[ok],
                                  f"hpa_score {key}")
    return errs, int(edge.sum())


HI_CHECK = ((128, 1536), (1024, 1536), (2048, 1536), (16384, 384))  # (T, rows)


# kernel H's path boundary (BI_SLICE_T = 4096: one CTA, then a cluster of
# two), and a T that is no multiple of 16 (a slot at a time)
BI_PATH_CHECK = ((4096, 512), (4112, 512), (4100, 256))


def bivariate_paths_vs_twin(B, T, gen):
    """Kernel H on each path forced (the cta path where one CTA holds the
    row, the cluster path always), each against the twin, the optional
    arguments given and left out. Returns (largest band difference, rows
    bracketed on each path)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import bivariate as bv

    args = adversarial_bivariate(B, T, gen)
    err, brk = 0.0, {}
    for path in kernels.BIVARIATE_PATHS:
        if path == "cta" and kernels.bivariate_smem_bytes(T, 1) > kernels.CTA_SMEM_BYTES:
            continue
        kernels.BIVARIATE_FORCE = path
        try:
            for a in (args, args[:6]):
                e, b = compare_bivariate(a, kernels.bivariate(*a),
                                         bv.bivariate_normal_anomalies_plain(*a))
                err = max(err, e)
                brk.setdefault(path, []).append(b)
        finally:
            kernels.BIVARIATE_FORCE = None
    return err, brk


def kernels_h_i_vs_twin(gen):
    """Kernels H and I against their twins on adversarial rows at T in
    {128, 1024, 2048, 16384}, the optional arguments given and left out, H
    on each of its paths (and at BI_PATH_CHECK's T); I also on
    hpa_edge_rows at each T, both entries."""
    from foremast_tpu_torch import kernels

    for T, B in HI_CHECK + BI_PATH_CHECK:
        err, brk = bivariate_paths_vs_twin(B, T, gen)
        torch.cuda.synchronize()
        print(f"  bivariate T={T} (path {kernels.bivariate_path(T)}, "
              f"{kernels.bivariate_cluster(T)} CTA a row): max |d band| {err:.3g}; rows of {B} "
              f"bracketed at the ellipse's edge on each path forced (optional arguments given, "
              f"left out): {brk}", flush=True)
        if (T, B) not in HI_CHECK:
            continue
        a = adversarial_hpa(B, T, gen)
        worst, brk = {}, []
        for sigma in (True, False):
            for optional in (True, False):
                kw = {k: a[k] for k in HPA_OPTIONAL} if optional else {}
                if sigma:
                    kw["tps_sigma"] = a["tps_sigma"]
                errs, b = compare_hpa(a, kernels.hpa_score(*hpa_series(a), **kw), sigma,
                                      optional)
                brk.append(b)
                for k, v in errs.items():
                    worst[k] = max(worst.get(k, 0.0), v)
        e = hpa_edge_rows(256 if T < 16384 else 64, T, gen)
        for sigma in (True, False):
            kw = {k: e[k] for k in HPA_OPTIONAL}
            if sigma:
                kw["tps_sigma"] = e["tps_sigma"]
            errs, b = compare_hpa(e, kernels.hpa_score(*hpa_series(e), **kw), sigma)
            brk.append(b)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
        torch.cuda.synchronize()
        print(f"  hpa_score T={T}: max |d| " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
              + f"; rows bracketed at a decision edge {brk} of {B} (sigma given / computed, "
              f"optional arguments given / left out; then of {e['tps'].shape[0]} edge rows, sigma "
              f"given / computed)", flush=True)


# ---------------------------------------------------------------------------
# kernels J and K vs their twins
# ---------------------------------------------------------------------------
ST_ORDER, ST_CHANGEPOINTS = 3, 12  # EngineConfig.st_order, st_changepoints
ST_CHECK = ((128, 1024), (2048, 1024), (16384, 256))  # (T, rows)
LSTM_W = 32  # EngineConfig.lstm_window
LSTM_WIDTHS = ((3, 32, 16), (4, 32, 16), (8, 32, 16), (4, 128, 64))  # (F, H, Z)
LSTM_CHECK_JOBS = 256
LSTM_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                            "lstm_ae_ref.npz")


def adversarial_st(B, T, gen):
    """Seasonal-trend rows on the card, nine kinds: a cycle with a trend and
    gaps, no valid point, one point, constant, a kinked trend, a long gap,
    history shorter than one period, NaN and +inf at masked slots, a 2-step
    cycle. Periods from the engine's candidates, the fallback
    min(1440, T // 2) and 2; the fit (the history) is the first 7/8 of the
    slots. Returns (x, mask, fit, period)."""
    dev = DEV
    kind = torch.arange(B, device=dev) % 9
    t = torch.arange(T, device=dev, dtype=torch.float32)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    choices = torch.tensor(PERIOD_CANDIDATES + (min(1440, T // 2), 2), dtype=torch.int32,
                           device=dev)
    period = choices[torch.randint(0, len(choices), (B,), generator=gen, device=dev)]
    period = torch.where(kind == 8, 2, period).to(torch.int32)
    level = 20 + 80 * u(B, 1)
    sigma = level / 20
    x = (level + sigma * torch.randn((B, T), generator=gen, device=dev)
         + 3 * sigma * torch.sin(2 * math.pi * t / period[:, None] + 6 * u(B, 1))
         + (u(B, 1) - 0.5) * 4 * sigma * t / T)
    x = x + torch.where((kind == 4)[:, None] & (t > T / 2), 8 * sigma * (t - T / 2) / T, 0.0)
    m = u(B, T) > 0.05
    m[kind == 1] = False
    m[kind == 2] = t == T // 3
    x[kind == 3] = 42.5
    m[kind == 5] &= (t < T / 4) | (t > T / 2)
    m &= ~((kind == 6)[:, None] & (t >= torch.clamp(period[:, None] // 2, min=2)))
    hole = ~m & (kind == 7)[:, None]
    x = torch.where(hole, torch.where(u(B, T) < 0.5, torch.nan, torch.inf), x)
    fit = (t < T - T // 8).expand(B, T).contiguous()
    return x.contiguous(), m.contiguous(), fit, period.contiguous()


def st_ill_posed(sel, period, D):
    """Rows whose fit rests on the ridge alone: fewer fitted points than
    columns, or fitted points spanning less than one period."""
    T = sel.shape[1]
    t = torch.arange(T, device=sel.device)
    first = torch.where(sel, t, T).amin(1)
    last = torch.where(sel, t, -1).amax(1)
    return (sel.sum(1) < D) | (last - first + 1 < period)


def compare_st_fit(args, kern, plain, D):
    """Kernel J against its twin: both sum the normal equations in float64
    from the same float32 columns and solve them by float64 Cholesky, in
    other orders. preds within 1e-5 of the row's scale, beta within 1e-4
    of the row's largest |beta| (+1), on well-posed rows; preds within 1e-3
    of the scale on ill-posed ones (st_ill_posed: condition numbers up to
    ~1e9 turn float64 rounding, or an ulp of a sine where two math
    libraries differ, into that). Returns (largest preds difference,
    ill-posed rows)."""
    x, m, fit, period = args
    (kb, kp), (pb, pp) = kern, plain
    check(bool(torch.isfinite(kp).all()), "st_fit preds not finite")
    ill = st_ill_posed(m & fit, period, D)
    scale = row_scale(x, m)
    d = (kp.double() - pp.double()).abs().amax(1) / scale
    check(bool((d[~ill] <= 1e-5).all()), f"st_fit preds differ by {float(d[~ill].max()):.3g} "
                                         f"of the row's scale")
    if bool(ill.any()):
        check(bool((d[ill] <= 1e-3).all()), f"st_fit preds differ by {float(d[ill].max()):.3g} "
                                            f"of the scale on an ill-posed row")
    db = (kb.double() - pb.double()).abs().amax(1) / (pb.double().abs().amax(1) + 1.0)
    check(bool((db[~ill] <= 1e-4).all()), f"st_fit beta differs by {float(db[~ill].max()):.3g}")
    return max_abs_err(kp, pp), int(ill.sum())


ST_WIDEST_C = 24  # with ST_ORDER, D = 32 = kernels.WARP_ST_D
# past the warp path's 32 columns, kernel J's cta path, (C, order): D = 33
# (ST_CHANGEPOINTS=25 at the engine's ST_ORDER), 47 (Prophet's published
# defaults, n_changepoints=25 and yearly order 10), 64 and 160 (the gram in
# device scratch)
ST_WIDE_CHECK = ((25, ST_ORDER), (25, 10), (40, 11), (150, 4))
ST_PROPHET_C, ST_PROPHET_ORDER = 25, 10


def st_wide_vs_twin():
    """Kernel J's cta path at ST_WIDE_CHECK's widths on 256 adversarial
    rows of T = 2048 (a generator of its own: the later checks' rows do not
    depend on it), each launched once on that path, against the twin; two
    runs equal bit for bit."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    T, B = 2048, 256
    args = adversarial_st(B, T, torch.Generator(device=DEV).manual_seed(SEED + 18))
    line = []
    for C, order in ST_WIDE_CHECK:
        D = 2 + C + 2 * order
        kernels.reset_launches()
        kern = kernels.st_fit(*args, order, C, 1e-4, 3e-3, 3)
        check(kernels.st_path_launches == {"warp": 0, "cta": 1},
              f"st_fit at D = {D}: launches by path {kernels.st_path_launches}")
        err, ill = compare_st_fit(args, kern, fc.fit_seasonal_trend_plain(
            *args, order, 1e-4, C, 3e-3, 3), D)
        again = kernels.st_fit(*args, order, C, 1e-4, 3e-3, 3)
        check(torch.equal(kern[0], again[0]) and torch.equal(kern[1], again[1]),
              f"st_fit at D = {D}: two runs differ")
        line.append(f"D={D} {err:.3g} ({ill} ill-posed)")
    torch.cuda.synchronize()
    print(f"  st_fit's cta path, {B} rows x {T}: max |d preds| against the twin "
          + ", ".join(line) + "; two runs equal bit for bit", flush=True)


def kernel_j_vs_twin(gen):
    """Kernel J against its twin on adversarial rows at T in {128, 2048,
    16384}, without and with the engine's 12 hinge columns and at the
    widest D (24 hinges); two runs equal bit for bit. First, the premise of
    its Fourier columns: the card's sincosf gives sinf's and cosf's bits on
    every float32 argument."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    st_wide_vs_twin()
    bad = kernels.st_sincos_check()
    check(bad == 0, f"sincosf differs from sinf / cosf at {bad} float32 arguments")
    print(f"  sincosf against sinf and cosf on all 2^32 float32 arguments: {bad} differ "
          f"(the premise of kernel J's Fourier pairs)", flush=True)
    for T, B in ST_CHECK:
        args = adversarial_st(B, T, gen)
        line = []
        for C in (0, ST_CHANGEPOINTS, ST_WIDEST_C):
            D = 2 + C + 2 * ST_ORDER
            kern = kernels.st_fit(*args, ST_ORDER, C, 1e-4, 3e-3, 3)
            plain = fc.fit_seasonal_trend_plain(*args, ST_ORDER, 1e-4, C, 3e-3, 3)
            err, ill = compare_st_fit(args, kern, plain, D)
            again = kernels.st_fit(*args, ST_ORDER, C, 1e-4, 3e-3, 3)
            check(torch.equal(kern[0], again[0]) and torch.equal(kern[1], again[1]),
                  f"st_fit T={T} C={C}: two runs differ")
            line.append(f"C={C} (D={D}): max |d preds| {err:.3g}, {ill} of {B} rows ill-posed")
        torch.cuda.synchronize()
        print(f"  st_fit T={T}: " + "; ".join(line) + "; two runs equal bit for bit",
              flush=True)


def lstm_params(J, F, H, Z, gen):
    """(J, P) parameters at flax's initial scales: input kernels N(0, 1 /
    fan_in), recurrent kernels N(0, 1 / H) (flax: orthogonal), biases
    N(0, 0.1^2) (flax: zeros), in the flat layout."""
    from foremast_tpu_torch.models import lstm_ae as tl

    shapes = tl.param_shapes(F, H, Z)
    out = torch.empty((J, sum(math.prod(s) for s in shapes.values())), device=DEV)
    at = 0
    for name, shape in shapes.items():
        fan = shape[0] if len(shape) == 2 else 100.0
        n = math.prod(shape)
        # one part drawn at a time, into its columns: the rows of H = 320
        # (37 GB at 10,000 jobs) are never held twice
        out[:, at:at + n] = torch.randn((J, n), generator=gen, device=DEV).div_(math.sqrt(fan))
        at += n
    return out


def adversarial_lstm(J, K, F, H, Z, gen):
    """J jobs of K windows (W = 32) on the card: values N(0, 1), 10% gaps,
    every fifth job's first window fully masked, every job's second window
    with a masked head (the engine's tail window); mu in [0, 0.5], sigma in
    [0.05, 1.05]. Returns (params, x, mask, mu, sigma)."""
    dev = DEV
    x = torch.randn((J, K, LSTM_W, F), generator=gen, device=dev)
    m = torch.rand((J, K, LSTM_W, F), generator=gen, device=dev) > 0.1
    m[::5, 0] = False
    m[:, 1, :LSTM_W // 4] = False
    mu = 0.5 * torch.rand(J, generator=gen, device=dev)
    sigma = 0.05 + torch.rand(J, generator=gen, device=dev)
    return lstm_params(J, F, H, Z, gen), x.contiguous(), m.contiguous(), mu, sigma


def compare_lstm(kern, plain, sigma):
    """Kernel K against its twin: float32 products summed in other orders
    through 2W recurrent steps, the error sums in float64 (the twin's in
    float32). err within 1e-4 relative (+1e-7), z within that over sigma
    plus 1e-5 relative. Returns the largest |d err|."""
    (ke, kz), (pe, pz) = kern, plain
    check(bool(torch.isfinite(ke).all() and torch.isfinite(kz).all()), "lstm_ae not finite")
    de = (ke.double() - pe.double()).abs()
    lim = 1e-4 * pe.double().abs() + 1e-7
    check(bool((de <= lim).all()), f"lstm_ae errors differ by {float(de.max()):.3g}")
    dz = (kz.double() - pz.double()).abs()
    check(bool((dz <= lim / sigma.double()[:, None] + 1e-5 * (pz.double().abs() + 1)).all()),
          f"lstm_ae z differs by {float(dz.max()):.3g}")
    return float(de.max())


def lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma):
    """Kernel K on every path that serves the shape (kernels.LSTM_AE_FORCE),
    each against the twin (compare_lstm) and all equal to the wide path's
    (the first design) bit for bit; a fully masked window scores 0. Returns
    (the largest |d err| against the twin, the paths that ran)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    K, W, F = x.shape[1], x.shape[2], x.shape[3]
    plain = tl.reconstruction_errors_plain(p, x, m, H, Z, mu, sigma)
    empty = ~m.flatten(2).any(2)
    outs, err = {}, 0.0
    for path in kernels.LSTM_AE_PATHS:
        if not kernels.lstm_ae_serves(path, K, F, H, Z, W):
            continue
        saved, kernels.LSTM_AE_FORCE = kernels.LSTM_AE_FORCE, path
        try:
            out = kernels.lstm_ae(p, x, m, H, Z, mu, sigma)
        finally:
            kernels.LSTM_AE_FORCE = saved
        err = max(err, compare_lstm(out, plain, sigma))
        check(bool((out[0][empty] == 0).all()), f"lstm_ae {path} path: a fully masked window "
                                                f"did not score 0")
        outs[path] = out
    for path, out in outs.items():
        check(all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(out, outs["wide"])),
              f"lstm_ae: the {path} path differs from the wide path's bits at K={K} W={W} "
              f"F={F} H={H} Z={Z}")
    return err, tuple(outs)


# kernel K's path checks beyond LSTM_WIDTHS at K = 6: a job of many windows
# (J = 1, the warp path's chunks), the scoring pass's K = 2 and K = 1, the
# normalizer's K = 45, a width whose slots are not whole float4s (H = 10),
# one that takes two windows a warp group (F = 9), one the warp path cannot
# take (F = 17), the widest (H = Z = 256: a cluster of eight CTAs) and
# clusters of three CTAs with rows past a column's 64 in registers (H = 72;
# H = 65, an odd one)
LSTM_AE_PATH_CASES = ((1, 3000, 4, 32, 16), (64, 2, 4, 32, 16), (64, 1, 4, 32, 16),
                      (32, 45, 4, 32, 16), (64, 5, 2, 10, 6), (32, 3, 9, 32, 16),
                      (32, 3, 17, 32, 16), (16, 2, 4, 256, 256), (16, 7, 3, 72, 8),
                      (16, 3, 3, 65, 8))  # (J, K, F, H, Z)


def kernel_k_vs_twin(gen):
    """Kernel K against its twin at (F, H, Z) in LSTM_WIDTHS, W = 32, on
    adversarial windows (gaps, a fully masked window, a masked head), each
    path that serves a shape against the twin and the paths against one
    another bit for bit, at those widths and at LSTM_AE_PATH_CASES."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    for F, H, Z in LSTM_WIDTHS:
        J, K = LSTM_CHECK_JOBS, 6
        p, x, m, mu, sigma = adversarial_lstm(J, K, F, H, Z, gen)
        err = compare_lstm(kernels.lstm_ae(p, x, m, H, Z, mu, sigma),
                           tl.reconstruction_errors_plain(p, x, m, H, Z, mu, sigma), sigma)
        empty = m[::5, 0].flatten(1).any(1).logical_not()
        check(bool((kernels.lstm_ae(p, x, m, H, Z)[::5, 0][empty] == 0).all()),
              "a fully masked window did not score 0")
        e, paths = lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma)
        torch.cuda.synchronize()
        print(f"  lstm_ae F={F} H={H} Z={Z} ({tl.param_count(F, H, Z)} parameters a job): {J} "
              f"jobs x {K} windows, max |d err| {max(err, e):.3g}; {kernels.lstm_ae_path(K, F, H, Z)} "
              f"path; paths {', '.join(paths)} equal bit for bit", flush=True)
    for J, K, F, H, Z in LSTM_AE_PATH_CASES:
        p, x, m, mu, sigma = adversarial_lstm(J, max(K, 2), F, H, Z, gen)
        x, m = x[:, :K].contiguous(), m[:, :K].contiguous()
        e, paths = lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma)
        torch.cuda.synchronize()
        print(f"  lstm_ae J={J} K={K} F={F} H={H} Z={Z}: max |d err| {e:.3g}; paths "
              f"{', '.join(paths)} equal bit for bit", flush=True)
    # past 32 metrics a job and 256 units: the wide path alone serves (its
    # head over chunks of features); a generator of its own
    lgen = torch.Generator(device=DEV).manual_seed(SEED + 182)
    for J, K, F, H, Z in LSTM_LIMIT_CASES:
        p, x, m, mu, sigma = adversarial_lstm(J, K, F, H, Z, lgen)
        e, paths = lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma)
        check(paths == ("wide",), f"lstm_ae at F={F} H={H}: paths {paths}, not the wide alone")
        torch.cuda.synchronize()
        print(f"  lstm_ae past the first design's limits J={J} K={K} F={F} H={H} Z={Z}: max "
              f"|d err| {e:.3g} on the wide path", flush=True)


# (J, K, F, H, Z) past 32 metrics a job and 256 units
LSTM_LIMIT_CASES = ((64, 6, 33, 32, 16), (64, 6, 40, 32, 16), (16, 4, 4, 257, 16),
                    (16, 4, 4, 320, 64))
LSTM_TRAIN_WS = (8, 32)  # window lengths of kernel L's check
# kernel L's widths: K's, one whose slots are not whole float4s (H = 10:
# the GEMM's scalar staging) and the widest its launchers take (H = Z = 256)
LSTM_TRAIN_WIDTHS = LSTM_WIDTHS + ((2, 10, 6), (4, 256, 256))
LSTM_TRAIN_CHECK_JOBS = 64
LSTM_TRAIN_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                                  "lstm_ae_train_ref.npz")


def adversarial_lstm_train(J, K, W, F, H, Z, gen):
    """J jobs of K >= 2 windows of W steps on the card: values N(0, 1), 10%
    gaps, job 0's first window fully masked, every job's second window with
    a masked head (the engine's tail window), job 1's first slot masked and
    NaN (the encoder reads x as given, so its loss and gradient are NaN on
    both sides, and only its own); parameters at flax's initial scales.
    Returns (params, x, mask)."""
    x = torch.randn((J, K, W, F), generator=gen, device=DEV)
    m = torch.rand((J, K, W, F), generator=gen, device=DEV) > 0.1
    m[0, 0] = False
    m[:, 1, :max(W // 4, 1)] = False
    m[1, 0, 0, 0] = False
    x[1, 0, 0, 0] = float("nan")
    return lstm_params(J, F, H, Z, gen), x.contiguous(), m.contiguous()


def compare_lstm_train(kern, plain):
    """Kernel L's (loss, gradient) against torch autograd through the twin:
    float32 products summed in other orders through 2W recurrent steps
    forward and back, the loss's sums in float64 (the twin's in float32).
    A job whose loss is NaN on one side is NaN on the other, and a job whose
    gradient is not finite on one side is not on the other (a NaN input
    under the mask leaves the loss finite but, 0 x NaN, not the gradient);
    elsewhere the loss within 1e-5 relative and each job's gradient within
    1e-4 of its largest entry. Returns the largest |d grad|."""
    (kl, kg), (pl, pg) = kern, plain
    nan = torch.isnan(pl)
    check(bool((torch.isnan(kl) == nan).all()), "lstm_train loss: NaN jobs differ")
    bad = ~torch.isfinite(pg).all(1)
    check(bool(((~torch.isfinite(kg).all(1)) == bad).all()),
          "lstm_train gradient: the jobs that are not finite differ from the twin's")
    dl = (kl[~nan].double() - pl[~nan].double()).abs()
    check(bool((dl <= 1e-5 * pl[~nan].double().abs() + 1e-7).all()),
          f"lstm_train loss differs by {float(dl.max()):.3g}")
    ok = ~(nan | bad)
    dg = (kg[ok].double() - pg[ok].double()).abs()
    lim = 1e-4 * pg[ok].double().abs().amax(1, keepdim=True) + 1e-9
    check(bool((dg <= lim).all()), f"lstm_train gradient differs by {float(dg.max()):.3g} "
                                   f"(relative {float((dg / lim).max() * 1e-4):.3g})")
    return float(dg.max())


def same_or_both_nan(a, b):
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def compare_adam(params, mu, nu, step, gpart, num, cnt):
    """Kernel M against the written-out Adam (reduce_partials_plain, then
    adam_plain) on the same gradient blocks (J, NG, P) and the forward's
    count blocks (J, NC): bit for bit (NaN where the other is NaN). Both sum
    the blocks in order and round every operation once in float32 (IEEE
    division, a correctly rounded square root, b^t in float64); nothing is
    contracted. Returns the largest |d| (0)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    k = [t.clone() for t in (params, mu, nu)]
    loss = kernels.adam(*k, step, gpart, num, cnt, tl.LEARNING_RATE, tl.ADAM_B1, tl.ADAM_B2,
                        tl.ADAM_EPS)
    p = [t.clone() for t in (params, mu, nu)]
    tl.adam_plain(*p[:1], tl.reduce_partials_plain(gpart, cnt), *p[1:], step)
    want = num.sum(1).float() / cnt.sum(1).float().clamp(min=1.0)
    for name, a, b in (("params", k[0], p[0]), ("mu", k[1], p[1]), ("nu", k[2], p[2]),
                       ("loss", loss, want)):
        check(same_or_both_nan(a, b), f"adam: {name} differs from the written-out Adam by "
                                      f"{max_abs_err(a, b):.3g}")
    return max(max_abs_err(a, b) for a, b in zip(k, p))


def lstm_backward_twice(p, x, m, act, H, Z):
    """Kernel L's backward run twice on copies of the same activations (the
    recurrence entry overwrites them): the two gradients, which must be
    equal bit for bit (no atomics, fixed summation orders)."""
    from foremast_tpu_torch import kernels

    g1 = kernels.lstm_train_backward(p, x, m, act.clone(), H, Z)
    g2 = kernels.lstm_train_backward(p, x, m, act.clone(), H, Z)
    check(torch.equal(g1.view(torch.int32), g2.view(torch.int32)),
          "lstm_train_backward: two runs on the same inputs differ")
    return g1


def compare_lstm_wgrad(p, x, m, act, H, Z):
    """Kernel L's weight-gradient entry against its twin (wgrad_plain) on
    what the recurrence entry leaves from a copy of act: a job has a NaN on
    one side if and only if on the other (the adversarial NaN job);
    elsewhere each job's row within 1e-4 of its largest entry (float32 sums
    over the K W rows in another order). Returns the largest |d|."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    a = act.clone()
    rec = kernels.lstm_train_recurrence(p, x, m, a, H, Z)
    got = kernels.lstm_train_wgrad(p, x, m, a, rec, H, Z)[:, 0]
    want = tl.wgrad_plain(a, rec, x.shape[-1], H, Z)[:, 0]
    nan = torch.isnan(want).any(1)
    check(bool((torch.isnan(got).any(1) == nan).all()), "lstm_train_wgrad: NaN jobs differ "
                                                         "from its twin's")
    ok = ~nan
    d = (got[ok].double() - want[ok].double()).abs()
    lim = 1e-4 * want[ok].double().abs().amax(1, keepdim=True) + 1e-9
    check(bool((d <= lim).all()), f"lstm_train_wgrad differs from its twin by "
                                  f"{float(d.max()):.3g}")
    return float(d.max()) if d.numel() else 0.0


def lstm_forward_paths_agree(p, x, m, H, Z, out):
    """Kernel L's forward `out` (num, cnt, act) against its wide path's (8
    windows a CTA) on the same inputs, bit for bit. Says which path `out`
    came from."""
    from foremast_tpu_torch import kernels

    saved = kernels.LSTM_FORWARD_SMEM_BYTES
    kernels.LSTM_FORWARD_SMEM_BYTES = 0
    try:
        wide = kernels.lstm_train_forward(p, x, m, H, Z)
    finally:
        kernels.LSTM_FORWARD_SMEM_BYTES = saved
    for name, a, b in zip(("num", "cnt", "act"), out, wide):
        check(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
              f"lstm_train_forward: {name} differs from the wide path's")
    path = kernels.lstm_train_forward_path(x.shape[1], x.shape[3], H, Z)
    return "tile path, equal to the wide path bit for bit" if path == "tile" else "wide path"


def kernels_l_m_vs_twin(gen):
    """Kernel L against torch autograd through the twin at (F, H, Z) in
    LSTM_TRAIN_WIDTHS and W in LSTM_TRAIN_WS on adversarial windows (K = 11:
    two forward window blocks a job, and no whole number of the recurrence
    entry's window blocks; from H = 128 the recurrent weights are read from
    device memory; at H = 10 the GEMM stages its rows by 4-byte copies); two
    backward runs equal bit for bit; L's weight-gradient entry against its
    twin; kernel M against the written-out Adam on L's one-block gradient
    and the forward's two count blocks."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    for F, H, Z in LSTM_TRAIN_WIDTHS:
        for W in LSTM_TRAIN_WS:
            J, K = LSTM_TRAIN_CHECK_JOBS, 11
            p, x, m = adversarial_lstm_train(J, K, W, F, H, Z, gen)
            kern = tl.loss_and_grad(p, x, m, hidden=H, latent=Z, device=DEV)
            with torch.enable_grad():
                q = p.clone().requires_grad_(True)
                pl = tl.loss_plain(q, x, m, H, Z)
                pg, = torch.autograd.grad(pl.sum(), q)
            g_err = compare_lstm_train(kern, (pl.detach(), pg))
            num, cnt, act = kernels.lstm_train_forward(p, x, m, H, Z)
            path = lstm_forward_paths_agree(p, x, m, H, Z, (num, cnt, act))
            w_err = compare_lstm_wgrad(p, x, m, act, H, Z)
            gpart = lstm_backward_twice(p, x, m, act, H, Z)
            step = torch.randint(1, 40, (J,), generator=gen, device=DEV, dtype=torch.int32)
            mu = 1e-3 * torch.randn(p.shape, generator=gen, device=DEV)
            nu = 1e-6 * torch.rand(p.shape, generator=gen, device=DEV)
            compare_adam(p, mu, nu, step, gpart, num, cnt)
            torch.cuda.synchronize()
            print(f"  lstm_train F={F} H={H} Z={Z} W={W}: {J} jobs x {K} windows (recurrence "
                  f"blocks of {kernels.lstm_bptt_blocks(K, H)[0]}; forward {path}), max |d "
                  f"grad| {g_err:.3g}, loss NaN on the NaN job on both sides; weight-gradient entry against its "
                  f"twin {w_err:.3g}; two backward runs equal bit for bit; adam bit for bit",
                  flush=True)
    # past 32 metrics a job and 256 units: the recurrence's wide path (a
    # generator of its own)
    lgen = torch.Generator(device=DEV).manual_seed(SEED + 183)
    for F, H, Z in ((33, 32, 16), (40, 32, 16), (4, 257, 16), (4, 320, 64)):
        J, K, W = 16, 11, 8
        p, x, m = adversarial_lstm_train(J, K, W, F, H, Z, lgen)
        kernels.reset_launches()
        kern = tl.loss_and_grad(p, x, m, hidden=H, latent=Z, device=DEV)
        check(kernels.bptt_path_launches == {"group": 0, "wide": 1},
              f"lstm_train at F={F} H={H}: recurrence launches {kernels.bptt_path_launches}")
        with torch.enable_grad():
            q = p.clone().requires_grad_(True)
            pl = tl.loss_plain(q, x, m, H, Z)
            pg, = torch.autograd.grad(pl.sum(), q)
        g_err = compare_lstm_train(kern, (pl.detach(), pg))
        num, cnt, act = kernels.lstm_train_forward(p, x, m, H, Z)
        path = lstm_forward_paths_agree(p, x, m, H, Z, (num, cnt, act))
        w_err = compare_lstm_wgrad(p, x, m, act, H, Z)
        gpart = lstm_backward_twice(p, x, m, act, H, Z)
        step = torch.randint(1, 40, (J,), generator=lgen, device=DEV, dtype=torch.int32)
        compare_adam(p, 1e-3 * torch.randn(p.shape, generator=lgen, device=DEV),
                     1e-6 * torch.rand(p.shape, generator=lgen, device=DEV), step, gpart, num,
                     cnt)
        torch.cuda.synchronize()
        print(f"  lstm_train past the first design's limits F={F} H={H} Z={Z} W={W}: {J} jobs x "
              f"{K} windows (recurrence on its wide path; forward {path}), max |d grad| "
              f"{g_err:.3g}; weight-gradient entry against its twin {w_err:.3g}; two backward "
              f"runs equal bit for bit; adam bit for bit", flush=True)


# ---------------------------------------------------------------------------
# kernels N, O and P vs their twins
# ---------------------------------------------------------------------------
TESTS_CHECK = ((8, 512), (16, 512), (128, 2048), (1024, 512), (4096, 128), (8192, 64),
               (16384, 32))  # (T, rows) of kernel N's check
STAT_RTOL = 1e-6  # kernel vs twin statistics: the same expressions of exact integers
KRUSKAL_CHECK = ((2, 64), (3, 128), (5, 64), (3, 16384))  # (k, T)
RANK_CHECK = ((8, 512), (256, 2048), (4096, 128), (16384, 32))  # (T, rows)
RANK_WARP_CHECK = ((100, 512), (512, 512), (513, 256))  # the warp path's edges
FRIEDMAN_CHECK = ((128, 3), (20, 6), (7, 200))  # (n, k)
FRIEDMAN_WARP_CHECK = ((7, 16), (7, 17), (300, 2))  # the warp path's edges, (n, k)
# 32 / 33: the select path's edge; 500: passes over kept keys; 3000: one
# sort in device memory
TOPK_CHECK_K = (1, 8, 32, 33, 64, 500, 3000)


def adversarial_tests(B, T, rng):
    """Kernel N's (x, x_mask, y, y_mask) as numpy: adversarial_pairs' eight
    kinds (ties with +-0, NaN and +inf, sparse rows in the exact KS and
    Wilcoxon regimes, all-masked sides, shifted, constant), then every
    tenth row with one valid point a side, every tenth + 4 all tied across
    both sides, and every tenth + 7 the two samples interleaved in runs of
    two (a KS band of one or two cells a diagonal, whose lattice values
    fall through the subnormal range)."""
    x, xm, y, ym = adversarial_pairs(B, T, rng)[:4]
    r = np.arange(B)
    one = r % 10 == 9
    xm[one], ym[one] = False, False
    xm[one, 0], ym[one, T // 2] = True, True
    tied = r % 10 == 4
    x[tied], y[tied] = np.float32(3.5), np.float32(3.5)
    runs = r % 10 == 7
    slot = np.arange(T)
    x[runs], y[runs] = 4 * (slot // 2) + slot % 2, 4 * (slot // 2) + slot % 2 + 2
    xm[runs], ym[runs] = True, True
    return x, xm, y, ym


def close(a, b, rtol, atol, what):
    """|a - b| <= rtol |b| + atol (NaN where the other is NaN); returns the
    largest |a - b|."""
    d = (a.double() - b.double()).abs()
    same = (torch.isnan(a) & torch.isnan(b)) | (a == b)
    ok = same | (d <= rtol * b.double().abs() + atol)
    check(bool(ok.all()), f"{what}: differs by {max_abs_err(a, b):.3g}")
    return max_abs_err(a, b)


def compare_pair_tests(kern, plain, names):
    """Kernel N's (stat, p), (B, 5) in PAIR_TEST_BITS' order, against the
    twin's {name: (stat, p)} for the tests `names`: p within P_ATOL, each
    statistic (U1, H, W, D: the same float32 or float64 expression of the
    same exact integers on both sides) within STAT_RTOL. Returns the
    largest |dp|."""
    from foremast_tpu_torch import kernels

    stat, p = kern
    cols = list(kernels.PAIR_TEST_BITS)
    worst = 0.0
    for name in names:
        j = cols.index(name)
        ts, tp = plain[name]
        worst = max(worst, close(p[:, j], tp, 0.0, P_ATOL, f"pair_tests {name} p"))
        close(stat[:, j], ts, STAT_RTOL, 1e-6, f"pair_tests {name} statistic")
    return worst


def kernel_n_vs_twin(rng):
    """Kernel N against two_sample_tests_plain and sign_test_exact_plain at T
    from 8 to 16384 (device scratch above 4096): the four tests in one
    launch and each alone, as all_pairwise_tests and the *_batch entry
    points ask for them, the sign test alone, and the reference's single
    forms on one pair."""
    from foremast_tpu_torch.ops import pairwise as pw

    worst = 0.0
    for T, B in TESTS_CHECK:
        x, xm, y, ym = (torch.from_numpy(a).to(DEV) for a in adversarial_tests(B, T, rng))
        plain = pw.two_sample_tests_plain(x, xm, y, ym)
        names = pw.TWO_SAMPLE_TESTS
        kern = pw.all_pairwise_tests(x, xm, y, ym, device=DEV)
        stack = (torch.stack([kern[n][0] for n in names], 1),
                 torch.stack([kern[n][1] for n in names], 1))
        err = compare_pair_tests(stack, plain, names)
        for name, fn in (("mann_whitney", pw.mann_whitney_u_batch), ("wilcoxon", pw.wilcoxon_batch),
                         ("ks", pw.ks_2samp_batch)):
            st, pv = fn(x, xm, y, ym, device=DEV)
            close(pv, plain[name][1], 0.0, P_ATOL, f"{name} batch p")
            close(st, plain[name][0], STAT_RTOL, 1e-6, f"{name} batch statistic")
        ns, ps = pw.sign_test_batch(x, y, xm & ym, device=DEV)
        pns, pps = pw.sign_test_exact_plain(x, y, xm & ym)
        err = max(err, close(ps, pps, 0.0, P_ATOL, "sign test p"))
        check(torch.equal(ns, pns), "sign test: untied counts differ")
        one = (x[0], xm[0], y[0], ym[0])
        singles = {"mann_whitney": pw.mann_whitney_u(*one, device=DEV),
                   "kruskal": pw.two_sample_tests(*one, device=DEV)["kruskal"],
                   "wilcoxon": pw.wilcoxon_signed_rank(*one, device=DEV),
                   "ks": pw.ks_2samp(*one, device=DEV),
                   "sign": pw.sign_test_exact(x[0], y[0], xm[0] & ym[0], device=DEV)}
        for name, (st, pv) in singles.items():
            st_b, pv_b = (ns, ps) if name == "sign" else kern[name]
            check(st.shape == () and same_or_both_nan(st, st_b[0])
                  and same_or_both_nan(pv, pv_b[0]),
                  f"the single form of {name} differs from its batch")
        n1, n2 = xm.sum(1), ym.sum(1)
        stephens = int(((n1 > pw.KS_EXACT_MAX_T) | (n2 > pw.KS_EXACT_MAX_T)).sum())
        torch.cuda.synchronize()
        worst = max(worst, err)
        print(f"  pair_tests T={T}: {B} rows, max |dp| {err:.3g} (tol {P_ATOL}), {stephens} in "
              f"the Stephens regime; each *_batch and the sign test alone equal, the single "
              f"forms equal their batch of one", flush=True)
    return worst


def adversarial_ranks(B, T, rng):
    """(values, mask) numpy rows of six kinds: ties with +-0, NaN and +inf
    in valid slots, all masked, all tied, one valid point, plain."""
    x = rng.normal(0, 1, (B, T)).astype(np.float32)
    m = rng.random((B, T)) > 0.1
    kind = np.arange(B) % 6
    k = kind == 0
    x[k] = np.round(x[k] * 2) / 2
    z = k[:, None] & (x == 0)
    x[z] = np.where(rng.random(int(z.sum())) < 0.5, 0.0, -0.0)
    k = (kind == 1)[:, None]
    x[k & (rng.random((B, T)) < 0.05)] = np.nan
    x[k & (rng.random((B, T)) < 0.05)] = np.inf
    m[kind == 2] = False
    x[kind == 3] = np.float32(1.25)
    one = kind == 4
    m[one] = False
    m[one, T // 3] = True
    return x, m


def compare_ranks(kern, plain):
    """Kernel O's ranks, tie term and count against the twin's: equal
    (half-integer ranks and integer sums, exact on both sides). Returns the
    largest |difference| over the three."""
    worst = 0.0
    for name, a, b in zip(("ranks", "tie", "n_valid"), kern, plain):
        err = max_abs_err(a, b)
        check(torch.equal(a, b), f"rank_and_ties {name} differs by {err:.3g}")
        worst = max(worst, err)
    return worst


def adversarial_groups(B, k, T, rng):
    """(groups, masks) numpy (B, k, T) from adversarial_ranks' rows, the
    first group shifted by 1 in every third row."""
    x, m = adversarial_ranks(B * k, T, rng)
    g, gm = x.reshape(B, k, T), m.reshape(B, k, T)
    g[::3, 0] += 1.0
    return g, gm


def adversarial_friedman(B, n, k, rng):
    """(data (B, n, k), block_mask (B, n)) numpy: values on a grid of 0.5
    (ties, +-0), NaN in 2% of entries, a treatment effect in every second
    row, 80% of blocks masked in, every seventh row none, every fifth one
    block."""
    d = np.round(rng.normal(0, 1, (B, n, k)) * 2).astype(np.float32) / 2
    d[::2] += np.linspace(0, 1, k, dtype=np.float32)
    z = d == 0
    d[z] = np.where(rng.random(int(z.sum())) < 0.5, 0.0, -0.0)
    d[rng.random((B, n, k)) < 0.02] = np.nan
    bm = rng.random((B, n)) < 0.8
    bm[::7] = False
    bm[::5] = False
    bm[::5, 0] = True
    return d, bm


def kruskal_paths_agree(g, gm, default, pH, pp):
    """kruskal_groups forced onto each path that serves the rows: H and p
    against the twin's (pH, pp), and equal bit for bit to the default
    path's and, where the cta path serves, to the cta path's."""
    from foremast_tpu_torch import kernels

    _, k, T = g.shape
    served = [path for path in kernels.KRUSKAL_PATHS if kernels.kruskal_serves(path, k, T)]
    out = {path: kernels.kruskal_groups(g, gm, path=path) for path in served}
    ref = out.get("cta", default)
    for path, (H, p) in out.items():
        close(H, pH, STAT_RTOL, 1e-6, f"kruskal_groups k={k} T={T} {path} path H")
        close(p, pp, 0.0, P_ATOL, f"kruskal_groups k={k} T={T} {path} path p")
        check(same_bits(H, ref[0]) and same_bits(p, ref[1]),
              f"kruskal_groups k={k} T={T}: the {path} path differs from the "
              f"{'cta' if 'cta' in out else 'default'} path")
    check(same_bits(default[0], ref[0]) and same_bits(default[1], ref[1]),
          f"kruskal_groups k={k} T={T}: the default path differs")
    return served


def rank_paths_agree(v, m, default):
    """rank_and_ties forced onto each path that serves the rows: ranks, tie
    terms and counts equal bit for bit to the cta path's (the scratch
    path's where the cta path does not serve) and to the default path's."""
    from foremast_tpu_torch import kernels

    T = v.shape[1]
    served = [path for path in kernels.RANK_PATHS if kernels.rank_serves(path, T)]
    out = {path: kernels.rank_and_ties(v, m, path=path) for path in served}
    ref = out.get("cta", out["scratch"])
    for path, got in list(out.items()) + [("default", default)]:
        check(all(same_bits(a, b) for a, b in zip(got, ref)),
              f"rank_and_ties T={T}: the {path} path differs from the "
              f"{'cta' if 'cta' in out else 'scratch'} path")
    return served


def friedman_paths_agree(d, bm, pc, pp, what):
    """friedman forced onto each path that serves the tables: chi2 and p
    against the twin's (pc, pp) and equal bit for bit to the cta path's.
    Returns (the paths, the largest |dp|)."""
    from foremast_tpu_torch import kernels

    _, n, k = d.shape
    served = [path for path in kernels.FRIEDMAN_PATHS if kernels.friedman_serves(path, n, k)]
    out = {path: kernels.friedman(d, bm, path=path) for path in served}
    err = 0.0
    for path, (chi, p) in out.items():
        close(chi, pc, STAT_RTOL, 1e-5, f"{what} {path} path chi2")
        err = max(err, close(p, pp, 0.0, P_ATOL, f"{what} {path} path p"))
        check(same_bits(chi, out["cta"][0]) and same_bits(p, out["cta"][1]),
              f"{what}: the {path} path differs from the cta path")
    return served, err


def kernel_o_vs_twin(rng):
    """Kernel O's three entries against their twins: ranks at T from 8 to
    16384 (the warp path up to 512, device scratch above 8192; each path
    that serves T forced, equal bit for bit), Kruskal-Wallis at k in
    {2, 3, 5} (and k T = 49,152 in scratch), Friedman at (n, k) in
    FRIEDMAN_CHECK and FRIEDMAN_WARP_CHECK, each path that serves a shape."""
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.ops import ranks as rk

    worst = {"rank_and_ties": 0.0, "kruskal_groups": 0.0, "friedman": 0.0}
    for T, B in RANK_CHECK + RANK_WARP_CHECK:
        # the warp path's added shapes draw from a generator of their own:
        # the later phases' rows do not depend on them
        own = (T, B) in RANK_WARP_CHECK
        v, m = (torch.from_numpy(a).to(DEV) for a in adversarial_ranks(
            B, T, np.random.default_rng(SEED + T) if own else rng))
        out = rk.rank_and_ties(v, m, device=DEV)
        worst["rank_and_ties"] = max(worst["rank_and_ties"], compare_ranks(
            out, rk.rank_and_ties_plain(v, m)))
        rank_paths_agree(v, m, out)
    for k, T in KRUSKAL_CHECK:
        B = 32 if k * T > 8192 else 512
        g, gm = (torch.from_numpy(a).to(DEV) for a in adversarial_groups(B, k, T, rng))
        H, p = pw.kruskal_batch(g, gm, device=DEV)
        pH, pp = pw.kruskal_plain(g, gm)
        H0, p0 = pw.kruskal_wallis(g[0], gm[0], device=DEV)
        check(same_or_both_nan(H0, H[0]) and same_or_both_nan(p0, p[0]),
              "kruskal_wallis differs from kruskal_batch's row")
        close(H, pH, STAT_RTOL, 1e-6, f"kruskal_groups k={k} H")
        worst["kruskal_groups"] = max(worst["kruskal_groups"],
                                      close(p, pp, 0.0, P_ATOL, f"kruskal_groups k={k} p"))
        check(bool((p[gm.flatten(1).any(1).logical_not()] == 1.0).all()),
              "kruskal_groups: a fully masked row has p != 1")
        kruskal_paths_agree(g, gm, (H, p), pH, pp)
    for n, k in FRIEDMAN_CHECK + FRIEDMAN_WARP_CHECK:
        # the warp path's added shapes draw from a generator of their own
        own = (n, k) in FRIEDMAN_WARP_CHECK
        d, bm = (torch.from_numpy(a).to(DEV) for a in adversarial_friedman(
            257 if own else 256, n, k, np.random.default_rng(SEED + n * k) if own else rng))
        chi, p = pw.friedman_batch(d, bm, device=DEV)
        pc, pp = pw.friedman_plain(d, bm)
        c0, p0 = pw.friedman_chi_square(d[1], bm[1], device=DEV)
        check(same_or_both_nan(c0, chi[1]) and same_or_both_nan(p0, p[1]),
              "friedman_chi_square differs from friedman_batch's row")
        close(chi, pc, STAT_RTOL, 1e-5, f"friedman n={n} k={k} chi2")
        worst["friedman"] = max(worst["friedman"],
                                close(p, pp, 0.0, P_ATOL, f"friedman n={n} k={k} p"))
        worst["friedman"] = max(worst["friedman"], friedman_paths_agree(
            d, bm, pc, pp, f"friedman n={n} k={k}")[1])
    kernel_o_df0(np.random.default_rng(SEED + 181))
    torch.cuda.synchronize()
    print(f"  rank_and_ties T in {tuple(T for T, _ in RANK_CHECK + RANK_WARP_CHECK)}: ranks, tie "
          f"terms and counts "
          f"equal to the twin's, each path that serves T equal bit for bit; "
          f"kruskal_groups (k, T) in {KRUSKAL_CHECK}: max |dp| {worst['kruskal_groups']:.3g}, "
          f"each path that serves a shape forced, the warp path equal to the cta path bit for "
          f"bit; "
          f"friedman (n, k) in {FRIEDMAN_CHECK + FRIEDMAN_WARP_CHECK}: max |dp| "
          f"{worst['friedman']:.3g}, each path that serves k forced, equal bit for bit",
          flush=True)
    return worst


KRUSKAL_DF0_T = (128, 4096, 16384)  # k = 1: the warp, cta and scratch paths' shapes
FRIEDMAN_DF0_N = (5, 128)


def kernel_o_df0(rng):
    """P5: Kruskal-Wallis and Friedman at one group (df = 0) on every path
    that serves the shape: p equal to the twin's bit for bit, 0 wherever the
    statistic is defined and 1 (the ok guard) where it is not."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import pairwise as pw

    ran = []
    for T in KRUSKAL_DF0_T:
        g, gm = (torch.from_numpy(a).to(DEV) for a in adversarial_groups(
            64 if T > 512 else 512, 1, T, rng))
        _, pp = pw.kruskal_plain(g, gm)
        check(bool(((pp == 0) | (pp == 1)).all()) and bool((pp == 0).any()),
              f"kruskal_plain at k = 1, T = {T}: p not 0 or 1")
        for path in kernels.KRUSKAL_PATHS:
            if kernels.kruskal_serves(path, 1, T):
                check(same_bits(kernels.kruskal_groups(g, gm, path=path)[1], pp),
                      f"kruskal_groups at k = 1, T = {T}, {path} path: p differs from the twin's")
                ran.append(f"kruskal T={T} {path}")
    for n in FRIEDMAN_DF0_N:
        d, bm = (torch.from_numpy(a).to(DEV) for a in adversarial_friedman(257, n, 1, rng))
        _, pp = pw.friedman_plain(d, bm)
        check(bool(((pp == 0) | (pp == 1)).all()) and bool((pp == 0).any()),
              f"friedman_plain at k = 1, n = {n}: p not 0 or 1")
        for path in kernels.FRIEDMAN_PATHS:
            if kernels.friedman_serves(path, n, 1):
                check(same_bits(kernels.friedman(d, bm, path=path)[1], pp),
                      f"friedman at k = 1, n = {n}, {path} path: p differs from the twin's")
                ran.append(f"friedman n={n} {path}")
    torch.cuda.synchronize()
    print(f"  P5, one group (df = 0): p = 0 where the statistic is defined, 1 where not, equal "
          f"to the twin's on {', '.join(ran)}", flush=True)


def adversarial_topk(n, rng):
    """(unhealthy, severity) numpy: 10% unhealthy; severities with ties (a
    third at 12 plus a band fraction of 0 or 0.5, as p clamped at 1e-12
    gives), +NaN and -NaN, +-0 and +-inf."""
    u = rng.random(n) < 0.10
    s = rng.uniform(0, 14, n).astype(np.float32)
    tie = rng.random(n) < 0.33
    s[tie] = np.float32(12.0) + np.where(rng.random(int(tie.sum())) < 0.5, 0.0, 0.5)
    odd = rng.choice(n, min(n, 12), replace=False)
    s[odd] = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf] * 2, np.float32)[:len(odd)]
    return u, s


def compare_topk(kern, plain, what):
    """Kernel P against its twin: the count, the values' bits and the
    indices equal. Returns the largest |difference| over the three."""
    (kc, kv, ki), (pc, pv, pi) = kern, plain
    check((kc is None) == (pc is None), f"{what}: count")
    counts = 0.0 if kc is None else abs(float(kc) - float(pc))
    check(counts == 0.0, f"{what}: count {kc} against {pc}")
    check(torch.equal(kv.view(torch.int32), pv.view(torch.int32)), f"{what}: values differ")
    check(torch.equal(ki, pi), f"{what}: indices differ")
    return max(counts, max_abs_err(kv, pv), max_abs_err(ki.double(), pi.double()))


def topk_paths_agree(s, k, u, base):
    """fleet_topk forced onto each path that serves k, with the unhealthy
    mask u and base and without either: each against the twin, and so each
    equal to the others. Returns the paths."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    n = s.shape[0]
    served = [path for path in kernels.FLEET_TOPK_PATHS if kernels.fleet_topk_serves(path, n, k)]
    want, want_all = fl.fleet_topk_plain(s, k, u, base=base), fl.fleet_topk_plain(s, k)
    for path in served:
        compare_topk(kernels.fleet_topk(s, k, u, base=base, path=path), want,
                     f"fleet_topk n={n} k={k} {path} path")
        compare_topk(kernels.fleet_topk(s, k, path=path), want_all,
                     f"fleet_topk n={n} k={k} {path} path unmasked")
    return served


def kernel_p_vs_twin(rng):
    """Kernel P against fleet_topk_plain at n in {5, 4096, 100,000}, k in
    TOPK_CHECK_K and k > n, with the unhealthy mask and a base, and
    without either. Returns the largest |difference|."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    worst = 0.0
    for n in (5, 4096, 100_000):
        u, s = (torch.from_numpy(a).to(DEV) for a in adversarial_topk(n, rng))
        for k in TOPK_CHECK_K + (n + 5,):
            worst = max(worst, compare_topk(kernels.fleet_topk(s, k, u, base=7),
                                            fl.fleet_topk_plain(s, k, u, base=7),
                                            f"fleet_topk n={n} k={k}"),
                        compare_topk(kernels.fleet_topk(s, k), fl.fleet_topk_plain(s, k),
                                     f"fleet_topk n={n} k={k} unmasked"))
            topk_paths_agree(s, k, u, 7)
    torch.cuda.synchronize()
    print(f"  fleet_topk n in (5, 4096, 100000), k in {TOPK_CHECK_K} and n + 5: counts, values "
          f"(bit for bit) and indices equal, on each path that serves k, max |err| "
          f"{worst:.3g}", flush=True)
    return worst


# ---------------------------------------------------------------------------
# kernels A, N, O and P past their first designs' limits
# ---------------------------------------------------------------------------
LONG_PAIR_T, LONG_PAIR_ROWS = 43_200, 1024  # a 30-day window at a 60 s step
KRUSKAL_LONG = (8, 172_800, 4)  # (k, T, rows): 30 days at a 15 s scrape, 1,382,400 keys
TIED_KEYS = (1 << 21) + 1  # t^3 - t past a signed 64-bit t^3
BIG_RANK_KEYS = 1 << 24
FLEET_PAST_SLICE = (1 << 30) + 7  # rows: two launches of kernel P and a merge
FLEET_PAST_BASE = 3 << 30  # keys past 2^32
FLEET_TWIN_SLICE = 1 << 26


def past_the_limits():
    """Kernels A and N at T = 43,200 on 1,024 adversarial pairs (the
    scratch path), O's ranks and Kruskal-Wallis at k T = 1,382,400, a fully
    tied row of 2^21 + 1 keys (the tie term against the exact integer) and
    one row of 2^24 keys, P on 2^30 + 7 rows keyed from 3 x 2^30, each
    against its twin, each timed. Returns {kernel: its numbers}."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.ops import ranks as rk
    from foremast_tpu_torch.parallel import fleet as fl

    rng = np.random.default_rng(SEED + 43_200)
    out = {}
    T, B = LONG_PAIR_T, LONG_PAIR_ROWS
    args = adversarial_pairs(B, T, rng)
    t = fl.pair_args_from_numpy(args, DEV)
    kernels.reset_launches()
    kern = fl.score_pairs(*t, device=DEV)
    check(kernels.pair_path_launches["scratch"] == 1, f"pair_verdict at T = {T}: "
          f"{kernels.pair_path_launches}")
    err, bracketed = compare_pair_verdict(t, kern, fl.pair_verdict_plain(*t))
    ms = cuda_ms(lambda: fl.score_pairs(*t, device=DEV), 2)
    out["pair_verdict"] = {"T": T, "rows": B, "max_abs_err": err, "ms": ms,
                           **pair_bound(args)}
    print(f"  pair_verdict T={T}, {B} pairs (scratch path): max |dp| {err:.3g}, {bracketed} "
          f"rows bracketed, {ms:.3f} ms, bound {out['pair_verdict']['bound_ms']:.4f} ms",
          flush=True)
    del t, kern
    x, xm, y, ym = (torch.from_numpy(a).to(DEV) for a in (args[0], args[1], args[2], args[3]))
    del args
    plain = pw.two_sample_tests_plain(x, xm, y, ym)
    names = pw.TWO_SAMPLE_TESTS
    kernels.reset_launches()
    got = pw.all_pairwise_tests(x, xm, y, ym, device=DEV)
    check(kernels.pair_tests_path_launches["scratch"] == 1, f"pair_tests at T = {T}: "
          f"{kernels.pair_tests_path_launches}")
    err = compare_pair_tests((torch.stack([got[n][0] for n in names], 1),
                              torch.stack([got[n][1] for n in names], 1)), plain, names)
    ns, ps = pw.sign_test_batch(x, y, xm & ym, device=DEV)
    pns, pps = pw.sign_test_exact_plain(x, y, xm & ym)
    err = max(err, close(ps, pps, 0.0, P_ATOL, "sign test p at T = 43,200"))
    check(torch.equal(ns, pns), "sign test at T = 43,200: untied counts differ")
    ms = cuda_ms(lambda: pw.all_pairwise_tests(x, xm, y, ym, device=DEV), 2)
    out["pair_tests"] = {"T": T, "rows": B, "max_abs_err": err, "ms": ms}
    print(f"  pair_tests T={T}, {B} pairs (scratch path): the battery and the sign test, max "
          f"|dp| {err:.3g}, the battery {ms:.3f} ms", flush=True)
    del x, xm, y, ym, plain, got
    torch.cuda.empty_cache()

    k, T, B = KRUSKAL_LONG
    g, gm = (torch.from_numpy(a).to(DEV) for a in adversarial_groups(B, k, T, rng))
    kernels.reset_launches()
    H, p = pw.kruskal_batch(g, gm, device=DEV)
    check(kernels.kruskal_path_launches["scratch"] == 1, f"kruskal_groups at k T = {k * T}: "
          f"{kernels.kruskal_path_launches}")
    pH, pp = pw.kruskal_plain(g, gm)
    close(H, pH, STAT_RTOL, 1e-6, f"kruskal_groups k T = {k * T} H")
    err = close(p, pp, 0.0, P_ATOL, f"kruskal_groups k T = {k * T} p")
    ms = cuda_ms(lambda: pw.kruskal_batch(g, gm, device=DEV), 1)
    v, m = g.reshape(B, k * T), gm.reshape(B, k * T)
    kernels.reset_launches()
    ranks = rk.rank_and_ties(v, m, device=DEV)
    check(kernels.rank_path_launches["scratch"] == 1, f"rank_and_ties at {k * T} keys: "
          f"{kernels.rank_path_launches}")
    compare_ranks(ranks, rk.rank_and_ties_plain(v, m))
    rms = cuda_ms(lambda: rk.rank_and_ties(v, m, device=DEV), 1)
    out["kruskal_groups"] = {"k": k, "T": T, "rows": B, "max_abs_err": err, "ms": ms}
    print(f"  kruskal_groups k={k}, T={T} ({k * T} keys a row), {B} rows (scratch path): max "
          f"|dp| {err:.3g}, {ms:.3f} ms; rank_and_ties on the same rows: equal to the twin, "
          f"{rms:.3f} ms", flush=True)
    del g, gm, v, m, ranks

    n = TIED_KEYS
    v = torch.full((1, n), 2.5, device=DEV)
    m = torch.ones((1, n), dtype=torch.bool, device=DEV)
    r, tie, nv = rk.rank_and_ties(v, m, device=DEV)
    exact = n ** 3 - n
    want = float(np.float32(exact))
    _, ptie, _ = rk.rank_and_ties_plain(v, m)
    check(float(tie[0]) == want, f"a tied row of {n} keys: tie term {float(tie[0])!r}, the exact "
          f"{exact} rounds to {want!r}")
    check(abs(float(ptie[0]) - want) <= float(np.spacing(np.float32(want))),
          "the twin's tie term is more than one float32 ulp from the exact value")
    check(bool((r == (n + 1) / 2).all()) and float(nv[0]) == n, "a tied row's ranks or count")
    half = n // 2 + 1
    H, p = kernels.kruskal_groups(torch.full((1, 2, half), 2.5, device=DEV),
                                  torch.ones((1, 2, half), dtype=torch.bool, device=DEV))
    check(float(H[0]) == 0.0 and float(p[0]) == 1.0, "every key tied: H must be 0 and p 1")
    print(f"  a fully tied row of {n} keys: tie term {float(tie[0]):.9g} = float32 of the exact "
          f"{exact} (the twin's float64 sum {float(ptie[0]):.9g}); ranks (t + 1) / 2; "
          f"Kruskal over two tied groups of {n // 2 + 1}: H 0, p 1", flush=True)
    del v, m, r

    n = BIG_RANK_KEYS
    v = torch.round(torch.randn((1, n), generator=torch.Generator(device=DEV).manual_seed(
        SEED + n), device=DEV) * 100) / 100
    m = torch.rand((1, n), generator=torch.Generator(device=DEV).manual_seed(SEED + n + 1),
                   device=DEV) > 0.01
    # one launch, timed as it runs: one CTA's sort of 2^24 keys takes seconds
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    got = rk.rank_and_ties(v, m, device=DEV)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    compare_ranks(got, rk.rank_and_ties_plain(v, m))
    out["rank_and_ties"] = {"T": n, "rows": 1, "ms": ms, **least_time(n * 9 + 8, 0)}
    print(f"  rank_and_ties, one row of {n} keys (one CTA sorting through device scratch): equal "
          f"to the twin, {ms:.1f} ms (bound {out['rank_and_ties']['bound_ms']:.4f} ms, bytes)",
          flush=True)
    del v, m, got
    torch.cuda.empty_cache()

    n, base = FLEET_PAST_SLICE, FLEET_PAST_BASE
    gen = torch.Generator(device=DEV).manual_seed(SEED + 30)
    s = torch.round(torch.rand(n, generator=gen, device=DEV) * 1e4) / 1e4
    # the second slice: six rows above every other, and one tied with the
    # first slice's largest (the first slice's rows come first)
    s[n - 7] = 1.0
    s[n - 6:] = 2.0
    s[5] = 1.0
    u = torch.rand(n, generator=gen, device=DEV) < 0.1
    u[n - 7:] = True
    u[5] = True
    kernels.reset_launches()
    got = kernels.fleet_topk(s, FLEET_K, u, base=base)
    check(kernels.launches["fleet_topk"] == 3, f"fleet_topk on {n} rows: "
          f"{kernels.launches['fleet_topk']} launches (two slices and a merge)")
    ms = cuda_ms(lambda: kernels.fleet_topk(s, FLEET_K, u, base=base), 2)
    # the twin on the whole would sort 2^30 64-bit keys in ~60 GB; it runs
    # in slices of FLEET_TWIN_SLICE rows merged by fleet_topk_slices, which
    # equals the twin on the whole (tests/test_torch_past_limits.py)
    twin = kernels.fleet_topk_slices(s, FLEET_K, u, base, FLEET_TWIN_SLICE,
                                     lambda v, k, ok: fl.fleet_topk_plain(v, k, ok, 0))
    err = compare_topk(got, twin, f"fleet_topk on {n} rows")
    check(int(got[2][:6].min()) > 1 << 32 and float(got[1][6]) == 1.0 and
          int(got[2][6]) < base + n - 7, "fleet_topk: the second slice's rows misplaced")
    out["fleet_topk"] = {"rows": n, "base": base, "max_abs_err": err, "ms": ms,
                         **least_time(n * 5 + FLEET_K * 12 + 8, n)}
    print(f"  fleet_topk on {n} rows keyed from {base} (two launches and a merge): count, values "
          f"and indices (past 2^32) equal to the twin's (in slices of {FLEET_TWIN_SLICE}), "
          f"{ms:.3f} ms (bound "
          f"{out['fleet_topk']['bound_ms']:.3f} ms, bytes)", flush=True)
    del s, u
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the pair path at full size
# ---------------------------------------------------------------------------
def error_generator_windows(rng, n, rates, start, minutes):
    """Raw (ts, value) error-rate series, resampled to the 60 s grid: per
    minute a Poisson count of errors over the scrape, as err/s, with scrape
    jitter and 5% lost samples."""
    from foremast_tpu_torch.ops.windowing import resample_to_grid

    ts = start + STEP * np.arange(minutes) + rng.uniform(-5, 5, (n, minutes))
    vals = rng.poisson(np.asarray(rates)[:, None] * STEP, (n, minutes)) / STEP
    keep = rng.random((n, minutes)) > 0.05
    end = start + STEP * minutes
    return [resample_to_grid(ts[i][keep[i]], vals[i][keep[i]], start, end) for i in range(n)]


def pair_path_inputs(rng):
    """The pair path's numpy arguments and which canaries are bad: the
    windows through resample_to_grid -> pack_windows, the policy of a
    Foremast canary check with the whole test family."""
    from foremast_tpu_torch.ops.windowing import pack_windows
    from foremast_tpu_torch.parallel import fleet as fl

    start = 1_700_000_040
    bad = rng.random(PAIRS) < 0.10
    base = error_generator_windows(rng, PAIRS, np.full(PAIRS, 0.5), start, PAIR_T)
    cur = error_generator_windows(rng, PAIRS, np.where(bad, 5.0, 0.5), start, PAIR_T)
    bv, bm = pack_windows(base, pad_to=PAIR_T)
    cv, cm = pack_windows(cur, pad_to=PAIR_T)
    args = list(fl.pair_arg_spec(PAIRS, PAIR_T))
    args[:4] = bv, bm, cv, cm
    args[4][:] = 0.01                  # ML_PAIRWISE_THRESHOLD
    args[5][:] = 31                    # the full test family ("all")
    args[6][:] = fl.COMBINE_ALL
    args[8][:] = 2.0                   # ML_THRESHOLD
    args[9][:] = 1                     # ML_BOUND: upper
    return args, bad


def pair_path(rng):
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    t0 = time.perf_counter()
    args, bad = pair_path_inputs(rng)
    host_s = time.perf_counter() - t0
    print(f"  host: resample_to_grid + pack_windows of {2 * PAIRS} windows: {host_s:.2f} s",
          flush=True)

    kernels.reset_launches()
    out = fl.score_pairs(*args, device=DEV)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    paths = dict(kernels.pair_path_launches)
    check(launches["pair_verdict"] >= 1, "the pair path did not launch pair_verdict")
    check(paths["warp"] == launches["pair_verdict"],
          f"the pair path at T = {PAIR_T} ran pair_verdict's paths {paths}, not the warp path")
    unhealthy = out["unhealthy"].cpu().numpy()
    check(out["pvalues"].shape == (PAIRS, 5) and bool(torch.isfinite(out["pvalues"]).all()),
          "pair path p-values not finite")
    recall = float(unhealthy[bad].mean())
    fp = float(unhealthy[~bad].mean())
    check(recall == 1.0, f"only {recall:.4f} of bad canaries flagged")
    check(fp < 0.01, f"healthy false-positive share {fp:.4f} >= 0.01")
    print(f"  verdicts: recall {recall:.4f} on {int(bad.sum())} bad canaries, healthy "
          f"false positives {fp:.5f} (limit 0.01); launches {launches}; pair_verdict by path "
          f"{paths}", flush=True)

    t = fl.pair_args_from_numpy(args, DEV)
    sub = tuple(a[:CHECK_ROWS] for a in t)
    err, bracketed = compare_pair_verdict(sub, fl.score_pairs(*sub, device=DEV),
                                          fl.pair_verdict_plain(*sub))
    print(f"  kernel vs twin on {CHECK_ROWS} of these pairs: max |dp| = {err:.3g}, "
          f"{bracketed} rows bracketed", flush=True)

    e2e = wall_ms(lambda: fl.score_pairs(*args, device=DEV), TIMED_RUNS)
    copy = wall_ms(lambda: fl.pair_args_from_numpy(args, DEV), TIMED_RUNS)
    ms = cuda_ms(lambda: fl.score_pairs(*t, device=DEV), TIMED_RUNS)
    plain_ms = cuda_ms(lambda: fl.pair_verdict_plain(*t), 3)
    med, p99 = float(np.median(e2e)), float(np.percentile(e2e, 99))
    print(f"  score_pairs from numpy, {TIMED_RUNS} runs: median {med:.3f} ms, p99 {p99:.3f} ms, "
          f"{PAIRS / med * 1e3:.0f} pairs/s; of it the copy of the 12 arguments to the card "
          f"(pair_args_from_numpy), median {np.median(copy):.3f} ms", flush=True)
    print(f"  pair_verdict kernel on device tensors: {ms:.3f} ms "
          f"({PAIRS / ms * 1e3:.0f} pairs/s); plain twin {plain_ms:.1f} ms", flush=True)
    return ({"launches": launches["pair_verdict"], "paths": paths, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms, **pair_bound(args)}, args, bad)


def pair_bound(args):
    """Least time for kernel A's work on these inputs: the larger of the
    bytes read and written once over HBM and the operations the data needs
    at the fp32 instruction rate. The operations: 7 for each cell of the
    (n1 + 1)(n2 + 1) KS lattice of a pair in the exact regime (band test
    and update, a multiply-add counted once), n log2 n compares for each
    sort of the n valid entries (the combined sample, the nonzero paired
    differences), 2 per exact Wilcoxon pmf entry and 4 per sign-test
    term."""
    from foremast_tpu_torch.ops.pairwise import KS_EXACT_MAX_T, WILCOXON_EXACT_MAX_N

    B, T = args[0].shape
    nbytes = sum(a.nbytes for a in args) + B * (1 + 4 + 20 + 4 + 4 + 1 + 1)
    nbytes += WILCOXON_EXACT_MAX_N * (WILCOXON_EXACT_MAX_N * (WILCOXON_EXACT_MAX_N + 1) // 2 + 1) * 4
    n1 = args[1].sum(1).astype(np.float64)
    n2 = args[3].sum(1).astype(np.float64)
    exact = (n1 > 0) & (n2 > 0) & (n1 <= KS_EXACT_MAX_T) & (n2 <= KS_EXACT_MAX_T)
    cells = np.where(exact, (n1 + 1) * (n2 + 1), 0.0).sum()

    def compares(n):
        n = n.astype(np.float64)
        return (n * np.log2(np.maximum(n, 1.0))).sum()

    both = args[1] & args[3]
    d = args[0] - args[2]
    nz = (both & (d != 0)).sum(1)
    sort_ops = compares(n1 + n2) + compares(nz)
    wil = np.where(nz <= WILCOXON_EXACT_MAX_N, nz * (nz + 1) / 2 + 1, 0).sum()
    s = np.minimum(((args[2] > args[0]) & both).sum(1), ((args[2] < args[0]) & both).sum(1))
    ops = 7 * cells + sort_ops + 2 * wil + 4 * (s + 1).sum()
    return least_time(nbytes, ops)


# ---------------------------------------------------------------------------
# the public test battery at full width (kernels N and O)
# ---------------------------------------------------------------------------
FRIEDMAN_N = 128  # blocks: the window's 128 steps, three windows as treatments
RANK_T = 256  # rank_and_ties over baseline ++ current


def tests_inputs(pair_args):
    """The phase's inputs on the card, from the pair path's windows: the
    (baseline, current) pairs; three groups a row (baseline, current and the
    previous row's current) for Kruskal-Wallis; the same three windows as
    treatments over the 128 steps as blocks for Friedman, a block counted
    where all three are valid; baseline ++ current (T = 256) for the ranks."""
    bv, bm, cv, cm = (torch.from_numpy(np.ascontiguousarray(a)).to(DEV) for a in pair_args[:4])
    groups = torch.stack([bv, cv, torch.roll(cv, 1, 0)], 1).contiguous()
    gmask = torch.stack([bm, cm, torch.roll(cm, 1, 0)], 1).contiguous()
    fr = groups[:, :, :FRIEDMAN_N].transpose(1, 2).contiguous()
    frm = gmask[:, :, :FRIEDMAN_N].all(1).contiguous()
    rv, rm = torch.cat([bv, cv], 1).contiguous(), torch.cat([bm, cm], 1).contiguous()
    return (bv, bm, cv, cm), (groups, gmask), (fr, frm), (rv, rm)


def tests_bounds(pairs, groups, fr, ranks):
    """Least time (ms, bound_by) of each kernel's work on these inputs:
    bytes each input read and each output written once, against the
    operations at the fp32 instruction rate. N: as kernel A's tests (7 a
    cell of each exact KS lattice, n log2 n compares a sort of n valid
    entries, 2 an exact Wilcoxon pmf entry); O's ranks and Kruskal: n log2 n
    compares a row of n valid entries; Friedman: 2 compares for each pair
    of treatments in a counted block."""
    from foremast_tpu_torch.ops.pairwise import KS_EXACT_MAX_T, WILCOXON_EXACT_MAX_N

    def nlogn(n):
        n = n.double()
        return float((n * torch.log2(n.clamp(min=1.0))).sum())

    x, xm, y, ym = pairs
    B, T = x.shape
    n1, n2 = xm.sum(1).double(), ym.sum(1).double()
    exact = (n1 > 0) & (n2 > 0) & (n1 <= KS_EXACT_MAX_T) & (n2 <= KS_EXACT_MAX_T)
    cells = float(torch.where(exact, (n1 + 1) * (n2 + 1), 0.0).sum())
    nz = (xm & ym & (x != y)).sum(1)
    wil = float(torch.where(nz <= WILCOXON_EXACT_MAX_N, nz * (nz + 1) / 2 + 1, 0).sum())
    table = WILCOXON_EXACT_MAX_N * (WILCOXON_EXACT_MAX_N * (WILCOXON_EXACT_MAX_N + 1) // 2 + 1)
    out = {"pair_tests": least_time(B * T * 10 + table * 4 + B * 32,
                                    7 * cells + nlogn(n1 + n2) + nlogn(nz) + 2 * wil)}
    g, gm = groups
    out["kruskal_groups"] = least_time(g.numel() * 5 + B * 8, nlogn(gm.flatten(1).sum(1)))
    d, bm = fr
    k = d.shape[2]
    out["friedman"] = least_time(d.numel() * 4 + bm.numel() + B * 8,
                                 2 * k * k * float(bm.sum()))
    v, m = ranks
    out["rank_and_ties"] = least_time(v.numel() * 9 + B * 8, nlogn(m.sum(1)))
    return out


def tests_path(pair_args, bad):
    """Drive the public test battery at the north-star width (kernels N and
    O), then hold each kernel against its twin on the first CHECK_ROWS rows
    and time it beside its twin."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.ops import ranks as rk

    pairs, groups, fr, ranks = tests_inputs(pair_args)
    B, T = pairs[0].shape

    def battery():
        return {"all": pw.all_pairwise_tests(*pairs, device=DEV),
                "mann_whitney": pw.mann_whitney_u_batch(*pairs, device=DEV),
                "wilcoxon": pw.wilcoxon_batch(*pairs, device=DEV),
                "ks": pw.ks_2samp_batch(*pairs, device=DEV),
                "kruskal": pw.kruskal_batch(*groups, device=DEV),
                "friedman": pw.friedman_batch(*fr, device=DEV),
                "ranks": rk.rank_and_ties(*ranks, device=DEV)}

    kernels.reset_launches()
    out = battery()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    paths = dict(kernels.pair_tests_path_launches)
    k_paths = dict(kernels.kruskal_path_launches)
    r_paths = dict(kernels.rank_path_launches)
    f_paths = dict(kernels.friedman_path_launches)
    for name in ("pair_tests", "rank_and_ties", "kruskal_groups", "friedman"):
        check(launches[name] >= 1, f"the tests phase did not launch {name}")
    check(paths["warp"] == launches["pair_tests"],
          f"the battery at T = {T} ran pair_tests' paths {paths}, not the warp path")
    check(k_paths["warp"] == launches["kruskal_groups"],
          f"the battery's kruskal_batch (k = 3, T = {T}) ran kruskal_groups' paths {k_paths}, "
          f"not the warp path")
    check(r_paths["warp"] == launches["rank_and_ties"],
          f"the battery's rank_and_ties (T = {RANK_T}) ran its paths {r_paths}, not the warp path")
    check(f_paths["warp"] == launches["friedman"],
          f"the battery's friedman_batch ({FRIEDMAN_N} blocks x 3) ran its paths {f_paths}, not "
          f"the warp path")
    for name, (st, p) in list(out["all"].items()) + [(k, out[k]) for k in (
            "mann_whitney", "wilcoxon", "ks", "kruskal", "friedman")]:
        check(st.shape == (B,) and p.shape == (B,) and bool(torch.isfinite(st).all())
              and bool(((p >= 0) & (p <= 1)).all()), f"{name}: statistics or p out of range")
    bad_t = torch.from_numpy(bad).to(DEV)
    recall = {n: float((out["all"][n][1][bad_t] < 0.01).float().mean())
              for n in ("mann_whitney", "kruskal", "ks")}
    check(min(recall.values()) >= 0.99, f"bad canaries rejected at 0.01 on {recall}")
    check(torch.equal(out["ranks"][2], ranks[1].sum(1).float()), "rank_and_ties: counts differ")

    c = CHECK_ROWS
    sub = tuple(a[:c] for a in pairs)
    plain = pw.two_sample_tests_plain(*sub)
    names = pw.TWO_SAMPLE_TESTS
    err_n = compare_pair_tests((torch.stack([out["all"][n][0][:c] for n in names], 1),
                                torch.stack([out["all"][n][1][:c] for n in names], 1)),
                               plain, names)
    err_r = compare_ranks(tuple(o[:c] for o in out["ranks"]),
                          rk.rank_and_ties_plain(ranks[0][:c], ranks[1][:c]))
    kp = pw.kruskal_plain(groups[0][:c], groups[1][:c])
    close(out["kruskal"][0][:c], kp[0], STAT_RTOL, 1e-6, "kruskal_batch H")
    err_k = close(out["kruskal"][1][:c], kp[1], 0.0, P_ATOL, "kruskal_batch p")
    fp = pw.friedman_plain(fr[0][:c], fr[1][:c])
    close(out["friedman"][0][:c], fp[0], STAT_RTOL, 1e-5, "friedman_batch chi2")
    err_f = close(out["friedman"][1][:c], fp[1], 0.0, P_ATOL, "friedman_batch p")
    f_cta = kernels.friedman(*fr, path="cta")
    check(same_bits(out["friedman"][0], f_cta[0]) and same_bits(out["friedman"][1], f_cta[1]),
          "friedman_batch: its warp path differs from the cta path on the battery's rows")

    bounds = tests_bounds(pairs, groups, fr, ranks)
    rows = {
        "pair_tests": (err_n, cuda_ms(lambda: pw.all_pairwise_tests(*pairs, device=DEV),
                                      TIMED_RUNS),
                       cuda_ms(lambda: pw.two_sample_tests_plain(*pairs), 1, warm=False)),
        "rank_and_ties": (err_r,
                          cuda_ms(lambda: rk.rank_and_ties(*ranks, device=DEV), TIMED_RUNS),
                          cuda_ms(lambda: rk.rank_and_ties_plain(*ranks), 3)),
        "kruskal_groups": (err_k, cuda_ms(lambda: pw.kruskal_batch(*groups, device=DEV),
                                          TIMED_RUNS),
                           cuda_ms(lambda: pw.kruskal_plain(*groups), 3)),
        "friedman": (err_f, cuda_ms(lambda: pw.friedman_batch(*fr, device=DEV), TIMED_RUNS),
                     cuda_ms(lambda: pw.friedman_plain(*fr), 3)),
    }
    # each of kernel N's four battery launches alone
    battery_ms = {name: cuda_ms(lambda: fn(*pairs, device=DEV), TIMED_RUNS)
                  for name, fn in (("all_pairwise_tests", pw.all_pairwise_tests),
                                   ("mann_whitney_u_batch", pw.mann_whitney_u_batch),
                                   ("wilcoxon_batch", pw.wilcoxon_batch),
                                   ("ks_2samp_batch", pw.ks_2samp_batch))}
    print(f"  {B} pairs at T = {T}: all_pairwise_tests, the three *_batch, kruskal_batch "
          f"(k = 3), friedman_batch ({FRIEDMAN_N} blocks x 3), rank_and_ties (T = {RANK_T}); "
          f"bad canaries rejected at 0.01: {recall}; launches {launches}; pair_tests by path "
          f"{paths}; kruskal_groups by path {k_paths}; rank_and_ties by path {r_paths}; "
          f"friedman by path {f_paths}", flush=True)
    print(f"  pair_tests, each battery launch (ms): "
          f"{ {k: round(v, 4) for k, v in battery_ms.items()} }", flush=True)
    result = {}
    for name, (err, ms, plain_ms) in rows.items():
        result[name] = {"launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, **bounds[name]}
        print(f"  {name}: kernel {ms:.3f} ms, plain twin {plain_ms:.1f} ms, bound "
              f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}), max |err| "
              f"against the twin on {c} rows {err:.3g}, launches {launches[name]}", flush=True)
    result["pair_tests"].update(paths=paths, battery_ms=battery_ms)
    result["kruskal_groups"].update(paths=k_paths)
    result["rank_and_ties"].update(paths=r_paths)
    result["friedman"].update(paths=f_paths)
    pair_tests_paths()
    return result


def pair_tests_paths():
    """Kernel N forced onto each of its paths at PAIR_PATH_T on CHECK_ROWS -
    1 adversarial rows: the five tests against the twins, and stat and p of
    every test mask (1-31) on the warp and scratch paths equal to the cta
    path's bit for bit."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import pairwise as pw

    kw = dict(wilcoxon_table=pw.wilcoxon_pmf_table(DEV), ks_exact_max=pw.KS_EXACT_MAX_T,
              wilcoxon_exact_max_n=pw.WILCOXON_EXACT_MAX_N)
    for T in PAIR_PATH_T:
        n = [torch.from_numpy(a).to(DEV)
             for a in adversarial_tests(CHECK_ROWS - 1, T, np.random.default_rng(SEED + T))]
        plain = pw.two_sample_tests_plain(*n)
        plain["sign"] = pw.sign_test_exact_plain(n[0], n[2], n[1] & n[3])
        err = 0.0
        for path in kernels.PAIR_PATHS:
            err = max(err, compare_pair_tests(kernels.pair_tests(*n, 31, **kw, path=path), plain,
                                              pw.TWO_SAMPLE_TESTS + ("sign",)))
        for mask in range(1, 1 << len(kernels.PAIR_TEST_BITS)):
            cta = kernels.pair_tests(*n, mask, **kw, path="cta")
            for path in ("warp", "scratch"):
                got = kernels.pair_tests(*n, mask, **kw, path=path)
                check(same_bits(got[0], cta[0]) and same_bits(got[1], cta[1]),
                      f"pair_tests T={T} mask {mask}: the {path} path differs from the cta path")
        torch.cuda.synchronize()
        print(f"  pair_tests T={T}, each path forced on {CHECK_ROWS - 1} rows: max |dp| "
              f"{err:.3g} against the twins; stat and p of masks 1-31 on the warp and scratch "
              f"paths equal to the cta path's bit for bit", flush=True)


# ---------------------------------------------------------------------------
# the fleet scorer on torch.distributed (kernel P)
# ---------------------------------------------------------------------------
FLEET_K = 8
FLEET_TIMEOUT_S = 300  # a hung collective ends the run
CFG_KEYS = ("pvalue_threshold", "test_mask", "combine", "ma_window", "band_threshold",
            "bound_mode", "min_lower_bound", "min_points")


def fleet_path(pair_args):
    """make_fleet_scorer at the north-star shape in a world of one over
    NCCL, then fleet_summary alone and on built ties; kernel P against its
    twin and beside torch.topk."""
    import faulthandler

    import torch.distributed as dist

    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl
    from foremast_tpu_torch.parallel import mesh as pm

    faulthandler.dump_traceback_later(FLEET_TIMEOUT_S, exit=True)
    started = pm.world_of_one(DEV)
    try:
        mesh = pm.fleet_mesh(device=DEV)
        check(dist.get_backend() == "nccl", f"the fleet world runs {dist.get_backend()}")
        t = fl.pair_args_from_numpy(pair_args, DEV)
        cfg = dict(zip(CFG_KEYS, t[4:]))
        B = t[0].shape[0]
        run = fl.make_fleet_scorer(mesh, k=FLEET_K)
        kernels.reset_launches()
        out, total, top_v, top_idx = run(*t[:4], cfg)
        torch.cuda.synchronize()
        launches = dict(kernels.launches)
        paths = dict(kernels.pair_path_launches)
        p_paths = dict(kernels.fleet_topk_path_launches)
        for name in ("pair_verdict", "fleet_topk"):
            check(launches[name] >= 1, f"make_fleet_scorer did not launch {name}")
        check(paths["warp"] == launches["pair_verdict"],
              f"make_fleet_scorer at T = {PAIR_T} ran pair_verdict's paths {paths}")
        check(p_paths["select"] == launches["fleet_topk"],
              f"make_fleet_scorer at k = {FLEET_K} ran fleet_topk's paths {p_paths}")
        ref = fl.score_pairs(*t, device=DEV)
        for key, v in ref.items():
            check(torch.equal(out[key], v), f"make_fleet_scorer's {key} differs from score_pairs'")
        want = fl.fleet_topk_plain(ref["severity"], FLEET_K, ref["unhealthy"])
        err = compare_topk((torch.tensor(total), top_v, top_idx), want,
                           "make_fleet_scorer's summary")
        summary = fl.fleet_summary(ref["unhealthy"], ref["severity"], mesh, k=FLEET_K)
        err = max(err, compare_topk((torch.tensor(summary[0]),) + tuple(summary[1:]), want,
                                    "fleet_summary"))
        # ties: equal severities come lower index first; with three unhealthy
        # rows the -inf tail carries the lowest healthy indices
        u = torch.ones(B, dtype=torch.bool, device=DEV)
        sev = torch.full((B,), 12.0, device=DEV)
        sev[B // 2] = 13.0
        _, tv, ti = fl.fleet_summary(u, sev, mesh, k=FLEET_K)
        check(ti.tolist() == [B // 2] + list(range(FLEET_K - 1)), f"tie order {ti.tolist()}")
        u[:] = False
        u[[10, 20, 30]] = True
        tot, tv, ti = fl.fleet_summary(u, sev, mesh, k=FLEET_K)
        check(tot == 3 and ti.tolist() == [10, 20, 30] + list(range(FLEET_K - 3))
              and bool(torch.isinf(tv[3:]).all()), f"-inf tail {tot} {ti.tolist()}")
        for k in TOPK_CHECK_K:
            err = max(err, compare_topk(kernels.fleet_topk(ref["severity"], k, ref["unhealthy"]),
                                        fl.fleet_topk_plain(ref["severity"], k, ref["unhealthy"]),
                                        f"fleet_topk k={k} on the scored fleet"))
            topk_paths_agree(ref["severity"], k, ref["unhealthy"], 0)

        e2e = wall_ms(lambda: run(*t[:4], cfg), TIMED_RUNS)
        score = wall_ms(lambda: fl.score_pairs(*t, device=DEV), TIMED_RUNS)
        reduce = wall_ms(lambda: fl.fleet_summary(ref["unhealthy"], ref["severity"], mesh,
                                                  k=FLEET_K), TIMED_RUNS)
        u, s = ref["unhealthy"], ref["severity"]
        # kernel P is shorter than its launcher's host work: its device time
        # with the launches queued, and the time a call takes from the host
        ms = queued_ms(lambda: kernels.fleet_topk(s, FLEET_K, u), TIMED_RUNS)
        host_ms = cuda_ms(lambda: kernels.fleet_topk(s, FLEET_K, u), TIMED_RUNS)
        plain_ms = cuda_ms(lambda: fl.fleet_topk_plain(s, FLEET_K, u), TIMED_RUNS)
        chunked_ms = queued_ms(lambda: kernels.fleet_topk(s, FLEET_K, u, path="chunked"),
                               TIMED_RUNS)
        library_ms = queued_ms(lambda: (torch.topk(torch.where(u, s, -torch.inf), FLEET_K),
                                        u.sum()), TIMED_RUNS)
        # the select path's floor: its two launches with nothing in them
        floor_ms = queued_ms(lambda: kernels.empty_launches(2, s.device), TIMED_RUNS)
        med = float(np.median(e2e))
        print(f"  make_fleet_scorer, {B} pairs at T = {PAIR_T}, k = {FLEET_K}, a world of one "
              f"over {dist.get_backend()}: total {total}, top_idx {top_idx.tolist()}; "
              f"launches {launches}; pair_verdict by path {paths}; fleet_topk by path "
              f"{p_paths}", flush=True)
        print(f"  make_fleet_scorer wall, {TIMED_RUNS} runs: median {med:.3f} ms, p99 "
              f"{np.percentile(e2e, 99):.3f} ms", flush=True)
        print(f"  canary_pairs_scored_per_sec_per_chip: {B / med * 1e3:.0f}", flush=True)
        print(f"  the reduction (fleet_summary: kernel P twice, two all_gathers) median "
              f"{np.median(reduce):.3f} ms beside the scoring (score_pairs) median "
              f"{np.median(score):.3f} ms", flush=True)
        bound = least_time(B * 5 + FLEET_K * 12 + 8, B)
        print(f"  fleet_topk, device time with the launches queued: kernel {ms:.4f} ms (the "
              f"chunked path forced {chunked_ms:.4f} ms), torch.topk + sum {library_ms:.4f} ms, "
              f"two empty launches {floor_ms:.4f} ms; bound {bound['bound_ms']:.5f} ms "
              f"({bound['bound_by']}); a call from the host {host_ms:.4f} ms, plain twin "
              f"{plain_ms:.4f} ms", flush=True)
    finally:
        faulthandler.cancel_dump_traceback_later()
        if started:
            dist.destroy_process_group()
    return {"launches": launches["fleet_topk"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms, **bound, "paths": p_paths,
            "chunked_ms": chunked_ms, "launch_floor_ms": floor_ms, "host_ms": host_ms}


# ---------------------------------------------------------------------------
# the band path at full size
# ---------------------------------------------------------------------------
def band_path_inputs(gen):
    """The band path's rows on the card and which are shifted: the simfleet
    shape (512 history + 128 current in bucket 1024), 2% lost points, a
    +8 sigma level shift in 10% of the current windows, 3 sigma both
    bounds."""
    dev = DEV
    B, T, n = BAND_ROWS, BAND_T, BAND_HIST + BAND_CUR
    level = 20 + 80 * torch.rand((B, 1), generator=gen, device=dev)
    noise = level / 10
    x = level + noise * torch.randn((B, T), generator=gen, device=dev)
    t = torch.arange(T, device=dev)
    mask = (t < n) & (torch.rand((B, T), generator=gen, device=dev) > 0.02)
    region = ((t >= BAND_HIST) & (t < n)).expand(B, T).contiguous()
    shifted = torch.rand(B, generator=gen, device=dev) < 0.10
    x = torch.where(shifted[:, None] & region, x + 8 * noise, x).contiguous()
    thr = torch.full((B,), 3.0, device=dev)
    mode = torch.full((B,), 3, dtype=torch.int32, device=dev)
    mlb = torch.zeros(B, device=dev)
    return (x, mask, region, thr, mode, mlb), shifted


def band_path(gen):
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    args, shifted = band_path_inputs(gen)
    x, mask, region, thr, mode, mlb = args
    B, T = x.shape
    kernels.reset_launches()
    out = fc.moving_average_band(x, mask, region, 30, thr, mode, mlb, device=DEV)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    paths = dict(kernels.band_path_launches)
    check(launches["ma_band"] >= 1, "the band path did not launch ma_band")
    check(paths[kernels.band_path(T)] == launches["ma_band"] == 1,
          f"the band path at T = {T} ran ma_band's paths {paths}, not the "
          f"{kernels.band_path(T)} path once")
    frac = out["count"].float() / out["checked"].clamp(min=1).float()
    flagged = (frac > 0.3).cpu().numpy()
    sh = shifted.cpu().numpy()
    recall, fp = float(flagged[sh].mean()), float(flagged[~sh].mean())
    check(bool(torch.isfinite(out["sigma"]).all()), "band sigma not finite")
    check(recall == 1.0, f"band recall {recall:.4f} < 1")
    check(fp < 0.01, f"band false-positive share {fp:.4f} >= 0.01")
    print(f"  verdicts: recall {recall:.4f} on {int(sh.sum())} shifted rows, false positives "
          f"{fp:.5f} (limit 0.01); launches {launches}; ma_band by path {paths}", flush=True)

    sub = tuple(a[:CHECK_ROWS] for a in args)
    err, bracketed = compare_ma_band(sub, 30, fc.moving_average_band(*sub[:3], 30, *sub[3:],
                                                                      device=DEV),
                                     fc.moving_average_band_plain(*sub[:3], 30, *sub[3:]))
    print(f"  kernel vs twin on {CHECK_ROWS} of these rows: max |d preds| = {err:.3g}, "
          f"{bracketed} rows bracketed; ma_band's {band_paths_agree(sub, 30)}", flush=True)

    def run():
        return fc.moving_average_band(x, mask, region, 30, thr, mode, mlb, device=DEV)

    e2e = wall_ms(run, TIMED_RUNS)
    ms = cuda_ms(run, TIMED_RUNS)
    plain_ms = cuda_ms(lambda: fc.moving_average_band_plain(x, mask, region, 30, thr, mode, mlb), 3)
    print(f"  moving_average_band, {TIMED_RUNS} runs: median {np.median(e2e):.3f} ms, "
          f"p99 {np.percentile(e2e, 99):.3f} ms, {B / np.median(e2e) * 1e3:.0f} rows/s; "
          f"kernel {ms:.3f} ms; plain twin {plain_ms:.1f} ms", flush=True)
    nbytes = B * T * (4 + 1 + 1) + B * 12 + B * T * (4 * 3 + 1) + B * 16
    g = triage_beside_band(args, "bands", TIMED_RUNS)
    return {"launches": launches["ma_band"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "paths": paths, **least_time(nbytes, 20 * B * T)}, g


# ---------------------------------------------------------------------------
# the seasonal band path at full size
# ---------------------------------------------------------------------------
# The engine's band verdict (EngineConfig.band_min_points,
# band_violation_fraction): unhealthy when count >= max(2, 0.1 checked).
BAND_MIN_POINTS, BAND_VIOLATION_FRACTION = 2, 0.1
# The kernels each algorithm's forecast_band must launch.
SEASON_KERNELS = {"holt_winters": ("detect_period", "hw_fit", "smooth", "band_from_preds"),
                  "exponential_smoothing": ("affine_scan", "band_from_preds"),
                  "double_exponential": ("smooth", "band_from_preds"),
                  "seasonal_trend": ("detect_period", "st_fit", "band_from_preds")}
# Detection limits. DES is held to sanity bounds only: the reference's own
# DES (the engine's fixed alpha 0.5, beta 0.1) extrapolates its trend
# across the 60-point window, and on this data flags ~6% of healthy rows
# and ~98.7% of shifted ones (the JAX reference on the CPU, 1,500 rows of
# this generator); the port's DES counts equal the reference's there.
# seasonal_trend is held to the full limits: on rows of this generator the
# JAX reference's verdicts equal the port's twin's on every row, with
# recall >= 0.99 and <= 1% of the healthy rows flagged (tests/
# test_torch_seasonal_trend.py, on the CPU).
SEASON_LIMITS = {"holt_winters": (0.99, 0.01), "exponential_smoothing": (0.99, 0.01),
                 "double_exponential": (0.95, 0.15), "seasonal_trend": (0.99, 0.01),
                 "moving_average_all": (0.99, 0.01)}


def season_inputs(gen, rows=SEASON_ROWS, dev=None, T=SEASON_T, hist=SEASON_HIST):
    """The seasonal path's rows on the card and their truth: 7 days of
    60 s history (10,080 points; `hist`) + 60 current points in bucket 16384
    (`T`); a
    level in [20, 100], white noise of sigma = level / 20; 40% a daily
    cycle (1440 steps), 30% an 8-hour shift cycle (480), each of amplitude
    2-4 sigma and random phase, 30% aperiodic with a trend of up to
    +-2 sigma over the history; 5% lost scrapes; a +8 sigma level shift in
    the current window of 10% of the rows. The band policy is the
    reference's cpu / memory one (ML_THRESHOLD 5, ML_BOUND upper). Made in
    chunks of rows to bound the temporaries. `rows` and `dev` let the
    tests make a few rows on the CPU."""
    dev = dev or DEV
    B, n = rows, hist + SEASON_CUR

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    kind = torch.where(u(B) < 0.4, 0, torch.where(u(B) < 0.5, 1, 2))
    shifted = u(B) < 0.10
    level = 20 + 80 * u(B)
    sigma = level / 20
    amp, phase = sigma * (2 + 2 * u(B)), 2 * math.pi * u(B)
    slope = (u(B) - 0.5) * 4 * sigma / hist
    cycle = torch.where(kind == 0, 1440.0, 480.0)
    t = torch.arange(T, device=dev, dtype=torch.float32)
    region_row = (t >= hist) & (t < n)
    x = torch.empty((B, T), device=dev)
    mask = torch.empty((B, T), dtype=torch.bool, device=dev)
    for lo in range(0, B, 8192):
        s = slice(lo, min(B, lo + 8192))
        k = kind[s][:, None]
        v = level[s, None] + sigma[s, None] * torch.randn((s.stop - lo, T), generator=gen,
                                                          device=dev)
        v += torch.where(k < 2, amp[s, None] * torch.sin(2 * math.pi * t / cycle[s, None]
                                                         + phase[s, None]),
                         slope[s, None] * t)
        v += torch.where(shifted[s, None] & region_row, 8 * sigma[s, None], 0.0)
        m = (t < n) & (u(s.stop - lo, T) > 0.05)
        x[s] = torch.where(m, v, 0.0)
        mask[s] = m
    region = region_row.expand(B, T).contiguous()
    policy = (torch.full((B,), 5.0, device=dev), torch.full((B,), 1, dtype=torch.int32, device=dev),
              torch.zeros(B, device=dev))
    return (x, mask, region) + policy, kind, shifted


def season_bounds(B, T, n_fit, G, walked):
    """Least time (ms, bound_by) for each seasonal kernel's work on these
    inputs: bytes each input read and each output written once over HBM,
    against the operations at the fp32 instruction rate (a float64 add
    counted as two). Per step: SES 3 operations (its scan form ~11), DES 8,
    Holt-Winters 14 per candidate plus 5 per fitted point; the band ~10
    per slot. The Holt-Winters fit needs its steps only up to each row's
    last fitted slot (mask & fit): `walked` of them. Kernel F's bound is
    period_bound's."""
    BT = B * T
    return {
        "smooth": least_time(BT * 9 + B * 8, 8 * BT),
        # the Holt-Winters refit: kernel C with each row's winner and period
        "smooth_hw": least_time(BT * 9 + B * 16, 14 * BT),
        "affine_scan": least_time(BT * 9 + B * 4, 11 * BT),
        "hw_fit": least_time(BT * 6 + B * (4 + 12 + 4 + 8 * G) + G * 12,
                             14 * G * walked + 5 * G * n_fit),
        "band_from_preds": least_time(BT * 19 + B * 28, 10 * BT),
    }


def period_bound(hist, cands):
    """Least time of kernel F's work on these rows: the mask read once, x
    at its valid slots, the fallback, the period and the scores; the
    detrend, 12 operations a slot, and 13 a pair of slots at each distinct
    lag (a float64 add counted as two), both up to each row's last valid
    slot, the slots after it holding exact zeros. The distinct lags are each
    candidate 2 <= p < T and, from 4 on, its half. `bound_all_ms` counts
    every slot, as the first design's bound did."""
    B, T = hist.shape
    lags = {q for p in cands if 2 <= p < T for q in ((p, p // 2) if p >= 4 else (p,))}
    t = torch.arange(T, device=hist.device)
    ends = (torch.where(hist, t, -1).amax(1) + 1).double()
    pairs = sum(float((ends - p).clamp(min=0).sum()) for p in lags)
    out_b = B * (8 + 4 * len(cands))
    need = least_time(B * T + 4 * int(hist.sum()) + out_b, 12 * float(ends.sum()) + 13 * pairs)
    every = least_time(B * T * 5 + out_b, 12 * B * T + 13 * B * sum(T - p for p in lags))
    return {**need, "bound_all_ms": every["bound_ms"]}


def hpa_bound(tps_mask, region, sla_mask, sigma_given=False):
    """Least time of kernel I's work on these rows: tps and the three
    masks read at every slot, tps_pred where the region or (hpa_from_preds)
    the traffic history needs it, sla where its mask holds, the per-row
    parameters and the outputs; ~30 operations a slot. `bound_all_ms`
    counts every slot's 15 B, as the first design's bound did."""
    B, T = tps_mask.shape
    need_p = region if sigma_given else region | tps_mask
    nbytes = B * T * 7 + 4 * int(need_p.sum()) + 4 * int(sla_mask.sum()) + B * (25 + 48)
    every = least_time(B * T * 15 + B * (25 + 48), 30.0 * B * T)
    return {**least_time(nbytes, 30.0 * B * T), "bound_all_ms": every["bound_ms"]}


ST_D = 2 + ST_CHANGEPOINTS + 2 * ST_ORDER


def st_bound(B, T, n_fit, D=ST_D):
    """Least time of kernel J's work: each input read once (value, mask,
    fit mask, period) and each output written once (preds, beta), against
    its multiply-adds, (D + 1)(D + 2) / 2 - 1 per fitted slot for the
    gram [G rhs] and D per slot for preds, one instruction slot each. The
    gram is a float64 matrix product, which the tensor cores run at 67
    TFLOP/s, the fp32 rate outside them; preds are float32 in the
    reference."""
    ne = (D + 1) * (D + 2) // 2 - 1
    return least_time(B * T * 10 + B * (4 + 4 * D), ne * n_fit + D * B * T)


def cholesky_ms(x, mask, fit, period):
    """Time of torch.linalg.cholesky + cholesky_solve on the first solve's
    (D, D) float64 systems of these rows (built here as kernel J's twin
    builds them)."""
    from foremast_tpu_torch.ops import forecast as fc

    B, T = x.shape
    A = torch.empty((B, ST_D, ST_D), dtype=torch.float64, device=DEV)
    rhs = torch.empty((B, ST_D, 1), dtype=torch.float64, device=DEV)
    pen = torch.full((ST_D,), 1e-4, dtype=torch.float64, device=DEV)
    pen[2:2 + ST_CHANGEPOINTS] += 3e-3
    sel = mask & fit
    for p in torch.unique(period).tolist():
        X = fc.st_columns(T, p, ST_ORDER, ST_CHANGEPOINTS, DEV).double()
        rows = torch.nonzero(period == p)[:, 0]
        for lo in range(0, rows.numel(), 256):
            r = rows[lo:lo + 256]
            s = sel[r].double()
            A[r] = (s[:, :, None] * X).transpose(1, 2) @ X + torch.diag(pen)
            rhs[r] = (torch.where(sel[r], x[r].double(), 0.0) @ X)[:, :, None]
    return cuda_ms(lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(A)), 3)


def season_moving_average(args, shifted):
    """forecast_band under moving_average_all on the seasonal phase's rows
    (7 days of history in bucket 16384): kernel B's ma_band on its long
    path, recall and false positives against the planted shifts at the
    engine's band verdict, the path counter, and every path that serves T
    equal to the unstaged path's bits on every row; then ma_band alone
    (mean of SEASON_RUNS), its bound, its twin (in row chunks) and the twin's
    comparison on the first CHECK_ROWS rows."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    x, mask, region, thr, mode, mlb = args
    B, T = x.shape
    kernels.reset_launches()
    out = fc.forecast_band(*args, algorithm="moving_average_all", device=DEV)
    torch.cuda.synchronize()
    ran = dict(kernels.launches)
    paths = dict(kernels.band_path_launches)
    check(kernels.band_path(T) == "long" and paths["long"] == ran["ma_band"] == 1,
          f"moving_average_all at T = {T} ran ma_band's paths {paths}, not the long path once")
    gate = torch.clamp(BAND_VIOLATION_FRACTION * out["checked"].float(), min=BAND_MIN_POINTS)
    flagged = out["count"].float() >= gate
    recall = float(flagged[shifted].float().mean())
    fp = float(flagged[~shifted].float().mean())
    check(bool(torch.isfinite(out["sigma"]).all()), "moving_average_all: sigma not finite")
    check(bool((out["checked"] == (mask & region).sum(1)).all()),
          "moving_average_all: checked differs")
    min_recall, max_fp = SEASON_LIMITS["moving_average_all"]
    check(recall >= min_recall, f"moving_average_all: recall {recall:.4f} < {min_recall}")
    check(fp < max_fp, f"moving_average_all: false-positive share {fp:.5f} >= {max_fp}")
    del out, flagged
    e2e = wall_ms(lambda: fc.forecast_band(*args, algorithm="moving_average_all", device=DEV),
                  SEASON_RUNS)
    print(f"  moving_average_all: recall {recall:.5f} on {int(shifted.sum())} shifted rows, "
          f"false positives {fp:.5f} (limits {min_recall}, {max_fp}); forecast_band "
          f"{SEASON_RUNS} runs: median {np.median(e2e):.3f} ms, p99 "
          f"{np.percentile(e2e, 99):.3f} ms, {B / np.median(e2e) * 1e3:.0f} rows/s; launches "
          f"{ {k: v for k, v in ran.items() if v} }; ma_band by path {paths}", flush=True)
    same = band_paths_agree(args, 30)
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: kernels.ma_band(x, mask, region, 30, thr, mode, mlb), SEASON_RUNS)
    plain_ms = chunked_ms(lambda s: fc.moving_average_band_plain(
        x[s], mask[s], region[s], 30, thr[s], mode[s], mlb[s]), B)
    sub = tuple(a[:CHECK_ROWS] for a in args)
    err, bracketed = compare_ma_band(sub, 30, kernels.ma_band(*sub[:3], 30, *sub[3:]),
                                     fc.moving_average_band_plain(*sub[:3], 30, *sub[3:]))
    bound = least_time(B * T * 19 + B * 28, 20 * B * T)
    print(f"  ma_band on these rows ({B} x {T}): {same} on every row; kernel {ms:.3f} ms, bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), plain twin {plain_ms:.1f} ms; "
          f"against the twin on {CHECK_ROWS} rows: max |d preds| {err:.3g}, {bracketed} rows "
          f"bracketed", flush=True)
    return {"launches": ran["ma_band"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "path": kernels.band_path(T), "paths": paths, **bound}


def seasonal_path(gen):
    """Drive forecast_band under each algorithm at full size, then time
    each of its kernels alone and its twin on the path's inputs."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.ops import seqscan as sq

    t0 = time.perf_counter()
    args, kind, shifted = season_inputs(gen)
    torch.cuda.synchronize()
    x, mask, region, thr, mode, mlb = args
    B, T = x.shape
    print(f"  {B} rows x {T} slots made on the card in {time.perf_counter() - t0:.1f} s; "
          f"{int((kind == 0).sum())} daily, {int((kind == 1).sum())} shift, "
          f"{int((kind == 2).sum())} aperiodic, {int(shifted.sum())} shifted", flush=True)
    periodic = kind < 2
    planted = torch.where(kind == 0, 1440, 480).to(torch.int32)
    ma_row = season_moving_average(args, shifted)
    launches = {k: 0 for k in kernels.launches}
    for algo in SEASON_ALGOS:
        kernels.reset_launches()
        out = fc.forecast_band(*args, algorithm=algo, device=DEV)
        torch.cuda.synchronize()
        ran = dict(kernels.launches)
        for k in SEASON_KERNELS[algo]:
            check(ran[k] >= 1, f"{algo} did not launch {k}")
        for k, v in ran.items():
            launches[k] += v
        gate = torch.clamp(BAND_VIOLATION_FRACTION * out["checked"].float(), min=BAND_MIN_POINTS)
        flagged = out["count"].float() >= gate
        recall = float(flagged[shifted].float().mean())
        fp = float(flagged[~shifted].float().mean())
        check(bool(torch.isfinite(out["sigma"]).all()), f"{algo}: sigma not finite")
        check(bool(torch.isfinite(out["preds"][mask]).all()), f"{algo}: predictions not finite")
        check(bool((out["checked"] == (mask & region).sum(1)).all()), f"{algo}: checked differs")
        min_recall, max_fp = SEASON_LIMITS[algo]
        check(recall >= min_recall, f"{algo}: recall {recall:.4f} < {min_recall}")
        check(fp < max_fp, f"{algo}: false-positive share {fp:.5f} >= {max_fp}")
        line = (f"  {algo}: recall {recall:.5f} on {int(shifted.sum())} shifted rows, false "
                f"positives {fp:.5f} (limits {min_recall}, {max_fp})")
        if "period" in out:
            got = out["period"]
            rec = float((got[periodic] == planted[periodic]).float().mean())
            check(rec >= 0.99, f"planted period recovered on {rec:.4f} < 0.99 of periodic rows")
            line += (f"; planted period recovered on {rec:.5f} of {int(periodic.sum())} "
                     f"periodic rows; aperiodic rows on the fallback 1440: "
                     f"{float((got[~periodic] == 1440).float().mean()):.5f}")
        if algo == "seasonal_trend":
            check(bool(torch.isfinite(out["beta"]).all()), "seasonal_trend: beta not finite")
            st_period = out["period"]
        if algo == "holt_winters":
            # the refit alone: kernel C under each row's fitted parameters
            check(ran["smooth"] == 1, f"holt_winters ran the refit {ran['smooth']} times")
            prm = out["params"]
            refit = (x, mask & ~region, prm[:, 0].contiguous(), prm[:, 1].contiguous(),
                     prm[:, 2].contiguous(), got)
            hw_row = smooth_hw_row(refit, ran["smooth"])
            del prm, refit
        e2e = wall_ms(lambda: fc.forecast_band(*args, algorithm=algo, device=DEV), SEASON_RUNS)
        print(line + f"; forecast_band {SEASON_RUNS} runs: median {np.median(e2e):.3f} ms, "
              f"p99 {np.percentile(e2e, 99):.3f} ms, {B / np.median(e2e) * 1e3:.0f} rows/s; "
              f"launches {ran}", flush=True)

    # each kernel alone on the path's inputs, beside its twin; comparisons on
    # the first rows (the smoother and fit twins step in Python)
    hist = mask & ~region
    n, c = SERIES_CHECK_ROWS, CHECK_ROWS
    f32 = dict(dtype=torch.float32, device=DEV)
    rows = {}
    fb = torch.full((B,), 1440, dtype=torch.int32, device=DEV)
    candt = torch.tensor(PERIOD_CANDIDATES, dtype=torch.int32, device=DEV)

    def detect():
        return kernels.detect_period(x, hist, candt, fb, 0.2, 0.05, 0.01)

    period, _ = detect()
    err, _ = compare_detect_period(x[:c], hist[:c], PERIOD_CANDIDATES, fb[:c],
                                   kernels.detect_period(x[:c], hist[:c], candt, fb[:c],
                                                         0.2, 0.05, 0.01))
    rows["detect_period"] = (err, cuda_ms(detect, 3), cuda_ms(
        lambda: fc.detect_period_plain(x, hist, PERIOD_CANDIDATES, fb, 0.2, 0.05, 0.01), 1))
    fit = hist & (torch.arange(T, device=DEV) >= 2 * period[:, None])
    grid = torch.tensor(fc.DEFAULT_GRID, **f32)
    err = compare_hw_fit(x[:n], hist[:n], fit[:n], period[:n], grid,
                         kernels.hw_fit(x[:n], hist[:n], fit[:n], period[:n], grid))
    rows["hw_fit"] = (err, cuda_ms(lambda: kernels.hw_fit(x, hist, fit, period, grid,
                                                          max_period=1440), 2),
                      cuda_ms(lambda: fc.fit_holt_winters_plain(x, hist, fit, period, grid), 1,
                              warm=False))
    fitted = fit & hist
    n_fit = int(fitted.sum())
    # steps up to each row's last fitted slot: all the fit needs
    walked = int((torch.where(fitted, torch.arange(T, device=DEV), -1).amax(1) + 1).sum())
    del fit, fitted
    al5, be1, al3 = (torch.full((B,), v, **f32) for v in (0.5, 0.1, 0.3))
    err = compare_smooth(2, x[:n], hist[:n], (al5[:n], be1[:n]),
                         kernels.smooth(2, x[:n], hist[:n], al5[:n], be1[:n]))
    # the step-by-step twins hold several (B, T) int64 temporaries: timed in
    # row chunks, the same work in bounded memory
    rows["smooth"] = (err, cuda_ms(lambda: kernels.smooth(2, x, hist, al5, be1), 3),
                      chunked_ms(lambda s: fc.smooth_plain(2, x[s], hist[s], al5[s], be1[s]), B))
    err = compare_scan(1, x[:c], hist[:c], (al3[:c],), kernels.affine_scan(1, x[:c], hist[:c],
                                                                             al3[:c]))
    rows["affine_scan"] = (err, cuda_ms(lambda: kernels.affine_scan(1, x, hist, al3), 3),
                           chunked_ms(lambda s: sq.ses_predictions_assoc_plain(x[s], hist[s],
                                                                              al3[s]), B))
    des_row = des_walk_row(x, hist, al5, be1, c)
    preds = kernels.smooth(2, x, hist, al5, be1)
    pol = (thr, mode, mlb)
    err, _ = compare_band_from_preds(
        x[:c], mask[:c], region[:c], preds[:c], thr[:c], mode[:c], mlb[:c],
        kernels.band_from_preds(x[:c], mask[:c], region[:c], preds[:c], *(p[:c] for p in pol)))
    rows["band_from_preds"] = (
        err, cuda_ms(lambda: kernels.band_from_preds(x, mask, region, preds, *pol), 5),
        cuda_ms(lambda: fc.band_from_preds_plain(x, mask, region, preds, *pol), 1))
    del preds
    # kernel J on the path's rows, each with the period kernel F gave it
    st = (x, hist, hist, st_period)
    cfg = (ST_ORDER, ST_CHANGEPOINTS, 1e-4, 3e-3, 3)
    sub = tuple(a[:c] for a in st)
    err, ill = compare_st_fit(sub, kernels.st_fit(*sub, *cfg), fc.fit_seasonal_trend_plain(
        *sub, ST_ORDER, 1e-4, ST_CHANGEPOINTS, 3e-3, 3), 2 + ST_CHANGEPOINTS + 2 * ST_ORDER)
    rows["st_fit"] = (err, cuda_ms(lambda: kernels.st_fit(*st, *cfg), 3),
                      cuda_ms(lambda: fc.fit_seasonal_trend_plain(
                          *st, ST_ORDER, 1e-4, ST_CHANGEPOINTS, 3e-3, 3), 1, warm=False))
    chol_ms = cholesky_ms(*st)
    n_st = int(hist.sum())
    bounds = season_bounds(B, T, n_fit, grid.shape[0], walked)
    bounds["detect_period"] = period_bound(hist, PERIOD_CANDIDATES)
    print(f"  detect_period: bound {bounds['detect_period']['bound_ms']:.3f} ms "
          f"({bounds['detect_period']['bound_by']}, each row's sweeps to its last valid slot); "
          f"counted over every slot: {bounds['detect_period']['bound_all_ms']:.3f} ms", flush=True)
    bounds["st_fit"] = st_bound(B, T, n_st)
    print(f"  st_fit: vs twin on {c} rows, {ill} ill-posed; torch.linalg.cholesky + "
          f"cholesky_solve of the same {B} ({ST_D} x {ST_D}) float64 systems {chol_ms:.3f} ms "
          f"(for the record: the solve alone, not the fit)", flush=True)
    # kernel D's own floor: its season rings live in device memory, each
    # walked step reading and writing one slot of every candidate's ring
    ring_b = 2 * 4 * kernels.build.library().fm_hw_fit_ring_row(grid.shape[0])
    fb_ = bounds["hw_fit"]
    print(f"  hw_fit: bound {fb_['bound_ms']:.3f} ms ({fb_['bound_by']}) over {walked} walked "
          f"steps of {B * T} (each row to its last fitted slot); this design's own floor, its "
          f"season rings' traffic of {ring_b} B a walked step ({walked * ring_b / 1e9:.1f} GB): "
          f"{walked * ring_b / HBM_BYTES_PER_S * 1e3:.3f} ms", flush=True)
    hw_row.update(bounds["smooth_hw"])
    print(f"  smooth_hw, the Holt-Winters refit alone: kernel "
          f"{hw_row['ms']:.3f} ms, bound {hw_row['bound_ms']:.3f} ms ({hw_row['bound_by']}, 9 B a "
          f"slot), plain twin {hw_row['plain_ms']:.1f} ms, max |err| against the twin "
          f"{hw_row['max_abs_err']:.3g}", flush=True)
    prophet = st_prophet_leg(args, st, c)
    c2048 = period_wide_leg(x, hist)
    # kernel G on the same rows, 7 days of history (bucket 16384)
    g = triage_beside_band(args, "seasonal", SEASON_RUNS)
    result = {}
    for name, (err, ms, plain_ms) in rows.items():
        result[name] = {"launches": launches[name], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain_ms, **bounds[name]}
        print(f"  {name}: kernel {ms:.3f} ms, plain twin {plain_ms:.1f} ms, bound "
              f"{bounds[name]['bound_ms']:.3f} ms ({bounds[name]['bound_by']}), max |err| "
              f"against the twin {err:.3g}, launches on the path {launches[name]}", flush=True)
    result["smooth_hw"] = hw_row
    result["affine_scan_des"] = des_row
    result["ma_band"] = ma_row
    result["st_fit"]["d47"] = prophet
    result["detect_period"]["c2048"] = c2048
    return result, g


def des_walk_row(x, hist, al, be, c):
    """Kernel E's DES on the seasonal rows (the engine's alpha 0.5, beta
    0.1) through seqscan.des_predictions_assoc, its launches counted: the
    walk path at this many rows, the twin's bits on the first c rows; its
    time beside its bound, the twin's (in row chunks) and the scan path's
    forced on the same rows and on one row."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import seqscan as sq

    B, T = x.shape
    kernels.reset_launches()
    got = sq.des_predictions_assoc(x, hist, al, be)
    torch.cuda.synchronize()
    paths = dict(kernels.scan_path_launches)
    check(paths == {"scan": 0, "walk": 1}, f"des_predictions_assoc on {B} rows: {paths}")
    twin = sq.des_predictions_assoc_plain(x[:c], hist[:c], al[:c], be[:c])
    check(same_bits_nan(got[:c], twin),
          "affine_scan's walk on the seasonal rows: not the twin's bits")
    del got
    des = kernels.SMOOTH_DES
    row = {"launches": kernels.launches["affine_scan"], "max_abs_err": 0.0, "path": "walk",
           "paths": paths, "T": T,
           "ms": cuda_ms(lambda: kernels.affine_scan(des, x, hist, al, be), 5),
           "scan_ms": cuda_ms(lambda: kernels.affine_scan(des, x, hist, al, be, path="scan"), 3),
           "scan_one_row_ms": cuda_ms(lambda: kernels.affine_scan(
               des, x[:1], hist[:1], al[:1], be[:1], path="scan"), 5),
           "walk_one_row_ms": cuda_ms(lambda: kernels.affine_scan(
               des, x[:1], hist[:1], al[:1], be[:1], path="walk"), 5),
           "plain_ms": chunked_ms(lambda s: sq.des_predictions_assoc_plain(
               x[s], hist[s], al[s], be[s]), B),
           **least_time(B * T * 9 + B * 8, 11 * B * T)}
    print(f"  affine_scan DES, {B} rows x {T} (des_predictions_assoc, the walk path): "
          f"{row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}), the scan path "
          f"forced {row['scan_ms']:.3f} ms; one row: scan {row['scan_one_row_ms']:.3f} ms, walk "
          f"{row['walk_one_row_ms']:.3f} ms; twin {row['plain_ms']:.1f} ms; the twin's bits on "
          f"{c} rows", flush=True)
    return row


PERIOD_WIDE_ROWS = 10_000  # the seasonal rows kernel F's tiled path is timed on


def period_wide_leg(x, hist):
    """Kernel F's tiled path on the first PERIOD_WIDE_ROWS seasonal rows
    (cut for time) with PERIOD_WIDE_CHECK[-1] candidates (2 to 2049):
    launched once on that path, its time beside its bound, against the twin
    on 64 rows and the twin's time on them."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    C = PERIOD_WIDE_CHECK[-1]
    cands = tuple(range(2, 2 + C))
    rows = PERIOD_WIDE_ROWS
    xs, hs = x[:rows], hist[:rows]
    ct = torch.tensor(cands, dtype=torch.int32, device=DEV)
    fb = torch.full((rows,), 7, dtype=torch.int32, device=DEV)
    kernels.reset_launches()
    kernels.detect_period(xs, hs, ct, fb, 0.2, 0.05, 0.01)
    torch.cuda.synchronize()
    check(kernels.period_path_launches == {"table": 0, "tiled": 1},
          f"detect_period with {C} candidates: {kernels.period_path_launches}")
    ms = cuda_ms(lambda: kernels.detect_period(xs, hs, ct, fb, 0.2, 0.05, 0.01), 2)
    err, near = compare_detect_period(xs[:64], hs[:64], cands, fb[:64], kernels.detect_period(
        xs[:64], hs[:64], ct, fb[:64], 0.2, 0.05, 0.01))
    plain_ms = cuda_ms(lambda: fc.detect_period_plain(xs[:64], hs[:64], cands, fb[:64], 0.2),
                       1, warm=False)
    bound = period_bound(hs, cands)
    print(f"  detect_period's tiled path, {C} candidates on {rows} rows x {x.shape[1]}: kernel "
          f"{ms:.3f} ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}); against the "
          f"twin on 64 rows: max |d score| {err:.3g}, {near} bracketed, the twin "
          f"{plain_ms:.1f} ms on those rows", flush=True)
    return {"C": C, "rows": rows, "path": "tiled", "launches": 1, "ms": ms, "max_abs_err": err,
            "plain_ms": plain_ms, "plain_rows": 64, **bound}


def st_prophet_leg(args, st, c):
    """Prophet's published defaults (ST_PROPHET_C changepoints, order
    ST_PROPHET_ORDER: D = 47, kernel J's cta path) on the seasonal phase's
    rows: forecast_band under seasonal_trend once (kernel J launched once, on
    the cta path; sigma and the valid slots' predictions finite) and its
    wall time (median of 2); kernel J alone on the rows with F's periods
    (st) beside its bound; against the twin on the first c rows, and the
    twin's time on those rows. Returns the leg's record."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    C, order = ST_PROPHET_C, ST_PROPHET_ORDER
    D = 2 + C + 2 * order
    x, mask = args[:2]
    B, T = x.shape

    def band():
        return fc.forecast_band(*args, algorithm="seasonal_trend", st_order=order,
                                st_changepoints=C, device=DEV)

    kernels.reset_launches()
    out = band()
    torch.cuda.synchronize()
    check(kernels.launches["st_fit"] == 1 and kernels.st_path_launches["cta"] == 1,
          f"seasonal_trend at D = {D}: st_fit launches {kernels.st_path_launches}")
    check(bool(torch.isfinite(out["sigma"]).all()) and bool(torch.isfinite(out["preds"][mask]).all()),
          f"seasonal_trend at D = {D}: sigma or predictions not finite")
    del out
    e2e = wall_ms(band, 2)
    sub = tuple(a[:c] for a in st)
    kern = kernels.st_fit(*sub, order, C, 1e-4, 3e-3, 3)
    plain_ms = cuda_ms(lambda: fc.fit_seasonal_trend_plain(*sub, order, 1e-4, C, 3e-3, 3), 1,
                       warm=False)
    err, ill = compare_st_fit(sub, kern, fc.fit_seasonal_trend_plain(*sub, order, 1e-4, C, 3e-3,
                                                                      3), D)
    ms = cuda_ms(lambda: kernels.st_fit(*st, order, C, 1e-4, 3e-3, 3), 2)
    bound = st_bound(B, T, int((st[1] & st[2]).sum()), D)
    print(f"  seasonal_trend at Prophet's defaults ({C} changepoints, order {order}: D = {D}, "
          f"kernel J's cta path), {B} rows x {T}: forecast_band median {np.median(e2e):.3f} ms "
          f"of 2; st_fit alone {ms:.3f} ms (bound {bound['bound_ms']:.3f} ms, "
          f"{bound['bound_by']}); against the twin on {c} rows: max |d preds| {err:.3g}, {ill} "
          f"ill-posed, the twin {plain_ms:.1f} ms on those rows", flush=True)
    return {"D": D, "path": "cta", "launches": 1, "ms": ms, "band_ms": float(np.median(e2e)),
            "max_abs_err": err, "plain_ms_rows": c, "plain_ms": plain_ms, **bound}


def smooth_hw_row(refit, launches):
    """Kernel C's Holt-Winters refit on the seasonal path's rows: its time
    (median of SEASON_RUNS) with max_period 1440, equal bit for bit to the
    launch that reads the largest period from the card, its first rows
    against the twin, the twin's time over every row in chunks. Returns its
    kernels-line row but the bound."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    x, hist, al, be, ga, period = refit
    B = x.shape[0]
    n = SERIES_CHECK_ROWS

    def run():
        return kernels.smooth(kernels.SMOOTH_HW, *refit, max_period=1440)

    ms = median_ms(run, SEASON_RUNS)
    got = run()
    read = kernels.smooth(kernels.SMOOTH_HW, *refit)
    check(bool(torch.equal(got.view(torch.int32), read.view(torch.int32))),
          "the Holt-Winters refit differs with the largest period read from the card")
    del got, read
    sub = tuple(a[:n].contiguous() for a in refit)
    err = compare_smooth(3, sub[0], sub[1], sub[2:], kernels.smooth(3, *sub, max_period=1440))
    plain_ms = chunked_ms(lambda s: fc.smooth_plain(3, *(a[s] for a in refit)), B)
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# the bivariate and hpa families at full size
# ---------------------------------------------------------------------------
FAMILY_ROWS = 100_000
# (bucket, history points): 1 day at 60 s (the engine's bucket) and 7 days
# (HISTORICAL_DAYS' default)
FAMILY_SHAPES = ((2048, 1_440), (16384, 10_080))
BI_CUR, HPA_CUR = 60, 30
# the pair's policies: latency (threshold 10, both bounds) and cpu (5, upper);
# the ellipse takes the smaller threshold
BI_THRESHOLD, BI_MODES = 5.0, (3, 1)
# the engine's HPA inputs under the default EngineConfig: ML_THRESHOLD, the
# SES alpha, SLA_HEADROOM_SAFE, dynamic SLA mode with no limit configured
HPA_THRESHOLD, HPA_ALPHA, HPA_SAFE = 2.0, 0.3, 0.7


def _rows(B, T, fn):
    """fn(slice, t) over row chunks of 8192, for bounded temporaries."""
    t = torch.arange(T, device=DEV)
    for lo in range(0, B, 8192):
        fn(slice(lo, min(B, lo + 8192)), t)


def break_radius(rho):
    """The standardized excursion k of a correlation break (latency +k,
    cpu -k): d2 = 2 k^2 / (1 - rho), so d = 1.1 x (2 x the threshold) at
    k = 1.1 sqrt(50 (1 - rho)); at most 5.5, inside latency's own 10-sigma
    band, and cpu's band is upper-only."""
    return 1.1 * torch.sqrt((2 * BI_THRESHOLD) ** 2 * (1 - rho) / 2)


def bivariate_family_inputs(gen, T, n_h):
    """B metric pairs made on the card: latency at a level in [20, 100] and
    cpu in [10, 60], noise level/20 each, correlated at rho in [0.5, 0.95];
    n_h history + BI_CUR current points, 2% lost; 10% with a correlation
    break over the whole current window (latency up, cpu down by
    break_radius: inside each metric's own band, d >= 2 x the threshold),
    5% with a joint +8 sigma level shift, the rest healthy. Returns
    (kernels.bivariate's ten arguments, kind (B,): 0 healthy, 1 break, 2
    shift)."""
    dev, B = DEV, FAMILY_ROWS

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    r = u(B)
    kind = torch.where(r < 0.10, 1, torch.where(r < 0.15, 2, 0))
    rho = 0.5 + 0.45 * u(B)
    l1, l2 = 20 + 80 * u(B), 10 + 50 * u(B)
    x1 = torch.empty((B, T), device=dev)
    x2 = torch.empty((B, T), device=dev)
    m1 = torch.empty((B, T), dtype=torch.bool, device=dev)
    m2 = torch.empty((B, T), dtype=torch.bool, device=dev)

    def fill(s, t):
        n = s.stop - s.start
        reg = (t >= n_h) & (t < n_h + BI_CUR)
        rh = rho[s, None]
        z1 = torch.randn((n, T), generator=gen, device=dev)
        z2 = rh * z1 + torch.sqrt(1 - rh * rh) * torch.randn((n, T), generator=gen, device=dev)
        k = kind[s, None]
        kr = break_radius(rho[s])[:, None]
        jit = 0.05 * torch.randn((n, T), generator=gen, device=dev)
        z1 = torch.where((k == 1) & reg, kr + jit, z1)
        z2 = torch.where((k == 1) & reg, -kr + jit, z2)
        z1 = torch.where((k == 2) & reg, z1 + 8, z1)
        z2 = torch.where((k == 2) & reg, z2 + 8, z2)
        valid = t < n_h + BI_CUR
        m1[s] = valid & (u(n, T) > 0.02)
        m2[s] = valid & (u(n, T) > 0.02)
        x1[s] = torch.where(valid, l1[s, None] * (1 + z1 / 20), 0.0)
        x2[s] = torch.where(valid, l2[s, None] * (1 + z2 / 20), 0.0)

    _rows(B, T, fill)
    t = torch.arange(T, device=dev)
    region = ((t >= n_h) & (t < n_h + BI_CUR)).expand(B, T).contiguous()
    f32, i32 = dict(device=dev), dict(dtype=torch.int32, device=dev)
    args = (x1, m1, x2, m2, region, torch.full((B,), BI_THRESHOLD, **f32),
            torch.zeros(B, **f32), torch.zeros(B, **f32),
            torch.full((B,), BI_MODES[0], **i32), torch.full((B,), BI_MODES[1], **i32))
    return args, kind


def hpa_family_inputs(gen, T, n_h):
    """B hpa rows made on the card: traffic at a level in [50, 500] with 3%
    noise, latency (the SLA metric) at a level in [2, 10] with 6%; n_h
    history + HPA_CUR current points, 2% lost; a quarter each steady,
    surging (traffic x 2 over the current window), collapsing (x 0.3) and
    violating the SLA (latency x 3). The engine's policy: threshold 2,
    dynamic SLA mode (no limit configured: 1e9), safe 0.7, no pod counts.
    Returns (a dict of kernel I's arguments and the SES alpha, class (B,))."""
    dev, B = DEV, FAMILY_ROWS

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    cls = (u(B) * 4).long().clamp(max=3)
    lt, ls = 50 + 450 * u(B), 2 + 8 * u(B)
    tps = torch.empty((B, T), device=dev)
    sla = torch.empty((B, T), device=dev)
    tm = torch.empty((B, T), dtype=torch.bool, device=dev)
    sm = torch.empty((B, T), dtype=torch.bool, device=dev)

    def fill(s, t):
        n = s.stop - s.start
        reg = (t >= n_h) & (t < n_h + HPA_CUR)
        valid = t < n_h + HPA_CUR
        c = cls[s, None]
        factor = torch.where(c == 1, 2.0, torch.where(c == 2, 0.3, 1.0))
        x = lt[s, None] * (1 + 0.03 * torch.randn((n, T), generator=gen, device=dev))
        y = ls[s, None] * (1 + 0.06 * torch.randn((n, T), generator=gen, device=dev))
        tps[s] = torch.where(valid, torch.where(reg, x * factor, x), 0.0)
        sla[s] = torch.where(valid, torch.where(reg & (c == 3), y * 3, y), 0.0)
        tm[s] = valid & (u(n, T) > 0.02)
        sm[s] = valid & (u(n, T) > 0.02)

    _rows(B, T, fill)
    t = torch.arange(T, device=dev)
    region = ((t >= n_h) & (t < n_h + HPA_CUR)).expand(B, T).contiguous()
    f32 = dict(device=dev)
    a = {"tps": tps, "tps_mask": tm, "region": region, "sla": sla, "sla_mask": sm,
         "hist": (tm & ~region).contiguous(),
         "alpha": torch.full((B,), HPA_ALPHA, **f32),
         "sla_static_limit": torch.full((B,), 1e9, **f32),
         "sla_mode": torch.full((B,), 1, dtype=torch.int32, device=dev),
         "threshold": torch.full((B,), HPA_THRESHOLD, **f32),
         "safe": torch.full((B,), HPA_SAFE, **f32), "pods_now": torch.ones(B, **f32),
         "pods_hist": torch.ones(B, **f32),
         "sla_absolute": torch.ones(B, dtype=torch.bool, device=dev)}
    return a, cls


def median_ms(fn, runs):
    fn()
    return float(np.median([cuda_ms(fn, 1, warm=False) for _ in range(runs)]))


def bivariate_family(gen, T, n_h):
    """Kernel H on 100,000 pairs at bucket T through the entry point, the
    engine's verdict rule, then its time, bound and twin."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import bivariate as bv

    t0 = time.perf_counter()
    args, kind = bivariate_family_inputs(gen, T, n_h)
    torch.cuda.synchronize()
    B = FAMILY_ROWS
    kernels.reset_launches()
    out = bv.bivariate_normal_anomalies(*args, device=DEV)
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    paths = dict(kernels.bivariate_path_launches)
    check(launches["bivariate"] == 1, f"bivariate launched {launches['bivariate']} times, not 1")
    check(paths[kernels.bivariate_path(T)] == 1, f"bivariate at T={T} took the paths {paths}")
    gate = torch.clamp(BAND_VIOLATION_FRACTION * out["checked"].float(), min=BAND_MIN_POINTS)
    flagged = out["count"].float() >= gate
    # counted in integers: a float32 mean of ones need not be exactly 1
    missed = {k: int((~flagged & (kind == k)).sum()) for k in (1, 2)}
    rec_break = 1.0 - missed[1] / int((kind == 1).sum())
    rec_shift = 1.0 - missed[2] / int((kind == 2).sum())
    fp = int((flagged & (kind == 0)).sum()) / int((kind == 0).sum())
    check(missed[1] == 0, f"bivariate T={T}: {missed[1]} correlation breaks missed")
    check(missed[2] == 0, f"bivariate T={T}: {missed[2]} joint shifts missed")
    check(fp < 0.01, f"bivariate T={T}: healthy rows flagged {fp:.5f} >= 0.01")
    # the breaks stay inside each metric's own band (latency 10 sigma both
    # ways, cpu 5 sigma upward) of the history's mean and sd
    x1, m1, x2, m2, region = args[:5]
    brk = (kind == 1)[:, None] & region & m1 & m2
    hist = m1 & m2 & ~region
    n = hist.sum(1).clamp(min=1)
    mu1 = torch.where(hist, x1, 0).sum(1) / n
    mu2 = torch.where(hist, x2, 0).sum(1) / n
    sd1 = torch.sqrt(torch.where(hist, (x1 - mu1[:, None]) ** 2, 0).sum(1) / n)
    sd2 = torch.sqrt(torch.where(hist, (x2 - mu2[:, None]) ** 2, 0).sum(1) / n)
    inside = (((x1 - mu1[:, None]).abs() <= 10 * sd1[:, None])
              & (x2 - mu2[:, None] <= 5 * sd2[:, None]))
    outside = int((~inside & brk).sum())
    check(outside == 0, f"bivariate T={T}: {outside} break points outside a metric's own band")
    sub = tuple(a[:CHECK_ROWS] for a in args)
    err, bracketed = compare_bivariate(sub, kernels.bivariate(*sub),
                                       bv.bivariate_normal_anomalies_plain(*sub))
    del out, inside, brk, hist
    ms = median_ms(lambda: kernels.bivariate(*args), TIMED_RUNS)
    plain_ms = chunked_ms(lambda s: bv.bivariate_normal_anomalies_plain(
        *(a[s] for a in args)), B)
    bound = least_time(B * T * 16 + B * (20 + 28), 27.0 * B * T)
    print(f"  bivariate, {B} pairs at T = {T} ({n_h} history + {BI_CUR} current) made in "
          f"{time.perf_counter() - t0:.1f} s: recall {rec_break:.5f} on "
          f"{int((kind == 1).sum())} correlation breaks (every break point inside both metrics' "
          f"own bands) and {rec_shift:.5f} on {int((kind == 2).sum())} joint shifts, healthy "
          f"flagged {fp:.5f} (limit 0.01); kernel {ms:.3f} ms (median of {TIMED_RUNS}), bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}, 16 B a slot), plain twin "
          f"{plain_ms:.1f} ms; {launches['bivariate']} launch per call on the "
          f"{kernels.bivariate_path(T)} path ({kernels.bivariate_cluster(T)} CTA a row); vs twin "
          f"on {CHECK_ROWS} rows: max |d band| {err:.3g}, {bracketed} rows bracketed", flush=True)
    return {"launches": launches["bivariate"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "T": T, "path": kernels.bivariate_path(T), **bound}


def hpa_family(gen, T, n_h):
    """The engine's HPA launch on 100,000 rows at bucket T through the entry
    points (kernel C's SES on the history, kernel I from its predictions),
    the classes' sides of 50, then the times, bounds and twins."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.ops import hpa as hp

    t0 = time.perf_counter()
    a, cls = hpa_family_inputs(gen, T, n_h)
    torch.cuda.synchronize()
    B = FAMILY_ROWS
    rest = (a["sla"], a["sla_mask"], a["sla_static_limit"], a["sla_mode"], a["threshold"],
            a["safe"], a["pods_now"], a["pods_hist"], a["sla_absolute"])

    def launch():
        preds = fc.ses_predictions(a["tps"], a["hist"], a["alpha"], device=DEV)
        return preds, hp.hpa_from_preds(a["tps"], a["tps_mask"], a["region"], preds, *rest,
                                        device=DEV)

    kernels.reset_launches()
    preds, out = launch()
    torch.cuda.synchronize()
    launches = dict(kernels.launches)
    check(launches["smooth"] == 1 and launches["hpa_score"] == 1,
          f"the HPA launch ran smooth {launches['smooth']} and hpa_score "
          f"{launches['hpa_score']} times, not once each")
    score, reason = out["score"], out["reason"]
    shares = {
        "steady within [40, 60]": ((score >= 40) & (score <= 60))[cls == 0],
        "surge > 50": (score > 50)[cls == 1],
        "collapse < 50": (score < 50)[cls == 2],
        "violation > 50": (score > 50)[cls == 3],
        "violation reason 2, >= 75": ((reason == 2) & (score >= 75))[cls == 3],
    }
    shares = {k: float(v.float().mean()) for k, v in shares.items()}
    for k, v in shares.items():
        check(v >= 0.99, f"hpa T={T}: {k} on {v:.5f} < 0.99 of its rows")
    c = CHECK_ROWS
    sub = {k: v[:c] for k, v in a.items()}
    sub["tps_pred"] = preds[:c].contiguous()
    sub["tps_sigma"] = out["tps_sigma"][:c]
    kw = {k: sub[k] for k in HPA_OPTIONAL}
    errs, bracketed = compare_hpa(sub, kernels.hpa_score(*hpa_series(sub), **kw), False)
    tp = preds.contiguous()
    i_ms = median_ms(lambda: kernels.hpa_score(a["tps"], a["tps_mask"], a["region"], tp,
                                               *rest[:5], safe=a["safe"],
                                               pods_now=a["pods_now"],
                                               pods_hist=a["pods_hist"],
                                               sla_absolute=a["sla_absolute"]), TIMED_RUNS)
    c_ms = median_ms(lambda: kernels.smooth(kernels.SMOOTH_SES, a["tps"], a["hist"], a["alpha"]),
                     TIMED_RUNS)
    launch_ms = median_ms(launch, TIMED_RUNS)
    plain_ms = chunked_ms(lambda s: hp.hpa_from_preds_plain(
        a["tps"][s], a["tps_mask"][s], a["region"][s], tp[s], *(r[s] for r in rest)), B)
    bound = hpa_bound(a["tps_mask"], a["region"], a["sla_mask"])
    c_bound = least_time(B * T * 9 + B * 4, 3.0 * B * T)
    print(f"  hpa, {B} rows at T = {T} ({n_h} history + {HPA_CUR} current) made in "
          f"{time.perf_counter() - t0:.1f} s: " + ", ".join(f"{k} on {v:.5f}"
                                                          for k, v in shares.items())
          + f" (limits 0.99); kernel I {i_ms:.3f} ms (median of {TIMED_RUNS}), bound "
          f"{bound['bound_ms']:.3f} ms ({bound['bound_by']} these rows need; 15 B at every "
          f"slot: {bound['bound_all_ms']:.3f} ms), plain twin "
          f"{plain_ms:.1f} ms; kernel C's SES {c_ms:.3f} ms, bound {c_bound['bound_ms']:.3f} ms "
          f"(9 B a slot); the HPA launch (C then I, from the entry points) {launch_ms:.3f} ms; "
          f"launches per call: smooth {launches['smooth']}, hpa_score {launches['hpa_score']}; "
          f"vs twin on {c} rows: max |d| " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f", {bracketed} rows bracketed", flush=True)
    return {"launches": launches["hpa_score"], "max_abs_err": errs["score"], "ms": i_ms,
            "plain_ms": plain_ms, **bound, "smooth_ms": c_ms, "launch_ms": launch_ms}


def families_path(gen):
    """Phase `families`: kernels H and I at both shapes; returns the rows of
    the engine's bucket (T = 2048) and the 7-day ones."""
    out = {}
    for T, n_h in FAMILY_SHAPES:
        out[("bivariate", T)] = bivariate_family(gen, T, n_h)
        torch.cuda.empty_cache()
        out[("hpa", T)] = hpa_family(gen, T, n_h)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# the LSTM autoencoder's scoring at fleet size
# ---------------------------------------------------------------------------
LSTM_JOBS, LSTM_WINDOWS = 100_000, 2  # the scoring pass: the last hour's windows
LSTM_NORM_JOBS, LSTM_DAY = 10_000, 1_440  # the normalizer pass: a day, 45 windows
LSTM_WIDE_JOBS = 10_000  # the module's default width, H = 128, Z = 64
LSTM_RUNS = 5


def lstm_bound(J, K, F, H, Z):
    """Least time of kernel K's work: each job's parameters and windows
    (values and mask) read once, err and z written once, mu and sigma read
    once, against one fp32 multiply-add per weight use: per step 4H (2F + H)
    in the encoder and 4H H in the decoder, H F in the head, and H Z + Z 4H
    once per window."""
    from foremast_tpu_torch.models import lstm_ae as tl

    G = 4 * H
    macs = LSTM_W * (G * (2 * F + H) + G * H + H * F) + H * Z + Z * G
    return least_time(J * tl.param_count(F, H, Z) * 4 + J * K * LSTM_W * F * 5 + J * K * 8
                      + J * 8, float(J * K * macs))


def lstm_day_windows(J, gen):
    """Each job's day of four standardized metrics (latency, error rate,
    cpu, tps: a shared daily load cycle, correlated noise, 3% lost samples;
    the fixture's generator) cut into 45 windows of 32 steps, made on the
    card. Returns x, mask (J, 45, 32, 4)."""
    dev = DEV
    t = torch.arange(LSTM_DAY, device=dev, dtype=torch.float32)

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def noise(s):
        return 1 + s * torch.randn((J, LSTM_DAY), generator=gen, device=dev)

    load = 1 + 0.5 * torch.sin(2 * math.pi * t / LSTM_DAY + 2 * math.pi * u(J, 1))
    raw = torch.stack([(20 + 60 * u(J, 1)) * (1 + 0.3 * (load - 1)) * noise(0.06),
                       ((0.1 + 0.9 * u(J, 1)) * load + 0.1 * torch.randn(
                           (J, LSTM_DAY), generator=gen, device=dev)).abs(),
                       (10 + 30 * u(J, 1)) * load * noise(0.05),
                       (100 + 400 * u(J, 1)) * load * noise(0.03)], -1)
    m = u(J, LSTM_DAY, 4) > 0.03
    n = m.sum(1, keepdim=True).clamp(min=1)
    mu = torch.where(m, raw, 0).sum(1, keepdim=True) / n
    sd = torch.sqrt(torch.where(m, (raw - mu) ** 2, 0).sum(1, keepdim=True) / n).clamp(min=1e-6)
    x = ((raw - mu) / sd).reshape(J, LSTM_DAY // LSTM_W, LSTM_W, 4)
    return x.contiguous(), m.reshape(J, LSTM_DAY // LSTM_W, LSTM_W, 4).contiguous()


def lstm_fixture():
    """The reference-trained fixture (LSTM_FIXTURE) on the card."""
    with np.load(LSTM_FIXTURE) as d:
        return {k: torch.from_numpy(d[k]).to(DEV) for k in d.files}


def lstm_scoring_inputs(fx, J):
    """The fleet's scoring pass: job j runs the fixture's job j % 8 on its
    healthy window j % 6 and its anomalous window 6 + j % 6. Returns
    (params, x, mask, mu, sigma) of J jobs x 2 windows."""
    J8 = fx["z"].shape[0]
    jobs = torch.arange(J, device=DEV) % J8
    pick = torch.stack([torch.arange(J, device=DEV) % 6, 6 + torch.arange(J, device=DEV) % 6], 1)
    return (fx["params"][jobs].contiguous(), fx["x"][jobs[:, None], pick].contiguous(),
            fx["mask"][jobs[:, None], pick].contiguous(), fx["mu"][jobs].contiguous(),
            fx["sigma"][jobs].contiguous())


def lstm_normalizer_inputs(fx, J, gen):
    """The normalizer pass: the fixture's rows (job j the fixture's j % 8)
    over each job's day of healthy windows (lstm_day_windows). Returns
    (params, x, mask)."""
    params = fx["params"][torch.arange(J, device=DEV) % fx["z"].shape[0]].contiguous()
    return (params, *lstm_day_windows(J, gen))


def lstm_path_launches(K, F, H, Z, what):
    """The path kernel K took for this shape, and its launches since the
    counts were reset: exactly one, on that path."""
    from foremast_tpu_torch import kernels

    path = kernels.lstm_ae_path(K, F, H, Z, LSTM_W)
    got = {k: v for k, v in kernels.lstm_ae_path_launches.items() if v}
    check(got == {path: 1}, f"{what}: kernel K's launches by path {got}, not one on the {path} "
                            f"path")
    return {"path": path, "launches": 1}


def lstm_path(gen):
    """Phase `lstm`: the reference-trained fixture scored by kernel K against
    the reference's recorded z; the fleet's scoring pass (100,000 jobs of
    the fixture's parameters x 2 windows) through anomaly_scores_fleet;
    the normalizer pass (10,000 jobs x 45 windows); the module's default
    width (10,000 jobs at H = 128) on seeded parameters; each leg checks
    that kernel K launched once, on the path kernels.lstm_ae_path names.
    Returns kernel K's row for the kernels line, with each leg's path,
    launches, ms, bound and twin's ms under "paths"."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    fx = lstm_fixture()
    F, H, Z, W = (int(v) for v in fx["dims"])
    check(W == LSTM_W, f"the fixture's windows are {W} steps, not {LSTM_W}")
    J8, K12 = fx["z"].shape

    def against(z, want, what):
        """z within 1e-3 of the reference's, verdicts (z > 3) equal but
        within 1e-3 of the threshold."""
        dz = float((z - want).abs().max())
        check(dz <= 1e-3, f"{what}: z differs from the reference's by {dz:.3g}")
        edge = (want - 3.0).abs() <= 1e-3
        wrong = int((((z > 3) != (want > 3)) & ~edge).sum())
        check(wrong == 0, f"{what}: {wrong} verdicts differ from the reference's")
        return dz, int(edge.sum())

    z = tl.anomaly_scores_fleet(fx["params"], fx["x"], fx["mask"], fx["mu"], fx["sigma"],
                                hidden=H, latent=Z, device=DEV)
    dz, edge = against(z, fx["z"], "the fixture")
    anom = fx["anomalous"]
    print(f"  the reference-trained fixture ({J8} jobs x {K12} windows, F={F} H={H} Z={Z} "
          f"W={W}): max |d z| against the reference's {dz:.3g}, {edge} windows at the edge; "
          f"flagged: healthy {int((z[:, ~anom] > 3).sum())} of {int((~anom).sum()) * J8}, "
          f"anomalous {int((z[:, anom] > 3).sum())} of {int(anom.sum()) * J8} (the "
          f"reference: {int((fx['z'][:, anom] > 3).sum())})", flush=True)

    # the scoring pass: job j runs the fixture's job j % 8 on its healthy
    # window j % 6 and its anomalous window 6 + j % 6
    t0 = time.perf_counter()
    J, K = LSTM_JOBS, LSTM_WINDOWS
    params, x, m, mu, sigma = lstm_scoring_inputs(fx, J)
    jobs = torch.arange(J, device=DEV) % J8
    pick = torch.stack([torch.arange(J, device=DEV) % 6, 6 + torch.arange(J, device=DEV) % 6], 1)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0
    kernels.reset_launches()
    z = tl.anomaly_scores_fleet(params, x, m, mu, sigma, hidden=H, latent=Z, device=DEV)
    torch.cuda.synchronize()
    launches = kernels.launches["lstm_ae"]
    check(launches == 1, f"anomaly_scores_fleet launched lstm_ae {launches} times, not 1")
    by_path = lstm_path_launches(K, F, H, Z, "the scoring pass")
    dz, edge = against(z, fx["z"][jobs[:, None], pick], "the scoring pass")
    e2e = wall_ms(lambda: tl.anomaly_scores_fleet(params, x, m, mu, sigma, hidden=H, latent=Z,
                                                  device=DEV), LSTM_RUNS)
    ms = cuda_ms(lambda: kernels.lstm_ae(params, x, m, H, Z, mu, sigma), TIMED_RUNS)
    n = LSTM_CHECK_JOBS
    sub = (params[:n], x[:n], m[:n])
    err = compare_lstm(kernels.lstm_ae(*sub, H, Z, mu[:n], sigma[:n]),
                       tl.reconstruction_errors_plain(*sub, H, Z, mu[:n], sigma[:n]), sigma[:n])
    plain_ms = chunked_ms(lambda s: tl.reconstruction_errors_plain(
        params[s], x[s], m[s], H, Z, mu[s], sigma[s]), J)
    bound = lstm_bound(J, K, F, H, Z)
    print(f"  scoring pass: {J} jobs x {K} windows x {W} steps x {F} metrics, their parameters "
          f"{params.numel() * 4 / 1e9:.2f} GB, made in {made:.1f} s: max |d z| against the "
          f"reference {dz:.3g} ({edge} at the edge), healthy windows flagged "
          f"{float((z[:, 0] > 3).float().mean()):.5f}, anomalous "
          f"{float((z[:, 1] > 3).float().mean()):.5f}; anomaly_scores_fleet {LSTM_RUNS} runs: "
          f"median {np.median(e2e):.3f} ms, {J / np.median(e2e) * 1e3:.0f} jobs/s; kernel "
          f"{ms:.3f} ms (mean of {TIMED_RUNS}), bound {bound['bound_ms']:.3f} ms "
          f"({bound['bound_by']}), plain twin {plain_ms:.1f} ms; {launches} launch; vs twin on "
          f"{n} jobs: max |d err| {err:.3g}", flush=True)
    row = {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **bound,
           "paths": [{"shape": f"{J} x {K}, H={H}", **by_path, "ms": ms, **bound,
                      "plain_ms": plain_ms}]}
    del params, x, m, z
    torch.cuda.empty_cache()

    # the normalizer pass over a day of healthy windows
    t0 = time.perf_counter()
    Jn = LSTM_NORM_JOBS
    params, x, m = lstm_normalizer_inputs(fx, Jn, gen)
    torch.cuda.synchronize()
    made = time.perf_counter() - t0

    def normalizer():
        """Each job's fit_score_normalizer over its day: kernel K's errors,
        their mean and max(population std, 1e-6)."""
        e = kernels.lstm_ae(params, x, m, H, Z)
        return e.mean(1), e.std(1, unbiased=False).clamp(min=1e-6)

    kernels.reset_launches()
    mu, sd = normalizer()
    torch.cuda.synchronize()
    by_path = lstm_path_launches(x.shape[1], F, H, Z, "the normalizer pass")
    errs = tl.reconstruction_errors_plain(params[:n], x[:n], m[:n], H, Z)
    pmu, psd = errs.mean(1), errs.std(1, unbiased=False).clamp(min=1e-6)
    dmu = float(((mu[:n] - pmu).abs() / pmu.abs().clamp(min=1e-6)).max())
    dsd = float(((sd[:n] - psd).abs() / psd).max())
    check(dmu <= 1e-4 and dsd <= 1e-3, f"the normalizer differs from the twin's: mu {dmu:.3g}, "
                                       f"sigma {dsd:.3g} relative")
    norm = wall_ms(normalizer, 3)
    k_ms = cuda_ms(lambda: kernels.lstm_ae(params, x, m, H, Z), 3)
    nb = lstm_bound(Jn, x.shape[1], F, H, Z)
    n_plain = chunked_ms(lambda s: tl.reconstruction_errors_plain(params[s], x[s], m[s], H, Z), Jn,
                         rows=2_500)
    row["paths"].append({"shape": f"{Jn} x {x.shape[1]}, H={H}", **by_path, "ms": k_ms, **nb,
                         "plain_ms": n_plain})
    print(f"  normalizer pass: {Jn} jobs x {x.shape[1]} windows (a day) made on the card in "
          f"{made:.1f} s: the normalizer median {np.median(norm):.3f} ms (kernel "
          f"{k_ms:.3f} ms, {by_path['path']} path, bound {nb['bound_ms']:.3f} ms, "
          f"{nb['bound_by']}; plain twin {n_plain:.1f} ms); mu "
          f"{float(mu.mean()):.4f}, sigma {float(sd.mean()):.4f} on average; vs twin on {n} jobs: mu {dmu:.3g}, "
          f"sigma {dsd:.3g} relative", flush=True)
    del params, x, m
    torch.cuda.empty_cache()

    # the module's default width, parameters read from device memory
    Fw, Hw, Zw = 4, 128, 64
    p, x, m, mu, sigma = adversarial_lstm(LSTM_WIDE_JOBS, 2, Fw, Hw, Zw, gen)
    kernels.reset_launches()
    kernels.lstm_ae(p, x, m, Hw, Zw, mu, sigma)
    torch.cuda.synchronize()
    by_path = lstm_path_launches(2, Fw, Hw, Zw, "the default width")
    err_w = compare_lstm(kernels.lstm_ae(p[:n], x[:n], m[:n], Hw, Zw, mu[:n], sigma[:n]),
                         tl.reconstruction_errors_plain(p[:n], x[:n], m[:n], Hw, Zw, mu[:n],
                                                        sigma[:n]), sigma[:n])
    w_ms = cuda_ms(lambda: kernels.lstm_ae(p, x, m, Hw, Zw, mu, sigma), 3)
    w_plain = chunked_ms(lambda s: tl.reconstruction_errors_plain(
        p[s], x[s], m[s], Hw, Zw, mu[s], sigma[s]), LSTM_WIDE_JOBS, rows=5_000)
    wb = lstm_bound(LSTM_WIDE_JOBS, 2, Fw, Hw, Zw)
    row["paths"].append({"shape": f"{LSTM_WIDE_JOBS} x 2, H={Hw}", **by_path, "ms": w_ms, **wb,
                         "plain_ms": w_plain})
    print(f"  default width H={Hw} Z={Zw}: {LSTM_WIDE_JOBS} jobs x 2 windows, parameters "
          f"{p.numel() * 4 / 1e9:.2f} GB: kernel {w_ms:.3f} ms ({by_path['path']} path), bound "
          f"{wb['bound_ms']:.3f} ms "
          f"({wb['bound_by']}), plain twin {w_plain:.1f} ms; vs twin on {n} jobs: max |d err| "
          f"{err_w:.3g}", flush=True)
    del p, x, m
    torch.cuda.empty_cache()
    return row


LSTM_TRAIN_JOBS = 1_024  # MAX_CACHE_SIZE: a cold restart's training at once
LSTM_TRAIN_RUNS = 5


def lstm_train_bounds(J, K, W, F, H, Z, nkb):
    """Least times of one training epoch's kernels on these shapes:
    L's forward (kernel K's multiply-adds; parameters and windows read once,
    the activations (J K 2 W 5H floats) and the block sums written once);
    L's backward as one function (a step's products with the transposed
    weights and the weight gradients: W (3 H F + 2 H 4H) in the decoder and
    head, W (2F 4H + 2 H 4H) in the encoder, 3 H Z + 2 Z 4H for the latent;
    parameters, windows and activations read once, the gradient, one row of
    P floats a job, written once), split between its two entries by their
    shares of its operations (of its bytes when bytes bound it: the
    recurrence reads the inputs, the GEMM writes the gradient): the
    recurrence W (3 H F + H 4H) + W H 4H + 2 H Z + Z 4H multiply-adds a
    window, the weight gradients W H 4H + W (H + 2F + 1) 4H + (Z + 1) 4H +
    (H + 1) Z + (H + 1) F; M (the gradient row read once, parameters and
    both moments read and written once, ~13 operations an entry).
    Besides, printed only: each entry's bound on the traffic of this design
    (the recurrence reads and rewrites the activations and writes the
    records, the GEMM reads both), and the backward's and M's bounds counted
    with nkb partial gradient rows a job (written by L, read by M), a
    backward with a gradient row per window block."""
    from foremast_tpu_torch.models import lstm_ae as tl

    G, P = 4 * H, tl.param_count(F, H, Z)
    win = J * K
    S = 2 * Z + G + H + H * F + F + 2 * F * W  # a window's record (lstm_train.cu rec_layout)
    fwd_macs = W * (G * (2 * F + H) + G * H + H * F) + H * Z + Z * G
    bwd_macs = W * (3 * H * F + 2 * H * G) + W * (2 * F * G + 2 * H * G) + 3 * H * Z + 2 * Z * G
    rec_macs = W * (3 * H * F + H * G) + W * H * G + 2 * H * Z + Z * G
    wg_macs = (W * H * G + W * (H + 2 * F + 1) * G + (Z + 1) * G + (H + 1) * Z
               + (H + 1) * F)
    inputs = J * P * 4 + win * W * F * 5
    act = win * 2 * W * 5 * H * 4
    recs = win * S * 4
    bwd = least_time(inputs + act + J * P * 4, float(win * bwd_macs))
    share = (rec_macs / (rec_macs + wg_macs) if bwd["bound_by"] == "operations"
             else (inputs + act) / (inputs + act + J * P * 4))
    return {
        "forward": least_time(inputs + act + J * nkb * 16, float(win * fwd_macs)),
        "backward": bwd,
        "recurrence": {"bound_ms": bwd["bound_ms"] * share, "bound_by": bwd["bound_by"]},
        "wgrad": {"bound_ms": bwd["bound_ms"] * (1 - share), "bound_by": bwd["bound_by"]},
        "recurrence_traffic": least_time(inputs + 2 * act + recs, float(win * rec_macs)),
        "wgrad_traffic": least_time(act + recs + J * P * 4, float(win * wg_macs)),
        "adam": least_time(J * P * 4 + 6 * J * P * 4 + J * (4 + nkb * 16),
                           float(J * P * 13)),
        "backward_partials": least_time(inputs + act + J * nkb * P * 4, float(win * bwd_macs)),
        "adam_partials": least_time(J * nkb * P * 4 + 6 * J * P * 4 + J * (4 + nkb * 16),
                                    float(J * P * (nkb + 12)))}


def lstm_forward_floor_ms(J, K, W, F, H, Z):
    """Kernel L's forward's arithmetic floor: its multiply-adds (the count
    lstm_train_bounds takes for the forward) as two fp32 instructions each,
    since -fmad=false keeps every product and sum apart, at the fp32
    instruction rate. Printed beside the bound, which it does not replace."""
    G = 4 * H
    macs = J * K * (W * (G * (2 * F + H) + G * H + H * F) + H * Z + Z * G)
    return 2 * macs / FP32_OPS_PER_S * 1e3


def cuda_ms_fresh(fn, fresh, runs):
    """Mean time of fn on the card over `runs` launches, by CUDA events
    around each launch alone, with fresh() (untimed) before each: for a
    kernel that consumes its input in place."""
    fresh()
    fn()
    times = []
    for _ in range(runs):
        fresh()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in times) / runs


def cudnn_lstm_ms(windows, W, F, H, Z, gen):
    """A yardstick for the record, not the same function: cuDNN's
    torch.nn.LSTM forward and backward over the encoder's recurrence (2F
    inputs) and the decoder's (Z inputs) at `windows` windows x W steps x H
    units, without the head, the latent or the masked loss. Returns the ms
    of one forward and backward of both, by CUDA events."""
    enc = torch.nn.LSTM(2 * F, H, batch_first=True).to(DEV)
    dec = torch.nn.LSTM(Z, H, batch_first=True).to(DEV)
    xe = torch.randn((windows, W, 2 * F), generator=gen, device=DEV).requires_grad_(True)
    xd = torch.randn((windows, W, Z), generator=gen, device=DEV).requires_grad_(True)

    def run():
        with torch.enable_grad():
            (enc(xe)[0].sum() + dec(xd)[0].sum()).backward()

    ms = cuda_ms(run, 3)
    del enc, dec, xe, xd
    torch.cuda.empty_cache()
    return ms


def lstm_train_reference(tl):
    """train_fleet on the card from the reference's fixture
    (tests/data/lstm_ae_train_ref.npz, 8 jobs x 45 windows, F = 4, H = 32,
    Z = 16, W = 32, 30 epochs): the initial row equal to the reference's
    (its truncated-normal groups bit for bit, the orthogonal recurrent
    kernels within 3e-6: the reference's float32 QR against ours in
    float64), each epoch's fleet-mean loss within 1e-5 relative, the same
    stop epoch, mu and sigma within 1e-4 relative, and the z of the scoring
    fixture's windows within 1e-3 of the reference's with equal verdicts
    outside 1e-3 of the threshold."""
    from foremast_tpu_torch.models import lstm_init as li

    with np.load(LSTM_TRAIN_FIXTURE) as d:
        tr = {k: d[k] for k in d.files}
    with np.load(LSTM_FIXTURE) as d:
        ev = {k: torch.from_numpy(d[k]).to(DEV) for k in d.files}
    F, H, Z, W, E = (int(v) for v in tr["dims"])
    init = li.init_params(F, H, Z).numpy()
    shapes = tl.param_shapes(F, H, Z)
    ortho = np.concatenate([np.full(math.prod(s), k.endswith(".wh")) for k, s in shapes.items()])
    d_init = np.abs(init - tr["init"])
    check(bool((d_init[~ortho] == 0).all()), "the initial row's truncated-normal groups differ "
                                             "from the reference's")
    check(float(d_init[ortho].max()) <= 3e-6, f"the initial orthogonal kernels differ by "
                                              f"{float(d_init[ortho].max()):.3g}")
    hist = []
    params, mu, sd = tl.train_fleet(tr["x_train"], tr["m_train"], hidden=H, latent=Z, epochs=E,
                                    device=DEV, history=hist)
    losses = torch.stack(hist).double().cpu().numpy()
    check(len(losses) == len(tr["losses"]), f"train_fleet stopped after {len(losses)} epochs, "
                                            f"the reference after {len(tr['losses'])}")
    d_loss = float((np.abs(losses - tr["losses"]) / tr["losses"]).max())
    check(d_loss <= 1e-5, f"the fleet-mean losses differ from the reference's by {d_loss:.3g}")
    d_mu = float(np.abs(mu.cpu().numpy() / tr["mu"] - 1).max())
    d_sd = float(np.abs(sd.cpu().numpy() / tr["sigma"] - 1).max())
    check(d_mu <= 1e-4 and d_sd <= 1e-4, f"mu / sigma differ from the reference's by {d_mu:.3g} "
                                         f"/ {d_sd:.3g}")
    z = tl.anomaly_scores_fleet(params, ev["x"], ev["mask"], mu, sd, hidden=H, latent=Z,
                                device=DEV)
    dz = float((z - ev["z"]).abs().max())
    check(dz <= 1e-3, f"the trained models' z differ from the reference's by {dz:.3g}")
    edge = (ev["z"] - 3.0).abs() <= 1e-3
    wrong = int((((z > 3) != (ev["z"] > 3)) & ~edge).sum())
    check(wrong == 0, f"{wrong} verdicts of the trained models differ from the reference's")
    d_par = float(np.abs(params.cpu().numpy() - tr["params"]).max())
    print(f"  training from the reference's fixture ({tr['x_train'].shape[0]} jobs x "
          f"{tr['x_train'].shape[1]} windows, F={F} H={H} Z={Z} W={W}): initial row equal to the "
          f"reference's (orthogonal kernels within {float(d_init[ortho].max()):.3g}); "
          f"{len(losses)} of {E} epochs as the reference; fleet-mean loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}, max relative difference {d_loss:.3g}; mu {d_mu:.3g}, sigma "
          f"{d_sd:.3g} relative; parameters within {d_par:.3g}; z of the scoring fixture within "
          f"{dz:.3g}, {int(edge.sum())} at the edge, verdicts equal", flush=True)


def lstm_train_path(gen):
    """Phase `lstm`, training: the reference check, then train_fleet over
    LSTM_TRAIN_JOBS jobs of a day of standardized metrics (45 windows of 32
    steps x 4 at H = 32, Z = 16: the engine's width) on the card: epochs
    run, the whole call, and one epoch's kernels L (forward, and the
    backward's recurrence and weight-gradient entries apart) and M timed
    alone with their bounds, the twins' times, beside M one
    torch.optim.Adam(fused=True).step() over the same rows, and for the
    record cuDNN's LSTM over the same recurrences; two backward runs equal
    bit for bit. Returns the kernels line's rows for L's three entries and
    M."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    lstm_train_reference(tl)
    F, H, Z, W = 4, 32, 16, LSTM_W
    J = LSTM_TRAIN_JOBS
    x, m = lstm_day_windows(J, gen)
    K = x.shape[1]
    KB, nkb = kernels.lstm_train_blocks(K, F, H, Z)
    hist = []
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    params, mu, sd = tl.train_fleet(x, m, hidden=H, latent=Z, epochs=30, device=DEV,
                                    history=hist)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launches)
    E = len(hist)
    for k in ("lstm_train_forward", "lstm_train_recurrence", "lstm_train_wgrad", "adam"):
        check(launches[k] == E, f"train_fleet ran {E} epochs but launched {k} {launches[k]} "
                                f"times")
    check(launches["lstm_ae"] == 1, "train_fleet's normalizer did not launch lstm_ae once")
    check(bool(torch.isfinite(mu).all() and torch.isfinite(sd).all() and (sd > 0).all()),
          "train_fleet's normalizers are not finite and positive")
    losses = [float(h) for h in hist]
    # one epoch's kernels alone, from the trained rows; the recurrence
    # consumes its activations, so each of its runs gets a fresh copy
    step = torch.full((J,), E + 1, dtype=torch.int32, device=DEV)
    mom = [torch.zeros_like(params), torch.zeros_like(params)]
    num, cnt, act0 = kernels.lstm_train_forward(params, x, m, H, Z)
    fwd_ms = cuda_ms(lambda: kernels.lstm_train_forward(params, x, m, H, Z), LSTM_TRAIN_RUNS)
    act = torch.empty_like(act0)
    rec_ms = cuda_ms_fresh(lambda: kernels.lstm_train_recurrence(params, x, m, act, H, Z),
                           lambda: act.copy_(act0), LSTM_TRAIN_RUNS)
    act.copy_(act0)
    rec = kernels.lstm_train_recurrence(params, x, m, act, H, Z)
    wg_ms = cuda_ms(lambda: kernels.lstm_train_wgrad(params, x, m, act, rec, H, Z),
                    LSTM_TRAIN_RUNS)
    gpart = kernels.lstm_train_wgrad(params, x, m, act, rec, H, Z)
    plain_wg = cuda_ms(lambda: tl.wgrad_plain(act, rec, F, H, Z), 2)
    bwd_ms = rec_ms + wg_ms
    act.copy_(act0)
    check(torch.equal(gpart.view(torch.int32),
                      kernels.lstm_train_backward(params, x, m, act, H, Z).view(torch.int32)),
          "lstm_train_backward: two runs on the fleet's rows differ")
    del act, rec
    w_err = compare_lstm_wgrad(params, x, m, act0, H, Z)
    del act0
    work = [params.clone(), *mom]
    adam_ms = cuda_ms(lambda: kernels.adam(*work, step, gpart, num, cnt, tl.LEARNING_RATE,
                                           tl.ADAM_B1, tl.ADAM_B2, tl.ADAM_EPS), TIMED_RUNS)
    adam_err = compare_adam(params, *mom, step, gpart, num, cnt)
    grad = tl.reduce_partials_plain(gpart, cnt)
    plain_adam = cuda_ms(lambda: tl.adam_plain(work[0], tl.reduce_partials_plain(gpart, cnt),
                                               work[1], work[2], step), 3)
    # the yardstick: PyTorch's fused Adam over the same rows and gradient
    lib_p = torch.nn.Parameter(params.clone())
    lib_p.grad = grad
    opt = torch.optim.Adam([lib_p], lr=tl.LEARNING_RATE, betas=(tl.ADAM_B1, tl.ADAM_B2),
                           eps=tl.ADAM_EPS, fused=True)
    lib_ms = cuda_ms(opt.step, TIMED_RUNS)
    del lib_p, opt, work, grad
    # the twins, and kernel L against autograd on a slice
    n = 64
    sub = (params[:n].contiguous(), x[:n].contiguous(), m[:n].contiguous())
    kern = tl.loss_and_grad(*sub, hidden=H, latent=Z, device=DEV)
    with torch.enable_grad():
        q = sub[0].clone().requires_grad_(True)
        pl = tl.loss_plain(q, *sub[1:], H, Z)
        pg, = torch.autograd.grad(pl.sum(), q)
    l_err = compare_lstm_train(kern, (pl.detach(), pg))
    plain_fwd = cuda_ms(lambda: tl.loss_plain(params, x, m, H, Z), 2)
    with torch.enable_grad():
        q = params.clone().requires_grad_(True)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        pl = tl.loss_plain(q, x, m, H, Z)
        torch.cuda.synchronize()
        start.record()
        torch.autograd.grad(pl.sum(), q)
        end.record()
        torch.cuda.synchronize()
        plain_bwd = start.elapsed_time(end)
        del pl, q
    torch.cuda.empty_cache()
    cudnn_ms = cudnn_lstm_ms(J * K, W, F, H, Z, gen)
    b = lstm_train_bounds(J, K, W, F, H, Z, nkb)
    print(f"  cuDNN yardstick (not the same function: no head, latent or masked loss): "
          f"torch.nn.LSTM forward and backward over the encoder's and the decoder's "
          f"recurrences, {J * K} windows x {W} steps x H = {H}: {cudnn_ms:.3f} ms", flush=True)
    print(f"  training pass: {J} jobs x {K} windows x {W} steps x {F} metrics (windows "
          f"{x.numel() * 5 / 1e6:.1f} MB, activations {J * K * 2 * W * 5 * H * 4 / 1e9:.2f} GB, "
          f"gradient rows {gpart.numel() * 4 / 1e9:.3f} GB): train_fleet {wall:.3f} s for "
          f"{E} epochs ({wall / E * 1e3:.1f} ms an epoch with the plateau's host reads and the "
          f"normalizer), fleet-mean loss {losses[0]:.5f} -> {losses[-1]:.5f}; launches "
          f"{ {k: v for k, v in launches.items() if v} }; one epoch: lstm_train_forward "
          f"{fwd_ms:.3f} ms ({kernels.lstm_train_forward_path(K, F, H, Z)} path; bound "
          f"{b['forward']['bound_ms']:.3f} ms, {b['forward']['bound_by']}; arithmetic floor "
          f"{lstm_forward_floor_ms(J, K, W, F, H, Z):.3f} ms, its multiply-adds unfused; twin "
          f"{plain_fwd:.1f} ms), lstm_train_backward "
          f"{bwd_ms:.3f} ms (bound {b['backward']['bound_ms']:.3f} ms, "
          f"{b['backward']['bound_by']}; {b['backward_partials']['bound_ms']:.3f} ms counted "
          f"with {nkb} partial rows a job; autograd's backward {plain_bwd:.1f} ms) = "
          f"lstm_train_recurrence {rec_ms:.3f} ms (its share of the bound "
          f"{b['recurrence']['bound_ms']:.3f} ms; {b['recurrence_traffic']['bound_ms']:.3f} ms "
          f"on this design's traffic, {b['recurrence_traffic']['bound_by']}) + "
          f"lstm_train_wgrad {wg_ms:.3f} ms (its share {b['wgrad']['bound_ms']:.3f} ms; "
          f"{b['wgrad_traffic']['bound_ms']:.3f} ms on this design's traffic, "
          f"{b['wgrad_traffic']['bound_by']}; twin {plain_wg:.1f} ms, within {w_err:.3g}); adam "
          f"{adam_ms:.3f} ms (bound {b['adam']['bound_ms']:.3f} ms, {b['adam']['bound_by']}; "
          f"{b['adam_partials']['bound_ms']:.3f} ms counted with {nkb} partial rows; written-out "
          f"twin {plain_adam:.3f} ms; torch.optim.Adam(fused=True).step() {lib_ms:.3f} ms); L "
          f"against autograd on {n} jobs: max |d grad| {l_err:.3g}; two backward runs equal bit "
          f"for bit; M bit for bit", flush=True)
    del x, m, gpart, params
    torch.cuda.empty_cache()
    return [
        {"name": "lstm_train_forward", "launches": launches["lstm_train_forward"],
         "max_abs_err": l_err, "ms": fwd_ms, "plain_ms": plain_fwd, "library_ms": None,
         **b["forward"]},
        # the recurrence's outputs (the rewritten slots, the records) exist
        # only in this design: its twin is the whole backward's, autograd
        {"name": "lstm_train_recurrence", "launches": launches["lstm_train_recurrence"],
         "max_abs_err": l_err, "ms": rec_ms, "plain_ms": plain_bwd, "library_ms": None,
         **b["recurrence"]},
        {"name": "lstm_train_wgrad", "launches": launches["lstm_train_wgrad"],
         "max_abs_err": w_err, "ms": wg_ms, "plain_ms": plain_wg, "library_ms": None,
         **b["wgrad"]},
        {"name": "adam", "launches": launches["adam"], "max_abs_err": adam_err, "ms": adam_ms,
         "plain_ms": plain_adam, "library_ms": lib_ms, **b["adam"]}]


# past the first designs' limits: kernel K's scoring pass at F = 40 (100,000
# jobs x 2 windows, the engine's H = 32) and at H = 320 (10,000 x 2, Z = 64),
# then train_fleet (kernels L and M) over 1,024 jobs x 45 windows x 40
# metrics at H = 32 and over 256 jobs at H = 320 (F = 4), LSTM_LIMIT_EPOCHS
# epochs each (the plateau needs 10)
LSTM_LIMIT_SCORE = ((100_000, 40, 32, 16), (10_000, 4, 320, 64))  # (J, F, H, Z), 2 windows
LSTM_LIMIT_TRAIN = ((1_024, 40, 32, 16), (256, 4, 320, 64))  # (J, F, H, Z), 45 windows
LSTM_LIMIT_EPOCHS = 2
LSTM_LIMIT_TWIN_JOBS = 1_000  # the twins' time is taken on this many jobs


def lstm_limits_path():
    """Phase `lstm`, past 32 metrics a job and 256 units, on seeded windows
    and parameters (a generator of its own): each scoring leg through
    anomaly_scores_fleet (kernel K launched once, on the wide path; its
    wall time, the kernel alone beside its bound, the twin on
    LSTM_LIMIT_TWIN_JOBS jobs, against the twin on CHECK_ROWS // 8 jobs);
    each training leg through train_fleet (L's recurrence on its wide path
    each epoch; the wall time an epoch, one epoch's entries alone beside
    their bounds; losses finite). Returns the legs' records."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=DEV).manual_seed(SEED + 184)
    n = CHECK_ROWS // 8
    legs = {"score": [], "train": []}
    for J, F, H, Z in LSTM_LIMIT_SCORE:
        p, x, m, mu, sigma = adversarial_lstm(J, 2, F, H, Z, gen)
        kernels.reset_launches()
        t0 = time.perf_counter()
        z = tl.anomaly_scores_fleet(p, x, m, mu, sigma, hidden=H, latent=Z, device=DEV)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        by_path = lstm_path_launches(2, F, H, Z, f"the scoring pass at F={F} H={H}")
        check(by_path["path"] == "wide", f"the scoring pass at F={F} H={H} took the "
                                         f"{by_path['path']} path")
        err = compare_lstm(kernels.lstm_ae(p[:n], x[:n], m[:n], H, Z, mu[:n], sigma[:n]),
                           tl.reconstruction_errors_plain(p[:n], x[:n], m[:n], H, Z, mu[:n],
                                                          sigma[:n]), sigma[:n])
        check(bool(torch.isfinite(z[m.flatten(2).any(2)]).all()),
              f"the scoring pass at F={F} H={H}: z not finite")
        ms = cuda_ms(lambda: kernels.lstm_ae(p, x, m, H, Z, mu, sigma), 2)
        t = LSTM_LIMIT_TWIN_JOBS
        plain = chunked_ms(lambda s: tl.reconstruction_errors_plain(
            p[s], x[s], m[s], H, Z, mu[s], sigma[s]), t, rows=t)
        b = lstm_bound(J, 2, F, H, Z)
        legs["score"].append({"shape": f"{J} x 2, F={F} H={H} Z={Z}", **by_path, "ms": ms,
                              "wall_ms": wall, "max_abs_err": err,
                              "plain_ms": plain, "plain_jobs": t, **b})
        print(f"  lstm_ae past the first design's limits, {J} jobs x 2 windows, F={F} H={H} "
              f"Z={Z} (parameters {p.numel() * 4 / 1e9:.2f} GB): anomaly_scores_fleet "
              f"{wall:.3f} ms (its first call), kernel {ms:.3f} ms ({by_path['path']} path), bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']}), twin {plain:.1f} ms on {t} jobs; vs "
              f"twin on {n} jobs: max |d err| {err:.3g}", flush=True)
        del p, x, m, mu, sigma, z
        torch.cuda.empty_cache()
    for J, F, H, Z in LSTM_LIMIT_TRAIN:
        K, W = LSTM_DAY // LSTM_W, LSTM_W
        x = torch.randn((J, K, W, F), generator=gen, device=DEV)
        m = torch.rand((J, K, W, F), generator=gen, device=DEV) > 0.03
        hist = []
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, mu, sd = tl.train_fleet(x, m, hidden=H, latent=Z, epochs=LSTM_LIMIT_EPOCHS,
                                        device=DEV, history=hist)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        E = len(hist)
        check(E == LSTM_LIMIT_EPOCHS and kernels.bptt_path_launches == {"group": 0, "wide": E},
              f"train_fleet at F={F} H={H}: {E} epochs, recurrence launches "
              f"{kernels.bptt_path_launches}")
        check(all(math.isfinite(float(h)) for h in hist) and bool(torch.isfinite(params).all()),
              f"train_fleet at F={F} H={H}: a loss or a parameter not finite")
        num, cnt, act0 = kernels.lstm_train_forward(params, x, m, H, Z)
        fwd_ms = cuda_ms(lambda: kernels.lstm_train_forward(params, x, m, H, Z), 2)
        act = torch.empty_like(act0)
        rec_ms = cuda_ms_fresh(lambda: kernels.lstm_train_recurrence(params, x, m, act, H, Z),
                               lambda: act.copy_(act0), 2)
        act.copy_(act0)
        rec = kernels.lstm_train_recurrence(params, x, m, act, H, Z)
        wg_ms = cuda_ms(lambda: kernels.lstm_train_wgrad(params, x, m, act, rec, H, Z), 2)
        del act, rec, act0
        nkb = kernels.lstm_train_blocks(K, F, H, Z)[1]
        b = lstm_train_bounds(J, K, W, F, H, Z, nkb)
        legs["train"].append({
            "shape": f"{J} x {K} x {W}, F={F} H={H} Z={Z}", "epochs": E,
            "epoch_ms": wall / E * 1e3, "forward_ms": fwd_ms, "recurrence_ms": rec_ms,
            "wgrad_ms": wg_ms, "forward_bound_ms": b["forward"]["bound_ms"],
            "recurrence_bound_ms": b["recurrence"]["bound_ms"],
            "wgrad_bound_ms": b["wgrad"]["bound_ms"], "bound_by": b["backward"]["bound_by"],
            "recurrence_path": "wide"})
        print(f"  train_fleet past the first design's limits, {J} jobs x {K} windows x {W} steps, "
              f"F={F} H={H} Z={Z}: {wall:.3f} s for {E} epochs ({wall / E * 1e3:.1f} ms an "
              f"epoch), loss {float(hist[0]):.5f} -> {float(hist[-1]):.5f}; one epoch: "
              f"lstm_train_forward {fwd_ms:.3f} ms ({kernels.lstm_train_forward_path(K, F, H, Z)} "
              f"path; bound {b['forward']['bound_ms']:.3f} ms, {b['forward']['bound_by']}), "
              f"lstm_train_recurrence {rec_ms:.3f} ms (wide path; its share of the backward's "
              f"bound {b['recurrence']['bound_ms']:.3f} ms, {b['backward']['bound_by']}), "
              f"lstm_train_wgrad {wg_ms:.3f} ms (its share {b['wgrad']['bound_ms']:.3f} ms)",
              flush=True)
        del x, m, params, mu, sd
        torch.cuda.empty_cache()
    return legs


# ---------------------------------------------------------------------------
# the engine cycle at fleet size
# ---------------------------------------------------------------------------
ENGINE_CANARIES, ENGINE_CONTINUOUS = 6_000, 4_000
# bench_cycle's mix=True shares of a 10,000-job fleet: 10% bivariate, 5% hpa
ENGINE_BIVARIATE, ENGINE_HPA = 1_000, 500
ENGINE_PAIR_T, ENGINE_HIST, ENGINE_CUR, ENGINE_HPA_CUR = 128, 1_440, 60, 30
ENGINE_CYCLES = 2
ENGINE_T0 = 1_700_000_040  # a step boundary
ENGINE_SPANS = ("engine.cycle", "engine.claim", "engine.preprocess", "engine.score")


def _prom_points(ts, vals, keep):
    """Each kept sample as its query_range text, `[ts,"value"]`."""
    return [f'[{t:.3f},"{v:.4f}"]' if k else None
            for t, v, k in zip(ts.tolist(), vals.tolist(), keep.tolist())]


def _prom_body(points) -> bytes:
    return ('{"status":"success","data":{"resultType":"matrix","result":[{"metric":{},'
            '"values":[' + ",".join(p for p in points if p is not None) + "]}]}}").encode()


def engine_fleet(rng):
    """11,500 jobs as Prometheus query_range bodies, one set per cycle, made
    with numpy from the seed; the second cycle's windows are the first's
    advanced by one step.

    - 6,000 canaries, one metric http_errors_5xx, baseline and current
      windows of 128 steps at 60 s: per minute a Poisson count of errors as
      err/s, ~0.5 err/s, 10% bad canaries at ~5 err/s in the current window;
    - 4,000 continuous jobs, one metric latency: 1,440 history points (1 day)
      and 60 current points, level in [20, 100], white noise sigma =
      level / 20; 10% with a +16 sigma level shift in the current window
      (the latency policy's band is 10 sigma), 2% with one +30 sigma spike in
      it (a suspect the screen escalates and the band scorer keeps healthy);
    - 1,000 continuous two-metric monitors, latency and cpu (bench_cycle's
      bi_doc), judged under the bivariate ellipse: 1,440 history and 60
      current points, levels in [20, 100] and [10, 60], noise level/20,
      correlated at rho in [0.5, 0.95]; 10% with a correlation break over
      the whole current window inside each metric's own band
      (break_radius); a job whose two metrics lose different boundary
      samples (the history's last, the current window's first) is paired a
      step apart by the joint grid, as in the reference ("misaligned");
    - 500 hpa jobs, tps and latency (priority 1, is_increase; bench_cycle's
      hpa_doc): 1,440 history and 30 current points, traffic at [50, 500]
      with 3% noise, latency at [2, 10] with 6%; a quarter each steady,
      surging (x 2), collapsing (x 0.3), violating the SLA (latency x 3);
      20% with a podCountURL (4 ready pods throughout).

    Every series: scrape offsets of 0-5 s after the step, 5% lost scrapes."""
    from foremast_tpu_torch.engine import Document, MetricQueries
    from foremast_tpu_torch.utils.timeutils import to_rfc3339

    nc, nk = ENGINE_CANARIES, ENGINE_CONTINUOUS
    L = ENGINE_PAIR_T + ENGINE_CYCLES - 1
    bad = rng.random(nc) < 0.10
    now = ENGINE_T0 + STEP * (ENGINE_HIST + ENGINE_CUR + ENGINE_CYCLES)

    def series(n, start, rates=None, level=None, sigma=None, extra=None):
        ts = start + STEP * np.arange(n) + rng.uniform(0, 5, n)
        if rates is not None:
            vals = rng.poisson(rates * STEP) / STEP
        else:
            vals = level + sigma * rng.standard_normal(n) + extra
        return ts, vals, rng.random(n) > 0.05

    pages = [{} for _ in range(ENGINE_CYCLES)]
    docs = []
    for i in range(nc):
        jid = f"canary-{i:05d}"
        urls = {}
        for role, t0, rate in (("b", ENGINE_T0, 0.5),
                               ("c", ENGINE_T0 + STEP * L, 5.0 if bad[i] else 0.5)):
            pts = _prom_points(*series(L, t0, rates=np.full(L, rate)))
            urls[role] = url = f"http://prometheus/q/{jid}/{role}"
            for c in range(ENGINE_CYCLES):
                pages[c][url] = _prom_body(pts[c:c + ENGINE_PAIR_T])
        docs.append((jid, "canary",
                     {"http_errors_5xx": dict(current=urls["c"], baseline=urls["b"])}, ""))
    kind = rng.random(nk)
    shifted, spiked = kind < 0.10, (kind >= 0.10) & (kind < 0.12)
    n = ENGINE_HIST + ENGINE_CUR + ENGINE_CYCLES - 1
    for i in range(nk):
        jid = f"continuous-{i:05d}"
        level = 20 + 80 * rng.random()
        sigma = level / 20
        extra = np.zeros(n)
        if shifted[i]:
            extra[ENGINE_HIST:] = 16 * sigma
        if spiked[i]:
            extra[ENGINE_HIST + ENGINE_CUR // 2] = 30 * sigma
        pts = _prom_points(*series(n, ENGINE_T0, level=level, sigma=sigma, extra=extra))
        uh, uc = f"http://prometheus/q/{jid}/h", f"http://prometheus/q/{jid}/c"
        for c in range(ENGINE_CYCLES):
            pages[c][uh] = _prom_body(pts[c:c + ENGINE_HIST])
            pages[c][uc] = _prom_body(pts[c + ENGINE_HIST:c + ENGINE_HIST + ENGINE_CUR])
        docs.append((jid, "continuous", {"latency": dict(current=uc, historical=uh)}, ""))
    broken = rng.random(ENGINE_BIVARIATE) < 0.10
    misaligned = set()
    for i in range(ENGINE_BIVARIATE):
        jid = f"bivariate-{i:05d}"
        rho = 0.5 + 0.45 * rng.random()
        z1 = rng.standard_normal(n)
        z2 = rho * z1 + np.sqrt(1 - rho * rho) * rng.standard_normal(n)
        if broken[i]:
            k = float(break_radius(torch.tensor(rho)))
            z1[ENGINE_HIST:], z2[ENGINE_HIST:] = k, -k
        metrics, ends = {}, []
        for name, z, level in (("latency", z1, 20 + 80 * rng.random()),
                               ("cpu", z2, 10 + 50 * rng.random())):
            ts = ENGINE_T0 + STEP * np.arange(n) + rng.uniform(0, 5, n)
            keep = rng.random(n) > 0.05
            # the grid ends with the history's last kept sample and starts
            # with the current window's first: where the two metrics
            # differ, the joint grid pairs them a step apart
            ends.append([(np.nonzero(keep[c:c + ENGINE_HIST])[0][-1],
                          np.nonzero(keep[c + ENGINE_HIST:c + ENGINE_HIST + ENGINE_CUR])[0][0])
                         for c in range(ENGINE_CYCLES)])
            pts = _prom_points(ts, level * (1 + z / 20), keep)
            uh, uc = (f"http://prometheus/q/{jid}/{name}/{r}" for r in ("h", "c"))
            for c in range(ENGINE_CYCLES):
                pages[c][uh] = _prom_body(pts[c:c + ENGINE_HIST])
                pages[c][uc] = _prom_body(pts[c + ENGINE_HIST:c + ENGINE_HIST + ENGINE_CUR])
            metrics[name] = dict(current=uc, historical=uh)
        if ends[0] != ends[1]:
            misaligned.add(jid)
        docs.append((jid, "continuous", metrics, ""))
    hpa_class = {}
    n = ENGINE_HIST + ENGINE_HPA_CUR + ENGINE_CYCLES - 1
    for i in range(ENGINE_HPA):
        jid = f"hpa-{i:05d}"
        cls = hpa_class[jid] = i % 4
        reg = np.arange(n) >= ENGINE_HIST
        tps = (50 + 450 * rng.random()) * (1 + 0.03 * rng.standard_normal(n))
        tps = np.where(reg, tps * (2.0 if cls == 1 else 0.3 if cls == 2 else 1.0), tps)
        lat = (2 + 8 * rng.random()) * (1 + 0.06 * rng.standard_normal(n))
        lat = np.where(reg & (cls == 3), lat * 3, lat)
        metrics = {}
        for name, vals, extra in (("tps", tps, {}), ("latency", lat, {"priority": 1})):
            ts = ENGINE_T0 + STEP * np.arange(n) + rng.uniform(0, 5, n)
            pts = _prom_points(ts, vals, rng.random(n) > 0.05)
            uh, uc = (f"http://prometheus/q/{jid}/{name}/{r}" for r in ("h", "c"))
            for c in range(ENGINE_CYCLES):
                pages[c][uh] = _prom_body(pts[c:c + ENGINE_HIST])
                pages[c][uc] = _prom_body(
                    pts[c + ENGINE_HIST:c + ENGINE_HIST + ENGINE_HPA_CUR])
            metrics[name] = dict(current=uc, historical=uh, **extra)
        pods = ""
        if i % 5 == 0:
            pods = f"http://prometheus/q/{jid}/pods"
            ts = ENGINE_T0 + STEP * np.arange(n)
            body = _prom_body(_prom_points(ts, np.full(n, 4.0), np.ones(n, bool)))
            for c in range(ENGINE_CYCLES):
                pages[c][pods] = body
        docs.append((jid, "hpa", metrics, pods))

    def make_docs():
        return [Document(id=jid, app_name=jid, namespace="smoke", strategy=strategy,
                         start_time=to_rfc3339(now - 3600),
                         end_time=("" if strategy in ("continuous", "hpa")
                                   else to_rfc3339(now + 86400)),
                         metrics={m: MetricQueries(**q) for m, q in metrics.items()},
                         pod_count_url=pods)
                for jid, strategy, metrics, pods in docs]

    return {"pages": pages, "docs": make_docs, "now": now,
            "bad": {f"canary-{i:05d}" for i in np.nonzero(bad)[0]},
            "shifted": {f"continuous-{i:05d}" for i in np.nonzero(shifted)[0]},
            "spiked": {f"continuous-{i:05d}" for i in np.nonzero(spiked)[0]},
            "broken": {f"bivariate-{i:05d}" for i in np.nonzero(broken)[0]},
            "misaligned": misaligned, "hpa_class": hpa_class}


def idle_split(prof):
    """The card's idle share over a profiled engine cycle, split into the
    host stages its record_function spans mark: claim, preprocess (fetch,
    parse, pack, the streamed launches), score (the last launches, collect,
    retries) and fold (from the end of score to the end of the cycle).
    Returns {stage: (host ms, device busy ms, idle share)}, or None when the
    profiler saw no device event."""
    from torch.autograd import DeviceType

    host, dev = {}, []
    for e in prof.events():
        lo, hi = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if e.name not in ENGINE_SPANS:
                dev.append((lo, hi))
        elif e.name in ENGINE_SPANS and e.name not in host:
            host[e.name] = (lo, hi)
    if not dev or "engine.cycle" not in host:
        return None
    merged = []
    for lo, hi in sorted(dev):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])

    def busy(lo, hi):
        return sum(max(0.0, min(hi, b) - max(lo, a)) for a, b in merged)

    cyc = host["engine.cycle"]
    stages = {"claim": host["engine.claim"], "preprocess": host["engine.preprocess"],
              "score": host["engine.score"], "fold": (host["engine.score"][1], cyc[1]),
              "cycle": cyc}
    out = {}
    for name, (lo, hi) in stages.items():
        dur = max(hi - lo, 1e-9)
        b = busy(lo, hi)
        out[name] = (dur / 1e3, b / 1e3, 1.0 - b / dur)
    return out


def engine_arm(fleet, triage, profile_cycle=None, algorithm="moving_average_all",
               cycles=ENGINE_CYCLES, **cfg):
    """The fleet through the port's Analyzer on the card, `cycles` cycles
    under the default EngineConfig (triage on or off; ML_ALGORITHM
    `algorithm`; other fields from cfg). Per cycle:
    wall, stages, kernel launches (counts reset just before the cycle, read
    just after), the analyzer's launches per family, triage rows, kernel
    builds, the verdict digest, the hpa_score series by app, and the idle
    split when profiled."""
    from torch.profiler import ProfilerActivity, profile

    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.dataplane import VerdictExporter
    from foremast_tpu_torch.dataplane.fetch import RawFixtureDataSource
    from foremast_tpu_torch.engine import Analyzer, EngineConfig, JobStore
    from foremast_tpu_torch.engine.jobs import verdict_digest
    from foremast_tpu_torch.kernels import build

    store = JobStore()
    for doc in fleet["docs"]():
        store.create(doc)
    src = RawFixtureDataSource(keep_urls=False)
    an = Analyzer(EngineConfig(triage=triage, algorithm=algorithm, **cfg), src, store,
                  VerdictExporter(), device=DEV)
    n_cycles, cycles = cycles, []
    for c in range(n_cycles):
        src.pages = fleet["pages"][c]
        kernels.reset_launches()
        d0, tl0 = an.device_launches, an.triage_launches_total
        prof = None
        builds = build.builds
        t0 = time.perf_counter()
        if c == profile_cycle:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                an.run_cycle(worker="smoke", now=fleet["now"] + c * STEP)
                torch.cuda.synchronize()
        else:
            an.run_cycle(worker="smoke", now=fleet["now"] + c * STEP)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = an.last_cycle_stages
        cycles.append({
            "wall_s": wall, "jobs": st["jobs"], "stages": st["stage_seconds"],
            "launches": dict(kernels.launches), "st_paths": dict(kernels.st_path_launches),
            "device_launches": an.device_launches - d0,
            "triage_launches": an.triage_launches_total - tl0, "triage": st["triage"],
            "builds": build.builds - builds, "digest": verdict_digest(store),
            "idle": idle_split(prof) if prof is not None else None,
            "hpa_gauges": {labels["app"]: value for name, labels, value in an.exporter.samples()
                           if name == "foremastbrain:namespace_app_per_pod:hpa_score"},
            "family_launches": dict(st["family_launches"])})
    return an, store, cycles


def hpa_engine_checks(fleet, store, cycles):
    """Every hpa job: one hpalog and one hpa_score sample a cycle, the raw
    score on its class's side of 50 (steady within [40, 60], violations
    >= 75 by the SLA rule), the gated score as a fresh BreathState rules
    on the same raw scores and times, the series carrying it."""
    import re

    from foremast_tpu_torch.ops import hpa as hp

    raw_re = re.compile(r"raw (-?[0-9.]+|nan)\) via (.+?) on")
    breath = hp.BreathState()
    sides = {0: lambda r: 40 <= r <= 60, 1: lambda r: r > 50, 2: lambda r: r < 50,
             3: lambda r: r >= 75}
    wrong, gated_wrong, logs_wrong = [], [], []
    for jid, cls in fleet["hpa_class"].items():
        logs = sorted(store.hpalogs_for(jid), key=lambda log: log.timestamp)
        if len(logs) != ENGINE_CYCLES:
            logs_wrong.append(jid)
            continue
        for c, log in enumerate(logs):
            raw, why = raw_re.search(log.reason).groups()
            raw = float(raw)
            if not sides[cls](raw) or (cls == 3 and why != "SLA violation"):
                wrong.append((jid, cls, raw, why))
            if (breath.apply(jid, raw, now=log.timestamp) != log.hpascore
                    or cycles[c]["hpa_gauges"].get(jid) != log.hpascore):
                gated_wrong.append(jid)
    check(not logs_wrong, f"{len(logs_wrong)} hpa jobs without one hpalog a cycle, e.g. "
                          f"{logs_wrong[:3]}")
    check(not wrong, f"{len(wrong)} hpa raw scores on the wrong side of 50, e.g. {wrong[:3]}")
    check(not gated_wrong, f"{len(gated_wrong)} hpa gated scores or series samples not as the "
                           f"breath rules, e.g. {gated_wrong[:3]}")
    per_cycle = [len(c["hpa_gauges"]) for c in cycles]
    check(all(n == ENGINE_HPA for n in per_cycle), f"hpa_score samples per cycle {per_cycle}")
    print(f"  hpa: {ENGINE_HPA} jobs, one hpalog and one hpa_score sample each a cycle "
          f"({per_cycle}); raw scores on their class's side of 50 (steady [40, 60], surge "
          f"> 50, collapse < 50, SLA violation >= 75 with its reason) on every job; gated scores "
          f"as BreathState rules", flush=True)


def engine_band_inputs(fleet):
    """The first cycle's continuous rows as the engine packs them for the
    triage screen and the band family: every continuous job's history ++
    current through the port's parser, the latency policy, zero rows up to
    the 4096 rung; then the triage margin."""
    from foremast_tpu_torch.dataplane.fetch import window_from_prometheus_body
    from foremast_tpu_torch.engine.analyzer import _concat_trimmed

    pages = fleet["pages"][0]
    R, T = 4096, 2048
    x = np.zeros((R, T), np.float32)
    m = np.zeros((R, T), bool)
    reg = np.zeros((R, T), bool)
    j = 0
    for i in range(ENGINE_CONTINUOUS):
        jid = f"continuous-{i:05d}"
        h = window_from_prometheus_body(pages[f"http://prometheus/q/{jid}/h"])
        c = window_from_prometheus_body(pages[f"http://prometheus/q/{jid}/c"])
        vals, mask, n_h = _concat_trimmed(h, c)
        x[j, :len(vals)], m[j, :len(vals)], reg[j, n_h:len(vals)] = vals, mask, True
        j += 1
    thr = np.zeros(R, np.float32)
    thr[:j] = 10.0  # the latency policy
    mode = np.ones(R, np.int32)
    mode[:j] = 3
    t = [torch.from_numpy(a).to(DEV) for a in (x, m, reg, thr, mode)]
    return (*t, torch.zeros(R, device=DEV), torch.full((R,), TRIAGE_MARGIN, device=DEV))


def engine_path(rng):
    """Two cycles of 10,000 jobs through the port's Analyzer on the card
    (triage on, the default), again with the second cycle under
    torch.profiler, and with triage off; the truth and contract checks; then
    kernels G and B against their twins at the shape the engine gave them,
    and kernel G's time there."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.engine import jobs as J
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.ops import triage as tr

    t0 = time.perf_counter()
    fleet = engine_fleet(rng)
    print(f"  {ENGINE_CANARIES} canary, {ENGINE_CONTINUOUS} continuous, {ENGINE_BIVARIATE} "
          f"two-metric and {ENGINE_HPA} hpa jobs as query_range bodies for {ENGINE_CYCLES} "
          f"cycles, made in {time.perf_counter() - t0:.1f} s; {len(fleet['bad'])} bad canaries, "
          f"{len(fleet['shifted'])} shifted and {len(fleet['spiked'])} spiked continuous jobs, "
          f"{len(fleet['broken'])} correlation breaks", flush=True)
    an, store, cycles = engine_arm(fleet, triage=True)
    _, _, prof_cycles = engine_arm(fleet, triage=True, profile_cycle=ENGINE_CYCLES - 1)
    _, _, off_cycles = engine_arm(fleet, triage=False)
    for c, rec in enumerate(cycles):
        tri = rec["triage"] or {}
        st = rec["stages"]
        print(f"  cycle {c + 1}: {rec['jobs']} jobs in {rec['wall_s']:.3f} s "
              f"({rec['jobs'] / rec['wall_s']:.0f} jobs/s); stages preprocess "
              f"{st['preprocess']:.3f} s, dispatch {st['dispatch']:.3f} s, collect "
              f"{st['collect']:.3f} s, fold {st['fold']:.3f} s; kernel launches "
              f"{ {k: v for k, v in rec['launches'].items() if v} }, analyzer device_launches "
              f"{rec['device_launches']} by family {rec['family_launches']}; screened "
              f"{tri.get('screened')}, cleared {tri.get('cleared')}, escalated "
              f"{tri.get('escalated')}; kernel library builds {rec['builds']}", flush=True)
        for k in ("pair_verdict", "ma_band", "triage_screen", "bivariate", "smooth",
                  "hpa_score"):
            check(rec["launches"][k] >= 1, f"engine cycle {c + 1} launched no {k}")
        # the HPA launch is kernel C then kernel I, once per chunk
        check(rec["launches"]["smooth"] == rec["launches"]["hpa_score"]
              == rec["family_launches"].get("hpa"),
              f"engine cycle {c + 1}: the hpa family's launches are not one C and one I each")
        check(rec["launches"]["bivariate"] == rec["family_launches"].get("bivariate"),
              f"engine cycle {c + 1}: the bivariate family's launches are not one H each")
        check(tri.get("cleared", 0) >= 1, f"engine cycle {c + 1}: the screen cleared no row")
        check(rec["launches"]["triage_screen"] == rec["triage_launches"],
              f"engine cycle {c + 1}: triage_screen launches {rec['launches']['triage_screen']} "
              f"!= the gate's {rec['triage_launches']} (a screen failed and escalated)")
        check(rec["digest"] == off_cycles[c]["digest"],
              f"engine cycle {c + 1}: the triage-off verdict digest differs")
        check(rec["digest"] == prof_cycles[c]["digest"],
              f"engine cycle {c + 1}: the profiled run's verdict digest differs")
    check(cycles[-1]["builds"] == 0, "the second engine cycle built the kernel library")
    rec = prof_cycles[-1]
    if rec["idle"] is None:
        print("  idle share: not measured (the profiler saw no device event)", flush=True)
    else:
        print(f"  cycle {ENGINE_CYCLES} under torch.profiler ({rec['wall_s']:.3f} s with the "
              f"profiler's own start and processing): "
              + "; ".join(f"{k} {h:.1f} ms host, {b:.1f} ms device busy, idle {i:.4f}"
                          for k, (h, b, i) in rec["idle"].items()), flush=True)
    docs = store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)
    status = {d.id: d.status for d in docs}
    failed = [d.id for d in docs if d.reason.startswith("scoring failed")
              or d.status in ("abort", "preprocess_failed")]
    check(not failed, f"{len(failed)} jobs failed scoring, e.g. {failed[:3]}")
    bad = fleet["bad"] | fleet["shifted"] | fleet["broken"]
    missed = [j for j in bad if status[j] != "completed_unhealth"]
    # a correlation break of a misaligned pair may pass: the history paired
    # a step apart shows no correlation to break (ROADMAP queue 3)
    excused = [j for j in missed if j in fleet["misaligned"]]
    missed = [j for j in missed if j not in fleet["misaligned"]]
    check(not missed, f"{len(missed)} bad canaries, shifted or broken jobs not unhealthy, e.g. "
                      f"{missed[:3]}")
    print(f"  two-metric jobs: {len(fleet['misaligned'])} of {ENGINE_BIVARIATE} misaligned by a "
          f"lost boundary sample in some cycle; {len(excused)} of {len(fleet['broken'])} "
          f"correlation breaks passed, every one of them misaligned", flush=True)
    healthy = [j for j in status if j not in bad]
    flagged = [j for j in healthy if status[j] == "completed_unhealth"]
    share = len(flagged) / len(healthy)
    canary_fp = sum(j.startswith("canary") for j in flagged)
    bi_fp = sum(j.startswith("bivariate") for j in flagged)
    # a misaligned pair's current window pairs the metrics a step apart: an
    # uncorrelated cloud, which a tight ellipse flags; held to the limit are
    # the aligned pairs, the misaligned ones are counted (ROADMAP queue 3)
    bi_healthy = [j for j in healthy if j.startswith("bivariate")]
    aligned = [j for j in bi_healthy if j not in fleet["misaligned"]]
    bi_fp_aligned = sum(status[j] == "completed_unhealth" for j in aligned)
    bi_share = bi_fp_aligned / len(aligned)
    print(f"  verdicts: {len(bad) - len(excused)} bad canaries, shifted and broken jobs "
          f"unhealthy, all but the {len(excused)} misaligned breaks; healthy "
          f"jobs flagged {share:.5f} (limit 0.01): {canary_fp} canaries (Mann-Whitney alone at "
          f"p < 0.01, the default pairwise test), {bi_fp} two-metric ({bi_fp_aligned} of "
          f"{len(aligned)} aligned healthy ones: {bi_share:.5f}, limit 0.01; "
          f"{bi_fp - bi_fp_aligned} of {len(bi_healthy) - len(aligned)} misaligned ones), "
          f"{len(flagged) - canary_fp - bi_fp} continuous; digests equal with triage on, on under "
          f"the profiler, and off", flush=True)
    check(bi_share < 0.01, f"aligned healthy two-metric jobs flagged {bi_share:.4f} >= 0.01")
    hpa_engine_checks(fleet, store, cycles)
    check(share < 0.01, f"healthy jobs flagged {share:.4f} >= 0.01")

    args = engine_band_inputs(fleet)
    band = args[:6]
    b_kern = kernels.ma_band(*band[:3], TRIAGE_WINDOW, *band[3:])
    b_err, b_bracketed = compare_ma_band(
        band, TRIAGE_WINDOW, b_kern, fc.moving_average_band_plain(*band[:3], TRIAGE_WINDOW,
                                                                  *band[3:]))
    print(f"  ma_band at the engine's shape ({band[0].shape[0]} x {band[0].shape[1]}, every "
          f"continuous row) against its twin: max |d preds| = {b_err:.3g}, {b_bracketed} rows "
          f"bracketed", flush=True)

    def run():
        return kernels.triage_screen(args[0], args[1], args[2], TRIAGE_WINDOW, *args[3:])

    g_kern = run()
    check_band_sigma(g_kern["sigma"], b_kern["sigma"], "the engine's rows")
    err, _ = compare_triage(args, g_kern, tr.screen_rows_plain(*args, TRIAGE_WINDOW))
    del b_kern, g_kern
    ms = cuda_ms(run, TIMED_RUNS)
    plain_ms = cuda_ms(lambda: tr.screen_rows_plain(*args, TRIAGE_WINDOW), 3)
    s_ms = sort_ms(args[0], args[1], args[2], args[0].shape[0])
    bound = triage_bound(args[1], args[2])
    launches = sum(r["launches"]["triage_screen"] for r in cycles)
    print(f"  triage_screen at the engine's shape ({args[0].shape[0]} x {args[0].shape[1]}): "
          f"kernel {ms:.3f} ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}), plain "
          f"twin {plain_ms:.1f} ms, torch.sort of the history {s_ms:.3f} ms, max |err| against "
          f"the twin {err:.3g}; {launches} launches in the {ENGINE_CYCLES} cycles", flush=True)
    family = {k: sum(r["launches"][k] for r in cycles) for k in ("bivariate", "hpa_score")}
    engine_seasonal_trend(fleet, args)
    engine_seasonal_trend(fleet, args, ENGINE_WIDE_CHANGEPOINTS)
    return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **bound}, family, fleet


ENGINE_WIDE_CHANGEPOINTS = 25  # ST_CHANGEPOINTS=25: D = 33, kernel J's cta path


def engine_seasonal_trend(fleet, band_args, changepoints=ST_CHANGEPOINTS):
    """One cycle of the fleet under ML_ALGORITHM=seasonal_trend with
    ST_CHANGEPOINTS=changepoints: the band family runs kernels F, J (on the
    path kernels.st_path names for its D) and B's band_from_preds. Every
    shifted monitor unhealthy, healthy monitors flagged under 1%, no job
    failing scoring; then kernel J against its twin on the rows the engine
    packs, each with the period kernel F gives it."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.engine import jobs as J
    from foremast_tpu_torch.ops import forecast as fc

    _, store, cycles = engine_arm(fleet, triage=True, algorithm="seasonal_trend", cycles=1,
                                  st_changepoints=changepoints)
    rec = cycles[0]
    D = 2 + changepoints + 2 * ST_ORDER
    for k in ("detect_period", "st_fit", "band_from_preds"):
        check(rec["launches"][k] >= 1, f"the seasonal_trend cycle launched no {k}")
    path = kernels.st_path(D)
    check(rec["st_paths"][path] == rec["launches"]["st_fit"],
          f"the seasonal_trend cycle at D = {D}: st_fit launches by path {rec['st_paths']}")
    docs = store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)
    status = {d.id: d.status for d in docs}
    failed = [d.id for d in docs if d.reason.startswith("scoring failed")
              or d.status in ("abort", "preprocess_failed")]
    check(not failed, f"seasonal_trend: {len(failed)} jobs failed scoring, e.g. {failed[:3]}")
    monitors = [f"continuous-{i:05d}" for i in range(ENGINE_CONTINUOUS)]
    missed = [j for j in monitors if j in fleet["shifted"] and status[j] != "completed_unhealth"]
    healthy = [j for j in monitors if j not in fleet["shifted"]]
    flagged = sum(status[j] == "completed_unhealth" for j in healthy)
    share = flagged / len(healthy)
    check(not missed, f"seasonal_trend: {len(missed)} shifted monitors not unhealthy")
    check(share < 0.01, f"seasonal_trend: healthy monitors flagged {share:.4f} >= 0.01")
    x, m, reg = band_args[:3]
    hist = m & ~reg
    T = x.shape[1]
    fb = torch.full((x.shape[0],), min(1440, T // 2), dtype=torch.int32, device=DEV)
    cand = torch.tensor(PERIOD_CANDIDATES, dtype=torch.int32, device=DEV)
    period, _ = kernels.detect_period(x, hist, cand, fb, 0.2, 0.05, 0.01)
    st = (x, hist, hist, period)
    err, ill = compare_st_fit(st, kernels.st_fit(*st, ST_ORDER, changepoints, 1e-4, 3e-3, 3),
                              fc.fit_seasonal_trend_plain(*st, ST_ORDER, 1e-4, changepoints,
                                                          3e-3, 3), D)
    print(f"  seasonal_trend cycle, ST_CHANGEPOINTS={changepoints} (D = {D}, st_fit's {path} "
          f"path): {rec['jobs']} jobs in {rec['wall_s']:.3f} s; kernel "
          f"launches { {k: v for k, v in rec['launches'].items() if v} }; "
          f"{len(fleet['shifted'])} shifted monitors unhealthy, healthy monitors flagged "
          f"{flagged} of {len(healthy)} ({share:.5f}, limit 0.01); st_fit at the engine's shape "
          f"({x.shape[0]} x {T}) against its twin: max |d preds| {err:.3g}, {ill} rows "
          f"ill-posed (the empty padding rows among them)", flush=True)


ENGINE_LSTM_JOBS, ENGINE_LSTM_APPS = 575, 32  # bench_cycle's 5% of 11,500, lstm_doc's apps
ENGINE_LSTM_METRICS = ("latency", "cpu", "tps")
ENGINE_LSTM_WIDE = 40  # metrics of the fleet's one wide job
# how far a job's z may move between the card and the twins (kernels L, M
# and K against autograd and the twin's sums in other orders, through 30
# epochs of training): a verdict may differ only within this of
# LSTM_THRESHOLD
ENGINE_LSTM_DRIFT = 1e-2


def engine_lstm_fleet(rng):
    """575 continuous three-metric jobs (latency, cpu, tps; bench_cycle's
    lstm_doc) over 32 app identities, as query_range bodies: 1,440 history
    and 60 current points at 60 s; per app a daily load cycle (its phase),
    per job its levels (latency [20, 80] ms rising 30% with load, cpu
    [10, 40]% and tps [100, 500]/s with load) and noise (6%, 5%, 3%); 10% of
    the jobs with a joint anomaly over the current window (latency up 4 and
    tps down 3 history standard deviations); scrape offsets of 0-5 s, 5%
    lost scrapes."""
    from foremast_tpu_torch.engine import Document, MetricQueries

    n, nh = ENGINE_HIST + ENGINE_CUR, ENGINE_HIST
    t = np.arange(n)
    phase = rng.uniform(0, 2 * np.pi, ENGINE_LSTM_APPS)
    anomalous = rng.random(ENGINE_LSTM_JOBS) < 0.10
    pages, docs = {}, []
    for i in range(ENGINE_LSTM_JOBS):
        jid = f"lstm-{i:04d}"
        load = 1 + 0.5 * np.sin(2 * np.pi * t / 1440 + phase[i % ENGINE_LSTM_APPS])
        vals = {"latency": rng.uniform(20, 80) * (1 + 0.3 * (load - 1))
                * (1 + 0.06 * rng.standard_normal(n)),
                "cpu": rng.uniform(10, 40) * load * (1 + 0.05 * rng.standard_normal(n)),
                "tps": rng.uniform(100, 500) * load * (1 + 0.03 * rng.standard_normal(n))}
        if anomalous[i]:
            vals["latency"][nh:] += 4 * vals["latency"][:nh].std()
            vals["tps"][nh:] -= 3 * vals["tps"][:nh].std()
        metrics = {}
        for name in ENGINE_LSTM_METRICS:
            ts = ENGINE_T0 + STEP * t + rng.uniform(0, 5, n)
            pts = _prom_points(ts, vals[name], rng.random(n) > 0.05)
            uh, uc = (f"http://prometheus/q/{jid}/{name}/{r}" for r in ("h", "c"))
            pages[uh], pages[uc] = _prom_body(pts[:nh]), _prom_body(pts[nh:])
            metrics[name] = MetricQueries(current=uc, historical=uh)
        docs.append((jid, f"lstm-app-{i % ENGINE_LSTM_APPS}", metrics))
    # one job of ENGINE_LSTM_WIDE metrics (past the 32 a warp's lanes hold):
    # the three kinds' levels and noise in turn, on an app of its own
    jid, metrics = "lstm-wide", {}
    load = 1 + 0.5 * np.sin(2 * np.pi * t / 1440 + phase[0])
    for k in range(ENGINE_LSTM_WIDE):
        level = rng.uniform(10, 100)
        v = level * (1 + 0.3 * (k % 3) * (load - 1)) * (1 + 0.05 * rng.standard_normal(n))
        ts = ENGINE_T0 + STEP * t + rng.uniform(0, 5, n)
        pts = _prom_points(ts, v, rng.random(n) > 0.05)
        uh, uc = (f"http://prometheus/q/{jid}/m{k:02d}/{r}" for r in ("h", "c"))
        pages[uh], pages[uc] = _prom_body(pts[:nh]), _prom_body(pts[nh:])
        metrics[f"m{k:02d}"] = MetricQueries(current=uc, historical=uh)
    docs.append((jid, "lstm-app-wide", metrics))

    def make_docs():
        return [Document(id=jid, app_name=app, namespace="smoke", strategy="continuous",
                         start_time="", end_time="", metrics=dict(metrics))
                for jid, app, metrics in docs]

    return {"pages": pages, "docs": make_docs, "now": ENGINE_T0 + STEP * n,
            "anomalous": {f"lstm-{i:04d}" for i in np.nonzero(anomalous)[0]}}


def engine_lstm_arm(fleet, device):
    """The LSTM fleet through the port's Analyzer (default EngineConfig) on
    `device`: cycles until one trains no model (the budget of 8 a cycle at
    32 identities: four training cycles), that last one the scored cycle.
    Per cycle: wall, the models trained, engine.lstm_train's seconds, the
    kernel launches (counts reset just before the cycle, read just after).
    Returns (store, cycles, {job: last z}, judged ids per cycle)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.dataplane.fetch import RawFixtureDataSource
    from foremast_tpu_torch.engine import Analyzer, EngineConfig, JobStore
    from foremast_tpu_torch.utils import tracing

    store = JobStore()
    for doc in fleet["docs"]():
        store.create(doc)
    an = Analyzer(EngineConfig(), RawFixtureDataSource(fleet["pages"], keep_urls=False), store,
                  device=device)
    zs, judged = {}, []
    score_multi = an._score_multi

    def record(items):
        res = score_multi(items)
        for (jid, _m, _f), r in res.items():
            zs[jid] = r["z"]
            judged[-1].add(jid)
        return res

    an._score_multi = record
    cycles = []
    for c in range(8):
        judged.append(set())
        kernels.reset_launches()
        tr0 = tracing.tracer.stats().get("engine.lstm_train", {}).get("total_seconds", 0.0)
        t0 = time.perf_counter()
        an.run_cycle(worker="smoke", now=fleet["now"])
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        tr1 = tracing.tracer.stats().get("engine.lstm_train", {}).get("total_seconds", 0.0)
        cycles.append({"wall_s": wall, "trained": an._lstm_trained_this_cycle,
                       "train_s": tr1 - tr0, "jobs": an.last_cycle_stages["jobs"],
                       "skips": len(an._lstm_budget_skipped_ids),
                       "launches": {k: v for k, v in kernels.launches.items() if v},
                       "wide": (kernels.bptt_path_launches["wide"],
                                kernels.lstm_ae_path_launches["wide"])})
        if an._lstm_trained_this_cycle == 0:
            break
    return store, cycles, zs, judged


def engine_lstm(rng):
    """Phase `engine`, arm engine_lstm: the LSTM fleet on the card and again
    with device="cpu" (the twins). No job fails scoring, every job is judged
    by the scored cycle (unhealthy before it, or judged in it), kernels L, M
    and K launch in the card's arm, and the verdicts equal the twins' job by
    job but where a job's z lies within ENGINE_LSTM_DRIFT of LSTM_THRESHOLD
    (those jobs are printed). Reports recall, healthy jobs flagged,
    engine.lstm_train seconds and wall time per cycle."""
    from foremast_tpu_torch.engine import EngineConfig
    from foremast_tpu_torch.engine import jobs as J

    t0 = time.perf_counter()
    fleet = engine_lstm_fleet(rng)
    print(f"  engine_lstm: {ENGINE_LSTM_JOBS} three-metric jobs over {ENGINE_LSTM_APPS} apps and one "
          f"of {ENGINE_LSTM_WIDE} metrics as "
          f"query_range bodies, made in {time.perf_counter() - t0:.1f} s; "
          f"{len(fleet['anomalous'])} with a joint anomaly", flush=True)
    thr = EngineConfig().lstm_threshold
    runs = {}
    for dev in (DEV, "cpu"):
        store, cycles, zs, judged = engine_lstm_arm(fleet, dev)
        docs = store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)
        status = {d.id: d.status for d in docs}
        failed = [d.id for d in docs if d.reason.startswith("scoring failed")
                  or d.status in ("abort", "preprocess_failed")]
        check(not failed, f"engine_lstm on {dev}: {len(failed)} jobs failed scoring, e.g. "
                          f"{failed[:3]}")
        last = cycles[-1]
        check(last["trained"] == 0 and last["skips"] == 0,
              f"engine_lstm on {dev}: no cycle of 8 judged every job")
        open_jobs = {j for j, st in status.items() if st != J.COMPLETED_UNHEALTH}
        check(open_jobs <= judged[-1], f"engine_lstm on {dev}: {len(open_jobs - judged[-1])} "
                                       f"open jobs not judged by the scored cycle")
        check(set(zs) == set(status), f"engine_lstm on {dev}: {len(set(status) - set(zs))} jobs "
                                      f"never judged")
        runs[dev] = (status, zs)
        anom = fleet["anomalous"]
        recall = sum(status[j] == J.COMPLETED_UNHEALTH for j in anom) / max(len(anom), 1)
        healthy = [j for j in status if j not in anom]
        flagged = sum(status[j] == J.COMPLETED_UNHEALTH for j in healthy) / len(healthy)
        for c, rec in enumerate(cycles):
            print(f"  engine_lstm on {dev}, cycle {c + 1}: {rec['jobs']} jobs in "
                  f"{rec['wall_s']:.3f} s, {rec['trained']} models trained "
                  f"(engine.lstm_train {rec['train_s']:.3f} s), {rec['skips']} jobs left for a "
                  f"later budget; kernel launches {rec['launches']}", flush=True)
        print(f"  engine_lstm on {dev}: recall {recall:.4f} ({len(anom)} anomalous jobs), "
              f"healthy jobs flagged {flagged:.4f}", flush=True)
        if dev == DEV:
            total = {}
            for rec in cycles:
                for k, v in rec["launches"].items():
                    total[k] = total.get(k, 0) + v
            for k in ("lstm_train_forward", "lstm_train_recurrence", "lstm_train_wgrad", "adam",
                      "lstm_ae"):
                check(total.get(k, 0) >= 1, f"engine_lstm on the card launched no {k}")
            wide = [sum(rec["wide"][i] for rec in cycles) for i in (0, 1)]
            check(min(wide) >= 1, f"engine_lstm on the card: the {ENGINE_LSTM_WIDE}-metric job "
                                  f"took no wide path (recurrence, scoring: {wide})")
            print(f"  engine_lstm on the card: the {ENGINE_LSTM_WIDE}-metric job's launches on "
                  f"the wide paths: recurrence {wide[0]}, scoring {wide[1]}", flush=True)
            card_launches = total
    (st_k, z_k), (st_c, z_c) = runs[DEV], runs["cpu"]
    edge = {j for j in z_k if min(abs(z_k[j] - thr), abs(z_c[j] - thr)) <= ENGINE_LSTM_DRIFT}
    differ = {j for j in st_k if st_k[j] != st_c[j]}
    check(differ <= edge, f"engine_lstm: {len(differ - edge)} verdicts differ between the card "
                          f"and the twins away from the threshold, e.g. "
                          f"{[(j, z_k[j], z_c[j]) for j in sorted(differ - edge)[:3]]}")
    dz = max(abs(z_k[j] - z_c[j]) for j in z_k)
    print(f"  engine_lstm: card against twins: verdicts equal on {len(st_k) - len(differ)} of "
          f"{len(st_k)} jobs; max |d z| {dz:.3g}; boundary jobs (z within {ENGINE_LSTM_DRIFT} of "
          f"{thr}): {[(j, round(z_k[j], 4), round(z_c[j], 4)) for j in sorted(edge)]}",
          flush=True)
    return card_launches


# ---------------------------------------------------------------------------
# the engine's own layers on the card
# ---------------------------------------------------------------------------
LAYERS_FAIL = {"canary_mid": 200, "canary_end": 100, "continuous": 200, "bivariate": 50,
               "hpa": 50}  # healthy warm jobs whose fetch fails in cycles 3 and 4
LAYERS_NOTIFY = {"canary": 400, "continuous": 300, "bivariate": 200, "hpa": 100}
LAYERS_SPIN_CYCLES = 540_000_000  # ~0.3 s of an H100's SM clock: a hung collect
LAYERS_WATCHDOG_S = 0.05
LAYERS_BUDGET_S = 60.0
LAYERS_AB_JOBS = 2000  # open jobs of the interleaved PROVENANCE off / on cycles
LAYERS_AB_ORDER = "CAACCA"  # C: PROVENANCE off, A: on
LAYER_PATHS = ("scored", "triaged", "memo-hit", "stream-scored")


def _settled(store):
    """Every job's (status, anomaly, reason when terminal). An open job keeps
    the reason of its last degraded-mode stamp (a requeue keeps the reason,
    as in the reference), so a carried job's "healthy so far" is compared by
    status."""
    from foremast_tpu_torch.engine import jobs as J

    return {d.id: (d.status, sorted(d.anomaly.items()),
                   d.reason if d.status in J.TERMINAL_STATUSES else "")
            for d in store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)}


def _layer_timer(an):
    """Wrap the layers' host entry points of one analyzer (provenance
    records and summaries, latency observations and the newest-sample scan
    they read, stale serving, the shed order, the quarantine's failure
    count and pruning, health) in one accumulator of seconds; `paths`
    keeps each job's last recorded verdict path (the recorder itself keeps
    only its newest 4,096 jobs). A lower bound of the layers' host cost:
    the dicts `_finish_*` build for a record and the quarantine gate run
    outside the wrapped calls."""
    acc = {"s": 0.0, "paths": {}}

    def timed(obj, name, log=False):
        fn = getattr(obj, name)

        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                if log:
                    acc["paths"][a[0]] = a[1]
                acc["s"] += time.perf_counter() - t0
        setattr(obj, name, run)

    timed(an.provenance, "record", log=True)
    for obj, name in ((an.provenance, "begin_cycle"), (an.provenance, "finish_cycle"),
                      (an, "_observe_latency"), (an, "_newest_sample_ts"),
                      (an, "_prov_content"), (an, "_serve_stale"), (an, "_job_priority"),
                      (an, "_record_scoring_failure"), (an, "_prune_degraded_state"),
                      (an.health, "begin_cycle"), (an.health, "end_cycle")):
        timed(obj, name)
    return acc


def layers_path(fleet):
    """Phase `layers`: the engine's own layers over engine_fleet's 11,500
    jobs on the card, every cycle on the first cycle's pages, at `now`s one
    step apart. Run A has the defaults (provenance, SLOs, stale serving,
    quarantine on), run C PROVENANCE off, run B its first cycle under a
    1e-9 s budget with the flight recorder dumping into a temporary
    directory. Checks: (5) after A's first cycle the SLO counts equal its
    judged jobs of each class; (7) A's and C's first cycles' walls, stages
    and equal digests, then re-confirm partial cycles over 2,000 of their
    open jobs, C and A interleaved, with equal digests after them; (6)
    StreamScheduler's partial cycle over 1,000 notified
    jobs of a fresh store gives A's first sweep's verdicts and hpalogs, each
    bucket's rows and kernel paths printed; (1) B's first cycle sheds every
    monitor but the first and scores every canary; (4) its OVERLOADED dump
    parses and holds provenance and knobs; (2) in A's second and third
    cycles the fetches of 600 warm jobs fail, mid-window and (for 100
    canaries) past endTime: each is stale-served, no unhealthy job is, and
    at the second cycle every job's settled verdict is that of B's second
    (the budget lifted, no failures), which is (1)'s carried jobs too; at
    the third the other jobs' verdicts are unchanged; (3) a poison job
    parked after three failed partial cycles, held without a fetch, then
    re-admitted; then a collect hung on the card (a spin kernel on the
    engine's stream) under a 0.05 s watchdog. Kernel counts are reset
    before each cycle and read after it."""
    import dataclasses
    import gc
    import tempfile
    import threading

    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.dataplane import VerdictExporter
    from foremast_tpu_torch.dataplane.fetch import FetchError, RawFixtureDataSource
    from foremast_tpu_torch.engine import Analyzer, EngineConfig, JobStore, StreamScheduler
    from foremast_tpu_torch.engine import jobs as J
    from foremast_tpu_torch.engine.jobs import verdict_digest
    from foremast_tpu_torch.engine.slo import classify
    from foremast_tpu_torch.utils.timeutils import to_rfc3339

    t_phase = time.perf_counter()
    pages = fleet["pages"][0]
    nows = [fleet["now"] + k * STEP for k in range(3)]
    sel = np.random.default_rng(SEED + 20)
    docs0 = fleet["docs"]()
    kind = {d.id: d.id.split("-")[0] for d in docs0}
    strategy = {d.id: d.strategy for d in docs0}
    monitors = [d.id for d in docs0 if d.strategy in ("continuous", "hpa")]
    canaries = [d.id for d in docs0 if d.strategy not in ("continuous", "hpa")]
    bad = fleet["bad"] | fleet["shifted"] | fleet["broken"]

    def pick(k, n, exclude=()):
        ids = sorted(j for j in kind if kind[j] == k and j not in bad and j not in exclude)
        return [ids[i] for i in sorted(sel.choice(len(ids), n, replace=False))]

    f_end = pick("canary", LAYERS_FAIL["canary_end"])
    failing = set(f_end) | set(pick("canary", LAYERS_FAIL["canary_mid"], set(f_end)))
    for k in ("continuous", "bivariate", "hpa"):
        failing |= set(pick(k, LAYERS_FAIL[k]))
    # the canaries of f_end end between the two failing cycles
    end_of = to_rfc3339(nows[0] + 1.5 * STEP)

    class Source(RawFixtureDataSource):
        """The fleet's pages; fetches of the jobs in `failing` raise, and
        each job's fetches are counted."""

        def __init__(self):
            super().__init__(dict(pages), keep_urls=False)
            self.failing, self.fetched = set(), {}

        def _raw(self, url):
            jid = url.split("/")[4]
            self.fetched[jid] = self.fetched.get(jid, 0) + 1
            if jid in self.failing:
                raise FetchError(f"blackout: {url}")
            return super()._raw(url)

    def arm(**cfg):
        store = JobStore()
        for doc in fleet["docs"]():
            if doc.id in f_end:
                doc.end_time = end_of
            store.create(doc)
        src = Source()
        an = Analyzer(EngineConfig(**cfg), src, store, VerdictExporter(), device=DEV)
        return an, store, src, _layer_timer(an)

    buckets = {}

    def log_buckets(an, key):
        launch = an._launch_chunks

        def run(family, T, B, *a, **kw):
            buckets.setdefault(key, []).append((family, T, B))
            return launch(family, T, B, *a, **kw)
        an._launch_chunks = run

    def kernel_paths():
        return {name: {p: n for p, n in counts.items() if n}
                for name, counts in (("pair", kernels.pair_path_launches),
                                     ("ma_band", kernels.band_path_launches),
                                     ("bivariate", kernels.bivariate_path_launches))}

    # the interpreter's garbage collections, timed through gc.callbacks
    # while the phase runs; `cycle` resets the sum
    gc_acc = {"s": 0.0, "n": 0, "t0": 0.0}

    def gc_timer(step, info):
        if step == "start":
            gc_acc["t0"] = time.perf_counter()
        else:
            gc_acc["s"] += time.perf_counter() - gc_acc["t0"]
            gc_acc["n"] += 1

    def cycle(an, timer, now, **kw):
        kernels.reset_launches()
        timer["s"], timer["paths"] = 0.0, {}
        gc_acc["s"], gc_acc["n"] = 0.0, 0
        t0 = time.perf_counter()
        out = an.run_cycle(worker="layers", now=now, **kw)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, dict(kernels.launches), kernel_paths()

    def verdicts(store, ids):
        return {j: (store.get(j).status, store.get(j).reason,
                    sorted(store.get(j).anomaly.items())) for j in ids}

    def hpalogs(store, ids):
        return {j: [(g.hpascore, g.reason, g.details) for g in store.hpalogs_for(j)]
                for j in ids if strategy[j] == "hpa"}

    tmp = tempfile.TemporaryDirectory()
    gc.callbacks.append(gc_timer)
    an_a, store_a, src_a, timer_a = arm()
    an_c, store_c, _, timer_c = arm(provenance=False)
    log_buckets(an_a, "full")
    print(f"  the kernel library loaded in {an_a.library_load_seconds:.3f} s before run A's "
          f"first cycle budget (built by phase build)", flush=True)

    # (5), (7): A's and C's first cycles
    runs = {}
    for name, an, store, timer in (("A", an_a, store_a, timer_a), ("C", an_c, store_c, timer_c)):
        out, wall, launches, paths = cycle(an, timer, nows[0])
        for k in ("pair_verdict", "ma_band", "triage_screen", "bivariate", "smooth",
                  "hpa_score"):
            check(launches[k] >= 1, f"layers run {name}, cycle 1 launched no {k}")
        runs[name] = (out, wall, timer["s"], verdict_digest(store), paths,
                      dict(timer["paths"]), dict(an.last_cycle_stages["stage_seconds"]),
                      (gc_acc["s"], gc_acc["n"]))
    out_a0, wall_a, layer_a, digest_a, full_paths, paths_a0, _, _ = runs["A"]
    _, wall_c, layer_c, digest_c, _, _, _, _ = runs["C"]
    check(digest_a == digest_c, "layers: the first cycle's digest differs with PROVENANCE off")
    print(f"  (7) first cycle, PROVENANCE on / off: {wall_a:.3f} / {wall_c:.3f} s, of them the "
          f"layers' host entry points {layer_a:.3f} / {layer_c:.3f} s; digests equal", flush=True)
    judged = {}
    for j, p in paths_a0.items():
        if p in LAYER_PATHS:
            cls = classify(strategy[j])
            judged[cls] = judged.get(cls, 0) + 1
    slo = {cls: d["n"] for cls, d in an_a.slo.digest().items()}
    check(slo == judged, f"layers: SLO counts {slo} != judged jobs of each class {judged}")
    print(f"  (5) SLO observations {slo} = the jobs judged in the cycle by class; p99 "
          f"{ {c: d['p99_s'] for c, d in an_a.slo.digest().items()} } s", flush=True)
    sweep = verdicts(store_a, out_a0)
    sweep_logs = hpalogs(store_a, out_a0)

    # (7) the layers' host cost: the first cycles' stages, then re-confirm
    # partial cycles over the same open jobs at the first now, PROVENANCE
    # off and on interleaved
    open_ids = sorted(j for j, st in out_a0.items() if st == J.INITIAL)
    ab_ids = {open_ids[i] for i in sel.choice(len(open_ids), LAYERS_AB_JOBS, replace=False)}
    ab = {"A": [], "C": []}
    for name in LAYERS_AB_ORDER:
        an, timer = (an_a, timer_a) if name == "A" else (an_c, timer_c)
        _, wall, _, _ = cycle(an, timer, nows[0], job_ids=ab_ids, partial=True)
        st = dict(an.last_cycle_stages["stage_seconds"])
        ab[name].append({"wall": wall, **st, "outside the stages": wall - sum(st.values()),
                         "the layers' entry points": timer["s"], "gc": gc_acc["s"],
                         "gc collections": gc_acc["n"]})
    check(verdict_digest(store_a) == verdict_digest(store_c),
          "layers: the re-confirm cycles' digests differ with PROVENANCE off")

    def spread(rows):
        out = []
        for k in rows[0]:
            vals = sorted(r[k] for r in rows)
            out.append(f"{k} {float(np.median(vals)):.4f} [{vals[0]:.4f}-{vals[-1]:.4f}]")
        return ", ".join(out)

    for name in ("A", "C"):
        st, gcs = runs[name][6], runs[name][7]
        print(f"  (7) first cycle, PROVENANCE {'on' if name == 'A' else 'off'}: stages "
              f"{ {k: round(v, 3) for k, v in st.items()} } s, gc {gcs[0]:.3f} s in {gcs[1]} "
              f"collections", flush=True)
    for name, label in (("A", "on"), ("C", "off")):
        print(f"  (7) re-confirm partial cycles over {len(ab_ids)} open jobs, PROVENANCE "
              f"{label} ({len(ab[name])} of the order {LAYERS_AB_ORDER}), median [min-max] s: "
              f"{spread(ab[name])}", flush=True)

    # (6) the scheduler's partial cycle over 1,000 notified jobs
    notified = set()
    for k, n in LAYERS_NOTIFY.items():
        ids = sorted(j for j in kind if kind[j] == k)
        notified |= {ids[i] for i in sel.choice(len(ids), n, replace=False)}
    an_p, store_p, _, timer_p = arm()
    log_buckets(an_p, "partial")
    errors = []

    class AtNow:
        """The analyzer as the scheduler sees it, its cycles at nows[0]."""
        waterfall = an_p.waterfall

        def run_cycle(self, worker="layers", job_ids=None, partial=False):
            try:
                return an_p.run_cycle(worker=worker, now=nows[0], job_ids=job_ids,
                                      partial=partial)
            except Exception as e:  # noqa: BLE001 - reported by the check below
                errors.append(repr(e))
                raise

    sched = StreamScheduler(AtNow(), full_cycle_fn=lambda: None, cycle_seconds=600.0,
                            worker="layers", debounce_seconds=0.0)
    stop = threading.Event()
    th = threading.Thread(target=sched.run, args=(stop,), daemon=True)
    kernels.reset_launches()
    th.start()
    try:
        t0 = time.perf_counter()
        while sched.sweeps_total < 1 and time.perf_counter() - t0 < 30:
            time.sleep(0.002)
        t0 = time.perf_counter()
        sched.notify(notified)
        while (sched.partial_cycles_total < 1 and not errors
               and time.perf_counter() - t0 < 60):
            time.sleep(0.002)
        partial_wall = time.perf_counter() - t0
    finally:
        stop.set()
        th.join(timeout=30)
    check(not errors and sched.partial_cycles_total == 1,
          f"layers: the partial cycle did not run ({errors})")
    p_paths = kernel_paths()
    st = an_p.last_cycle_stages
    check(st["jobs"] == len(notified) and st["partial"],
          f"layers: the partial cycle claimed {st['jobs']} jobs")
    got = verdicts(store_p, notified)
    differ = [j for j in notified if got[j] != sweep[j]]
    check(not differ, f"layers: {len(differ)} notified jobs' partial-cycle verdicts differ from "
                      f"the full sweep's, e.g. {[(j, got[j], sweep[j]) for j in differ[:2]]}")
    logs_p = hpalogs(store_p, notified)
    check(all(logs_p[j] == sweep_logs[j] for j in logs_p),
          "layers: a notified hpa job's hpalog differs from the full sweep's")
    unh = sum(got[j][0] == J.COMPLETED_UNHEALTH for j in notified)

    def rows_by_bucket(key):
        out = {}
        for fam, T, B in buckets[key]:
            out.setdefault(f"{fam}@{T}", []).append(B)
        return dict(sorted(out.items()))

    print(f"  (6) StreamScheduler: one partial cycle over {len(notified)} notified jobs "
          f"({LAYERS_NOTIFY}) in {partial_wall:.3f} s from the notify (stages "
          f"{st['stage_seconds']}): verdicts and hpalogs equal to the full sweep's ({unh} "
          f"unhealthy among them); rows a launch by family@T: partial {rows_by_bucket('partial')}, "
          f"full sweep {rows_by_bucket('full')}; kernel paths: partial {p_paths}, full sweep "
          f"{full_paths}", flush=True)
    del an_p, store_p

    # (1) shedding and (4) the OVERLOADED dump
    an_b, store_b, _, timer_b = arm(cycle_deadline_seconds=1e-9, flight_dump_dir=tmp.name)
    an_b.flight.min_dump_interval_s = 0.0
    out_b, wall_b0, launches_b, _ = cycle(an_b, timer_b, nows[0])
    shed = {j for j, p in timer_b["paths"].items() if p == "shed-carryover"}
    check(len(shed) == len(monitors) - 1 and set(monitors) - shed == {monitors[0]},
          f"layers: the expired budget shed {len(shed)} of {len(monitors)} monitors")
    check(all(timer_b["paths"].get(j) in LAYER_PATHS for j in canaries),
          "layers: a canary was not scored under the expired budget")
    check(an_b.health.state()[0] == "overloaded", "layers: shedding did not read OVERLOADED")
    check(an_b.flight.dumps_total == 1,
          f"layers: OVERLOADED wrote {an_b.flight.dumps_total} flight dumps, not one")
    with open(an_b.flight.last_dump_path) as f:
        dump = json.load(f)
    # the shed event names 16 jobs; their records survive in the recorder
    # only while fewer than 4,096 jobs were recorded after them (its
    # bound), so at this size the dump may hold none of them (the CPU test
    # test_overloaded_dump_holds_every_named_shed_job_s_record holds them
    # all below the bound)
    aff = dump["provenance"]["affected_jobs"]
    shed_ev = [e for e in dump["events"] if e["type"] == "load-shed"]
    check(dump["reason"] == "health:overloaded" and len(shed_ev) == 1
          and shed_ev[0]["detail"]["count"] == len(shed)
          and set(shed_ev[0]["detail"]["jobs"]) <= shed
          and len(dump["provenance"]["recent"]) == 20,
          f"layers: the dump ({dump['reason']}) does not hold the shed event and 20 recent "
          f"provenance records")
    check(dump["knobs"]["engine"]["cycle_deadline_seconds"] == 1e-9
          and dump["knobs"]["engine"]["device"].startswith("cuda"),
          "layers: the dump's knobs are not the run's")
    print(f"  (1) budget 1e-9 s: {len(shed)} of {len(monitors)} monitors shed, all "
          f"{len(canaries)} canaries and the first monitor scored in {wall_b0:.3f} s (kernel "
          f"launches { {k: v for k, v in launches_b.items() if v} })", flush=True)
    print(f"  (4) the OVERLOADED dump {os.path.basename(an_b.flight.last_dump_path)}: "
          f"{len(dump['events'])} events (the shed event names {len(shed_ev[-1]['detail']['jobs'])} "
          f"jobs, {len(aff)} of them still recorded), {len(dump['provenance']['recent'])} "
          f"recent provenance records, the engine's "
          f"knobs {sorted(dump['knobs']['engine'])}, {len(dump['knobs']['env'])} env knobs",
          flush=True)
    an_b.config = dataclasses.replace(an_b.config, cycle_deadline_seconds=0.0)

    # (2) fetch failures over warm jobs of A, against B without them
    walls_fail = []
    for c in (1, 2):
        src_a.failing = failing
        out_a, wall_f, _, _ = cycle(an_a, timer_a, nows[c])
        walls_fail.append(wall_f)
        stale = {j for j, p in timer_a["paths"].items() if p == "stale-served"}
        live = failing & set(out_a)
        check(stale == live and len(live) >= 0.95 * len(failing),
              f"layers: cycle {c + 1} stale-served {len(stale)} jobs, {len(live)} warm jobs "
              f"failed")
        check(not stale & bad and all(out_a0[j] == J.INITIAL for j in stale),
              "layers: a job not judged healthy was stale-served")
        ends = [j for j in f_end if j in out_a]
        want_end = J.COMPLETED_HEALTH if c == 2 else J.INITIAL
        check(all(out_a[j] == want_end for j in ends)
              and all(out_a[j] == J.INITIAL for j in stale - set(f_end)),
              f"layers: cycle {c + 1}'s stale-served statuses are not the rules'")
        check(all(f"age {c * STEP:.0f}s" in store_a.get(j).reason for j in stale),
              f"layers: cycle {c + 1}'s stale reasons do not carry the age {c * STEP} s")
        if c == 1:
            # B's second cycle: the budget lifted, no failures; the shed
            # jobs complete, and every job's settled verdict is A's
            _, wall_b1, _, _ = cycle(an_b, timer_b, nows[1])
            settled_b = _settled(store_b)
            check(_settled(store_a) == settled_b and not an_b._shed_streak,
                  "layers: the shed fleet did not settle to the unshed fleet's verdicts")
            print(f"  (1) the budget lifted: the {len(shed)} carried jobs completed in "
                  f"{wall_b1:.3f} s; every job's settled verdict equals the unshed run A's",
                  flush=True)
    others = [j for j in settled_b if j not in failing]
    settled_a = _settled(store_a)
    differ = [j for j in others if settled_a[j] != settled_b[j]]
    check(not differ, f"layers: {len(differ)} jobs outside the failures differ from the run "
                      f"without them, e.g. {differ[:3]}")
    check(an_a.health.state()[0] == "degraded", "layers: stale serving did not read DEGRADED")
    print(f"  (2) {len(failing)} warm jobs' fetches failed in cycles 2 and 3 "
          f"({LAYERS_FAIL}): each stale-served, {len(ends)} canaries past endTime "
          f"COMPLETED_HEALTH on the last fresh verdict, none of the {len(bad)} unhealthy jobs; "
          f"the other {len(others)} jobs' verdicts equal B's without failures (their data and "
          f"endTimes do not change between the two nows); cycles {walls_fail[0]:.3f} / "
          f"{walls_fail[1]:.3f} s; health DEGRADED", flush=True)

    # (3) a poison job: three failed partial cycles park it, the gate holds
    # it without a fetch, a healed probe re-admits it
    poison = next(j for j in sorted(kind) if kind[j] == "bivariate" and j not in bad
                  and j not in failing)
    # its next-cycle pages: windows the memo has not seen
    for url, body in fleet["pages"][1].items():
        if url.split("/")[4] == poison:
            src_a.pages[url] = body
    src_a.failing = set()
    poisoned = {"on": True}
    collect, score = an_a._collect_bivariate, an_a._score_bivariate

    def is_poison(entries):
        return poisoned["on"] and any((e[0] if isinstance(e, tuple) else e).job_id == poison
                                      for e in entries)

    def poisoned_collect(state):
        if is_poison(state[0]):
            raise RuntimeError("poisoned job")
        return collect(state)

    def poisoned_score(items):
        if is_poison(items):
            raise RuntimeError("poisoned job")
        return score(items)

    an_a._collect_bivariate, an_a._score_bivariate = poisoned_collect, poisoned_score
    t = nows[2]
    reasons = []
    for _ in range(3):
        t += 10
        cycle(an_a, timer_a, t, job_ids={poison}, partial=True)
        reasons.append(store_a.get(poison).reason)
    check(all(r.startswith("scoring failed: RuntimeError") for r in reasons)
          and an_a.quarantined_count(t) == 1, f"layers: the poison job was not parked ({reasons})")
    fetched = src_a.fetched.get(poison, 0)
    _, _, launches_q, _ = cycle(an_a, timer_a, t + 10, job_ids={poison}, partial=True)
    check(store_a.get(poison).reason.startswith("quarantined")
          and src_a.fetched.get(poison, 0) == fetched and not any(launches_q.values()),
          "layers: the quarantine gate fetched or scored the parked job")
    poisoned["on"] = False
    out, _, launches_r, _ = cycle(an_a, timer_a, t + 31, job_ids={poison}, partial=True)
    path = timer_a["paths"].get(poison)
    check(poison not in an_a._quarantine and path == "stream-scored"
          and launches_r["bivariate"] == 1,
          f"layers: the healed probe did not re-admit the job ({path})")
    print(f"  (3) poison job {poison}: three failed partial cycles, parked "
          f"({an_a.jobs_quarantined_total} parking), the gate's cycle fetched and launched "
          f"nothing, a clean probe 31 s later re-admitted it: {out[poison]}, path {path}, one "
          f"bivariate launch", flush=True)
    del an_a, store_a, an_b, store_b, an_c, store_c

    # a collect hung on the card under the watchdog
    an_w, store_w, _, timer_w = arm(watchdog_seconds=LAYERS_WATCHDOG_S)
    ids_w = set(canaries[:64])
    orig = an_w._collect_pairs
    calls = {"n": 0}

    def hung_collect(state):
        calls["n"] += 1
        if calls["n"] == 1:
            with an_w.staging.on_stream():
                torch.cuda._sleep(LAYERS_SPIN_CYCLES)
        return orig(state)

    an_w._collect_pairs = hung_collect
    out_w, wall_w, _, _ = cycle(an_w, timer_w, nows[0], job_ids=ids_w, partial=True)
    fires = an_w.watchdog_fires_total
    state_w = an_w.health.state()[0]
    paths_w = {timer_w["paths"].get(j) for j in ids_w}
    check(fires == 2 and state_w == "degraded" and paths_w == {"watchdog-failover"}
          and all(out_w[j] == J.INITIAL for j in ids_w) and not an_w._quarantine,
          f"layers: the hung collect gave {fires} watchdog fires, health {state_w}, paths "
          f"{paths_w}")
    deadline = time.perf_counter() + 10
    while an_w._watchdog_abandoned and time.perf_counter() < deadline:
        time.sleep(0.01)
    abandoned = an_w._watchdog_abandoned
    an_w._collect_pairs = orig
    cycle(an_w, timer_w, nows[0], job_ids=ids_w, partial=True)
    # a requeued job keeps the watchdog's reason: the healthy compare by
    # status and anomaly, the terminal by their reasons too
    healed = {j: v for j, v in _settled(store_w).items() if j in ids_w}
    check(abandoned == 0 and an_w.health.state()[0] == "ok"
          and all(healed[j] == (sweep[j][0], sweep[j][2],
                                sweep[j][1] if sweep[j][0] in J.TERMINAL_STATUSES else "")
                  for j in ids_w),
          f"layers: after the hung collect: {abandoned} threads still abandoned, health "
          f"{an_w.health.state()[0]}")
    print(f"  watchdog: a collect held ~0.3 s by a spin kernel on the engine's stream under "
          f"WATCHDOG_S = {LAYERS_WATCHDOG_S}: {fires} fires (the bucket, then one retry; the "
          f"other retries skipped), {len(ids_w)} canaries requeued as watchdog-failover in "
          f"{wall_w:.3f} s, health DEGRADED; the abandoned threads returned after the spin; "
          f"the next cycle OK with the sweep's verdicts", flush=True)
    gc.callbacks.remove(gc_timer)
    tmp.cleanup()
    took = time.perf_counter() - t_phase
    print(f"  layers: {took:.1f} s (limit {LAYERS_BUDGET_S:.0f} s)", flush=True)
    check(took <= LAYERS_BUDGET_S, f"layers took {took:.1f} s > {LAYERS_BUDGET_S:.0f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    try:
        from foremast_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 2

    phase("build")
    t0 = time.perf_counter()
    build.library()
    print(f"  built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    from foremast_tpu_torch import native

    t0 = time.perf_counter()
    print(f"  the host's native parser (g++): available {native.available()}, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for line in build.build_log().splitlines():
        if "Compiling entry function" in line:
            print("  ptxas: " + line.split("'")[1], flush=True)
        elif "registers" in line or "spill" in line:
            print("  ptxas:" + line.split("ptxas info")[-1], flush=True)

    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}", flush=True)

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEV).manual_seed(SEED)

    phase("kernels")
    kernel_a_vs_twin(rng)
    kernel_b_vs_twin(gen)
    kernels_c_to_f_vs_twin(gen)
    kernel_g_vs_twin(gen)
    kernels_h_i_vs_twin(gen)
    kernel_j_vs_twin(gen)
    kernel_k_vs_twin(gen)
    kernels_l_m_vs_twin(gen)
    kernel_n_vs_twin(rng)
    kernel_o_vs_twin(rng)
    kernel_p_vs_twin(rng)
    scan_share = kernel_e_paths()
    past = past_the_limits()

    phase("pairs")
    a, pair_args, bad = pair_path(rng)
    phase("tests")
    n_o = tests_path(pair_args, bad)
    phase("fleet")
    p_row = fleet_path(pair_args)
    phase("bands")
    b, g_bands = band_path(gen)
    phase("seasonal")
    s, g_season = seasonal_path(gen)
    phase("families")
    fam = families_path(gen)
    phase("lstm")
    k = lstm_path(gen)
    lm = lstm_train_path(gen)
    limits = lstm_limits_path()
    k["limits"] = limits["score"]
    lm[1]["limits"] = limits["train"]
    phase("engine")
    g, engine_launches, fleet = engine_path(rng)
    lstm_launches = engine_lstm(rng)
    phase("layers")
    layers_path(fleet)
    del fleet
    phase()
    print(f"  triage_screen, 100,000 rows: {g_bands['ms']:.3f} ms at T = {BAND_T} (bound "
          f"{g_bands['bound_ms']:.3f} ms, twin {g_bands['plain_ms']:.1f} ms, torch.sort "
          f"{g_bands['sort_ms']:.3f} ms), {g_season['ms']:.3f} ms at T = {SEASON_T} (bound "
          f"{g_season['bound_ms']:.3f} ms, twin {g_season['plain_ms']:.1f} ms, torch.sort "
          f"{g_season['sort_ms']:.3f} ms)", flush=True)

    csrc = "foremast_tpu_torch/csrc/"
    rows = [
        {"name": "pair_verdict", "source": csrc + "pair_verdict.cu",
         "replaces": "foremast_tpu/parallel/fleet.py:65", **a},
        {"name": "ma_band", "source": csrc + "ma_band.cu",
         "replaces": "foremast_tpu/ops/forecast.py:110", **b},
        {"name": "smooth", "source": csrc + "smoothers.cu",
         "replaces": "foremast_tpu/ops/forecast.py:156", **s["smooth"]},
        # kernel C's Holt-Winters refit, a row of its own: launches on the
        # seasonal path's holt_winters call
        {"name": "smooth_hw", "source": csrc + "smoothers.cu",
         "replaces": "foremast_tpu/ops/forecast.py:186", **s["smooth_hw"]},
        {"name": "hw_fit", "source": csrc + "smoothers.cu",
         "replaces": "foremast_tpu/ops/forecast.py:358", **s["hw_fit"]},
        {"name": "affine_scan", "source": csrc + "seqscan.cu",
         "replaces": "foremast_tpu/ops/seqscan.py:61", **s["affine_scan"]},
        # kernel E's DES kind, a row of its own: its walk path on the
        # seasonal rows through des_predictions_assoc (the scan path's times
        # beside it; the scan's worst share of compare_scan's limit)
        {"name": "affine_scan_des", "source": csrc + "seqscan.cu",
         "replaces": "foremast_tpu/ops/seqscan.py:89", **s["affine_scan_des"],
         "limits": {"scan_limit_share": scan_share}},
        {"name": "detect_period", "source": csrc + "period.cu",
         "replaces": "foremast_tpu/ops/forecast.py:225", **s["detect_period"]},
        {"name": "band_from_preds", "source": csrc + "ma_band.cu",
         "replaces": "foremast_tpu/ops/forecast.py:478", **s["band_from_preds"]},
        {"name": "triage_screen", "source": csrc + "triage.cu",
         "replaces": "foremast_tpu/ops/triage.py:58", **g},
        {"name": "st_fit", "source": csrc + "seasonal_trend.cu",
         "replaces": "foremast_tpu/ops/forecast.py:400", **s["st_fit"]},
        {"name": "lstm_ae", "source": csrc + "lstm_ae.cu",
         "replaces": "foremast_tpu/models/lstm_ae.py:240", **k},
        {"source": csrc + "lstm_train.cu", "replaces": "foremast_tpu/models/lstm_ae.py:88",
         **lm[0]},
        {"source": csrc + "lstm_train.cu", "replaces": "foremast_tpu/models/lstm_ae.py:88",
         **lm[1]},
        {"source": csrc + "lstm_train.cu", "replaces": "foremast_tpu/models/lstm_ae.py:88",
         **lm[2]},
        {"source": csrc + "adam.cu", "replaces": "foremast_tpu/models/lstm_ae.py:144", **lm[3]},
        {"name": "pair_tests", "source": csrc + "pair_tests.cu",
         "replaces": "foremast_tpu/ops/pairwise.py:533", **n_o["pair_tests"]},
        {"name": "rank_and_ties", "source": csrc + "rank_groups.cu",
         "replaces": "foremast_tpu/ops/ranks.py:164", **n_o["rank_and_ties"]},
        {"name": "kruskal_groups", "source": csrc + "rank_groups.cu",
         "replaces": "foremast_tpu/ops/pairwise.py:527", **n_o["kruskal_groups"]},
        {"name": "friedman", "source": csrc + "rank_groups.cu",
         "replaces": "foremast_tpu/ops/pairwise.py:528", **n_o["friedman"]},
        {"name": "fleet_topk", "source": csrc + "fleet_topk.cu",
         "replaces": "foremast_tpu/parallel/fleet.py:209", **p_row},
    ]
    print(f"  engine_lstm arm's launches on the card: {lstm_launches}", flush=True)
    # kernels H and I: times at the engine's bucket (phase families, T =
    # 2048); launches on the main path, the engine's cycles
    for name, fam_key, src, ref in (("bivariate", "bivariate", "bivariate.cu",
                                     "foremast_tpu/ops/bivariate.py:26"),
                                    ("hpa_score", "hpa", "hpa.cu", "foremast_tpu/ops/hpa.py:74")):
        row = dict(fam[(fam_key, FAMILY_SHAPES[0][0])])
        row["launches"] = engine_launches[name]
        if name == "bivariate":
            # kernel H at 7 days of history beside its engine-bucket row:
            # its family call's time, bound, twin and launch
            long_t = fam[("bivariate", FAMILY_SHAPES[1][0])]
            row["t16384"] = {k: long_t[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                    "launches", "path")}
        rows.append({"name": name, "source": csrc + src, "replaces": ref, **row})
    for (fam_key, T), r in fam.items():
        print(f"  {fam_key} at T = {T}: kernel {r['ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
              f"({r['bound_by']}), plain twin {r['plain_ms']:.1f} ms"
              + (f"; kernel C's SES {r['smooth_ms']:.3f} ms, the HPA launch "
                 f"{r['launch_ms']:.3f} ms" if fam_key == "hpa" else ""), flush=True)
    # kernel B's ma_band at the engine's 7-day bucket (seasonal phase, the
    # long path) beside its band-pass row
    # kernels A, N, O and P past their first designs' limits (phase kernels)
    for r in rows:
        if r.get("name") in past:
            r["limits"] = past[r["name"]]
    b_row = next(r for r in rows if r.get("name") == "ma_band")
    b_row["t16384"] = {k: s["ma_band"][k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                     "launches", "path", "paths", "max_abs_err")}
    for r in rows:
        # no single PyTorch call computes any of these functions but M's
        # Adam and P's top-k (torch.sort, timed beside kernel G, computes only
        # its order statistics; the Cholesky solve beside kernel J only its
        # solve; torch.sort gives N and O an order, not tie-averaged ranks)
        r["route"] = "cuda"
        r.setdefault("library_ms", None)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    # kernel K's row also gives each path's run on the main path, and so do
    # kernels A, N, O and P's; kernel H's its time at T = 16384; kernel N's
    # the time of each of its four battery launches; kernel P's its first
    # design's time, its two launches' floor and a call's time from the host
    extra = ("paths", "path", "T", "t16384", "battery_ms", "chunked_ms", "launch_floor_ms",
             "host_ms", "limits", "d47", "c2048", "scan_ms", "scan_one_row_ms",
             "walk_one_row_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys + tuple(e for e in extra if e in r)}
                                  for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
