#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (foremast_tpu_torch) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA Hopper card,
nvcc and PyTorch built for CUDA. It imports nothing of JAX or of the JAX
package. Phases, each printed as it ends; any failure exits non-zero:

  1. build   compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
             and load the library;
  2. device  the card's name and power limit, from nvidia-smi;
  3. kernels each kernel against its plain PyTorch twin on the card, on
             adversarial rows (ties, +-0, NaN, +inf, masked and all-masked
             slots, both KS and both Wilcoxon regimes): kernel A at B = 2048,
             T in {16, 128, 1024, 4096}; kernel B at T in {128, 1024, 16384};
  4. pairs   the pair path at full size: 100,000 ErrorGenerator-style
             (baseline, canary) pairs at T = 128 through resample_to_grid ->
             pack_windows -> score_pairs on the card; every bad canary
             flagged, healthy false positives under 1%;
  5. bands   the band path at full size: 100,000 rows of 512 history + 128
             current slots (bucket 1024), 10% with a level shift;
             moving_average_band on the card; recall 1.0, false positives
             under 1%.

Each path resets the launch counters just before it runs and reads them just
after: a kernel of the path that did not launch fails the run. The
second-to-last line is a JSON object with each kernel's launches, error
against its twin, times on the card and bound; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import math
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
TIMED_RUNS = 20
CHECK_ROWS = 2048  # rows per kernel-vs-twin comparison


def phase(name):
    print(f"[{name}]", flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, runs):
    """Mean time of fn on the card over `runs` launches, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


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
    for T in (16, 128, 1024, 4096):
        args = adversarial_pairs(CHECK_ROWS, T, rng)
        t = fl.pair_args_from_numpy(args, DEV)
        kern = fl.score_pairs(*t, device=DEV)
        plain = fl.pair_verdict_plain(*t)
        torch.cuda.synchronize()
        err, bracketed = compare_pair_verdict(t, kern, plain)
        const = torch.arange(CHECK_ROWS, device=DEV) % 8 == 7
        check(bool((kern["band_count"][const] == 0).all()),
              "a current window identical to a constant baseline was flagged")
        worst = max(worst, err)
        n1, n2 = args[1].sum(1), args[3].sum(1)
        stephens = int(((n1 > KS_EXACT_MAX_T) | (n2 > KS_EXACT_MAX_T)).sum())
        print(f"  pair_verdict T={T}: max |dp| = {err:.3g} (tol {P_ATOL}), "
              f"{bracketed} of {CHECK_ROWS} rows bracketed, {stephens} in the Stephens regime",
              flush=True)
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
    for T, B in ((128, CHECK_ROWS), (1024, CHECK_ROWS), (16384, CHECK_ROWS // 2)):
        args = adversarial_bands(B, T, gen)
        kern = fc.moving_average_band(*args[:3], 30, *args[3:], device=DEV)
        plain = fc.moving_average_band_plain(*args[:3], 30, *args[3:])
        torch.cuda.synchronize()
        err, bracketed = compare_ma_band(args, 30, kern, plain)
        const = torch.arange(B, device=DEV) % 8 == 4
        check(bool((kern["sigma"][const] == 0).all()), "constant history must keep sigma 0")
        check(bool((kern["count"][const] == 0).all()), "an identical constant current was flagged")
        worst = max(worst, err)
        print(f"  ma_band T={T}: max |d preds| = {err:.3g}, {bracketed} of {B} rows bracketed",
              flush=True)
    return worst


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
    check(launches["pair_verdict"] >= 1, "the pair path did not launch pair_verdict")
    unhealthy = out["unhealthy"].cpu().numpy()
    check(out["pvalues"].shape == (PAIRS, 5) and bool(torch.isfinite(out["pvalues"]).all()),
          "pair path p-values not finite")
    recall = float(unhealthy[bad].mean())
    fp = float(unhealthy[~bad].mean())
    check(recall == 1.0, f"only {recall:.4f} of bad canaries flagged")
    check(fp < 0.01, f"healthy false-positive share {fp:.4f} >= 0.01")
    print(f"  verdicts: recall {recall:.4f} on {int(bad.sum())} bad canaries, healthy "
          f"false positives {fp:.5f} (limit 0.01); launches {launches}", flush=True)

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
    return {"launches": launches["pair_verdict"], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **pair_bound(args)}


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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    check(launches["ma_band"] >= 1, "the band path did not launch ma_band")
    frac = out["count"].float() / out["checked"].clamp(min=1).float()
    flagged = (frac > 0.3).cpu().numpy()
    sh = shifted.cpu().numpy()
    recall, fp = float(flagged[sh].mean()), float(flagged[~sh].mean())
    check(bool(torch.isfinite(out["sigma"]).all()), "band sigma not finite")
    check(recall == 1.0, f"band recall {recall:.4f} < 1")
    check(fp < 0.01, f"band false-positive share {fp:.4f} >= 0.01")
    print(f"  verdicts: recall {recall:.4f} on {int(sh.sum())} shifted rows, false positives "
          f"{fp:.5f} (limit 0.01); launches {launches}", flush=True)

    sub = tuple(a[:CHECK_ROWS] for a in args)
    err, bracketed = compare_ma_band(sub, 30, fc.moving_average_band(*sub[:3], 30, *sub[3:],
                                                                      device=DEV),
                                     fc.moving_average_band_plain(*sub[:3], 30, *sub[3:]))
    print(f"  kernel vs twin on {CHECK_ROWS} of these rows: max |d preds| = {err:.3g}, "
          f"{bracketed} rows bracketed", flush=True)

    def run():
        return fc.moving_average_band(x, mask, region, 30, thr, mode, mlb, device=DEV)

    e2e = wall_ms(run, TIMED_RUNS)
    ms = cuda_ms(run, TIMED_RUNS)
    plain_ms = cuda_ms(lambda: fc.moving_average_band_plain(x, mask, region, 30, thr, mode, mlb), 3)
    print(f"  moving_average_band, {TIMED_RUNS} runs: median {np.median(e2e):.3f} ms, "
          f"p99 {np.percentile(e2e, 99):.3f} ms, {B / np.median(e2e) * 1e3:.0f} rows/s; "
          f"kernel {ms:.3f} ms; plain twin {plain_ms:.1f} ms", flush=True)
    nbytes = B * T * (4 + 1 + 1) + B * 12 + B * T * (4 * 3 + 1) + B * 16
    ops = 20 * B * T
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return {"launches": launches["ma_band"], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line:
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

    phase("pairs")
    a = pair_path(rng)
    phase("bands")
    b = band_path(gen)

    rows = [
        {"name": "pair_verdict", "route": "cuda",
         "source": "foremast_tpu_torch/csrc/pair_verdict.cu",
         "replaces": "foremast_tpu/parallel/fleet.py:65", **a, "library_ms": None},
        {"name": "ma_band", "route": "cuda", "source": "foremast_tpu_torch/csrc/ma_band.cu",
         "replaces": "foremast_tpu/ops/forecast.py:110", **b, "library_ms": None},
    ]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
