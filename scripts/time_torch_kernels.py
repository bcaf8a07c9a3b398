#!/usr/bin/env python3
"""Time and profile the port's kernels on chip_smoke.py's main-path inputs.

    python3 <checkout>/scripts/time_torch_kernels.py [--profile] [--out DIR]

Runs on one CUDA card. The package is the one in the current directory;
the inputs and the timing routine are those of the chip_smoke.py beside
this script: kernel A (`score_pairs`) on the 100,000-pair pass at T = 128,
kernel B (`moving_average_band`) on the 100,000-row band pass at bucket
1024, each the mean of 20 launches by CUDA events after one warm-up. To
compare two versions, start this one script from each checkout in turn
within one call (parent, change, change, parent): the inputs stay, the
package changes.

--profile splits the time as well:
  - kernel A by phase, from its clock stamps: each phase's share of the
    CTAs' cycles and mean cycles per pair, and kernel A's time with the
    stamps on;
  - one torch.profiler trace of three `score_pairs` calls from numpy: the
    device time of the host-to-device copies against the kernel's, and the
    host wall time of each call. The Chrome trace goes to DIR.

--seasonal splits the seasonal path instead (chip_smoke.py's 100,000 rows
of bucket 16384): one torch.profiler trace of `forecast_band` per
algorithm, with the device time of each kernel and of PyTorch's own
operations, and the card's idle share (1 - device busy time / host wall
time of the call).

--families times the bivariate and hpa families on chip_smoke.py's
100,000-row inputs at each of its buckets (2048 and 16384): kernel H and
kernel I alone (median of 20 by CUDA events), and one torch.profiler trace
of the engine's HPA launch (kernel C's SES on the history, then kernel I's
hpa_from_preds): the device time of each kernel and of anything else on the
card between them, and the card's idle share over the launch.

--lstm-train times one training epoch's kernels on chip_smoke.py's training
pass (1,024 jobs x a day of 45 windows of 32 steps x 4 metrics, H = 32,
Z = 16, from the reference's initial rows): kernel L's forward, its
backward's recurrence and weight-gradient entries and kernel M alone, with
torch.optim.Adam(fused=True) on the same rows and cuDNN's LSTM over the same
recurrences beside them, by CUDA events: L's entries the median of 5 (the
recurrence, which consumes its input, a mean of 5 on fresh copies), M and
the fused Adam the mean of chip_smoke.TIMED_RUNS launches back to back, as
chip_smoke.py times them.

--lstm-backward times kernel L's backward alone (`lstm_train_backward`,
both its entries where the checkout has two) at the widths above the
engine's, F = 4: H = 128, Z = 64 on the training pass's 1,024 jobs x 45
windows and H = 256, Z = 64 on its first 256 jobs, from seeded rows at
flax's initial scales (chip_smoke.lstm_params); each the mean of 5 launches
by CUDA events, on a fresh copy of the forward's activations each (the
backward may consume them). It calls only entry points that every checkout
since kernel L's first has, so parent and change run the same code.

--engine-lstm-epochs runs chip_smoke.py's engine_lstm arm on one fixed
fleet (engine_lstm_fleet from numpy's default_rng(SEED)) on the card and on
the CPU twins, and records each train_fleet call the engine makes: its
jobs, the epochs it ran (the plateau's stop) and each epoch's fleet-mean
loss; with the kernel launches per cycle and the verdicts. Run from two
checkouts, it shows whether training stops at the same epochs on both.

--fleet times kernel P (`kernels.fleet_topk`, k = chip_smoke.FLEET_K) on
the fleet that `score_pairs` scores from the 100,000-pair pass, and beside
it `torch.topk` over the masked severities, each the mean of 20 launches by
CUDA events.

--triage-hw times kernel G (`kernels.triage_screen`) at the engine's shape
(4096 x 2048: chip_smoke.engine_band_inputs on engine_fleet from numpy's
default_rng(SEED)) and on the seasonal phase's 100,000 rows of bucket
16384 (chip_smoke.season_inputs), and kernel D (`kernels.hw_fit`) on those
rows with the periods kernel F elects and the seasonal path's fit mask
(t >= 2 period): each the median of 20 launches back to back by CUDA
events (`median_back_to_back_ms`). It prints a digest of
every output of G (at both shapes) and of D and writes G's outputs to
DIR/triage_hw_<checkout>.pt; `--compare A.pt B.pt` (no card needed) holds two
such files against each other, key by key. It calls only entry points that
every checkout since kernel G's first has, so run it from the parent's
checkout and this one in one call (parent, change, change, parent).
With --profile it also splits both kernels by phase from their optional
per-row cycle counts (`phase_clocks=`, phases kernels.TRIAGE_PHASES and
kernels.HW_FIT_PHASES; this checkout only) and times D under smaller
device-scratch budgets (fewer warps in flight, rings nearer to L2).

--lstm-st times kernel L's forward (`kernels.lstm_train_forward`) on
--lstm-train's inputs (1,024 jobs x 45 windows of 32 steps x 4 metrics from
the reference's initial rows at H = 32, Z = 16; seeded rows at H = 128,
Z = 64 on the 1,024 jobs and at H = 256, Z = 64 on the first 256), and
kernel J (`kernels.st_fit`) on the seasonal phase's 100,000 rows of bucket
16384 (chip_smoke.season_inputs) with the periods kernel F elects and at
the engine's seasonal_trend shape (4096 x 2048: chip_smoke.engine_band_inputs,
fallback period min(1440, T // 2)), the history as the fit: each the median
of 20 launches back to back (`median_back_to_back_ms`), beside each
kernel's bound (and L's arithmetic floor: its multiply-adds as two fp32
instructions each). It prints a SHA-256 of L's act, num and cnt at each
width and of J's beta and preds, and writes J's beta (every row) and preds
(the first 128 rows) to DIR/lstm_st_<checkout>.pt for `--compare`. It calls
only entry points every checkout since kernel L's first has: run it from
the parent's checkout and this one in one call (parent, change, change,
parent). With --profile it also splits both kernels by phase from their
optional cycle counts (`phase_clocks=`, phases kernels.LSTM_FORWARD_PHASES,
summed over a job's CTAs, and kernels.ST_FIT_PHASES per row; checkouts that
have them).

--lstm-ae times kernel K (`kernels.lstm_ae`) at the three shapes it runs
on chip_smoke.py's own inputs: the scoring pass (100,000 jobs x 2 windows of
the reference-trained fixture's rows, H = 32, Z = 16, with mu and sigma:
chip_smoke.lstm_scoring_inputs), the normalizer pass (10,000 jobs x a day
of 45 windows, errors only: chip_smoke.lstm_normalizer_inputs) and the
module's default width (10,000 jobs x 2 windows at H = 128, Z = 64 on
seeded rows: chip_smoke.adversarial_lstm), each the median of 20 launches
back to back, beside its bound and its arithmetic floor (its multiply-adds
as two fp32 instructions each, -fmad=false). It prints which path ran
(`kernels.lstm_ae_path`, in checkouts that have one) and a SHA-256 of err
(and z) at each shape; with --lstm-ae-paths also each path that serves a
shape, forced by `kernels.LSTM_AE_FORCE` (checkouts that have one). It calls
only entry points that every checkout since kernel K's first has: run it
from the parent's checkout and this one in one call (parent, change,
change, parent). With --profile it also splits K by phase from its
optional cycle counts (`phase_clocks=`, phases kernels.LSTM_AE_PHASES,
summed over a job's CTAs or warps; checkouts that have them).

--period-hpa times kernel F (`kernels.detect_period`) on the seasonal
phase's 100,000 rows of bucket 16384 (chip_smoke.season_inputs: 10,080
history slots, the history as the mask) with the engine's four candidates
and with chip_smoke.MANY_CANDIDATES (40), and kernel I (`kernels.hpa_score`,
both entries: hpa_from_preds, then hpa_scores with the sigma it returned) on
the hpa family's 100,000 rows at each bucket (chip_smoke.hpa_family_inputs,
2048 and 16384, tps_pred from kernel C's SES as the engine's launch makes
it): each the median of 20 launches back to back, beside its bound. It
prints a SHA-256 of every output and writes them all (F's forty-candidate
scores excepted) to DIR/period_hpa_<checkout>.pt for `--compare`. It calls
only entry points every checkout since kernels F and I's first has: run it
from the parent's checkout and this one in one call (parent, change,
change, parent). With --profile each shape is timed unstamped, then with
the optional per-row cycle counts (`phase_clocks=`, phases
kernels.PERIOD_PHASES and kernels.HPA_PHASES; checkouts that have them),
then unstamped again, and the phase split is printed.

--bivariate-hw times kernel H (`kernels.bivariate`) on the families
phase's 100,000 rows at each bucket (chip_smoke.bivariate_family_inputs,
2048 and 16384) and kernel C (`kernels.smooth`) on the seasonal phase's
100,000 rows of bucket 16384: the Holt-Winters refit with each row's
fitted parameters and period (forecast_band under holt_winters gives them,
as chip_smoke.py's seasonal phase does), then SES (alpha 0.3) and DES
(0.5, 0.1) on the history: each the median of 20 launches back to back,
beside its bound. It prints a SHA-256 of every output and writes H's and
C's outputs to DIR/bivariate_hw_<checkout>.pt for `--compare` (the (B,)
outputs whole, each (B, T) output as a hash a row and its first 8 rows).
In checkouts with kernel H's two paths (`kernels.BIVARIATE_PATHS`) it also
times each path forced. It calls only
entry points every checkout since kernels H and C's first has: run it from
the parent's checkout and this one in one call (parent, change, change,
parent). `--only bivariate` or `--only smooth` times one of the two. With
--profile each shape is timed unstamped, then with the optional cycle
counts (`phase_clocks=`, phases kernels.BI_PHASES a row
and kernels.SMOOTH_HW_PHASES a group of 32 rows; checkouts that have
them), then unstamped again, and the split is printed.

--a-digest prints a SHA-256 of every output of kernel A (`score_pairs` on
the card) and of kernel N (`kernels.pair_tests`, stat and p, at each mask of
the battery: 15, 1, 4, 8) on chip_smoke.py's adversarial rows at each T of
DIGEST_T (16 to 16384) and on the 100,000-pair pass: run from two checkouts
in one call, equal digests show that the outputs did not change, bit for
bit.

--pairs times kernels A and N on the 100,000-pair pass at T = 128 (A on
score_pairs' tensors; N as the four-test launch of all_pairwise_tests and as
each single-test launch of the battery's *_batch calls), then both at
T = 1024, 4096 (the CTA path) and 16384 (device scratch) on chip_smoke.py's
adversarial rows: each the median of 20 launches back to back, with a
SHA-256 of the outputs, and make_fleet_scorer's wall time and
canary_pairs_scored_per_sec_per_chip on the same pairs in a world of one
over NCCL. In checkouts whose launchers take `path=`, each path that serves
T = 128 is also forced, and the launches by path are printed.
With --profile it also splits A (kernels.PAIR_PHASES) and N (mask 15,
kernels.TESTS_PHASES, checkouts that have them) by their clock stamps. It
calls only entry points every checkout since kernel N's first has: run it
from the parent's checkout and this one in one call (parent, change,
change, parent).
"""
import hashlib
import argparse
import math
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.getcwd())


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def stamp_split(kernel, run, B, names, off_ms=None):
    """A kernel's phases from its clock stamps: run(phase_clocks=clocks)
    fills clocks (B, len(names) + 1) with each row's SM clock at its start
    and after each phase. Prints each phase's share of the rows' cycles,
    the mean cycles a row and the rows resident an SM on average."""
    clocks = torch.zeros((B, len(names) + 1), dtype=torch.int64, device=cs.DEV)
    on_ms = cs.cuda_ms(lambda: run(phase_clocks=clocks), cs.TIMED_RUNS)
    cyc = clocks.diff(dim=1).double()
    check_ok = bool((cyc >= 0).all())
    total = cyc.sum(0)
    share = (total / total.sum()).tolist()
    mean = cyc.mean(0).tolist()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    # row-cycles over SM-cycles of the kernel: how many rows an SM held at once
    resident = float(total.sum()) / (on_ms * 1e-3 * mhz * 1e6 * sms)
    print(f"  {kernel} phases (B = {B}), stamps monotone: {check_ok}; {on_ms:.3f} ms with "
          f"stamps" + ("" if off_ms is None else f", {off_ms:.3f} ms without"), flush=True)
    for name, sh, m in zip(names, share, mean):
        print(f"    {name:15s} {100 * sh:6.2f}% of the rows' cycles, {m:10.1f} cycles a row",
              flush=True)
    print(f"    mean {sum(mean):.1f} cycles a row; {resident:.2f} rows resident an SM on "
          f"average (at the {mhz:.0f} MHz max SM clock, {sms} SMs)", flush=True)
    return {"ms_stamps_on": on_ms, "ms_stamps_off": off_ms,
            "share": dict(zip(names, share)), "cycles_per_row": dict(zip(names, mean)),
            "resident_per_sm": resident, "monotone": check_ok}


def phase_split(t):
    """Kernel A's phases on device tensors t, from its clock stamps."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    def run(**kw):
        return kernels.pair_verdict(
            *t, wilcoxon_table=fl.wilcoxon_pmf_table(t[0].device),
            ks_exact_max=fl.KS_EXACT_MAX_T, wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N, **kw)

    off_ms = cs.cuda_ms(lambda: fl.score_pairs(*t, device=cs.DEV), cs.TIMED_RUNS)
    return stamp_split("kernel A", run, t[0].shape[0], kernels.PAIR_PHASES, off_ms)


def _device_us(e):
    for name in ("device_time_total", "cuda_time_total"):
        v = getattr(e, name, None)
        if v is not None:
            return float(v)
    return 0.0


def trace_pass(args, out_dir):
    """torch.profiler over three score_pairs calls from numpy."""
    from torch.profiler import ProfilerActivity, profile

    from foremast_tpu_torch.parallel import fleet as fl

    fl.score_pairs(*args, device=cs.DEV)
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            t0 = time.perf_counter()
            fl.score_pairs(*args, device=cs.DEV)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
    rows = sorted(((e.key, _device_us(e) / 3e3, e.count / 3) for e in prof.key_averages()),
                  key=lambda r: -r[1])
    device = [r for r in rows if r[1] > 0]
    copy_ms = sum(r[1] for r in device if "memcpy" in r[0].lower() and "htod" in r[0].lower())
    kern_ms = sum(r[1] for r in device if "pair_verdict" in r[0])
    print(f"  torch.profiler, 3 calls of score_pairs from numpy: wall {walls} ms", flush=True)
    print(f"    per call on the device: host-to-device copies {copy_ms:.3f} ms, "
          f"pair_verdict kernel {kern_ms:.3f} ms", flush=True)
    for key, ms, n in device[:8]:
        print(f"    {ms:9.3f} ms  x{n:g}  {key[:90]}", flush=True)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "score_pairs_trace.json")
    prof.export_chrome_trace(path)
    print(f"    Chrome trace: {path}", flush=True)
    return {"wall_ms": walls, "htod_ms": copy_ms, "kernel_ms": kern_ms,
            "device_rows": [{"name": k, "ms": m, "calls": n} for k, m, n in device[:8]]}


def seasonal_split():
    """torch.profiler over one forecast_band call per algorithm on the
    seasonal path's inputs: device time by kernel, idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from foremast_tpu_torch.ops import forecast as fc

    args, _, _ = cs.season_inputs(torch.Generator(device=cs.DEV).manual_seed(cs.SEED))
    out = {}
    for algo in cs.SEASON_ALGOS:
        fc.forecast_band(*args, algorithm=algo, device=cs.DEV)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fc.forecast_band(*args, algorithm=algo, device=cs.DEV)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        # the events that ran on the card (kernels, copies, fills); the host
        # operators that launched them carry the same time and are left out
        device = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
                         if getattr(e, "device_type", None) == DeviceType.CUDA),
                        key=lambda r: -r[1])
        busy = sum(ms for _, ms, _ in device)
        print(f"  {algo}: host wall {wall:.3f} ms, device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.4f}", flush=True)
        for key, ms, n in device[:8]:
            print(f"    {ms:9.3f} ms  x{n}  {key[:90]}", flush=True)
        out[algo] = {"wall_ms": wall, "busy_ms": busy,
                     "device_rows": [{"name": k, "ms": m, "calls": n} for k, m, n in device[:8]]}
    return out


def families_split():
    """Kernels H and I alone, and the HPA launch under torch.profiler, on
    chip_smoke's family inputs at each bucket."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.ops import hpa as hp

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    out = {}
    for T, n_h in cs.FAMILY_SHAPES:
        args, _ = cs.bivariate_family_inputs(gen, T, n_h)
        h_ms = cs.median_ms(lambda: kernels.bivariate(*args), cs.TIMED_RUNS)
        del args
        torch.cuda.empty_cache()
        a, _ = cs.hpa_family_inputs(gen, T, n_h)
        rest = [a[k] for k in ("sla", "sla_mask", "sla_static_limit", "sla_mode", "threshold",
                               "safe", "pods_now", "pods_hist", "sla_absolute")]

        def launch():
            preds = fc.ses_predictions(a["tps"], a["hist"], a["alpha"], device=cs.DEV)
            return hp.hpa_from_preds(a["tps"], a["tps_mask"], a["region"], preds, *rest,
                                     device=cs.DEV)

        launch()  # warm
        tp = fc.ses_predictions(a["tps"], a["hist"], a["alpha"], device=cs.DEV)
        i_ms = cs.median_ms(lambda: kernels.hpa_score(
            a["tps"], a["tps_mask"], a["region"], tp, *rest[:5], safe=rest[5],
            pods_now=rest[6], pods_hist=rest[7], sla_absolute=rest[8]), cs.TIMED_RUNS)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            launch()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        device = sorted(((e.key, _device_us(e) / 1e3, e.count) for e in prof.key_averages()
                         if getattr(e, "device_type", None) == DeviceType.CUDA),
                        key=lambda r: -r[1])
        busy = sum(ms for _, ms, _ in device)
        print(f"  T = {T}: kernel H {h_ms:.3f} ms, kernel I {i_ms:.3f} ms (medians of "
              f"{cs.TIMED_RUNS}); the HPA launch under torch.profiler: host wall {wall:.3f} ms, "
              f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.4f}", flush=True)
        for key, ms, n in device[:8]:
            print(f"    {ms:9.3f} ms  x{n}  {key[:90]}", flush=True)
        out[T] = {"bivariate_ms": h_ms, "hpa_score_ms": i_ms, "launch_wall_ms": wall,
                  "launch_busy_ms": busy,
                  "device_rows": [{"name": k, "ms": m, "calls": n} for k, m, n in device[:8]]}
        del a, rest, tp
        torch.cuda.empty_cache()
    return out


def lstm_train_split():
    """One training epoch's kernels alone on chip_smoke's training-pass
    inputs: L's forward, its backward's recurrence entry (on a fresh copy
    of the activations each run: it overwrites them) and weight-gradient
    entry, M, torch.optim.Adam(fused=True).step() on the same rows, and
    cuDNN's LSTM over the same recurrences (chip_smoke.cudnn_lstm_ms)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    x, m = cs.lstm_day_windows(cs.LSTM_TRAIN_JOBS, gen)
    H, Z = 32, 16
    params, step, mu, nu = (t.to(cs.DEV) for t in tl.init_state(4, H, Z, x.shape[0]))
    step += 1
    num, cnt, act0 = kernels.lstm_train_forward(params, x, m, H, Z)
    fwd = cs.median_ms(lambda: kernels.lstm_train_forward(params, x, m, H, Z), 5)
    act = torch.empty_like(act0)
    rec_ms = cs.cuda_ms_fresh(lambda: kernels.lstm_train_recurrence(params, x, m, act, H, Z),
                              lambda: act.copy_(act0), 5)
    act.copy_(act0)
    rec = kernels.lstm_train_recurrence(params, x, m, act, H, Z)
    wg_ms = cs.median_ms(lambda: kernels.lstm_train_wgrad(params, x, m, act, rec, H, Z), 5)
    gpart = kernels.lstm_train_wgrad(params, x, m, act, rec, H, Z)
    del act, act0, rec
    adam = cs.cuda_ms(lambda: kernels.adam(params, mu, nu, step, gpart, num, cnt,
                                           tl.LEARNING_RATE, tl.ADAM_B1, tl.ADAM_B2,
                                           tl.ADAM_EPS), cs.TIMED_RUNS)
    lib_p = torch.nn.Parameter(params.clone())
    lib_p.grad = tl.reduce_partials_plain(gpart, cnt)
    opt = torch.optim.Adam([lib_p], lr=tl.LEARNING_RATE, betas=(tl.ADAM_B1, tl.ADAM_B2),
                           eps=tl.ADAM_EPS, fused=True)
    fused = cs.cuda_ms(opt.step, cs.TIMED_RUNS)
    del lib_p, opt, gpart
    torch.cuda.empty_cache()
    cudnn = cs.cudnn_lstm_ms(x.shape[0] * x.shape[1], x.shape[2], x.shape[3], H, Z, gen)
    print(f"  lstm_train_forward {fwd:.3f} ms, backward {rec_ms + wg_ms:.3f} ms (recurrence "
          f"{rec_ms:.3f} ms, weight gradients {wg_ms:.3f} ms), adam {adam:.3f} ms, "
          f"torch.optim.Adam(fused=True).step() {fused:.3f} ms, cuDNN LSTM forward and "
          f"backward {cudnn:.3f} ms (L: medians of 5, the recurrence a mean of 5; M and the "
          f"fused Adam: means of {cs.TIMED_RUNS} back to back)", flush=True)
    return {"lstm_train_forward_ms": fwd, "lstm_train_recurrence_ms": rec_ms,
            "lstm_train_wgrad_ms": wg_ms, "lstm_train_backward_ms": rec_ms + wg_ms,
            "adam_ms": adam, "fused_adam_ms": fused, "cudnn_lstm_ms": cudnn}


LSTM_BACKWARD_WIDTHS = ((128, 64, 1_024), (256, 64, 256))  # (H, Z, jobs), F = 4


def lstm_backward_widths():
    from foremast_tpu_torch import kernels

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    x, m = cs.lstm_day_windows(cs.LSTM_TRAIN_JOBS, gen)
    out = {}
    for H, Z, J in LSTM_BACKWARD_WIDTHS:
        xj, mj = x[:J].contiguous(), m[:J].contiguous()
        p = cs.lstm_params(J, 4, H, Z, gen)
        act0 = kernels.lstm_train_forward(p, xj, mj, H, Z)[2]
        act = torch.empty_like(act0)
        t = cs.cuda_ms_fresh(lambda: kernels.lstm_train_backward(p, xj, mj, act, H, Z),
                             lambda: act.copy_(act0), 5)
        out[f"H={H} Z={Z} jobs={J}"] = t
        print(f"  lstm_train_backward at F=4 H={H} Z={Z}, {J} jobs x {x.shape[1]} windows: "
              f"{t:.3f} ms", flush=True)
        del p, act, act0
        torch.cuda.empty_cache()
    return out


def engine_lstm_epochs():
    from foremast_tpu_torch.engine import jobs as J
    from foremast_tpu_torch.models import lstm_ae as tl

    fleet = cs.engine_lstm_fleet(np.random.default_rng(cs.SEED))
    train_fleet = tl.train_fleet
    out = {}
    for dev in (cs.DEV, "cpu"):
        calls = []

        def recorded(x, mask, **kw):
            hist = []
            res = train_fleet(x, mask, **kw, history=hist)
            calls.append({"jobs": int(len(x)), "epochs": len(hist),
                          "losses": [float(h) for h in hist]})
            return res

        tl.train_fleet = recorded
        try:
            store, cycles, zs, _judged = cs.engine_lstm_arm(fleet, dev)
        finally:
            tl.train_fleet = train_fleet
        unhealthy = " ".join(sorted(d.id for d in store.by_status(J.COMPLETED_UNHEALTH)))
        out[dev] = {"calls": calls, "launches": [c["launches"] for c in cycles],
                    "unhealthy": len(unhealthy.split()),
                    "unhealthy_digest": hashlib.sha256(unhealthy.encode()).hexdigest()[:16],
                    "z": {j: zs[j] for j in sorted(zs)}}
        print(f"  engine_lstm on {dev}: train_fleet calls (jobs, epochs) "
              f"{[(c['jobs'], c['epochs']) for c in calls]}; {out[dev]['unhealthy']} jobs "
              f"unhealthy ({out[dev]['unhealthy_digest']})", flush=True)
    card, cpu = out[cs.DEV], out["cpu"]
    d_loss = max((abs(a - b) / abs(b) for c, t in zip(card["calls"], cpu["calls"])
                  for a, b in zip(c["losses"], t["losses"])), default=0.0)
    out["card_vs_cpu"] = {
        "same_epochs": [c["epochs"] for c in card["calls"]] == [c["epochs"] for c in cpu["calls"]],
        "max_rel_d_loss": d_loss,
        "max_d_z": max(abs(card["z"][j] - cpu["z"][j]) for j in card["z"])}
    print(f"  card against the CPU twins: {out['card_vs_cpu']}", flush=True)
    return out


def fleet_split():
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    args, _ = cs.pair_path_inputs(np.random.default_rng(cs.SEED))
    out = fl.score_pairs(*fl.pair_args_from_numpy(args, cs.DEV), device=cs.DEV)
    u, s = out["unhealthy"], out["severity"]
    return {"fleet_topk_ms": cs.cuda_ms(lambda: kernels.fleet_topk(s, cs.FLEET_K, u),
                                        cs.TIMED_RUNS),
            "torch_topk_ms": cs.cuda_ms(lambda: torch.topk(torch.where(u, s, -torch.inf),
                                                           cs.FLEET_K), cs.TIMED_RUNS)}


PAIR_TEST_MASKS = (15, 1, 4, 8)  # all_pairwise_tests, mann_whitney_u_batch, wilcoxon_batch, ks_2samp_batch
DIGEST_T = (16, 128, 256, 1024, 4096, 8192, 16384)


def _out_digest(out):
    """SHA-256 of a dict of outputs (kernel A's) or a tuple (kernel N's)."""
    h = hashlib.sha256()
    items = sorted(out.items()) if isinstance(out, dict) else enumerate(out)
    for k, v in items:
        h.update(str(k).encode() + v.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _n_kw():
    from foremast_tpu_torch.ops import pairwise as pw

    return dict(wilcoxon_table=pw.wilcoxon_pmf_table(cs.DEV), ks_exact_max=pw.KS_EXACT_MAX_T,
                wilcoxon_exact_max_n=pw.WILCOXON_EXACT_MAX_N)


def _rows(T):
    return cs.CHECK_ROWS if T <= 4096 else 512


def a_digest():
    """SHA-256 of kernel A's outputs (score_pairs) and of kernel N's (stat
    and p for each of PAIR_TEST_MASKS) on chip_smoke.py's adversarial rows at
    each T of DIGEST_T and on the 100,000-pair pass."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    res = {}
    for T in DIGEST_T:
        a = cs.adversarial_pairs(_rows(T), T, np.random.default_rng(cs.SEED + T))
        res[f"A T={T}"] = _out_digest(fl.score_pairs(*a, device=cs.DEV))
        n = [torch.from_numpy(v).to(cs.DEV)
             for v in cs.adversarial_tests(_rows(T), T, np.random.default_rng(cs.SEED - T))]
        for mask in PAIR_TEST_MASKS:
            res[f"N T={T} mask {mask}"] = _out_digest(kernels.pair_tests(*n, mask, **_n_kw()))
    args = cs.pair_path_inputs(np.random.default_rng(cs.SEED))[0]
    res["A pass"] = _out_digest(fl.score_pairs(*args, device=cs.DEV))
    pairs = fl.pair_args_from_numpy(args, cs.DEV)[:4]
    for mask in PAIR_TEST_MASKS:
        res[f"N pass mask {mask}"] = _out_digest(kernels.pair_tests(*pairs, mask, **_n_kw()))
    return res


def _takes_path(fn):
    import inspect

    return "path" in inspect.signature(fn).parameters


PAIRS_LONG = ((1024, 20_000), (4096, 5_000), (16384, 512))  # (T, B): the cta and scratch paths


def fleet_scorer_rate(t):
    """make_fleet_scorer on the pass's pairs (score_pairs' tensors t) in a
    world of one over NCCL, as chip_smoke.py's fleet phase runs it: the
    median wall time of TIMED_RUNS calls and canary_pairs_scored_per_sec_per_chip."""
    import torch.distributed as dist

    from foremast_tpu_torch.parallel import fleet as fl
    from foremast_tpu_torch.parallel import mesh as pm

    started = pm.world_of_one(cs.DEV)
    try:
        run = fl.make_fleet_scorer(pm.fleet_mesh(device=cs.DEV), k=cs.FLEET_K)
        cfg = dict(zip(cs.CFG_KEYS, t[4:]))
        med = float(np.median(cs.wall_ms(lambda: run(*t[:4], cfg), cs.TIMED_RUNS)))
    finally:
        if started:
            dist.destroy_process_group()
    B = t[0].shape[0]
    print(f"  make_fleet_scorer, {B} pairs, a world of one: median {med:.3f} ms, "
          f"canary_pairs_scored_per_sec_per_chip {B / med * 1e3:.0f}", flush=True)
    return {"ms": med, "pairs_per_s": B / med * 1e3}


def ks_window_work(n1, n2, t, ks_exact_max):
    """The warp path's exact KS work on pairs of n1, n2 valid points and
    integer statistic t (int64 numpy arrays), by warp_ks_exact_sf's own
    window rule: each pair's lattice steps, of them the one-register steps,
    and the wider steps' registers with the window kept and moved up."""
    n1, n2, t = (np.asarray(v, dtype=np.int64) for v in (n1, n2, t))
    N = n1 + n2
    alive = (n1 > 0) & (n2 > 0) & (n1 <= ks_exact_max) & (n2 <= ks_exact_max) & (t > 0)
    tm1 = np.maximum(t - 1, 0)
    Nd = np.maximum(N, 1)
    a_lo, a_hi = -tm1, tm1.copy()
    blo, bhi = -(tm1 // Nd), tm1 // Nd
    lo, hi = np.zeros_like(N), np.zeros_like(N)
    steps, one, kept, moved = (np.zeros_like(N) for _ in range(4))
    for d in range(1, int(N.max(initial=0)) + 1):
        act = alive & (d <= N)
        if not act.any():
            break
        a_lo += n1
        a_hi += n1
        blo += blo * Nd < a_lo
        bhi += (bhi + 1) * Nd <= a_hi
        nlo = np.maximum(np.maximum(0, d - n2), blo)
        nhi = np.minimum(np.minimum(d, n1), bhi)
        steps += act
        empty = nlo > nhi
        alive &= ~(act & empty)
        act &= ~empty
        span = np.maximum(hi - lo, nhi - nlo)
        regs = np.where(span < 32, 0, span // 32 + 1)
        one += act & (span < 32)
        kept += np.where(act & (nlo == lo), regs, 0)
        moved += np.where(act & (nlo != lo), regs, 0)
        lo, hi = np.where(act, nlo, lo), np.where(act, nhi, hi)
    return steps, one, kept, moved


def ks_floor(t):
    """The warp path's own floor for its KS lattice on the pass's pairs:
    the SASS instructions of each lattice step and of each register of
    cells it computes (scripts/sass_lines.py: the IEEE division included)
    over the steps and registers these pairs need (ks_window_work), at the
    issue rate (4 warp instructions a clock an SM at the max SM clock)."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import sass_lines
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import pairwise as pw

    T = t[0].shape[1]
    stat, _ = kernels.pair_tests(*t[:4], 8, **_n_kw())
    n1 = t[1].sum(1).cpu().numpy()
    n2 = t[3].sum(1).cpu().numpy()
    ks_t = np.rint(stat[:, 3].double().cpu().numpy() * n1 * n2).astype(np.int64)
    steps, one, kept, moved = ks_window_work(n1, n2, ks_t, pw.KS_EXACT_MAX_T)
    M = max(1, (1 << (2 * T - 1).bit_length()) // 32)
    src = os.path.join(os.getcwd(), "foremast_tpu_torch", "csrc", "pair_verdict.cu")
    ins = sass_lines.ks_step_instructions(src, f"pair_verdict_warp_kernelILi{M}E", M // 2 + 1)
    total = (steps.sum() * ins["step"] + one.sum() * ins["one_register"]
             + kept.sum() * ins["kept_register"] + moved.sum() * ins["moved_register"])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    ms = float(total) / (4 * sms * mhz * 1e6) * 1e3
    res = {"sass": ins, "steps": int(steps.sum()), "one_register_steps": int(one.sum()),
           "kept_registers": int(kept.sum()), "moved_registers": int(moved.sum()),
           "warp_instructions": float(total), "floor_ms": ms,
           "pairs_exact": int((steps > 0).sum())}
    print(f"  the KS lattice's own floor on the warp path: {ins} SASS instructions (a step; "
          f"the one-register step's cells; a register of a wider step, window kept / moved; "
          f"of them a cell's own); {res['steps']} steps, {res['one_register_steps']} of one "
          f"register, {res['kept_registers']} + {res['moved_registers']} registers of wider "
          f"ones over {res['pairs_exact']} exact pairs: {total:.4g} warp instructions, "
          f"{ms:.4f} ms at 4 a clock an SM ({sms} SMs, {mhz:.0f} MHz)", flush=True)
    return res


def pairs_ab(profile):
    """Kernels A and N at 100,000 x 128 on the pair pass's windows (A on
    score_pairs' 12 tensors, N on its four for each mask of PAIR_TEST_MASKS),
    then both at PAIRS_LONG on chip_smoke.py's adversarial rows: each the
    median of TIMED_RUNS launches back to back and a SHA-256 of the outputs.
    In checkouts whose launchers take a path, also each path forced at
    T = 128. With --profile, the split of A and N by their clock stamps
    (N's where the checkout has them)."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    args = cs.pair_path_inputs(np.random.default_rng(cs.SEED))[0]
    t = fl.pair_args_from_numpy(args, cs.DEV)
    a_kw = dict(wilcoxon_table=fl.wilcoxon_pmf_table(cs.DEV), ks_exact_max=fl.KS_EXACT_MAX_T,
                wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N)
    paths = getattr(kernels, "PAIR_PATHS", ()) if _takes_path(kernels.pair_verdict) else ()

    def timed(what, run):
        ms = median_back_to_back_ms(run, cs.TIMED_RUNS)
        sha = _out_digest(run())
        print(f"  {what}: {ms:.3f} ms (median of {cs.TIMED_RUNS}), sha256 {sha}", flush=True)
        return {"ms": ms, "sha256": sha}

    res = {"A 128": timed("kernel A at 100000 x 128", lambda: kernels.pair_verdict(*t, **a_kw))}
    for path in paths[:2]:  # warp and cta serve T = 128
        res[f"A 128 {path}"] = timed(f"kernel A at 100000 x 128, {path} path forced",
                                     lambda: kernels.pair_verdict(*t, **a_kw, path=path))
    for mask in PAIR_TEST_MASKS:
        res[f"N 128 mask {mask}"] = timed(f"kernel N mask {mask} at 100000 x 128",
                                          lambda: kernels.pair_tests(*t[:4], mask, **_n_kw()))
        for path in paths[:2]:
            res[f"N 128 mask {mask} {path}"] = timed(
                f"kernel N mask {mask} at 100000 x 128, {path} path forced",
                lambda: kernels.pair_tests(*t[:4], mask, **_n_kw(), path=path))
    res["fleet"] = fleet_scorer_rate(t)
    if hasattr(kernels, "pair_path_launches"):
        kernels.reset_launches()
        kernels.pair_verdict(*t, **a_kw)
        kernels.pair_tests(*t[:4], 15, **_n_kw())
        res["paths at 128"] = {"pair_verdict": dict(kernels.pair_path_launches),
                               "pair_tests": dict(kernels.pair_tests_path_launches)}
        print(f"  paths at T = 128: {res['paths at 128']}", flush=True)
    if profile and hasattr(kernels, "WARP_PAIR_T"):
        res["ks floor"] = ks_floor(t)
    if profile:
        res["A split"] = phase_split(t)
        if hasattr(kernels, "TESTS_PHASES"):
            res["N split"] = stamp_split(
                "kernel N (mask 15)",
                lambda **kw: kernels.pair_tests(*t[:4], 15, **_n_kw(), **kw),
                t[0].shape[0], kernels.TESTS_PHASES,
                res["N 128 mask 15"]["ms"])
    del t
    torch.cuda.empty_cache()
    for T, B in PAIRS_LONG:
        a = fl.pair_args_from_numpy(
            cs.adversarial_pairs(B, T, np.random.default_rng(cs.SEED + T)), cs.DEV)
        res[f"A {T}"] = timed(f"kernel A at {B} x {T}", lambda: kernels.pair_verdict(*a, **a_kw))
        res[f"N {T} mask 15"] = timed(f"kernel N mask 15 at {B} x {T}",
                                      lambda: kernels.pair_tests(*a[:4], 15, **_n_kw()))
        del a
        torch.cuda.empty_cache()
    return res


def median_back_to_back_ms(fn, runs):
    """Median of `runs` launches of fn by CUDA events recorded between
    launches enqueued back to back after a warm-up one: the host stays
    ahead of the card, so each interval is the card's time alone (a single
    timed launch would also count the launcher's host time, which rivals a
    small kernel's)."""
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(runs + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in zip(ev, ev[1:])]))


def _digest(t):
    """SHA-256 of a tensor's bytes, copied to the host in chunks."""
    h = hashlib.sha256()
    flat = t.contiguous().view(-1)
    for lo in range(0, flat.numel(), 1 << 26):
        h.update(flat[lo:lo + (1 << 26)].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def triage_hw_inputs():
    """Kernel G's two shapes and kernel D's rows, from chip_smoke's generators."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    season, _, _ = cs.season_inputs(gen)
    x, mask, region = season[:3]
    B, T = x.shape
    margin = torch.full((B,), cs.TRIAGE_MARGIN, device=cs.DEV)
    engine = cs.engine_band_inputs(cs.engine_fleet(np.random.default_rng(cs.SEED)))
    hist = mask & ~region
    fb = torch.full((B,), 1440, dtype=torch.int32, device=cs.DEV)
    candt = torch.tensor(cs.PERIOD_CANDIDATES, dtype=torch.int32, device=cs.DEV)
    period, _ = kernels.detect_period(x, hist, candt, fb, 0.2, 0.05, 0.01)
    fit = hist & (torch.arange(T, device=cs.DEV) >= 2 * period[:, None])
    grid = torch.tensor(fc.DEFAULT_GRID, dtype=torch.float32, device=cs.DEV)
    return {"engine": engine, "season": (*season, margin), "hw": (x, hist, fit, period, grid)}


def _screen(args, **kw):
    from foremast_tpu_torch import kernels

    return kernels.triage_screen(args[0], args[1], args[2], cs.TRIAGE_WINDOW, *args[3:], **kw)


def screen_phases(args, what):
    """Kernel G's split by phase, from its per-row cycle counts: staging,
    then the predictor group's phases beside the select group's, each
    beside the row's total."""
    from foremast_tpu_torch import kernels

    B = args[0].shape[0]
    names = kernels.TRIAGE_PHASES
    clocks = torch.zeros((B, len(names)), dtype=torch.int64, device=cs.DEV)
    on = cs.median_ms(lambda: _screen(args, phase_clocks=clocks), 5)
    mean = clocks.double().mean(0).tolist()
    total = mean[names.index("total")]
    print(f"  kernel G phases at {what}: {on:.3f} ms with the cycle counts", flush=True)
    for name, m in zip(names, mean):
        print(f"    {name:10s} {m:10.1f} cycles per row, {100 * m / total:6.2f}% of the row's",
              flush=True)
    return {"ms_counts_on": on, "cycles_per_row": dict(zip(names, mean))}


def hw_fit_phases(args):
    """Kernel D's split: the SM cycles each row's warp spent in each phase,
    then D's time under smaller device-scratch budgets."""
    from foremast_tpu_torch import kernels

    B = args[0].shape[0]
    clocks = torch.zeros((B, len(kernels.HW_FIT_PHASES)), dtype=torch.int64, device=cs.DEV)
    on = cs.median_ms(lambda: kernels.hw_fit(*args, max_period=1440, phase_clocks=clocks), 3)
    total = clocks.double().sum(0)
    share = (total / total.sum()).tolist()
    mean = clocks.double().mean(0).tolist()
    print(f"  kernel D phases: {on:.3f} ms with the cycle counts", flush=True)
    for name, sh, m in zip(kernels.HW_FIT_PHASES, share, mean):
        print(f"    {name:10s} {100 * sh:6.2f}% of warp cycles, {m:12.1f} cycles per row",
              flush=True)
    budgets = {}
    saved = kernels.SCRATCH_BYTES
    try:
        for mb in (1024, 256, 64, 32):
            kernels.SCRATCH_BYTES = mb << 20
            budgets[mb] = cs.median_ms(lambda: kernels.hw_fit(*args, max_period=1440), 3)
            print(f"    device scratch {mb} MiB: {budgets[mb]:.3f} ms", flush=True)
    finally:
        kernels.SCRATCH_BYTES = saved
    return {"ms_counts_on": on, "share": dict(zip(kernels.HW_FIT_PHASES, share)),
            "cycles_per_row": dict(zip(kernels.HW_FIT_PHASES, mean)),
            "scratch_mib_ms": budgets}


def triage_hw(out_dir, profile):
    """Kernels G and D alone on chip_smoke's inputs: times, digests, and
    G's outputs to out_dir."""
    from foremast_tpu_torch import kernels

    inp = triage_hw_inputs()
    res, outs = {"ms": {}, "digest": {}}, {}
    for shape in ("engine", "season"):
        args = inp[shape]
        what = f"{shape} {args[0].shape[0]} x {args[0].shape[1]}"
        res["ms"][f"triage_screen {what}"] = median_back_to_back_ms(lambda: _screen(args),
                                                                     cs.TIMED_RUNS)
        g = _screen(args)
        outs[shape] = {k: v.cpu() for k, v in g.items()}
        for k in sorted(g):
            res["digest"][f"triage_screen {shape} {k}"] = _digest(g[k])
        del g
    hw = inp["hw"]
    res["ms"]["hw_fit season"] = median_back_to_back_ms(
        lambda: kernels.hw_fit(*hw, max_period=1440), cs.TIMED_RUNS)
    d = kernels.hw_fit(*hw, max_period=1440)
    for k in sorted(d):
        res["digest"][f"hw_fit {k}"] = _digest(d[k])
    del d
    for k, v in res["ms"].items():
        print(f"  {k}: {v:.3f} ms (median of {cs.TIMED_RUNS})", flush=True)
    if profile:
        res["profile"] = {"triage_screen": {s: screen_phases(inp[s], s)
                                            for s in ("engine", "season")},
                          "hw_fit": hw_fit_phases(hw)}
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "triage_hw_%s.pt" % os.path.basename(os.getcwd()))
    torch.save(outs, path)
    res["written"] = path
    return res


LSTM_ST_WIDTHS = ((32, 16, 1_024),) + LSTM_BACKWARD_WIDTHS  # (H, Z, jobs), F = 4
ST_CFG = (cs.ST_ORDER, cs.ST_CHANGEPOINTS, 1e-4, 3e-3, 3)


def _phase_table(kernel, names, clocks, what):
    """Mean cycles per row of each phase and its share of the row's."""
    mean = clocks.double().mean(0).tolist()
    total = sum(mean)
    print(f"  {kernel} phases at {what}:", flush=True)
    for name, m in zip(names, mean):
        print(f"    {name:10s} {m:12.1f} cycles, {100 * m / max(total, 1):6.2f}%", flush=True)
    return dict(zip(names, mean))


def lstm_forward_ab(profile):
    """Kernel L's forward at each width of LSTM_ST_WIDTHS: time, bound,
    floor, digests, and with profile its phases."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    x, m = cs.lstm_day_windows(cs.LSTM_TRAIN_JOBS, gen)
    K, W, F = x.shape[1], x.shape[2], x.shape[3]
    res = {}
    for H, Z, J in LSTM_ST_WIDTHS:
        xj, mj = x[:J].contiguous(), m[:J].contiguous()
        p = (tl.init_state(F, H, Z, J)[0].to(cs.DEV) if H == 32
             else cs.lstm_params(J, F, H, Z, gen))
        what = f"H={H} Z={Z} jobs={J}"
        ms = median_back_to_back_ms(lambda: kernels.lstm_train_forward(p, xj, mj, H, Z),
                                    cs.TIMED_RUNS)
        num, cnt, act = kernels.lstm_train_forward(p, xj, mj, H, Z)
        b = cs.lstm_train_bounds(J, K, W, F, H, Z, num.shape[1])["forward"]
        floor = cs.lstm_forward_floor_ms(J, K, W, F, H, Z)
        path = (kernels.lstm_train_forward_path(K, F, H, Z)
                if hasattr(kernels, "lstm_train_forward_path") else "wide")
        r = {"ms": ms, "path": path, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "floor_ms": floor,
             "sha256": {"act": _digest(act), "num": _digest(num), "cnt": _digest(cnt)}}
        print(f"  lstm_train_forward {what} ({path} path): {ms:.3f} ms (median of "
              f"{cs.TIMED_RUNS}); bound {b['bound_ms']:.3f} ms ({b['bound_by']}), arithmetic "
              f"floor {floor:.3f} ms; sha256 {r['sha256']}", flush=True)
        del num, cnt, act
        if profile and hasattr(kernels, "LSTM_FORWARD_PHASES"):
            names = kernels.LSTM_FORWARD_PHASES
            clocks = torch.zeros((J, len(names)), dtype=torch.int64, device=cs.DEV)
            kernels.lstm_train_forward(p, xj, mj, H, Z, phase_clocks=clocks)
            r["cycles_per_job"] = _phase_table("lstm_train_forward", names, clocks, what)
        res[what] = r
        del p, xj, mj
        torch.cuda.empty_cache()
    return res


def st_ab_inputs():
    """Kernel J's two shapes: the seasonal phase's rows and the engine's,
    each with the periods kernel F elects and its history as the fit."""
    from foremast_tpu_torch import kernels

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    season, _, _ = cs.season_inputs(gen)
    engine = cs.engine_band_inputs(cs.engine_fleet(np.random.default_rng(cs.SEED)))
    cand = torch.tensor(cs.PERIOD_CANDIDATES, dtype=torch.int32, device=cs.DEV)
    out = {}
    for shape, (x, mask, region) in (("season", season[:3]), ("engine", engine[:3])):
        B, T = x.shape
        hist = mask & ~region
        fb = torch.full((B,), min(1440, T // 2), dtype=torch.int32, device=cs.DEV)
        period, _ = kernels.detect_period(x, hist, cand, fb, 0.2, 0.05, 0.01)
        out[shape] = (x, hist, hist, period)
    return out


def st_fit_ab(out_dir, profile):
    """Kernel J at both shapes: time, bound, digests; beta and the first
    rows' preds to out_dir; with profile its phases."""
    from foremast_tpu_torch import kernels

    res, outs = {}, {}
    for shape, args in st_ab_inputs().items():
        B, T = args[0].shape
        what = f"{shape} {B} x {T}"
        ms = median_back_to_back_ms(lambda: kernels.st_fit(*args, *ST_CFG), cs.TIMED_RUNS)
        beta, preds = kernels.st_fit(*args, *ST_CFG)
        b = cs.st_bound(B, T, int((args[1] & args[2]).sum()))
        r = {"ms": ms, **b, "sha256": {"beta": _digest(beta), "preds": _digest(preds)},
             "finite": bool(torch.isfinite(preds).all())}
        print(f"  st_fit {what}: {ms:.3f} ms (median of {cs.TIMED_RUNS}); bound "
              f"{b['bound_ms']:.3f} ms ({b['bound_by']}); sha256 {r['sha256']}", flush=True)
        outs[shape] = {"beta": beta.cpu(), "preds": preds[:128].cpu()}
        del beta, preds
        if profile and hasattr(kernels, "ST_FIT_PHASES"):
            names = kernels.ST_FIT_PHASES
            clocks = torch.zeros((B, len(names)), dtype=torch.int64, device=cs.DEV)
            kernels.st_fit(*args, *ST_CFG, phase_clocks=clocks)
            r["cycles_per_row"] = _phase_table("st_fit", names, clocks, what)
        res[what] = r
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "lstm_st_%s.pt" % os.path.basename(os.getcwd()))
    torch.save(outs, path)
    return res, path


def lstm_st(out_dir, profile):
    lstm = lstm_forward_ab(profile)
    torch.cuda.empty_cache()
    st, path = st_fit_ab(out_dir, profile)
    return {"lstm_train_forward": lstm, "st_fit": st, "written": path}


def lstm_ae_shapes():
    """Kernel K's three shapes on chip_smoke.py's inputs, as (name, (H, Z,
    params, x, mask, mu, sigma)); mu and sigma None for the normalizer."""
    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    fx = cs.lstm_fixture()
    H, Z = int(fx["dims"][1]), int(fx["dims"][2])
    yield "scoring 100000 x 2, H=32", (H, Z, *cs.lstm_scoring_inputs(fx, cs.LSTM_JOBS))
    yield "normalizer 10000 x 45, H=32", (H, Z, *cs.lstm_normalizer_inputs(
        fx, cs.LSTM_NORM_JOBS, gen), None, None)
    yield "default width 10000 x 2, H=128", (128, 64, *cs.adversarial_lstm(
        cs.LSTM_WIDE_JOBS, 2, 4, 128, 64, gen))


def lstm_ae_ab(profile, paths):
    """Kernel K at each of its shapes: time, path, bound, floor, digests;
    with paths each path that serves the shape, forced; with profile its
    phases."""
    from foremast_tpu_torch import kernels

    res = {}
    for what, (H, Z, p, x, m, mu, sigma) in lstm_ae_shapes():
        J, K, W, F = x.shape
        extra = () if mu is None else (mu, sigma)
        b = cs.lstm_bound(J, K, F, H, Z)
        floor = cs.lstm_forward_floor_ms(J, K, W, F, H, Z)
        chosen = (kernels.lstm_ae_path(K, F, H, Z) if hasattr(kernels, "lstm_ae_path")
                  else "parent")
        forced = [None]
        if paths and hasattr(kernels, "LSTM_AE_FORCE"):
            forced += [q for q in kernels.LSTM_AE_PATHS
                       if q != chosen and kernels.lstm_ae_serves(q, K, F, H, Z)]
        r = {"path": chosen, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
             "floor_ms": floor}
        for force in forced:
            if force is not None:
                kernels.LSTM_AE_FORCE = force
            try:
                ms = median_back_to_back_ms(lambda: kernels.lstm_ae(p, x, m, H, Z, *extra),
                                            cs.TIMED_RUNS)
                out = kernels.lstm_ae(p, x, m, H, Z, *extra)
            finally:
                if force is not None:
                    kernels.LSTM_AE_FORCE = None
            out = out if isinstance(out, tuple) else (out,)
            sha = {k: _digest(t) for k, t in zip(("err", "z"), out)}
            name = force or chosen
            r[name] = {"ms": ms, "sha256": sha,
                       "finite": bool(all(torch.isfinite(t).all() for t in out))}
            print(f"  lstm_ae {what} ({name} path{'' if force is None else ', forced'}): "
                  f"{ms:.3f} ms (median of {cs.TIMED_RUNS}); bound {b['bound_ms']:.3f} ms "
                  f"({b['bound_by']}), arithmetic floor {floor:.3f} ms; sha256 {sha}",
                  flush=True)
            del out
        if profile and hasattr(kernels, "LSTM_AE_PHASES"):
            names = kernels.LSTM_AE_PHASES
            clocks = torch.zeros((J, len(names)), dtype=torch.int64, device=cs.DEV)
            kernels.lstm_ae(p, x, m, H, Z, *extra, phase_clocks=clocks)
            r["cycles_per_job"] = _phase_table("lstm_ae", names, clocks, what)
            r["stamped_ms"] = median_back_to_back_ms(
                lambda: kernels.lstm_ae(p, x, m, H, Z, *extra, phase_clocks=clocks), 5)
            print(f"  lstm_ae {what} with its clock stamps: {r['stamped_ms']:.3f} ms", flush=True)
        res[what] = r
        del p, x, m, mu, sigma
        torch.cuda.empty_cache()
    return res


def _takes_clocks(fn):
    import inspect

    return "phase_clocks" in inspect.signature(fn).parameters


def stamped_split(kernel, run, names, B, what, profile):
    """run() timed unstamped, then (profile, a checkout with the stamps)
    with its per-row cycle counts and their split, then unstamped again."""
    r = {"ms": median_back_to_back_ms(run, cs.TIMED_RUNS)}
    if profile and names is not None:
        clocks = torch.zeros((B, len(names)), dtype=torch.int64, device=cs.DEV)
        r["stamped_ms"] = median_back_to_back_ms(lambda: run(phase_clocks=clocks), 5)
        r["cycles_per_row"] = _phase_table(kernel, names, clocks, what)
        r["monotone"] = bool((clocks >= 0).all())
        r["ms_after"] = median_back_to_back_ms(run, cs.TIMED_RUNS)
    print(f"  {kernel} {what}: {r['ms']:.3f} ms (median of {cs.TIMED_RUNS})"
          + (f"; stamped {r['stamped_ms']:.3f} ms, unstamped again {r['ms_after']:.3f} ms"
             if "stamped_ms" in r else ""), flush=True)
    return r


def period_ab(profile, outs):
    """Kernel F on the seasonal phase's rows with the engine's and forty
    candidates: times, bounds, digests, the split."""
    from foremast_tpu_torch import kernels

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    season, _, _ = cs.season_inputs(gen)
    x, mask, region = season[:3]
    hist = (mask & ~region).contiguous()
    del season, mask, region
    B, T = x.shape
    fb = torch.full((B,), 1440, dtype=torch.int32, device=cs.DEV)
    names = getattr(kernels, "PERIOD_PHASES", None)
    if not _takes_clocks(kernels.detect_period):
        names = None
    res = {}
    for name, cands in (("engine", cs.PERIOD_CANDIDATES), ("forty", cs.MANY_CANDIDATES)):
        candt = torch.tensor(cands, dtype=torch.int32, device=cs.DEV)

        def run(**kw):
            return kernels.detect_period(x, hist, candt, fb, 0.2, 0.05, 0.01, **kw)

        what = f"{B} x {T}, {len(cands)} candidates"
        r = stamped_split("detect_period", run, names, B, what, profile)
        period, scores = run()
        r.update(cs.period_bound(hist, cands))
        r["sha256"] = {"period": _digest(period), "scores": _digest(scores)}
        print(f"    bound {r['bound_ms']:.3f} ms ({r['bound_by']}; counted over every slot "
              f"{r['bound_all_ms']:.3f} ms); sha256 {r['sha256']}", flush=True)
        if name == "engine":
            outs[f"period {name}"] = {"period": period.cpu(), "scores": scores.cpu()}
        res[name] = r
        del period, scores
    return res


def hpa_ab(profile, outs):
    """Kernel I's two entries on the hpa family's rows at each bucket:
    times, bounds, digests, the split."""
    from foremast_tpu_torch import kernels

    names = getattr(kernels, "HPA_PHASES", None)
    if not _takes_clocks(kernels.hpa_score):
        names = None
    res = {}
    for T, n_h in cs.FAMILY_SHAPES:
        gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + T)
        a, _ = cs.hpa_family_inputs(gen, T, n_h)
        B = a["tps"].shape[0]
        preds = kernels.smooth(kernels.SMOOTH_SES, a["tps"], a["hist"], a["alpha"])
        series = (a["tps"], a["tps_mask"], a["region"], preds, a["sla"], a["sla_mask"],
                  a["sla_static_limit"], a["sla_mode"], a["threshold"])
        opt = {k: a[k] for k in cs.HPA_OPTIONAL}
        sigma = kernels.hpa_score(*series, **opt)["tps_sigma"]
        for entry, extra in (("hpa_from_preds", {}), ("hpa_scores", {"tps_sigma": sigma})):
            bound = cs.hpa_bound(a["tps_mask"], a["region"], a["sla_mask"], bool(extra))

            def run(**kw):
                return kernels.hpa_score(*series, **opt, **extra, **kw)

            what = f"{entry} {B} x {T}"
            r = stamped_split("hpa_score", run, names, B, what, profile)
            out = run()
            r.update(bound)
            r["sha256"] = {k: _digest(v) for k, v in sorted(out.items())}
            print(f"    bound {r['bound_ms']:.3f} ms ({r['bound_by']}; every slot's bytes "
                  f"{r['bound_all_ms']:.3f} ms); sha256 {r['sha256']}", flush=True)
            outs[f"hpa {entry} T={T}"] = {k: v.cpu() for k, v in out.items()}
            res[what] = r
            del out
        del a, preds, series, opt, sigma
        torch.cuda.empty_cache()
    return res


def period_hpa(out_dir, profile):
    outs = {}
    res = {"detect_period": period_ab(profile, outs)}
    torch.cuda.empty_cache()
    res["hpa_score"] = hpa_ab(profile, outs)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "period_hpa_%s.pt" % os.path.basename(os.getcwd()))
    torch.save(outs, path)
    res["written"] = path
    return res


def _row_hash(t):
    """A 64-bit hash of each row's bytes (B, ...), on the card in chunks of
    rows: rows with equal hashes hold equal bits (NaN payloads aside: the
    card's NaN is canonical)."""
    v = t.reshape(t.shape[0], -1)
    v = v.to(torch.int32) if v.dtype == torch.bool else v.view(torch.int32)
    g = torch.Generator(device=v.device).manual_seed(17)
    w = torch.randint(1, 1 << 62, (v.shape[1],), generator=g, device=v.device)
    out = torch.empty(v.shape[0], dtype=torch.int64, device=v.device)
    for lo in range(0, v.shape[0], 4096):
        out[lo:lo + 4096] = (v[lo:lo + 4096].long() * w).sum(1)
    return out.cpu()


def _kept(out, keys, rows):
    """What --bivariate-hw writes for --compare: the (B,) outputs whole,
    the (B, T) ones as row hashes and their first `rows` rows."""
    kept = {}
    for k in keys:
        v = out[k]
        if v.dim() == 1:
            kept[k] = v.cpu()
        else:
            kept[k + " rows"] = _row_hash(v)
            kept[k + " head"] = v[:rows].cpu()
    return kept


def _forced(knob, paths, run, what):
    """Each path of a kernel that has a FORCE knob (this design's
    checkouts), forced in turn: its time and digests."""
    from foremast_tpu_torch import kernels

    res = {}
    for path in paths:
        setattr(kernels, knob, path)
        try:
            ms = median_back_to_back_ms(run, cs.TIMED_RUNS)
            out = run()
            out = out if isinstance(out, dict) else {"preds": out}
            res[path] = {"ms": ms, "sha256": {k: _digest(v) for k, v in sorted(out.items())}}
            print(f"    {what}, {path} path forced: {ms:.3f} ms; sha256 {res[path]['sha256']}",
                  flush=True)
            del out
        finally:
            setattr(kernels, knob, None)
    return res


def bivariate_ab(profile, outs):
    """Kernel H on the families phase's rows at each bucket: times, bound,
    digests, the split, each path forced where the checkout has them."""
    from foremast_tpu_torch import kernels

    names = getattr(kernels, "BI_PHASES", None)
    if not _takes_clocks(kernels.bivariate):
        names = None
    res = {}
    for T, n_h in cs.FAMILY_SHAPES:
        gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED + T)
        args, _ = cs.bivariate_family_inputs(gen, T, n_h)
        B = args[0].shape[0]

        def run(**kw):
            return kernels.bivariate(*args, **kw)

        what = f"{B} x {T}"
        r = stamped_split("bivariate", run, names, B, what, profile)
        if hasattr(kernels, "bivariate_path"):
            r["path"] = kernels.bivariate_path(T)
            r["paths"] = _forced("BIVARIATE_FORCE", kernels.BIVARIATE_PATHS, run, what)
        out = run()
        r.update(cs.least_time(B * T * 16 + B * (20 + 28), 27.0 * B * T))
        r["sha256"] = {k: _digest(v) for k, v in sorted(out.items())}
        print(f"    bound {r['bound_ms']:.3f} ms ({r['bound_by']}); sha256 {r['sha256']}",
              flush=True)
        outs[f"bivariate T={T}"] = _kept(out, sorted(out), 8)
        res[what] = r
        del args, out
        torch.cuda.empty_cache()
    return res


def smooth_ab(profile, outs):
    """Kernel C on the seasonal phase's rows: the Holt-Winters refit with
    each row's fitted parameters and period (forecast_band's), then SES and
    DES at the seasonal phase's parameters: times, bounds, digests and the
    refit's split."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.ops import forecast as fc

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    args, _, _ = cs.season_inputs(gen)
    x, mask, region = args[:3]
    B, T = x.shape
    fit = fc.forecast_band(*args, algorithm="holt_winters", device=cs.DEV)
    prm, period = fit["params"], fit["period"]
    del fit
    hist = (mask & ~region).contiguous()
    del args, mask, region
    refit = (x, hist, prm[:, 0].contiguous(), prm[:, 1].contiguous(), prm[:, 2].contiguous(),
             period)
    names = getattr(kernels, "SMOOTH_HW_PHASES", None)
    if not _takes_clocks(kernels.smooth):
        names = None

    def run(**kw):
        return kernels.smooth(kernels.SMOOTH_HW, *refit, max_period=1440, **kw)

    what = f"Holt-Winters refit {B} x {T}"
    r = stamped_split("smooth", run, names, (B + 31) // 32, what, profile)
    preds = run()
    walked = cs.season_bounds(B, T, 0, 1, 0)
    r.update(walked["smooth_hw"])
    r["sha256"] = {"preds": _digest(preds)}
    r["periods"] = {str(int(p)): int(c) for p, c in zip(*torch.unique(period, return_counts=True))}
    print(f"    bound {r['bound_ms']:.3f} ms ({r['bound_by']}, 9 B a slot); periods "
          f"{r['periods']}; sha256 {r['sha256']}", flush=True)
    outs["smooth hw"] = _kept({"preds": preds}, ["preds"], 8)
    res = {"hw": r}
    del preds
    f32 = dict(dtype=torch.float32, device=cs.DEV)
    al5, be1, al3 = (torch.full((B,), v, **f32) for v in (0.5, 0.1, 0.3))
    for kind, name, params in ((kernels.SMOOTH_SES, "ses", (al3,)),
                               (kernels.SMOOTH_DES, "des", (al5, be1))):
        def run_k():
            return kernels.smooth(kind, x, hist, *params)

        q = {"ms": median_back_to_back_ms(run_k, cs.TIMED_RUNS)}
        out = run_k()
        q.update(walked["smooth"])
        q["sha256"] = {"preds": _digest(out)}
        print(f"  smooth {name} {B} x {T}: {q['ms']:.3f} ms (median of {cs.TIMED_RUNS}); bound "
              f"{q['bound_ms']:.3f} ms; sha256 {q['sha256']}", flush=True)
        outs[f"smooth {name}"] = _kept({"preds": out}, ["preds"], 8)
        res[name] = q
        del out
    return res


def bivariate_hw(out_dir, profile, only=None):
    outs, res = {}, {}
    if only in (None, "bivariate"):
        res["bivariate"] = bivariate_ab(profile, outs)
        torch.cuda.empty_cache()
    if only in (None, "smooth"):
        res["smooth"] = smooth_ab(profile, outs)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "bivariate_hw_%s.pt" % os.path.basename(os.getcwd()))
    torch.save(outs, path)
    res["written"] = path
    return res


def compare_outputs(a_path, b_path):
    """The outputs of two --triage-hw (kernel G), --lstm-st (kernel J),
    --period-hpa (kernels F and I) or --bivariate-hw (kernels H and C) runs,
    key by key: equal bit for bit, else the largest relative difference and
    the rows that differ (for a row hash, the rows whose hashes differ)."""
    a, b = torch.load(a_path), torch.load(b_path)
    out = {}
    for shape in a:
        for k in a[shape]:
            x, y = a[shape][k], b[shape][k]
            same = bool(torch.equal(x, y) or (x.is_floating_point()
                                              and torch.equal(torch.isnan(x), torch.isnan(y))
                                              and torch.equal(x[~torch.isnan(x)],
                                                              y[~torch.isnan(y)])))
            d = (x.double() - y.double()).abs() / y.double().abs().clamp(min=1e-30)
            both = (x == y) | (torch.isnan(x) & torch.isnan(y))
            d = torch.where(both, 0.0, torch.nan_to_num(d, nan=math.inf))
            rows = (~both).reshape(both.shape[0], -1).any(1) if both.dim() else ~both
            out[f"{shape} {k}"] = {"equal": same, "max_rel": float(d.max()),
                                   "rows_differ": int(rows.sum())}
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true", help="split kernel A and the pass")
    p.add_argument("--seasonal", action="store_true", help="split the seasonal path instead")
    p.add_argument("--families", action="store_true",
                   help="time kernels H and I and profile the HPA launch instead")
    p.add_argument("--lstm-train", action="store_true",
                   help="time one training epoch's kernels L and M instead")
    p.add_argument("--lstm-backward", action="store_true",
                   help="time kernel L's backward at H = 128 and 256 instead")
    p.add_argument("--engine-lstm-epochs", action="store_true",
                   help="record the engine_lstm arm's training epochs instead")
    p.add_argument("--fleet", action="store_true", help="time kernel P instead")
    p.add_argument("--triage-hw", action="store_true",
                   help="time kernels G and D and print their outputs' digests instead")
    p.add_argument("--lstm-st", action="store_true",
                   help="time kernel L's forward and kernel J and print their digests instead")
    p.add_argument("--lstm-ae", action="store_true",
                   help="time kernel K at its three shapes and print its digests instead")
    p.add_argument("--lstm-ae-paths", action="store_true",
                   help="with --lstm-ae, also time each path that serves a shape")
    p.add_argument("--period-hpa", action="store_true",
                   help="time kernels F and I and print their outputs' digests instead")
    p.add_argument("--bivariate-hw", action="store_true",
                   help="time kernel H and kernel C (the Holt-Winters refit, SES, DES) and print "
                        "their outputs' digests instead")
    p.add_argument("--only", choices=("bivariate", "smooth"),
                   help="with --bivariate-hw, time one of the two kernels")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"),
                   help="hold two --triage-hw, --lstm-st, --period-hpa or --bivariate-hw output "
                        "files against each other (CPU)")
    p.add_argument("--a-digest", action="store_true",
                   help="print a digest of kernel A's and kernel N's outputs instead")
    p.add_argument("--pairs", action="store_true",
                   help="time kernels A and N at 100,000 x 128 (N at each mask of the battery) "
                        "and at the CTA and scratch paths' T, with digests, instead")
    p.add_argument("--out", default="chiprun_out", help="where the Chrome trace goes")
    opt = p.parse_args()
    if opt.compare:
        print(json.dumps(compare_outputs(*opt.compare)), flush=True)
        return
    if not torch.cuda.is_available():
        sys.exit("time_torch_kernels: needs a CUDA device")
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.parallel import fleet as fl

    if opt.fleet:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "fleet": fleet_split()}), flush=True)
        return
    if opt.triage_hw:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "triage_hw": triage_hw(opt.out, opt.profile)}), flush=True)
        return
    if opt.lstm_st:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "lstm_st": lstm_st(opt.out, opt.profile)}), flush=True)
        return
    if opt.period_hpa:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "period_hpa": period_hpa(opt.out, opt.profile)}), flush=True)
        return
    if opt.bivariate_hw:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "bivariate_hw": bivariate_hw(opt.out, opt.profile, opt.only)}),
              flush=True)
        return
    if opt.lstm_ae:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "lstm_ae": lstm_ae_ab(opt.profile, opt.lstm_ae_paths)}), flush=True)
        return
    if opt.pairs:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "pairs": pairs_ab(opt.profile)}), flush=True)
        return
    if opt.a_digest:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "a_digest": a_digest()}), flush=True)
        return
    if opt.families:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "families": families_split()}), flush=True)
        return
    if opt.lstm_backward:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "lstm_backward": lstm_backward_widths()}), flush=True)
        return
    if opt.engine_lstm_epochs:
        res = engine_lstm_epochs()
        os.makedirs(opt.out, exist_ok=True)
        path = os.path.join(opt.out, "engine_lstm_epochs_%s.json" % os.path.basename(os.getcwd()))
        with open(path, "w") as fh:
            json.dump(res, fh)
        brief = {dev: {"epochs": [c["epochs"] for c in res[dev]["calls"]],
                       "launches": res[dev]["launches"], "unhealthy": res[dev]["unhealthy"],
                       "unhealthy_digest": res[dev]["unhealthy_digest"]}
                 for dev in (cs.DEV, "cpu")}
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "engine_lstm_epochs": brief, "card_vs_cpu": res["card_vs_cpu"],
                          "written": path}), flush=True)
        return
    if opt.lstm_train:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "lstm_train": lstm_train_split()}), flush=True)
        return
    if opt.seasonal:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "seasonal": seasonal_split()}), flush=True)
        return

    args, _ = cs.pair_path_inputs(np.random.default_rng(cs.SEED))
    t = fl.pair_args_from_numpy(args, cs.DEV)
    ka = cs.cuda_ms(lambda: fl.score_pairs(*t, device=cs.DEV), cs.TIMED_RUNS)
    bargs, _ = cs.band_path_inputs(torch.Generator(device=cs.DEV).manual_seed(cs.SEED))
    kb = cs.cuda_ms(lambda: fc.moving_average_band(*bargs[:3], 30, *bargs[3:], device=cs.DEV),
                    cs.TIMED_RUNS)
    res = {"checkout": os.getcwd(), "kernel_a_ms": ka, "kernel_b_ms": kb,
           "device": torch.cuda.get_device_name(0)}
    print(f"{os.getcwd()}: kernel A {ka:.3f} ms, kernel B {kb:.3f} ms; {res['device']}",
          flush=True)
    if opt.profile:
        res["phases"] = phase_split(t)
        res["trace"] = trace_pass(args, opt.out)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
