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
Z = 16, from the reference's initial rows): kernel L's forward and backward
entries and kernel M alone, each the median of 5 by CUDA events.

--fleet times kernel P (`kernels.fleet_topk`, k = chip_smoke.FLEET_K) on
the fleet that `score_pairs` scores from the 100,000-pair pass, and beside
it `torch.topk` over the masked severities, each the mean of 20 launches by
CUDA events.

--a-digest prints a SHA-256 of every output of kernel A (`score_pairs` on
the card) on chip_smoke.py's adversarial pairs at each T of its kernel
check and on the 100,000-pair pass: run from two checkouts in one call, equal
digests show that kernel A's outputs did not change, bit for bit.
"""
import hashlib
import argparse
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


def phase_split(t):
    """Kernel A's phases on device tensors t, from its clock stamps."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.parallel import fleet as fl

    B = t[0].shape[0]
    clocks = torch.zeros((B, len(kernels.PAIR_PHASES) + 1), dtype=torch.int64, device=cs.DEV)

    def run():
        return kernels.pair_verdict(
            *t, wilcoxon_table=fl.wilcoxon_pmf_table(t[0].device),
            ks_exact_max=fl.KS_EXACT_MAX_T, wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N,
            phase_clocks=clocks)

    on_ms = cs.cuda_ms(run, cs.TIMED_RUNS)
    off_ms = cs.cuda_ms(lambda: fl.score_pairs(*t, device=cs.DEV), cs.TIMED_RUNS)
    cyc = clocks.diff(dim=1).double()
    check_ok = bool((cyc >= 0).all())
    total = cyc.sum(0)
    share = (total / total.sum()).tolist()
    mean = cyc.mean(0).tolist()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout.split()[0])
    # CTA-cycles over SM-cycles of the kernel: how many pairs an SM held at once
    resident = float(total.sum()) / (on_ms * 1e-3 * mhz * 1e6 * sms)
    print(f"  kernel A phases (B = {B}), stamps monotone: {check_ok}; "
          f"{on_ms:.3f} ms with stamps, {off_ms:.3f} ms without", flush=True)
    for name, sh, m in zip(kernels.PAIR_PHASES, share, mean):
        print(f"    {name:15s} {100 * sh:6.2f}% of CTA cycles, {m:10.1f} cycles per pair",
              flush=True)
    print(f"    mean {sum(mean):.1f} cycles per pair; {resident:.2f} pairs resident per SM "
          f"on average (at the {mhz:.0f} MHz max SM clock, {sms} SMs)", flush=True)
    return {"ms_stamps_on": on_ms, "ms_stamps_off": off_ms,
            "share": dict(zip(kernels.PAIR_PHASES, share)),
            "cycles_per_pair": dict(zip(kernels.PAIR_PHASES, mean)),
            "resident_per_sm": resident, "monotone": check_ok}


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
    """One training epoch's kernels L (forward, backward) and M alone on
    chip_smoke's training-pass inputs."""
    from foremast_tpu_torch import kernels
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=cs.DEV).manual_seed(cs.SEED)
    x, m = cs.lstm_day_windows(cs.LSTM_TRAIN_JOBS, gen)
    H, Z = 32, 16
    params, step, mu, nu = (t.to(cs.DEV) for t in tl.init_state(4, H, Z, x.shape[0]))
    step += 1
    num, cnt, act = kernels.lstm_train_forward(params, x, m, H, Z)
    fwd = cs.median_ms(lambda: kernels.lstm_train_forward(params, x, m, H, Z), 5)
    gpart = kernels.lstm_train_backward(params, x, m, act, H, Z)
    bwd = cs.median_ms(lambda: kernels.lstm_train_backward(params, x, m, act, H, Z), 5)
    adam = cs.median_ms(lambda: kernels.adam(params, mu, nu, step, gpart, num, cnt,
                                             tl.LEARNING_RATE, tl.ADAM_B1, tl.ADAM_B2,
                                             tl.ADAM_EPS), 5)
    print(f"  lstm_train_forward {fwd:.3f} ms, lstm_train_backward {bwd:.3f} ms, adam "
          f"{adam:.3f} ms (medians of 5)", flush=True)
    return {"lstm_train_forward_ms": fwd, "lstm_train_backward_ms": bwd, "adam_ms": adam}


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


def a_digest():
    from foremast_tpu_torch.parallel import fleet as fl

    def digest(args):
        out = fl.score_pairs(*args, device=cs.DEV)
        torch.cuda.synchronize()
        h = hashlib.sha256()
        for k in sorted(out):
            h.update(k.encode() + out[k].cpu().numpy().tobytes())
        return h.hexdigest()[:16]

    res = {}
    for T in (16, 128, 1024, 4096, 8192, 16384):
        B = cs.CHECK_ROWS if T <= 4096 else 512
        res[f"T={T}"] = digest(cs.adversarial_pairs(B, T, np.random.default_rng(cs.SEED + T)))
    res["pass"] = digest(cs.pair_path_inputs(np.random.default_rng(cs.SEED))[0])
    return res


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--profile", action="store_true", help="split kernel A and the pass")
    p.add_argument("--seasonal", action="store_true", help="split the seasonal path instead")
    p.add_argument("--families", action="store_true",
                   help="time kernels H and I and profile the HPA launch instead")
    p.add_argument("--lstm-train", action="store_true",
                   help="time one training epoch's kernels L and M instead")
    p.add_argument("--fleet", action="store_true", help="time kernel P instead")
    p.add_argument("--a-digest", action="store_true",
                   help="print a digest of kernel A's outputs instead")
    p.add_argument("--out", default="chiprun_out", help="where the Chrome trace goes")
    opt = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("time_torch_kernels: needs a CUDA device")
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.parallel import fleet as fl

    if opt.fleet:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "fleet": fleet_split()}), flush=True)
        return
    if opt.a_digest:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "a_digest": a_digest()}), flush=True)
        return
    if opt.families:
        print(json.dumps({"checkout": os.getcwd(), "device": torch.cuda.get_device_name(0),
                          "families": families_split()}), flush=True)
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
