#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, under a host emulation of CUDA.

    python scripts/kernel_emulator/emulate.py     # every kernel vs its twin

For a machine without nvcc or a card. `build()` compiles
``foremast_tpu_torch/csrc/*.cu`` with g++ against ``emu.h`` (after three
textual rewrites: the dynamic shared-memory declaration, the ``<<<...>>>``
launches and the cp.async helpers) into
``build/kernel_emulator/<hash>/libemu.so``. `install()` points
``foremast_tpu_torch.kernels`` at that library and lets its launchers take
CPU tensors, so the real launchers run the real kernel sources: index
arithmetic, rings, grid-stride loops and block / warp synchronisation are
exercised. Speed, register pressure and what nvcc would refuse are not;
only a run on the card shows those. One OS thread per CUDA thread keeps
the shapes small (a few hundred rows).

Run as a script it holds each kernel against its plain twin at small
shapes and exits non-zero on a difference.
"""
from __future__ import annotations

import contextlib
import ctypes
import glob
import hashlib
import os
import re
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
CSRC = os.path.join(REPO, "foremast_tpu_torch", "csrc")
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from foremast_tpu_torch import kernels  # noqa: E402
from foremast_tpu_torch.kernels import build as kbuild  # noqa: E402

_LAUNCH = re.compile(r"([\w:]+(?:<[\w:, ]+>)?)<<<([^;]*?)>>>\(([^;]*)\);")


def _rewrite(text: str) -> str:
    text = text.replace("extern __shared__ __align__(16) unsigned char smem[];",
                        "unsigned char* smem = emu::ctx.smem;")
    text = _LAUNCH.sub(r"emu::launch(\1, \2, \3);", text)
    start = text.find("__device__ __forceinline__ void cp_async4")
    if start >= 0:
        end = text.find("}  // namespace fm", start)
        text = text[:start] + (
            "inline void cp_async4(void* d, const void* s) { std::memcpy(d, s, 4); }\n"
            "inline void cp_async8(void* d, const void* s) { std::memcpy(d, s, 8); }\n"
            "inline void cp_async_wait_all() {}\n\n") + text[end:]
    return text


def build() -> str:
    """Compile the kernels for the host; returns the library's path."""
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))
    h = hashlib.sha256()
    for p in sources + [os.path.join(HERE, "emu.h"), __file__]:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    out = os.path.join(REPO, "build", "kernel_emulator", h.hexdigest()[:16])
    lib = os.path.join(out, "libemu.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(out, exist_ok=True)
    for stub in ("cuda_runtime.h", "math_constants.h"):
        open(os.path.join(out, stub), "w").close()
    cpps = []
    for p in sources:
        with open(p) as f:
            text = _rewrite(f.read())
        name = os.path.basename(p)
        if name.endswith(".cuh"):
            text = '#include "emu.h"\n' + text
        else:
            name += ".cpp"
            cpps.append(os.path.join(out, name))
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    procs = [(c, subprocess.Popen(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-pthread", "-Wno-unknown-pragmas", "-I", HERE,
         "-I", out, "-c", c, "-o", c + ".o"], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)) for c in cpps]
    errors = [f"{c}:\n{p.communicate()[0]}" for c, p in procs if p.wait() != 0]
    if errors:
        raise RuntimeError("building the emulated kernels failed:\n" + "\n".join(errors))
    subprocess.run(["g++", "-shared", "-pthread", "-o", lib + ".tmp", *(c + ".o" for c in cpps)],
                   check=True)
    os.replace(lib + ".tmp", lib)
    return lib


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def install() -> None:
    """Let kernels.<launcher> run the emulated kernels on CPU tensors."""
    lib = ctypes.CDLL(build())
    kbuild._declare(lib)
    kbuild.library = lambda: lib
    kernels._check = _check
    torch.cuda.device = lambda dev: contextlib.nullcontext()
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)


def _err(a, b) -> float:
    same = (torch.isnan(a) & torch.isnan(b)) | (torch.isinf(a) & (a == b))
    return float(torch.where(same, 0.0, (a.double() - b.double()).abs()).max())


def self_check() -> int:
    """Each kernel against its twin at small shapes; returns the failures."""
    from foremast_tpu_torch.ops import forecast as fc
    from foremast_tpu_torch.ops import seqscan as sq
    from foremast_tpu_torch.ops.pairwise import (KS_EXACT_MAX_T, WILCOXON_EXACT_MAX_N,
                                                 wilcoxon_pmf_table)
    from foremast_tpu_torch.parallel import fleet as fl

    g = torch.Generator().manual_seed(0)
    failures = []

    def expect(name, ok, detail):
        print(f"{'ok  ' if ok else 'FAIL'} {name}: {detail}", flush=True)
        if not ok:
            failures.append(name)

    B, T = 40, 100
    t = torch.arange(T)
    x = 10 + 3 * torch.sin(2 * np.pi * t / 24) + torch.randn((B, T), generator=g)
    m = torch.rand((B, T), generator=g) > 0.1
    m[0] = False
    m[1, :30] = False
    x[2], m[2] = 7.25, True
    al = 0.1 + 0.8 * torch.rand(B, generator=g)
    be, ga = 0.3 * torch.rand(B, generator=g), 0.05 + 0.45 * torch.rand(B, generator=g)
    per = torch.tensor([1, 2, 3, 24, 31, 32, 33, 60, 200], dtype=torch.int32)[torch.arange(B) % 9]
    for kind, params in ((1, (al,)), (2, (al, be)), (3, (al, be, ga, per))):
        e = _err(kernels.smooth(kind, x, m, *params), fc.smooth_plain(kind, x, m, *params))
        expect(f"smooth {kind}", e == 0.0, f"max |err| {e:.3g} (same float32 steps)")
    for kind, params in ((1, (al,)), (2, (al, be))):
        twin = sq.ses_predictions_assoc_plain if kind == 1 else sq.des_predictions_assoc_plain
        e = _err(kernels.affine_scan(kind, x, m, *params), twin(x, m, *params))
        expect(f"affine_scan {kind}", e <= 1e-4 * 14, f"max |err| {e:.3g} (combine order)")
    fit = m & (t >= 2 * per[:, None])
    grid = torch.tensor(fc.DEFAULT_GRID, dtype=torch.float32)
    saved = kernels.SCRATCH_BYTES
    kernels.SCRATCH_BYTES = 3 * 100 * 64 * 4  # fewer warps than rows: grid-stride
    k, p = kernels.hw_fit(x, m, fit, per, grid), fc.fit_holt_winters_plain(x, m, fit, per, grid)
    kernels.SCRATCH_BYTES = saved
    expect("hw_fit", torch.equal(k["best"], p["best"]) and _err(k["mse"], p["mse"]) == 0.0,
           f"best equal {torch.equal(k['best'], p['best'])}, mse |err| {_err(k['mse'], p['mse']):.3g}")
    cands = (2, 3, 12, 24, 48, 99, 150)
    fb = torch.full((B,), 5, dtype=torch.int32)
    t_long = torch.arange(600)
    x_series = 10 + 3 * torch.sin(2 * np.pi * t_long / 48) + torch.randn((B, 600), generator=g)
    m_series = torch.rand((B, 600), generator=g) > 0.1
    kp, ks = kernels.detect_period(x, m, torch.tensor(cands, dtype=torch.int32), fb, 0.2, 0.05, 0.01)
    pp, ps = fc.detect_period_plain(x, m, cands, fb, 0.2, 0.05, 0.01)
    expect("detect_period", torch.equal(kp, pp) and _err(ks, ps) <= 1e-6,
           f"periods equal {torch.equal(kp, pp)}, scores |err| {_err(ks, ps):.3g}")
    region = torch.zeros((B, T), dtype=torch.bool)
    region[:, 80:] = True
    thr = torch.tensor([1.0, 2.0, 3.0])[torch.arange(B) % 3]
    mode = (torch.arange(B) % 4).to(torch.int32)
    mlb = torch.zeros(B)
    preds = x + torch.randn((B, T), generator=g)
    k = kernels.band_from_preds(x, m, region, preds, thr, mode, mlb)
    p = fc.band_from_preds_plain(x, m, region, preds, thr, mode, mlb)
    expect("band_from_preds", all(torch.equal(k[q], p[q]) for q in ("count", "checked", "flags")),
           f"sigma |err| {_err(k['sigma'], p['sigma']):.3g}")
    k = kernels.ma_band(x, m, region, 5, thr, mode, mlb)
    p = fc.moving_average_band_plain(x, m, region, 5, thr, mode, mlb)
    expect("ma_band", all(torch.equal(k[q], p[q]) for q in ("count", "checked", "flags", "preds")),
           "counts, flags and predictions")
    import chip_smoke as cs
    from foremast_tpu_torch.ops import bivariate as bv
    from foremast_tpu_torch.ops import triage as tr

    saved_dev, cs.DEV = cs.DEV, "cpu"
    for T in (64, 300):
        a = cs.adversarial_screen(30, T, g)
        k = kernels.triage_screen(a[0], a[1], a[2], cs.TRIAGE_WINDOW, *a[3:])
        e, bracketed = cs.compare_triage(a, k, tr.screen_rows_plain(*a, cs.TRIAGE_WINDOW))
        expect(f"triage_screen T={T}", e <= 1e-4,
               f"statistics |err| {e:.3g}, {bracketed} rows bracketed at a band edge")
    for T in (64, 300):
        a = cs.adversarial_bivariate(48, T, g)
        try:
            e, bracketed = cs.compare_bivariate(a, kernels.bivariate(*a),
                                                bv.bivariate_normal_anomalies_plain(*a))
            expect(f"bivariate T={T}", True,
                   f"bands |err| {e:.3g}, {bracketed} rows bracketed at the ellipse's edge")
        except AssertionError as e:
            expect(f"bivariate T={T}", False, str(e))
        a = cs.adversarial_hpa(48, T, g)
        for sigma in (True, False):
            for optional in (True, False):
                kw = {k: a[k] for k in cs.HPA_OPTIONAL} if optional else {}
                if sigma:
                    kw["tps_sigma"] = a["tps_sigma"]
                name = (f"hpa_score T={T} sigma {'given' if sigma else 'computed'}, optional "
                        f"arguments {'given' if optional else 'left out'}")
                try:
                    errs, bracketed = cs.compare_hpa(a, kernels.hpa_score(*cs.hpa_series(a), **kw),
                                                     sigma, optional)
                    expect(name, True, f"score |err| {errs['score']:.3g}, {bracketed} rows "
                                       f"bracketed at a decision edge")
                except AssertionError as e:
                    expect(name, False, str(e))
    from foremast_tpu_torch.models import lstm_ae as tl

    for T in (128, 300):
        a = cs.adversarial_st(27, T, g)
        for C in (0, cs.ST_CHANGEPOINTS):
            name = f"st_fit T={T} C={C}"
            try:
                e, ill = cs.compare_st_fit(a, kernels.st_fit(*a, cs.ST_ORDER, C, 1e-4, 3e-3, 3),
                                           fc.fit_seasonal_trend_plain(*a, cs.ST_ORDER, 1e-4, C,
                                                                       3e-3, 3),
                                           2 + C + 2 * cs.ST_ORDER)
                expect(name, True, f"preds |err| {e:.3g}, {ill} rows ill-posed")
            except AssertionError as e:
                expect(name, False, str(e))
    for F, H, Z in cs.LSTM_WIDTHS:
        name = f"lstm_ae F={F} H={H} Z={Z}"
        p, x, m, mu, sigma = cs.adversarial_lstm(3, 10, F, H, Z, g)  # two CTAs a job
        try:
            e = cs.compare_lstm(kernels.lstm_ae(p, x, m, H, Z, mu, sigma),
                                tl.reconstruction_errors_plain(p, x, m, H, Z, mu, sigma), sigma)
            expect(name, True, f"err |err| {e:.3g}")
        except AssertionError as e:
            expect(name, False, str(e))
    for F, H, Z in ((3, 8, 4), (4, 16, 8)):
        name = f"lstm_train and adam F={F} H={H} Z={Z}"
        p, x, m = cs.adversarial_lstm_train(4, 11, 8, F, H, Z, g)  # two window blocks a job
        try:
            kern = tl.LstmAeLoss.apply(p.clone().requires_grad_(True), x, m, H, Z)
            q = p.clone().requires_grad_(True)
            pl = tl.loss_plain(q, x, m, H, Z)
            pg, = torch.autograd.grad(pl.sum(), q)
            kg, = torch.autograd.grad(tl.LstmAeLoss.apply(q, x, m, H, Z).sum(), q)
            e = cs.compare_lstm_train((kern.detach(), kg), (pl.detach(), pg))
            num, cnt, act = kernels.lstm_train_forward(p, x, m, H, Z)
            gpart = kernels.lstm_train_backward(p, x, m, act, H, Z)
            step = torch.tensor([1, 2, 30, 400], dtype=torch.int32)
            cs.compare_adam(p, 1e-3 * torch.randn(p.shape, generator=g),
                            1e-6 * torch.rand(p.shape, generator=g), step, gpart, num, cnt)
            expect(name, True, f"grad |err| {e:.3g}, adam bit for bit")
        except AssertionError as e:
            expect(name, False, str(e))
    cs.DEV = saved_dev
    many = torch.tensor(cs.MANY_CANDIDATES, dtype=torch.int32)
    kp, ks = kernels.detect_period(x_series, m_series, many, fb, 0.2, 0.05, 0.01)
    pp, ps = fc.detect_period_plain(x_series, m_series, cs.MANY_CANDIDATES, fb, 0.2, 0.05, 0.01)
    expect("detect_period 40 candidates", torch.equal(kp, pp) and _err(ks, ps) <= 1e-6,
           f"periods equal {torch.equal(kp, pp)}, scores |err| {_err(ks, ps):.3g}")
    kernels.SCRATCH_BYTES = 3 * 16384 * 16  # three CTAs walk the pairs
    for T in (64, 4100):
        a = fl.pair_args_from_numpy(cs.adversarial_pairs(8, T, np.random.default_rng(T)), "cpu")
        k = kernels.pair_verdict(*a, wilcoxon_table=wilcoxon_pmf_table("cpu"),
                                 ks_exact_max=KS_EXACT_MAX_T, wilcoxon_exact_max_n=WILCOXON_EXACT_MAX_N)
        e = _err(k["pvalues"], fl.pair_verdict_plain(*a)["pvalues"])
        expect(f"pair_verdict T={T}", e <= cs.P_ATOL, f"max |dp| {e:.3g}")
    new_kernels_check(cs, expect)
    kernels.SCRATCH_BYTES = saved
    return len(failures)


def new_kernels_check(cs, expect) -> None:
    """Kernels N, O and P against their twins, with chip_smoke's adversarial
    rows and comparisons, device scratch and grid-stride walks included."""
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.ops import ranks as rk
    from foremast_tpu_torch.parallel import fleet as fl

    saved_dev, cs.DEV = cs.DEV, "cpu"
    rng = np.random.default_rng(7)
    names = pw.TWO_SAMPLE_TESTS
    kw = dict(wilcoxon_table=pw.wilcoxon_pmf_table("cpu"), ks_exact_max=pw.KS_EXACT_MAX_T,
              wilcoxon_exact_max_n=pw.WILCOXON_EXACT_MAX_N)
    kernels.SCRATCH_BYTES = 3 * 16384 * 16  # three CTAs walk the pairs
    for T, B in ((8, 20), (64, 20), (4100, 6)):
        x, xm, y, ym = (torch.from_numpy(a) for a in cs.adversarial_tests(B, T, rng))
        plain = pw.two_sample_tests_plain(x, xm, y, ym)
        plain["sign"] = pw.sign_test_exact_plain(x, y, xm & ym)
        try:
            e = cs.compare_pair_tests(kernels.pair_tests(x, xm, y, ym, 15, **kw), plain, names)
            for name in names + ("sign",):
                cs.compare_pair_tests(kernels.pair_tests(x, xm, y, ym,
                                                         kernels.PAIR_TEST_BITS[name], **kw),
                                      plain, (name,))
            expect(f"pair_tests T={T}", True, f"max |dp| {e:.3g}, each test alone equal")
        except AssertionError as err:
            expect(f"pair_tests T={T}", False, str(err))
    kernels.SCRATCH_BYTES = 3 * 16384 * 16
    for T, B in ((8, 12), (300, 12), (9000, 7)):
        v, m = (torch.from_numpy(a) for a in cs.adversarial_ranks(B, T, rng))
        try:
            cs.compare_ranks(kernels.rank_and_ties(v, m), rk.rank_and_ties_plain(v, m))
            expect(f"rank_and_ties T={T}", True, "ranks, tie terms and counts equal")
        except AssertionError as err:
            expect(f"rank_and_ties T={T}", False, str(err))
    for k, T in ((2, 20), (3, 20), (5, 7), (3, 3000)):
        g, gm = (torch.from_numpy(a) for a in cs.adversarial_groups(7, k, T, rng))
        try:
            H, p = kernels.kruskal_groups(g, gm)
            pH, pp = pw.kruskal_plain(g, gm)
            cs.close(H, pH, cs.STAT_RTOL, 1e-6, "H")
            e = cs.close(p, pp, 0.0, cs.P_ATOL, "p")
            expect(f"kruskal_groups k={k} T={T}", True, f"max |dp| {e:.3g}")
        except AssertionError as err:
            expect(f"kruskal_groups k={k} T={T}", False, str(err))
    for n, k in ((12, 3), (5, 200), (30, 6)):
        d, bm = (torch.from_numpy(a) for a in cs.adversarial_friedman(10, n, k, rng))
        try:
            chi, p = kernels.friedman(d, bm)
            pc, pp = pw.friedman_plain(d, bm)
            cs.close(chi, pc, cs.STAT_RTOL, 1e-5, "chi2")
            e = cs.close(p, pp, 0.0, cs.P_ATOL, "p")
            expect(f"friedman n={n} k={k}", True, f"max |dp| {e:.3g}")
        except AssertionError as err:
            expect(f"friedman n={n} k={k}", False, str(err))
    for n in (5, 5000):
        u, sev = (torch.from_numpy(a) for a in cs.adversarial_topk(n, rng))
        for k in (1, 8, 500, 3000, n + 5):
            try:
                cs.compare_topk(kernels.fleet_topk(sev, k, u, base=7),
                                fl.fleet_topk_plain(sev, k, u, base=7), "masked")
                cs.compare_topk(kernels.fleet_topk(sev, k), fl.fleet_topk_plain(sev, k),
                                "unmasked")
                expect(f"fleet_topk n={n} k={k}", True, "counts, values and indices equal")
            except AssertionError as err:
                expect(f"fleet_topk n={n} k={k}", False, str(err))
    cs.DEV = saved_dev


if __name__ == "__main__":
    install()
    sys.exit(1 if self_check() else 0)
