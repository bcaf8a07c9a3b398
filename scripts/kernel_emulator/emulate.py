#!/usr/bin/env python3
"""Run the port's CUDA kernels on the CPU, under a host emulation of CUDA.

    python scripts/kernel_emulator/emulate.py     # every kernel vs its twin
    python scripts/kernel_emulator/emulate.py --parent DIR   # and A, N, K, L's forward, J, F, I vs DIR's

For a machine without nvcc or a card. `build()` compiles
``foremast_tpu_torch/csrc/*.cu`` with g++ against ``emu.h`` (after textual
rewrites of the dynamic shared-memory declaration, the ``<<<...>>>``
launches, the named barrier, the float64 MMA, the cp.async helpers and the
thread block clusters' helpers and launch) into
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
    text = text.replace('asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(n) : "memory");',
                        "emu::bar_sync(id, n);")
    start = text.find("__device__ __forceinline__ unsigned cluster_ctarank()")
    if start >= 0:
        end = text.find("// Float64 tensor-core products", start)
        text = text[:start] + (
            "inline unsigned cluster_ctarank() { return emu::ctx.crank; }\n"
            "inline void cluster_arrive() { emu::cluster_token = emu::ctx.cluster_bar->arrive(); }\n"
            "inline void cluster_arrive_relaxed() { cluster_arrive(); }\n"
            "inline void cluster_wait() { emu::ctx.cluster_bar->wait(std::move(*emu::cluster_token)); }\n"
            "inline void cluster_sync() { emu::ctx.cluster_bar->arrive_and_wait(); }\n"
            "template <typename T>\ninline T* cluster_map(T* p, unsigned rank) {\n"
            "  return reinterpret_cast<T*>(emu::ctx.cluster_smem[rank] +\n"
            "                              (reinterpret_cast<unsigned char*>(p) - emu::ctx.smem));\n"
            "}\n"
            "template <typename... Args>\n"
            "inline cudaError_t launch_cluster(void (*kernel)(Args...), int grid, int block,\n"
            "                                  size_t smem, cudaStream_t, int cl, Args... args) {\n"
            "  emu::launch_cluster(kernel, unsigned(grid), unsigned(block), smem, unsigned(cl),\n"
            "                      args...);\n"
            "  return cudaSuccess;\n}\n\n") + text[end:]
    start = text.find("__device__ __forceinline__ void mma_f64_m8n8k4")
    if start >= 0:
        end = text.find("// Asynchronous 4-, 8- and 16-byte copies", start)
        text = text[:start] + "".join(
            f"inline void mma_f64_m{m}n8k4(double* d, const double* a, const double* b) {{\n"
            f"  emu::mma_f64<{m}>(d, a, b);\n}}\n" for m in (8, 16)) + "\n" + text[end:]
    start = text.find("__device__ __forceinline__ void cp_async4")
    if start >= 0:
        end = text.find("}  // namespace fm", start)
        text = text[:start] + (
            "inline void cp_async4(void* d, const void* s) { std::memcpy(d, s, 4); }\n"
            "inline void cp_async8(void* d, const void* s) { std::memcpy(d, s, 8); }\n"
            "inline void cp_async16(void* d, const void* s) { std::memcpy(d, s, 16); }\n"
            "inline void cp_async_wait_all() {}\n"
            "inline void cp_async_commit() {}\n"
            "template <int N>\ninline void cp_async_wait_group() {}\n\n") + text[end:]
    return text


def build(csrc: str = CSRC) -> str:
    """Compile the kernels in csrc for the host; returns the library's path."""
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")) + glob.glob(os.path.join(csrc, "*.cuh")))
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


def _bits(t):
    return t.view(torch.int64) if t.element_size() == 8 else t.view(torch.int32)


class _Present:
    """A library whose entries missing from it (a parent's, older than
    this tree's launchers) take their declarations and are never called."""

    def __init__(self, lib):
        self.__dict__["_lib"] = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def parent_check(parent: str) -> int:
    """Kernel L's forward, kernel J, kernel K, kernel F, kernel I, kernel A
    and kernel N of the checkout at `parent` (its own C entries, called
    directly; K's, A's and N's through this tree's launchers) against this
    tree's: L's act, num and cnt bit for bit, J within compare_st_fit's
    tolerances, K's err and z, F's periods and scores, I's outputs and A's
    and N's outputs bit for bit. Returns the failures."""
    import chip_smoke as cs
    from foremast_tpu_torch.models import lstm_ae as tl

    lib = ctypes.CDLL(build(os.path.join(parent, "foremast_tpu_torch", "csrc")))
    P_, I_, D_, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    lib.fm_st_fit.argtypes = [P_] * 4 + [I_, I_, D_, D_, I_, I_, I_, P_, P_, P_, P_]
    lib.fm_lstm_train_forward.argtypes = [P_, LL, P_, P_] + [I_] * 8 + [LL] + [P_] * 5
    lib.fm_lstm_train_smem_bytes.argtypes = [I_] * 5
    lib.fm_lstm_train_smem_bytes.restype = LL

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    saved_dev, cs.DEV = cs.DEV, "cpu"
    g = torch.Generator().manual_seed(3)
    failures = 0
    for F, H, Z, K, W in ((4, 32, 16, 45, 3), (3, 8, 4, 11, 8), (4, 40, 8, 11, 5),
                          (2, 10, 6, 5, 4)):
        p, x, m = cs.adversarial_lstm_train(3, K, W, F, H, Z, g)
        KB, nkb = kernels.lstm_train_blocks(K, F)
        num, cnt = torch.empty(3, nkb, dtype=torch.float64), torch.empty(3, nkb, dtype=torch.float64)
        act = torch.empty(3, K, 2, W, 5 * H)
        sp = int(lib.fm_lstm_train_smem_bytes(F, H, Z, KB, 1) <= kernels.LSTM_SMEM_PARAMS_BYTES)
        rc = lib.fm_lstm_train_forward(ptr(p), p.shape[1], ptr(x), ptr(m), 3, K, W, F, H, Z, KB,
                                       sp, kernels.LSTM_FORWARD_SMEM_BYTES, ptr(act), ptr(num),
                                       ptr(cnt), None, None)
        ours = kernels.lstm_train_forward(p, x, m, H, Z)
        ok = rc == 0 and all(torch.equal(_bits(u), _bits(v))
                             for u, v in zip(ours, (num, cnt, act)))
        print(f"{'ok  ' if ok else 'FAIL'} lstm_train_forward F={F} H={H} Z={Z} K={K} W={W} "
              f"against the parent's: num, cnt, act bit for bit", flush=True)
        failures += not ok
    for T in (128, 301):
        a = cs.adversarial_st(27, T, g)
        for C, order in ((0, cs.ST_ORDER), (cs.ST_CHANGEPOINTS, cs.ST_ORDER), (24, 3)):
            D = 2 + C + 2 * order
            beta, preds = torch.empty(27, D), torch.empty(27, T)
            rc = lib.fm_st_fit(*(ptr(t) for t in a), order, C, 1e-4, 3e-3, 3, 27, T, ptr(beta),
                               ptr(preds), None, None)
            try:
                cs.check(rc == 0, f"the parent's st_fit returned {rc}")
                e, _ = cs.compare_st_fit(a, kernels.st_fit(*a, order, C, 1e-4, 3e-3, 3),
                                         (beta, preds), D)
                print(f"ok   st_fit T={T} C={C} order={order} against the parent's: preds "
                      f"|err| {e:.3g}", flush=True)
            except AssertionError as err:
                print(f"FAIL st_fit T={T} C={C} order={order} against the parent's: {err}",
                      flush=True)
                failures += 1
    # kernel K, the parent's against this tree's paths: err and z bit for
    # bit, the parent's library run through this tree's launcher
    kbuild._declare(_Present(lib))
    for J, K, W, F, H, Z in ((3, 10, 32, 4, 32, 16), (4, 2, 6, 4, 32, 16), (2, 7, 6, 3, 72, 8),
                             (3, 3, 6, 17, 32, 16)):
        p, x, m, mu, sigma = cs.adversarial_lstm(J, max(K, 2), F, H, Z, g)
        x, m = x[:, :K, :W].contiguous(), m[:, :K, :W].contiguous()
        mine = kbuild.library
        kbuild.library = lambda: lib
        try:
            err, z = kernels.lstm_ae(p, x, m, H, Z, mu, sigma)
        finally:
            kbuild.library = mine
        ours = kernels.lstm_ae(p, x, m, H, Z, mu, sigma)
        ok = all(torch.equal(_bits(u), _bits(v)) for u, v in zip(ours, (err, z)))
        print(f"{'ok  ' if ok else 'FAIL'} lstm_ae J={J} K={K} W={W} F={F} H={H} Z={Z} "
              f"({kernels.lstm_ae_path(K, F, H, Z, W)} path) against the parent's: err, z bit "
              f"for bit", flush=True)
        failures += not ok
    failures += parent_check_f_i(lib, parent, g)
    failures += parent_check_a_n(lib)
    cs.DEV = saved_dev
    return failures


def parent_check_a_n(lib) -> int:
    """Kernels A and N of the parent's library `lib` (its CTA entries,
    through this tree's launchers with path="cta" where T allows, else its
    scratch path) against this tree's path for T: every output bit for bit,
    at T across the warp path's range (and its key and register counts) and
    beyond it. Returns the failures."""
    import chip_smoke as cs
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.parallel import fleet as fl

    kw = dict(wilcoxon_table=pw.wilcoxon_pmf_table("cpu"), ks_exact_max=pw.KS_EXACT_MAX_T,
              wilcoxon_exact_max_n=pw.WILCOXON_EXACT_MAX_N)
    failures = 0
    for T, B in ((7, 17), (16, 17), (33, 17), (100, 17), (128, 17), (256, 9), (300, 9)):
        rng = np.random.default_rng(100 + T)
        a = fl.pair_args_from_numpy(cs.adversarial_pairs(B, T, rng), "cpu")
        n = [torch.from_numpy(v) for v in cs.adversarial_tests(B, T, rng)]
        ours = kernels.pair_verdict(*a, **kw)
        ours_n = {m: kernels.pair_tests(*n, m, **kw) for m in (15, 1, 4, 8, 31)}
        mine = kbuild.library
        kbuild.library = lambda: lib
        try:
            theirs = kernels.pair_verdict(*a, **kw, path="cta")
            theirs_n = {m: kernels.pair_tests(*n, m, **kw, path="cta") for m in ours_n}
        finally:
            kbuild.library = mine
        ok = all(cs.same_bits(ours[k], theirs[k]) for k in ours)
        print(f"{'ok  ' if ok else 'FAIL'} pair_verdict T={T} ({kernels.pair_path(T)} path) "
              f"against the parent's: every output bit for bit", flush=True)
        failures += not ok
        ok = all(cs.same_bits(u, v) for m in ours_n for u, v in zip(ours_n[m], theirs_n[m]))
        print(f"{'ok  ' if ok else 'FAIL'} pair_tests T={T} masks {sorted(ours_n)} against the "
              f"parent's: stat and p bit for bit", flush=True)
        failures += not ok
    return failures


def _same(a, b) -> bool:
    """Equal bit for bit, NaN payloads aside (the card's NaN is canonical)."""
    nan = torch.isnan(a.float()) & torch.isnan(b.float())
    return bool(torch.equal(_bits(a)[~nan], _bits(b)[~nan]))


def parent_check_f_i(lib, parent, g) -> int:
    """Kernels F and I of the parent's library `lib` (their C entries as
    the parent declares them, without the clock stamps) against this
    tree's: F's periods and scores on adversarial and edge rows with the
    engine's and forty candidates, I's outputs at each T of its depths
    with both entries, on rows with non-finite and overflowing values,
    all bit for bit. Returns the failures."""
    import chip_smoke as cs

    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # a parent with the clock stamps takes one more pointer before the stream
    csrc = os.path.join(parent, "foremast_tpu_torch", "csrc")
    stamped = {k: "long long* clocks" in open(os.path.join(csrc, k + ".cu")).read()
               for k in ("period", "hpa")}
    clk = {k: [None] if v else [] for k, v in stamped.items()}
    lib.fm_detect_period.argtypes = ([P_, P_, P_, I_, P_, F_, F_, F_, I_, I_, P_, P_]
                                     + [P_] * len(clk["period"]) + [P_])
    lib.fm_hpa_scores.argtypes = [P_] * 14 + [I_, I_] + [P_] * (11 + len(clk["hpa"])) + [P_]
    lib.fm_hpa_from_preds.argtypes = [P_] * 13 + [I_, I_] + [P_] * (12 + len(clk["hpa"])) + [P_]

    def ptr(t):
        return None if t is None else ctypes.c_void_p(t.data_ptr())

    failures = 0
    for T, B, edge in ((301, 24, False), (300, 24, True), (2000, 9, True)):
        if edge:
            x, hist, cands = cs.period_edge_rows(B, T, g)
            sets = (cands, (2, 3, 24) + cs.PERIOD_CANDIDATES)
        else:
            x, m, region = cs.adversarial_series(B, T, g)[:3]
            hist = (m & ~region).contiguous()
            sets = ((2, 3, 24) + cs.PERIOD_CANDIDATES, cs.MANY_CANDIDATES)
        for cands in sets:
            C = len(cands)
            candt = torch.tensor(cands, dtype=torch.int32)
            fb = torch.full((B,), 7, dtype=torch.int32)
            per, sc = torch.empty(B, dtype=torch.int32), torch.empty(B, C)
            rc = lib.fm_detect_period(ptr(x), ptr(hist), ptr(candt), C, ptr(fb), 0.2, 0.05, 0.01,
                                      B, T, ptr(per), ptr(sc), *clk["period"], None)
            kp, ks = kernels.detect_period(x, hist, candt, fb, 0.2, 0.05, 0.01)
            ok = rc == 0 and torch.equal(kp, per) and _same(ks, sc)
            print(f"{'ok  ' if ok else 'FAIL'} detect_period T={T} C={C}{' edge rows' if edge else ''} "
                  f"against the parent's: periods and scores bit for bit", flush=True)
            failures += not ok
    for T, B in ((100, 32), (2048, 16), (16384, 5)):
        a = cs.hpa_edge_rows(B, T, g)
        s = [ptr(a[k]) for k in ("tps", "tps_mask", "region", "tps_pred")]
        rest = [ptr(a[k]) for k in ("sla", "sla_mask", "sla_static_limit", "sla_mode", "threshold")]
        for sigma in (True, False):
            for optional in (True, False):
                kw = {k: a[k] for k in cs.HPA_OPTIONAL} if optional else {}
                opt = [ptr(kw.get(k)) for k in cs.HPA_OPTIONAL]
                ref = {k: torch.empty(B, dtype=torch.int32 if k == "reason" else torch.float32)
                       for k in kernels.HPA_OUTPUTS}
                outs = [ptr(ref[k]) for k in kernels.HPA_OUTPUTS]
                if sigma:
                    kw["tps_sigma"] = a["tps_sigma"]
                    rc = lib.fm_hpa_scores(*s, ptr(a["tps_sigma"]), *rest, *opt, B, T, *outs,
                                           *clk["hpa"], None)
                else:
                    ref["tps_sigma"] = torch.empty(B)
                    rc = lib.fm_hpa_from_preds(*s, *rest, *opt, B, T, *outs, ptr(ref["tps_sigma"]),
                                               *clk["hpa"], None)
                ours = kernels.hpa_score(*cs.hpa_series(a), **kw)
                ok = rc == 0 and all(_same(ours[k], ref[k]) for k in ref)
                print(f"{'ok  ' if ok else 'FAIL'} hpa_score T={T} sigma "
                      f"{'given' if sigma else 'computed'}, optional arguments "
                      f"{'given' if optional else 'left out'} against the parent's: every output "
                      f"bit for bit", flush=True)
                failures += not ok
    return failures


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
    for kind, params in ((1, (al,)), (2, (al, be))):
        e = _err(kernels.smooth(kind, x, m, *params), fc.smooth_plain(kind, x, m, *params))
        expect(f"smooth {kind}", e == 0.0, f"max |err| {e:.3g} (same float32 steps)")
    # Holt-Winters against the twin, with rings of the largest period and of
    # T (the same bits); the last 40 steps masked on every row (the
    # all-masked tiles' walk)
    mt = m.clone()
    mt[:, T - 40:] = False
    for mm, what in ((m, ""), (mt, ", trailing gap")):
        hw = kernels.smooth(3, x, mm, al, be, ga, per)
        e = _err(hw, fc.smooth_plain(3, x, mm, al, be, ga, per))
        expect(f"smooth 3{what}", e == 0.0, f"max |err| {e:.3g} (same float32 steps)")
        longer = kernels.smooth(3, x, mm, al, be, ga, per, max_period=T)
        expect(f"smooth 3{what}, rings of T", torch.equal(_bits(hw), _bits(longer)),
               "bit for bit")
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
        # the cta path, and clusters of two and (slices of a quarter row) of four
        for path, slice_t in (("cta", kernels.BI_SLICE_T), ("cluster", kernels.BI_SLICE_T),
                              ("cluster", -(-T // 4))):
            a = cs.adversarial_bivariate(48, T, g)
            saved_slice = kernels.BI_SLICE_T
            kernels.BIVARIATE_FORCE, kernels.BI_SLICE_T = path, slice_t
            name = f"bivariate T={T}, {kernels.bivariate_cluster(T, path)} CTA a row"
            try:
                e, bracketed = cs.compare_bivariate(a, kernels.bivariate(*a),
                                                    bv.bivariate_normal_anomalies_plain(*a))
                expect(name, True,
                       f"bands |err| {e:.3g}, {bracketed} rows bracketed at the ellipse's edge")
            except AssertionError as e:
                expect(name, False, str(e))
            finally:
                kernels.BIVARIATE_FORCE, kernels.BI_SLICE_T = None, saved_slice
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

    # kernel J at each float64 MMA shape; T = 301 is no multiple of 4 or of
    # a warp's 32 slots; D = 32 (C = 24) and D = 2 (C = 0, order 0); the
    # adversarial rows include one with no selected slot
    for T in (128, 301):
        a = cs.adversarial_st(27, T, g)
        for C, order in ((0, cs.ST_ORDER), (cs.ST_CHANGEPOINTS, cs.ST_ORDER), (24, 3), (0, 0)):
            name = f"st_fit T={T} C={C} order={order}"
            try:
                kern = kernels.st_fit(*a, order, C, 1e-4, 3e-3, 3)
                e, ill = cs.compare_st_fit(a, kern, fc.fit_seasonal_trend_plain(
                    *a, order, 1e-4, C, 3e-3, 3), 2 + C + 2 * order)
                again = kernels.st_fit(*a, order, C, 1e-4, 3e-3, 3)
                cs.check(all(torch.equal(u, v) for u, v in zip(kern, again)), "two runs differ")
                expect(name, True, f"preds |err| {e:.3g}, {ill} rows ill-posed, two runs equal")
            except AssertionError as e:
                expect(name, False, str(e))
    # kernel K: each path that serves a shape against the twin, the paths
    # equal to the wide path's bits (cs.lstm_ae_paths_agree); K = 10 is two
    # of the wide path's CTAs a job and no whole number of warp groups; then
    # shorter windows: one job of many windows (chunks of four groups), two
    # windows a group (F = 9), none on the warp path (F = 17), clusters of
    # three CTAs with rows past the registers' 64 (H = 72, and H = 65: one
    # odd row) and of eight (H = 256)
    for (J, K, W, F, H, Z) in ([(3, 10, 32) + w for w in cs.LSTM_WIDTHS]
                               + [(1, 40, 6, 4, 32, 16), (4, 2, 6, 4, 32, 16),
                                  (4, 1, 6, 4, 32, 16), (4, 5, 6, 2, 10, 6),
                                  (3, 3, 6, 9, 32, 16), (3, 3, 6, 17, 32, 16),
                                  (2, 7, 6, 3, 72, 8), (2, 3, 5, 3, 65, 8),
                                  (2, 2, 3, 4, 256, 16)]):
        p, x, m, mu, sigma = cs.adversarial_lstm(J, max(K, 2), F, H, Z, g)
        x, m = x[:, :K, :W].contiguous(), m[:, :K, :W].contiguous()
        name = f"lstm_ae J={J} K={K} W={W} F={F} H={H} Z={Z}"
        try:
            e, paths = cs.lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma)
            expect(name, True, f"err |err| {e:.3g}; paths {', '.join(paths)} equal bit for bit")
        except AssertionError as e:
            expect(name, False, str(e))
    # kernel L: two forward window blocks a job; K = 11 is no whole number
    # of the recurrence's window blocks (16 at H <= 32, 8 at H = 40, whose
    # groups are two warps joined by a named barrier); the recurrent weights
    # in shared memory and, under a 1 KB budget, read from device memory; at
    # H = 10 the GEMM stages its rows by 4-byte copies
    saved_budget = kernels.LSTM_TRAIN_SMEM_BYTES
    for (F, H, Z, K, W), budget in (((3, 8, 4, 11, 8), saved_budget),
                                    ((4, 16, 8, 11, 8), 1024), ((4, 40, 8, 11, 5), saved_budget),
                                    ((4, 40, 8, 6, 5), 1024), ((2, 8, 4, 3, 1), saved_budget),
                                    ((2, 10, 6, 5, 4), saved_budget)):
        name = f"lstm_train and adam F={F} H={H} Z={Z} K={K} W={W} budget {budget}"
        kernels.LSTM_TRAIN_SMEM_BYTES = budget
        p, x, m = cs.adversarial_lstm_train(4, K, W, F, H, Z, g)
        try:
            kern = tl.LstmAeLoss.apply(p.clone().requires_grad_(True), x, m, H, Z)
            q = p.clone().requires_grad_(True)
            pl = tl.loss_plain(q, x, m, H, Z)
            pg, = torch.autograd.grad(pl.sum(), q)
            kg, = torch.autograd.grad(tl.LstmAeLoss.apply(q, x, m, H, Z).sum(), q)
            e = cs.compare_lstm_train((kern.detach(), kg), (pl.detach(), pg))
            num, cnt, act = kernels.lstm_train_forward(p, x, m, H, Z)
            gpart = cs.lstm_backward_twice(p, x, m, act, H, Z)
            step = torch.tensor([1, 2, 30, 400], dtype=torch.int32)
            cs.compare_adam(p, 1e-3 * torch.randn(p.shape, generator=g),
                            1e-6 * torch.rand(p.shape, generator=g), step, gpart, num, cnt)
            expect(name, True, f"grad |err| {e:.3g}, backward twice equal, adam bit for bit")
        except AssertionError as e:
            expect(name, False, str(e))
    kernels.LSTM_TRAIN_SMEM_BYTES = saved_budget
    # kernel L's forward: the tile path (a job's windows a CTA) against the
    # wide path (8 windows a CTA, the parent design), bit for bit; K = 1,
    # K = 45 (the engine's) and F = 8
    for F, H, Z, K, W in ((4, 32, 16, 45, 3), (4, 32, 16, 1, 4), (8, 32, 16, 9, 4),
                          (2, 10, 6, 5, 4), (4, 40, 8, 11, 5)):
        p, x, m = cs.adversarial_lstm_train(3, max(K, 2), W, F, H, Z, g)
        x, m = x[:, :K].contiguous(), m[:, :K].contiguous()
        name = f"lstm_train_forward tile path F={F} H={H} Z={Z} K={K} W={W}"
        saved_fwd = kernels.LSTM_FORWARD_SMEM_BYTES
        tile = kernels.lstm_train_forward(p, x, m, H, Z)
        kernels.LSTM_FORWARD_SMEM_BYTES = 0
        wide = kernels.lstm_train_forward(p, x, m, H, Z)
        kernels.LSTM_FORWARD_SMEM_BYTES = saved_fwd
        same = all(torch.equal(_bits(u), _bits(v)) for u, v in zip(tile, wide))
        expect(name, same, "num, cnt and act equal to the wide path's bit for bit")
    # kernel M on one gradient block and six count blocks, rows of P = 959
    # (scalar entries) and 1,032 floats (four a thread)
    for F, H, Z in ((3, 8, 4), (4, 8, 4)):
        P, J = tl.param_count(F, H, Z), 5
        cnt = torch.randint(0, 40, (J, 6), generator=g).double()
        cnt[0] = 0
        try:
            cs.compare_adam(torch.randn(J, P, generator=g), 1e-3 * torch.randn(J, P, generator=g),
                            1e-6 * torch.rand(J, P, generator=g),
                            torch.tensor([1, 2, 30, 400, 2900], dtype=torch.int32),
                            torch.randn(J, 1, P, generator=g),
                            10 * torch.rand(J, 6, dtype=torch.float64, generator=g), cnt)
            expect(f"adam P={P}", True, "bit for bit")
        except AssertionError as e:
            expect(f"adam P={P}", False, str(e))
    cs.DEV = saved_dev
    # kernel F's edge rows (spans ending early, all padding, non-finite
    # values, constant spans), rows of 2,100 slots with MAX_CANDIDATES
    # candidates (1,536 lags in batches), T = 100 (part of a warp past T)
    cs.DEV = "cpu"
    for T, B in ((100, 16), (300, 24)):
        x_e, h_e, c_e = cs.period_edge_rows(B, T, g)
        fb_e = torch.full((B,), 7, dtype=torch.int32)
        try:
            e, near = cs.compare_detect_period(x_e, h_e, c_e, fb_e, kernels.detect_period(
                x_e, h_e, torch.tensor(c_e, dtype=torch.int32), fb_e, 0.2, 0.05, 0.01))
            expect(f"detect_period edge rows T={T}", True, f"scores |err| {e:.3g}, {near} bracketed")
        except AssertionError as err:
            expect(f"detect_period edge rows T={T}", False, str(err))
    x_l, m_l, r_l = cs.adversarial_series(2, 2100, g)[:3]
    m_l = (m_l & ~r_l).contiguous()
    c_l = tuple(range(2, 2 + kernels.MAX_CANDIDATES))
    try:
        e, near = cs.compare_detect_period(x_l, m_l, c_l, fb[:2], kernels.detect_period(
            x_l, m_l, torch.tensor(c_l, dtype=torch.int32), fb[:2], 0.2, 0.05, 0.01))
        expect("detect_period MAX_CANDIDATES", True, f"scores |err| {e:.3g}")
    except AssertionError as err:
        expect("detect_period MAX_CANDIDATES", False, str(err))
    # kernel I's edge rows at each depth of its loads (T = 100, 2048: two
    # slots a thread; 16384: four)
    for T, B in ((100, 32), (2048, 16), (16384, 5)):
        a_e = cs.hpa_edge_rows(B, T, g)
        for sigma in (True, False):
            kw = {k: a_e[k] for k in cs.HPA_OPTIONAL}
            if sigma:
                kw["tps_sigma"] = a_e["tps_sigma"]
            name = f"hpa_score edge rows T={T} sigma {'given' if sigma else 'computed'}"
            try:
                errs, bracketed = cs.compare_hpa(a_e, kernels.hpa_score(*cs.hpa_series(a_e), **kw),
                                                 sigma)
                expect(name, True, f"score |err| {errs['score']:.3g}, {bracketed} bracketed")
            except AssertionError as err:
                expect(name, False, str(err))
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
    pair_paths_check(cs, expect)
    new_kernels_check(cs, expect)
    kernels.SCRATCH_BYTES = saved
    return len(failures)


def pair_paths_check(cs, expect) -> None:
    """Kernels A and N's warp path (a warp a pair, the last CTA's tail
    warps idle) against their twins and against the cta path bit for bit,
    at T on each side of its key and register counts."""
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.parallel import fleet as fl

    kw = dict(wilcoxon_table=pw.wilcoxon_pmf_table("cpu"), ks_exact_max=pw.KS_EXACT_MAX_T,
              wilcoxon_exact_max_n=pw.WILCOXON_EXACT_MAX_N)
    saved_dev, cs.DEV = cs.DEV, "cpu"
    for T in (5, 16, 17, 64, 100, 128, 256):
        B = 17  # every kind of adversarial row twice, and one CTA of a single pair
        rng = np.random.default_rng(T)
        a = fl.pair_args_from_numpy(cs.adversarial_pairs(B, T, rng), "cpu")
        try:
            warp = kernels.pair_verdict(*a, **kw, path="warp")
            e, _ = cs.compare_pair_verdict(a, warp, fl.pair_verdict_plain(*a))
            cta = kernels.pair_verdict(*a, **kw, path="cta")
            cs.check(all(cs.same_bits(warp[k], cta[k]) for k in cta),
                     "the warp path's outputs differ from the cta path's")
            expect(f"pair_verdict warp path T={T}", True,
                   f"max |dp| {e:.3g} against the twin, all 7 outputs equal to the cta path's")
        except AssertionError as err:
            expect(f"pair_verdict warp path T={T}", False, str(err))
        x, xm, y, ym = (torch.from_numpy(v) for v in cs.adversarial_tests(B, T, rng))
        plain = pw.two_sample_tests_plain(x, xm, y, ym)
        plain["sign"] = pw.sign_test_exact_plain(x, y, xm & ym)
        try:
            e = cs.compare_pair_tests(kernels.pair_tests(x, xm, y, ym, 31, **kw, path="warp"),
                                      plain, pw.TWO_SAMPLE_TESTS + ("sign",))
            for mask in (1, 2, 4, 8, 16, 5, 15, 26, 31):
                w = kernels.pair_tests(x, xm, y, ym, mask, **kw, path="warp")
                c = kernels.pair_tests(x, xm, y, ym, mask, **kw, path="cta")
                cs.check(all(cs.same_bits(u, v) for u, v in zip(w, c)),
                         f"mask {mask}: the warp path's stat or p differ from the cta path's")
            expect(f"pair_tests warp path T={T}", True,
                   f"max |dp| {e:.3g} against the twin, 9 masks equal to the cta path's")
        except AssertionError as err:
            expect(f"pair_tests warp path T={T}", False, str(err))
    cs.DEV = saved_dev


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
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="also hold kernels A, N, K, L's forward, J, F and I against those of "
                         "the checkout in DIR (e.g. a git archive of the parent commit)")
    opt = ap.parse_args()
    install()
    bad = self_check()
    if opt.parent:
        bad += parent_check(opt.parent)
    sys.exit(1 if bad else 0)
