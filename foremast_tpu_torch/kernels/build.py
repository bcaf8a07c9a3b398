"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/*.cu`` compiles to an object for sm_90a, all in parallel, and
the objects link into one shared library with a plain C interface. The
library lands in ``build/foremast_tpu_torch/<hash>/`` beside the package,
named by a hash of the sources and flags, so a changed source rebuilds and
an unchanged one loads at once. Nothing is built at import: the first
launch builds. A failed build raises.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "foremast_tpu_torch")

# -fmad=false: every float32 expression rounds as the plain twin's does
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# builds of the library in this process (compile + link; a load of an
# already-built library does not count)
builds = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _sources():
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return cu, headers


def library_path() -> str:
    cu, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + headers:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "libforemast_kernels.so")


def build() -> str:
    """Compile and link the library if it is not built yet; return its path.

    The compiler's output, ptxas' register and shared-memory report
    included, is kept in build.log beside the library.
    """
    global builds
    out = library_path()
    if os.path.exists(out):
        return out
    d = os.path.dirname(out)
    os.makedirs(d, exist_ok=True)
    cu, _ = _sources()
    exe = nvcc()
    procs = []
    for src in cu:
        obj = os.path.join(d, os.path.basename(src) + ".o")
        cmd = [exe, *NVCC_FLAGS, "-c", src, "-o", obj]
        procs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for cmd, obj, p in procs:
        text, _ = p.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        objs.append(obj)
        if p.returncode != 0:
            failed.append(obj)
    if not failed:
        tmp = out + f".tmp{os.getpid()}"
        cmd = [exe, *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs]
        p = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(" ".join(cmd) + "\n" + p.stdout)
        if p.returncode != 0:
            failed.append(out)
    with open(os.path.join(d, "build.log"), "w") as f:
        f.write("\n".join(log))
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(log))
    os.replace(tmp, out)
    builds += 1
    return out


def build_log() -> str:
    with open(os.path.join(os.path.dirname(library_path()), "build.log")) as f:
        return f.read()


def _declare(lib):
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    LL = ctypes.c_longlong
    lib.fm_pair_verdict.argtypes = ([P] * 12 + [I, P, I, I, I, I] + [P] * 7
                                    + [P, P, LL, I, P])
    lib.fm_pair_verdict.restype = I
    lib.fm_pair_verdict_scratch_stride.argtypes = [I]
    lib.fm_pair_verdict_scratch_stride.restype = LL
    lib.fm_pair_verdict_warp.argtypes = ([P] * 12 + [I, P, I, I, I, I] + [P] * 7
                                         + [P, P, I, P])
    lib.fm_lgamma_table.argtypes = [P, P]
    lib.fm_lgamma_table.restype = I
    lib.fm_lgamma_table_size.argtypes = []
    lib.fm_lgamma_table_size.restype = I
    lib.fm_pair_verdict_warp.restype = I
    lib.fm_pair_warps.argtypes = []
    lib.fm_pair_warps.restype = I
    lib.fm_ks_division_check.argtypes = [P, P]
    lib.fm_ks_division_check.restype = I
    lib.fm_ma_band.argtypes = [P, P, P, I, P, P, P, I, I] + [P] * 8 + [P]
    lib.fm_ma_band.restype = I
    lib.fm_band_from_preds.argtypes = [P] * 7 + [I, I] + [P] * 7 + [P]
    lib.fm_band_from_preds.restype = I
    lib.fm_smooth.argtypes = [I] + [P] * 4 + [I, I, I, P, P]
    lib.fm_smooth.restype = I
    lib.fm_smooth_hw.argtypes = [P] * 6 + [I, I, I, P, I, P, P, P]
    lib.fm_smooth_hw.restype = I
    lib.fm_hw_fit.argtypes = [P] * 5 + [I, I, I, P, I, I, P, P, P, P, P]
    lib.fm_hw_fit.restype = I
    lib.fm_hw_fit_ring_row.argtypes = [I]
    lib.fm_hw_fit_ring_row.restype = I
    lib.fm_affine_scan.argtypes = [I, P, P, P, P, I, I, P, P]
    lib.fm_affine_scan.restype = I
    lib.fm_detect_period.argtypes = [P, P, P, I, P, F, F, F, I, I, P, P, P, P]
    lib.fm_detect_period.restype = I
    lib.fm_triage_screen.argtypes = [P] * 7 + [I, I, I] + [P] * 10 + [P]
    lib.fm_triage_screen.restype = I
    lib.fm_bivariate.argtypes = [P] * 10 + [I, I, I] + [P] * 9 + [P, P]
    lib.fm_bivariate.restype = I
    lib.fm_bivariate_smem_bytes.argtypes = [I, I]
    lib.fm_bivariate_smem_bytes.restype = LL
    lib.fm_hpa_scores.argtypes = [P] * 14 + [I, I] + [P] * 11 + [P, P]
    lib.fm_hpa_scores.restype = I
    lib.fm_hpa_from_preds.argtypes = [P] * 13 + [I, I] + [P] * 12 + [P, P]
    lib.fm_hpa_from_preds.restype = I
    D = ctypes.c_double
    lib.fm_st_fit.argtypes = [P] * 4 + [I, I, D, D, I, I, I, P, P, P, P]
    lib.fm_st_fit.restype = I
    lib.fm_st_sincos_check.argtypes = [P, P]
    lib.fm_st_sincos_check.restype = I
    lib.fm_lstm_ae.argtypes = [P, LL, P, P, P, P] + [I] * 10 + [P] * 4
    lib.fm_lstm_ae_warp_smem_bytes.argtypes = [I] * 5
    lib.fm_lstm_ae_warp_smem_bytes.restype = LL
    lib.fm_lstm_ae_cluster_smem_bytes.argtypes = [I] * 6
    lib.fm_lstm_ae_cluster_smem_bytes.restype = LL
    lib.fm_lstm_ae_chunk_windows.argtypes = [I] * 3
    lib.fm_lstm_ae_chunk_windows.restype = I
    lib.fm_lstm_ae.restype = I
    lib.fm_lstm_ae_smem_bytes.argtypes = [I, I, I, I, I]
    lib.fm_lstm_ae_smem_bytes.restype = LL
    lib.fm_lstm_ae_param_count.argtypes = [I, I, I]
    lib.fm_lstm_ae_param_count.restype = LL
    lib.fm_lstm_train_forward.argtypes = [P, LL, P, P] + [I] * 8 + [LL] + [P] * 5
    lib.fm_lstm_train_forward.restype = I
    lib.fm_lstm_train_smem_bytes.argtypes = [I] * 5
    lib.fm_lstm_train_smem_bytes.restype = LL
    lib.fm_lstm_forward_tile_windows.argtypes = [I] * 4
    lib.fm_lstm_forward_tile_windows.restype = I
    lib.fm_lstm_forward_tile_smem_bytes.argtypes = [I] * 4
    lib.fm_lstm_forward_tile_smem_bytes.restype = LL
    lib.fm_lstm_rec_floats.argtypes = [I] * 4
    lib.fm_lstm_rec_floats.restype = I
    lib.fm_lstm_bptt_windows.argtypes = [I, I]
    lib.fm_lstm_bptt_windows.restype = I
    lib.fm_lstm_bptt.argtypes = [P, LL, P, P] + [I] * 6 + [LL] + [P] * 3
    lib.fm_lstm_bptt.restype = I
    lib.fm_lstm_wgrad.argtypes = [P] * 3 + [LL] + [I] * 7 + [P]
    lib.fm_lstm_wgrad.restype = I
    lib.fm_adam.argtypes = [P] * 8 + [LL] + [I] * 4 + [F] * 6 + [P]
    lib.fm_adam.restype = I
    lib.fm_pair_tests.argtypes = [P] * 4 + [I, I, I, P, I, I, P, P, P, LL, I, P]
    lib.fm_pair_tests.restype = I
    lib.fm_pair_tests_scratch_stride.argtypes = [I]
    lib.fm_pair_tests_scratch_stride.restype = LL
    lib.fm_pair_tests_warp.argtypes = [P] * 4 + [I, I, I, P, I, I, P, P, P, P, I, P]
    lib.fm_pair_tests_warp.restype = I
    lib.fm_rank_work_bytes.argtypes = [LL]
    lib.fm_rank_work_bytes.restype = LL
    lib.fm_rank_and_ties.argtypes = [P, P, I, I, P, P, P, P, LL, I, P]
    lib.fm_rank_and_ties.restype = I
    lib.fm_kruskal_groups.argtypes = [P, P, I, I, I, P, P, P, LL, I, P]
    lib.fm_kruskal_groups.restype = I
    lib.fm_friedman.argtypes = [P, P, I, I, I, P, P, P]
    lib.fm_friedman.restype = I
    lib.fm_fleet_topk_scratch_bytes.argtypes = [LL, LL]
    lib.fm_fleet_topk_scratch_bytes.restype = LL
    lib.fm_fleet_topk.argtypes = [P, P, LL, I, I, P, P, P, P, P]
    lib.fm_fleet_topk.restype = I
    lib.fm_error_string.argtypes = [I]
    lib.fm_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        return _lib
