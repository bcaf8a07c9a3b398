"""ctypes loader for the native data-plane extension (C++, no pybind11).

The port's own copy of the reference's host parser (``src/`` is a copy of
its source): a single-pass scanner of metric-store response bodies and a
grid resampler, run on the host, not on the card. Build-on-first-use: if
the shared library is absent and a C++ toolchain is available, it is
compiled once (g++ -O3, ~1 s) into ``build/foremast_tpu_torch/native/``
beside the package, named by a hash of the source and flags, and cached.
Every entry point degrades to ``None`` when the library is unavailable so
callers keep their pure-Python fallbacks (same results; the port's tests
pin the parity) — the extension is an accelerator, never a dependency.
Disable with FOREMAST_NATIVE=0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..utils import knobs

__all__ = ["available", "parse_series", "parse_grid", "resample",
           "render_matrix", "lib_path"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "foremast_native.cpp")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "foremast_tpu_torch", "native")


def _default_so() -> str:
    """build/foremast_tpu_torch/native/<hash of compiler and source>/..."""
    h = hashlib.sha256(knobs.read("CXX").encode())
    try:
        with open(_SRC, "rb") as f:
            h.update(f.read())
    except OSError:
        pass
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16], "foremast_native.so")


# the cached artifact under build/, named at import
_SO = _default_so()

_lock = threading.Lock()
_lib = None
_state = "unloaded"  # unloaded | ready | failed

FLAVOR_PROMETHEUS = 0
FLAVOR_WAVEFRONT = 1


def lib_path() -> str:
    return _SO


def _build() -> bool:
    tmp = f"{_SO}.tmp{os.getpid()}"
    cmd = [knobs.read("CXX"), "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp]
    try:
        os.makedirs(os.path.dirname(_SO), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _state
    # lock-free fast path: after the first load, every parse/resample call
    # lands here — taking _lock each time serializes the fetch pool's
    # threads on a hot mutex for no reason (double-checked locking; the
    # GIL makes the two reads atomic, and _state is written last)
    if _state == "ready":
        return _lib
    if _state == "failed":
        return None
    with _lock:
        if _state != "unloaded":
            return _lib
        # outcome is decided before _state leaves "unloaded" (the finally
        # below), so lock-free readers either see a final state or block
        # here behind the loading thread — never a transient "failed"
        try:
            return _try_load()
        finally:
            if _state == "unloaded":
                _state = "failed"


def _try_load():
    global _lib, _state
    if not knobs.read("FOREMAST_NATIVE"):
        return None
    # the path is named by the source's hash: a changed source builds
    # anew, an unchanged one loads at once
    if not os.path.exists(_SO) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
        _bind(lib)
    except OSError:
        return None
    _lib = lib
    _state = "ready"
    return _lib


def _bind(lib):
    lib.fm_parse_series.restype = ctypes.c_int
    lib.fm_parse_series.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.fm_resample.restype = None
    lib.fm_resample.argtypes = [
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.fm_parse_grid.restype = ctypes.c_long
    lib.fm_parse_grid.argtypes = [
        ctypes.c_char_p,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.c_long,
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_long),
    ]
    lib.fm_render_matrix.restype = ctypes.c_long
    lib.fm_render_matrix.argtypes = [
        ctypes.c_long,
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_long,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
        ctypes.c_long,
    ]
    lib.fm_free.restype = None
    lib.fm_free.argtypes = [ctypes.c_void_p]


def available() -> bool:
    return _load() is not None


def parse_series(buf: bytes, flavor: int):
    """Parse a metric-store response body -> (ts, vals) float64 arrays,
    duplicate timestamps averaged. None = unavailable/malformed (caller
    falls back to the Python parser)."""
    lib = _load()
    if lib is None:
        return None
    ts_p = ctypes.POINTER(ctypes.c_double)()
    val_p = ctypes.POINTER(ctypes.c_double)()
    n = ctypes.c_long()
    rc = lib.fm_parse_series(
        buf, len(buf), flavor, ctypes.byref(ts_p), ctypes.byref(val_p),
        ctypes.byref(n),
    )
    if rc != 0:
        return None
    try:
        count = n.value
        ts = np.ctypeslib.as_array(ts_p, shape=(max(count, 1),))[:count].copy()
        vals = np.ctypeslib.as_array(val_p, shape=(max(count, 1),))[:count].copy()
    finally:
        lib.fm_free(ts_p)
        lib.fm_free(val_p)
    return ts, vals


def parse_grid(buf: bytes, flavor: int, step: int = 60,
               max_steps: int = 16384):
    """Fused parse+grid: response bytes -> (values f32, mask bool, start)
    in one native call — the window the engine would build from
    parse_series + the align/clamp/resample steps, without intermediate
    arrays crossing the ctypes boundary. Returns None when the library is
    unavailable or the body is malformed (caller falls back to the
    parse_series / Python path); an empty-but-valid body yields the
    1-slot empty window the engine uses as its "no data" marker."""
    lib = _load()
    if lib is None:
        return None
    out_vals = np.empty(max_steps, np.float32)
    out_mask = np.empty(max_steps, np.uint8)
    start = ctypes.c_long()
    T = lib.fm_parse_grid(
        buf, len(buf), flavor, step, max_steps, out_vals, out_mask,
        ctypes.byref(start),
    )
    if T < 0:
        return None
    if T == 0:
        return np.zeros(1, np.float32), np.zeros(1, bool), 0
    return out_vals[:T].copy(), out_mask[:T].astype(bool), int(start.value)


def render_matrix(ts0: int, step: int, vals) -> bytes | None:
    """Serialize grid samples into the query_range matrix `values`
    payload `[ts,"v"],...` (4-decimal fixed precision) in one native
    call — the render twin of parse_grid, for in-process metric backends
    (simfleet) whose Python f-string join dominated serving at
    fleet-scale warm fetches. Byte-identical to the Python fallback
    (glibc %.4f and Python's fixed-precision format are both correctly
    rounded). None = library unavailable or buffer overflow (caller
    falls back to the Python join)."""
    lib = _load()
    if lib is None:
        return None
    vals = np.ascontiguousarray(vals, np.float64)
    n = vals.shape[0]
    if n == 0:
        return b""
    cap = 48 * n + 64
    out = np.empty(cap, np.uint8)
    w = lib.fm_render_matrix(ts0, step, vals, n, out, cap)
    if w < 0:
        return None
    return out[:w].tobytes()


def resample(ts, vals, start: int, end: int, step: int):
    """Grid-resample (ts, vals) onto [start, end) — native twin of
    ops.windowing.resample_to_grid's inner loop. None = unavailable."""
    lib = _load()
    if lib is None:
        return None
    ts = np.ascontiguousarray(ts, np.float64)
    vals = np.ascontiguousarray(vals, np.float64)
    T = max(1, (end - start) // step)
    out_vals = np.zeros(T, np.float32)
    out_mask = np.zeros(T, np.uint8)
    lib.fm_resample(ts, vals, len(ts), start, end, step, out_vals, out_mask)
    return out_vals, out_mask.astype(bool)
