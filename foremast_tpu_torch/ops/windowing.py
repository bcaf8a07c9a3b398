"""Ragged time-series -> fixed, masked (B, T) arrays (host side, numpy).

A copy of the reference's packers, kept here because the reference's module
is reachable only through a package that imports JAX. Everything downstream
of `resample_to_grid` is dense arrays plus bool masks; nothing downstream
filters. The reference also has a native resampler for long series; this
copy keeps the numpy path, which gives the same grid.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

__all__ = [
    "Window",
    "resample_to_grid",
    "pack_windows",
    "align_step",
    "bucket_length",
    "MAX_WINDOW_STEPS",
]

DEFAULT_STEP = 60  # seconds


def align_step(t: float, step: int = DEFAULT_STEP) -> int:
    """Floor-align a unix timestamp to the step boundary."""
    return int(t) // step * step


@dataclass
class Window:
    """One metric window on the fixed grid."""

    values: np.ndarray  # (T,) float32
    mask: np.ndarray  # (T,) bool
    start: int  # aligned unix seconds
    step: int = DEFAULT_STEP

    @property
    def n_valid(self) -> int:
        return int(self.mask.sum())


def resample_to_grid(
    timestamps: Sequence[float],
    values: Sequence[float],
    start: float,
    end: float,
    step: int = DEFAULT_STEP,
) -> Window:
    """Snap (ts, value) samples onto the [start, end) grid at `step` resolution.

    Samples round to the nearest slot; out-of-range samples and values that
    are not finite in float32 are dropped (masked); later samples win a slot.
    A mismatched (ts, values) pair degrades to the overlapping prefix. The
    window's length is fixed by (start, end, step), never by the data.
    """
    start = align_step(start, step)
    end = align_step(end + step - 1, step)
    ts = np.asarray(timestamps, dtype=np.float64)
    vs = np.asarray(values, dtype=np.float64)
    if ts.shape != vs.shape:
        n = min(ts.size, vs.size)
        ts, vs = ts[:n], vs[:n]
    if vs.size:
        # finiteness is judged at the storage dtype: 1e39 is f64-finite but
        # casts to f32 inf
        with np.errstate(over="ignore"):
            vs = np.where(np.isfinite(vs.astype(np.float32)), vs, np.nan)
    T = max(1, (end - start) // step)
    vals = np.zeros(T, dtype=np.float32)
    mask = np.zeros(T, dtype=bool)
    if ts.size:
        finite = np.isfinite(vs) & np.isfinite(ts)
        ts, vs = ts[finite], vs[finite]
        keep = (ts >= start) & (ts < end)  # in range by timestamp, not slot
        ts, vs = ts[keep], vs[keep]
        idx = np.clip(np.round((ts - start) / step).astype(np.int64), 0, T - 1)
        vals[idx] = vs.astype(np.float32)
        mask[idx] = True
    return Window(values=vals, mask=mask, start=start, step=step)


_BUCKETS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)

MAX_WINDOW_STEPS = _BUCKETS[-1]


def bucket_length(T: int) -> int:
    """Smallest padded length bucket >= T (16 .. 16384, powers of two)."""
    for b in _BUCKETS:
        if T <= b:
            return b
    raise ValueError(f"window length {T} exceeds max bucket {_BUCKETS[-1]}")


def pack_windows(windows: Sequence[Window], pad_to: int | None = None):
    """Pack windows into dense (B, T) value/mask arrays, right-padded.

    Returns (values (B,T) float32, mask (B,T) bool). T is the bucket of the
    longest member unless `pad_to` pins it.
    """
    if not windows:
        raise ValueError("no windows to pack")
    longest = max(w.values.shape[0] for w in windows)
    T = pad_to or bucket_length(longest)
    if longest > T:
        raise ValueError(
            f"window of length {longest} does not fit pad_to={T}; "
            "truncating would silently drop the most recent samples"
        )
    B = len(windows)
    vals = np.zeros((B, T), dtype=np.float32)
    mask = np.zeros((B, T), dtype=bool)
    for i, w in enumerate(windows):
        n = w.values.shape[0]
        vals[i, :n] = w.values
        mask[i, :n] = w.mask
    return vals, mask
