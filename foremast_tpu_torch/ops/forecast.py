"""The moving-average band family (plain PyTorch twins and the entry point).

Counterpart of the subset of the reference's ``ops/forecast.py`` that the
default band algorithm (``moving_average_all``) runs: the causal time-based
moving average, the residual sigma over history, and the band check. All
functions take (B, T) tensors, one series per row.

`moving_average_band` is the entry point. It runs the whole chain
moving average -> residual sigma -> band in one launch of kernel B
(``csrc/ma_band.cu``) on the card, and `moving_average_band_plain`, the
composition of the functions below, on the CPU.

One deliberate difference from the reference: windowed sums are differences
of float64 prefix sums, where the reference differences float32 cumsums. A
constant history therefore predicts its level exactly and keeps sigma = 0,
the semantics the reference documents (its float32 cancellation leaves
sigma ~1e-5 on a constant row at a high level), and a current window equal
to that constant is not flagged.
"""
from __future__ import annotations

import torch

from .. import kernels
from .._device import as_tensor, resolve_device

__all__ = [
    "BOUND_BOTH",
    "BOUND_UPPER",
    "BOUND_LOWER",
    "masked_mean_std",
    "moving_average_predictions",
    "residual_sigma",
    "band_anomalies",
    "moving_average_band",
    "moving_average_band_plain",
]

_F = torch.float32

# ML_BOUND codes as a bitmask: bit0 checks the upper band, bit1 the lower;
# 0 is read as both.
BOUND_UPPER = 1
BOUND_LOWER = 2
BOUND_BOTH = 3


def _hold_last(vals, flags, reverse: bool = False):
    """At each slot, the latest `vals` entry (looking left, or right when
    reverse) at a slot whose flag is set, the slot itself included; where
    none is, the row's edge value (vals[0], or vals[-1] when reverse)."""
    if reverse:
        return torch.flip(_hold_last(torch.flip(vals, (-1,)), torch.flip(flags, (-1,))), (-1,))
    T = vals.shape[-1]
    idx = torch.arange(T, device=vals.device).expand_as(vals)
    src = torch.cummax(torch.where(flags, idx, 0), dim=-1).values
    return torch.gather(vals, -1, src)


def _first_valid(x, mask):
    """(B,) value at the first True of mask (0.0 if none)."""
    held = _hold_last(x.to(_F), mask, reverse=True)
    return torch.where(mask.any(-1), held[:, 0], 0.0)


def masked_mean_std(x, mask):
    """(B,) mean and population std over the masked slots of each row."""
    m = mask.to(_F)
    n = m.sum(-1)
    denom = torch.where(n == 0, 1.0, n)
    mean = torch.sum(x * m, dim=-1) / denom
    var = torch.sum(m * (x - mean[:, None]) ** 2, dim=-1) / denom
    return mean, torch.sqrt(var)


def moving_average_predictions(x, mask, window):
    """Causal rolling mean over the last `window` time slots (valid only).

    preds[t] is the mean of the valid x in slots [t - window, t). window is
    an int or a (B,) tensor; a window below 1 is empty everywhere, as window
    0 is in the reference. Where the window holds no data the prediction
    freezes at the rolling mean just after the last observation; slots
    before the first observation see the first valid value (0.0 for a row
    with none).
    """
    B, T = x.shape
    dev = x.device
    xm = torch.where(mask, x.to(_F), 0.0).double()
    zero = torch.zeros((B, 1), dtype=torch.float64, device=dev)
    S = torch.cat([zero, torch.cumsum(xm, -1)], dim=1)  # S[:, j] = sum over [0, j)
    C = torch.cat([zero, torch.cumsum(mask.double(), -1)], dim=1)
    t = torch.arange(T, device=dev).expand(B, T)
    w = torch.as_tensor(window, device=dev).reshape(-1, 1).to(torch.int64)
    lo = torch.clamp(t - w, min=0)
    lo = torch.minimum(lo, t)
    s = S[:, :-1] - torch.gather(S, 1, lo)
    c = C[:, :-1] - torch.gather(C, 1, lo)
    ma = (s / torch.where(c == 0, 1.0, c)).to(_F)
    defined = c > 0
    # freeze-fill: ma at the slot just after the last observation before t
    idx = torch.where(mask, torch.arange(T, device=dev), -1)
    last_le = torch.cummax(idx, dim=-1).values
    prev_idx = torch.cat([torch.full((B, 1), -1, device=dev), last_le[:, :-1]], dim=1)
    reset = torch.cat([torch.ones((B, 1), dtype=torch.bool, device=dev), mask[:, :-1]], dim=1)
    h = _hold_last(ma, reset)
    first = _first_valid(x, mask)[:, None].expand(B, T)
    filled = torch.where(prev_idx >= 0, h, first)
    return torch.where(defined, ma, filled)


def residual_sigma(x, preds, mask, region_mask):
    """(B,) RMS residual over mask & region_mask; +inf below 2 points (a
    series with no history can never be judged, fail-open). A constant
    history keeps sigma = 0: any deviation from it is anomalous."""
    sel = mask & region_mask
    n = sel.to(_F).sum(-1)
    r = torch.where(sel, x.to(_F) - preds, 0.0)
    sigma = torch.sqrt(torch.sum(r * r, dim=-1) / torch.clamp(n, min=1.0))
    return torch.where(n >= 2.0, sigma, torch.inf)


def band_anomalies(x, mask, region_mask, preds, sigma, threshold, bound_mode,
                   min_lower_bound):
    """Flag the points of the scored region outside preds +- threshold*sigma.

    threshold, bound_mode and min_lower_bound are (B,); the lower band is
    floored at min_lower_bound. Returns upper, lower, flags (B, T), count,
    first_index (-1 if none) and checked (B,), as the reference.
    """
    thr = threshold[:, None] * sigma[:, None]
    upper = preds + thr
    lower = torch.maximum(preds - thr, min_lower_bound[:, None].to(_F))
    mode = bound_mode[:, None]
    mode = torch.where(mode == 0, BOUND_BOTH, mode)
    viol = ((x > upper) & ((mode & 1) > 0)) | ((x < lower) & ((mode & 2) > 0))
    flags = viol & mask & region_mask
    counts = flags.sum(-1, dtype=torch.int32)
    first = torch.where(counts > 0, torch.argmax(flags.to(torch.int32), dim=-1), -1)
    checked = (mask & region_mask).sum(-1, dtype=torch.int32)
    return {
        "upper": upper,
        "lower": lower,
        "flags": flags,
        "count": counts,
        "first_index": first.to(torch.int32),
        "checked": checked,
    }


def moving_average_band_plain(x, mask, region, window, threshold,
                              bound_mode, min_lower_bound):
    """Plain twin of kernel B: the band family's chain under
    moving_average_all. History is mask & ~region; the band judges
    mask & region. window is an int or, as inside score_pairs, a (B,)
    tensor. Returns band_anomalies' dict plus preds and sigma."""
    hist = mask & ~region
    preds = moving_average_predictions(x, hist, window)
    sigma = residual_sigma(x, preds, hist, ~region)
    out = band_anomalies(x, mask, region, preds, sigma, threshold, bound_mode,
                         min_lower_bound)
    out["preds"] = preds
    out["sigma"] = sigma
    return out


def moving_average_band(x, mask, region, window: int, threshold, bound_mode,
                        min_lower_bound, *, device=None):
    """The band family under moving_average_all, one launch for B rows.

    x (B, T) float32, mask and region (B, T) bool, window an int, threshold
    and min_lower_bound (B,) float32, bound_mode (B,) int32. numpy inputs
    move to `device` (default "cuda"); a tensor elsewhere is an error.
    Returns preds, sigma, upper, lower, flags, count, first_index, checked.
    """
    dev = resolve_device(device)
    x = as_tensor(x, torch.float32, dev, "x")
    B, T = x.shape
    mask = as_tensor(mask, torch.bool, dev, "mask", (B, T))
    region = as_tensor(region, torch.bool, dev, "region", (B, T))
    threshold = as_tensor(threshold, torch.float32, dev, "threshold", (B,))
    bound_mode = as_tensor(bound_mode, torch.int32, dev, "bound_mode", (B,))
    min_lower_bound = as_tensor(min_lower_bound, torch.float32, dev, "min_lower_bound", (B,))
    window = int(window)
    if dev.type == "cpu":
        return moving_average_band_plain(x, mask, region, window, threshold,
                                         bound_mode, min_lower_bound)
    return kernels.ma_band(x, mask, region, window, threshold, bound_mode,
                           min_lower_bound)
