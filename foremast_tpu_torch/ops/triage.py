"""The tier-0 triage screen: one pass over packed band rows (kernel G).

Counterpart of the reference's ``ops/triage.py`` (`screen_rows`,
`triage_arg_spec`). Per row, over the band scorer's packed layout (history
head, current tail marked by `region`, right padding masked):

- the smoother-residual band: the band scorer's own moving average over
  the history and its RMS residual sigma, with the violations of the
  current region counted under the policy band (`count`) and under the
  band narrowed by `margin` sigmas (`shrunk_count`), and the means of both
  band edges over every region slot; the shrunk count dominates the real
  one, so a shrunk count under the verdict gate implies a healthy verdict;
- the robust z-band: the largest |x - median(history)| of a checked slot
  over max(1.4826 MAD, finite sigma), 0 without history. Escalation only.

The moving average and sigma are the port's (`ops.forecast`: float64
prefix sums, so a constant history keeps sigma = 0): the screen predicts
exactly what the band scorer predicts, which keeps CLEAR one-sided. The
order statistics are exact: the mean of the (n-1)//2-th and n//2-th
smallest valid history values (masked slots read as +inf, NaN after +inf,
as ``jnp.sort`` orders them).

`screen_rows` runs kernel G on the card or, for device="cpu", the plain
twin `screen_rows_plain`. Thresholds stay on the host (the engine's
CLEAR/SUSPECT rule, ``engine/triage.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._device import as_tensor, resolve_device
from . import forecast as fc

__all__ = ["screen_rows", "screen_rows_plain", "triage_arg_spec"]

_F = torch.float32

# the plain twin works through the rows in chunks of about this many slots,
# so its float64 temporaries stay bounded at the path's full size
_PLAIN_CHUNK_SLOTS = 1 << 25


def _order_stat_mean(v, i0, i1):
    """Mean of the i0-th and i1-th smallest of each row (NaN last)."""
    s = torch.sort(v, dim=-1).values
    return 0.5 * (torch.gather(s, 1, i0[:, None])[:, 0] + torch.gather(s, 1, i1[:, None])[:, 0])


def _screen_chunk(x, mask, region, threshold, bound_mode, min_lower_bound, margin,
                  window: int) -> dict:
    B, T = x.shape
    x = x.to(_F)
    hist = mask & ~region
    chk = mask & region
    n_h = hist.sum(-1)

    preds = fc.moving_average_predictions(x, hist, window)
    sigma = fc.residual_sigma(x, preds, hist, ~region)
    mode = torch.where(bound_mode == 0, fc.BOUND_BOTH, bound_mode)[:, None]
    up_on, lo_on = (mode & 1) > 0, (mode & 2) > 0
    mlb = min_lower_bound.to(_F)[:, None]

    def band(width):
        w = width[:, None] * sigma[:, None]
        upper = preds + w
        lower = torch.maximum(preds - w, mlb)
        viol = ((x > upper) & up_on) | ((x < lower) & lo_on)
        return (viol & chk).sum(-1, dtype=torch.int32), upper, lower

    count, upper, lower = band(threshold)
    shrunk, _, _ = band(threshold - margin)
    n_r = torch.clamp(region.sum(-1), min=1).double()
    upper_mean = (torch.where(region, upper, 0.0).double().sum(-1) / n_r).to(_F)
    lower_mean = (torch.where(region, lower, 0.0).double().sum(-1) / n_r).to(_F)
    dev = torch.where(chk, (x - preds).abs(), 0.0).amax(-1)
    resid_z = dev / torch.clamp(sigma, min=1e-30)

    i0 = torch.clamp(torch.div(n_h - 1, 2, rounding_mode="floor"), 0, T - 1)
    i1 = torch.clamp(torch.div(n_h, 2, rounding_mode="floor"), 0, T - 1)
    med = _order_stat_mean(torch.where(hist, x, torch.inf), i0, i1)
    d = (x - med[:, None]).abs()
    mad = _order_stat_mean(torch.where(hist, d, torch.inf), i0, i1)
    scale = torch.maximum(1.4826 * mad, torch.where(torch.isfinite(sigma), sigma, 0.0))
    rob = torch.where(chk, d, 0.0).amax(-1) / torch.clamp(scale, min=1e-30)
    robust_z = torch.where(n_h > 0, rob, 0.0)
    return {
        "count": count,
        "shrunk_count": shrunk,
        "checked": chk.sum(-1, dtype=torch.int32),
        "n_hist": n_h.to(torch.int32),
        "upper_mean": upper_mean,
        "lower_mean": lower_mean,
        "resid_z": resid_z,
        "robust_z": robust_z,
        "sigma": sigma,
    }


def screen_rows_plain(values, mask, region, threshold, bound_mode, min_lower_bound, margin,
                      window: int) -> dict:
    """Plain twin of kernel G on tensors: the screen statistics of each row
    (see the module note). torch.clamp(min=) and torch.maximum propagate NaN
    as jnp.maximum does."""
    B, T = values.shape
    step = max(1, _PLAIN_CHUNK_SLOTS // max(T, 1))
    parts = [_screen_chunk(values[lo:lo + step], mask[lo:lo + step], region[lo:lo + step],
                           threshold[lo:lo + step], bound_mode[lo:lo + step],
                           min_lower_bound[lo:lo + step], margin[lo:lo + step], int(window))
             for lo in range(0, max(B, 1), step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def screen_rows(values, mask, region, threshold, bound_mode, min_lower_bound, margin,
                window: int, *, device=None) -> dict:
    """The fused screen over (B, T) packed rows, one launch: the reference's
    signature (values, mask, region, threshold, bound, min_lower_bound,
    margin, window), numpy arrays or tensors. Runs kernel G on `device`
    (default "cuda") or the plain twin for device="cpu". Returns count,
    shrunk_count, checked, n_hist (int32), upper_mean, lower_mean, resid_z,
    robust_z and sigma (float32), each (B,)."""
    dev = resolve_device(device)
    x = as_tensor(values, _F, dev, "values")
    B, T = x.shape
    mask = as_tensor(mask, torch.bool, dev, "mask", (B, T))
    region = as_tensor(region, torch.bool, dev, "region", (B, T))
    threshold = as_tensor(threshold, _F, dev, "threshold", (B,))
    bound_mode = as_tensor(bound_mode, torch.int32, dev, "bound_mode", (B,))
    min_lower_bound = as_tensor(min_lower_bound, _F, dev, "min_lower_bound", (B,))
    margin = as_tensor(margin, _F, dev, "margin", (B,))
    if dev.type == "cpu":
        return screen_rows_plain(x, mask, region, threshold, bound_mode, min_lower_bound,
                                 margin, int(window))
    return kernels.triage_screen(x, mask, region, int(window), threshold, bound_mode,
                                 min_lower_bound, margin)


def triage_arg_spec(B: int, T: int):
    """Zeroed argument tuple matching the engine's screen packing (minus
    `window`): the reference's contract, for `engine.pipeline.prewarm`."""
    return (
        np.zeros((B, T), np.float32),   # values
        np.zeros((B, T), bool),         # mask
        np.zeros((B, T), bool),         # current region
        np.zeros(B, np.float32),        # policy threshold (sigmas)
        np.ones(B, np.int32),           # bound bitmask
        np.zeros(B, np.float32),        # min lower bound
        np.zeros(B, np.float32),        # shrink margin (sigmas)
    )
