"""The bivariate-normal family: the joint k-sigma ellipse of a metric pair.

Counterpart of the reference's ``ops/bivariate.py``: fit a 2-D Gaussian
to the joint history of the pair (masked means, a 2x2 covariance with a
ridge floor, an analytic inverse) and flag the current points whose
squared Mahalanobis distance exceeds threshold^2. All functions take
(B, T) tensors, one pair per row.

- `bivariate_normal_anomalies`: the reference's entry (same arguments and
  dict), kernel H on the card or, for device="cpu", the plain twin. Its
  marginal bands are (B, T) views of (B,) values (constant in t).
- `bivariate_rows`: the same with the bands as (B,) values, for callers
  that read them per row (the engine's bivariate launch).
- `bivariate_normal_anomalies_plain`: the plain twin, with (B,) bands.

The reference writes its masked sums as x * w, which XLA's algebraic
simplifier compiles to a select, so a NaN or inf at a masked slot never
reaches its statistics (only d2 at that slot, computed from the raw value).
The port's sums select the history slots the same way. The engine's
packers leave masked slots finite anyway (``resample_to_grid`` and the zero
padding).
"""
from __future__ import annotations

import torch

from .. import kernels
from .._device import as_tensor, resolve_device

__all__ = ["bivariate_normal_anomalies", "bivariate_rows",
           "bivariate_normal_anomalies_plain"]

_F = torch.float32
_BANDS = ("upper1", "lower1", "upper2", "lower2")


def _directional(dev, mode):
    md = torch.where(mode == 0, 3, mode)[:, None]
    return ((dev > 0) & ((md & 1) > 0)) | ((dev < 0) & ((md & 2) > 0))


def bivariate_normal_anomalies_plain(x1, m1, x2, m2, region, threshold, min_lower_bound1=None,
                                     min_lower_bound2=None, bound_mode1=None, bound_mode2=None):
    """Plain twin of kernel H: the reference's float32 algebra in its
    order. Returns flags and d2 (B, T), count, first_index and checked
    (B,) int32, and the bands upper1, lower1, upper2, lower2 (B,)."""
    joint = m1 & m2
    hist = joint & ~region
    n = hist.to(_F).sum(-1)
    denom = torch.clamp(n, min=1.0)
    mu1 = torch.sum(torch.where(hist, x1, 0.0), dim=-1) / denom
    mu2 = torch.sum(torch.where(hist, x2, 0.0), dim=-1) / denom
    d1 = torch.where(hist, x1 - mu1[:, None], 0.0)
    e2 = torch.where(hist, x2 - mu2[:, None], 0.0)
    var1 = torch.sum(d1 * d1, dim=-1) / denom
    var2 = torch.sum(e2 * e2, dim=-1) / denom
    cov = torch.sum(d1 * e2, dim=-1) / denom
    ridge = 1e-6 * torch.maximum(torch.maximum(var1, var2), torch.ones_like(var1))
    var1 = var1 + ridge
    var2 = var2 + ridge
    det = torch.maximum(var1 * var2 - cov * cov, torch.full_like(var1, 1e-12))
    a = x1 - mu1[:, None]
    b = x2 - mu2[:, None]
    d2 = (var2[:, None] * a * a - 2.0 * cov[:, None] * a * b
          + var1[:, None] * b * b) / det[:, None]
    flags = (d2 > (threshold * threshold)[:, None]) & joint & region & (n >= 2.0)[:, None]
    if bound_mode1 is not None and bound_mode2 is not None:
        flags = flags & (_directional(a, bound_mode1) | _directional(b, bound_mode2))
    count = flags.sum(-1, dtype=torch.int32)
    first = torch.where(count > 0, torch.argmax(flags.to(torch.int32), dim=-1), -1)
    s1, s2 = torch.sqrt(var1), torch.sqrt(var2)
    lo1, lo2 = mu1 - threshold * s1, mu2 - threshold * s2
    if min_lower_bound1 is not None:
        lo1 = torch.maximum(lo1, min_lower_bound1)
    if min_lower_bound2 is not None:
        lo2 = torch.maximum(lo2, min_lower_bound2)
    return {"flags": flags, "d2": d2, "count": count, "first_index": first.to(torch.int32),
            "checked": (joint & region).sum(-1, dtype=torch.int32),
            "upper1": mu1 + threshold * s1, "lower1": lo1,
            "upper2": mu2 + threshold * s2, "lower2": lo2}


def _placed(device, x1, m1, x2, m2, region, threshold, optional):
    dev = resolve_device(device)
    x1 = as_tensor(x1, _F, dev, "x1")
    B, T = x1.shape
    args = [x1, as_tensor(m1, torch.bool, dev, "m1", (B, T)),
            as_tensor(x2, _F, dev, "x2", (B, T)), as_tensor(m2, torch.bool, dev, "m2", (B, T)),
            as_tensor(region, torch.bool, dev, "region", (B, T)),
            as_tensor(threshold, _F, dev, "threshold", (B,))]
    for (v, name), dt in zip(optional, (_F, _F, torch.int32, torch.int32)):
        args.append(None if v is None else as_tensor(v, dt, dev, name, (B,)))
    return dev, args


def bivariate_rows(x1, m1, x2, m2, region, threshold, min_lower_bound1=None,
                   min_lower_bound2=None, bound_mode1=None, bound_mode2=None, *, device=None):
    """`bivariate_normal_anomalies` with the marginal bands as (B,) values,
    one kernel H launch (or the twin for device="cpu")."""
    dev, args = _placed(device, x1, m1, x2, m2, region, threshold,
                        ((min_lower_bound1, "min_lower_bound1"),
                         (min_lower_bound2, "min_lower_bound2"),
                         (bound_mode1, "bound_mode1"), (bound_mode2, "bound_mode2")))
    if dev.type == "cpu":
        return bivariate_normal_anomalies_plain(*args)
    return kernels.bivariate(*args)


def bivariate_normal_anomalies(x1, m1, x2, m2, region, threshold, min_lower_bound1=None,
                               min_lower_bound2=None, bound_mode1=None, bound_mode2=None, *,
                               device=None):
    """Joint k-sigma-ellipse anomaly flags for B metric pairs.

    x1, x2 (B, T) float32 on a shared grid; m1, m2, region (B, T) bool, the
    Gaussian fit on the joint history (m1 & m2 & ~region); threshold (B,)
    the radius in sigmas. Optional (B,): min_lower_bound1/2 floor the
    lower marginal bands; bound_mode1/2 (int32 ML_BOUND bitmasks, 0 = both)
    keep a flag only where one metric's excursion direction is enabled
    (with both given, as in the reference). numpy inputs move to `device`
    (default "cuda").

    Returns flags (B, T), d2 (B, T), count, first_index (-1 if none),
    checked (B,), and upper1, lower1, upper2, lower2 (B, T): views of one
    value per row, mu +- threshold * sigma of each metric.
    """
    out = bivariate_rows(x1, m1, x2, m2, region, threshold, min_lower_bound1,
                         min_lower_bound2, bound_mode1, bound_mode2, device=device)
    B, T = out["flags"].shape
    for k in _BANDS:
        out[k] = out[k][:, None].expand(B, T)
    return out

