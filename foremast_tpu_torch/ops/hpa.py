"""The HPA family: the [0, 100] autoscaling score and its breath cooldowns.

Counterpart of the reference's ``ops/hpa.py``. The score is 50 to hold the
replica count, above 50 to scale up, below to scale down: the demand
(inside the traffic band the predicted level, outside it the recent trend
extrapolated half a window ahead) per pod against the per-pod capacity of
the history, shaped by an SLA reward (a ramp that turns scale-down off as
the SLA metric nears its limit, a floor from 75 once it is violated).
Cooldowns across cycles are host state, `BreathState`.

- `hpa_scores`: the reference's entry (same arguments and dict), kernel I
  on the card or, for device="cpu", the plain twin `hpa_scores_plain`;
- `hpa_from_preds`: the engine's launch after the SES predictions: the
  residual sigma of the predictions over the history (tps_mask & ~region,
  RMS, +inf below 2 points, as ``forecast.residual_sigma``) and the scores
  in one kernel I launch (twin `hpa_from_preds_plain`). Its dict adds
  "tps_sigma".

The reference writes its masked means as x * w, which XLA's algebraic
simplifier compiles to a select: a NaN or inf at a masked slot never
reaches them, and an infinite sigma (a row with fewer than 2 history
points) gives tps_upper = +inf and tps_lower = -inf. The port's masked
means select the same way. The one product of another form is the slope's
sel * (t - tm) * (x - xm), the selected factor times x - xm at every slot:
a non-finite tps anywhere in the row makes the slope, and with it an
anomaly-trend demand and score, NaN; the port forms it the same way. The
engine's packers leave masked slots finite anyway.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from .. import kernels
from .._device import as_tensor, resolve_device
from . import forecast as fc

__all__ = [
    "SLA_STATIC",
    "SLA_DYNAMIC",
    "SLA_MIN",
    "REASON_PREDICTED_TREND",
    "REASON_ANOMALY_TREND",
    "REASON_SLA_VIOLATION",
    "REASON_SLA_HEADROOM",
    "hpa_scores",
    "hpa_scores_plain",
    "hpa_from_preds",
    "hpa_from_preds_plain",
    "BreathState",
]

_F = torch.float32

SLA_STATIC = 0  # fixed limit
SLA_DYNAMIC = 1  # mean + 3 sigma of healthy history
SLA_MIN = 2  # min(static, dynamic)

REASON_PREDICTED_TREND = 0
REASON_ANOMALY_TREND = 1
REASON_SLA_VIOLATION = 2
REASON_SLA_HEADROOM = 3  # scale-down suppressed: too close to the SLA limit


def _masked_mean(x, m):
    n = torch.clamp(m.to(_F).sum(-1), min=1.0)
    return torch.sum(torch.where(m, x, 0.0), dim=-1) / n


def _recent_slope(x, mask, region):
    """Least-squares slope over the valid points of the scored region (B,)."""
    sel = mask & region
    t = torch.arange(x.shape[-1], dtype=_F, device=x.device)[None, :]
    tm = _masked_mean(t.expand_as(x), sel)
    xm = _masked_mean(x, sel)
    dt = torch.where(sel, t - tm[:, None], 0.0)
    # the selected factor times x - xm at every slot, as the reference forms it
    cov = torch.sum(dt * (x - xm[:, None]), dim=-1)
    var = torch.clamp(torch.sum(dt * dt, dim=-1), min=1e-6)  # NaN stays NaN
    return cov / var


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, torch.full_like(v, lo)), torch.full_like(v, hi))


def hpa_scores_plain(tps, tps_mask, region, tps_pred, tps_sigma, sla, sla_mask,
                     sla_static_limit, sla_mode, threshold, sla_safe_fraction=None,
                     pods_now=None, pods_hist=None, sla_absolute=None):
    """Plain twin of kernel I (given sigma): the reference's float32
    algebra in its order. Returns the 11 (B,) outputs of the reference."""
    thr = threshold[:, None] * tps_sigma[:, None]
    upper = tps_pred + thr
    lower = tps_pred - thr

    sel = tps_mask & region
    current_tps = _masked_mean(tps, sel)
    pred_mean = _masked_mean(tps_pred, region)
    upper_mean = _masked_mean(upper, region)
    lower_mean = _masked_mean(lower, region)

    out_of_band = sel & ((tps > upper) | (tps < lower))
    n_out = out_of_band.sum(-1)
    n_checked = torch.clamp(sel.sum(-1), min=1)
    anomalous = n_out * 3 >= n_checked

    horizon = region.to(_F).sum(-1) * 0.5
    slope = _recent_slope(tps, tps_mask, region)
    anomaly_demand = current_tps + slope * horizon
    demand = torch.maximum(torch.where(anomalous, anomaly_demand, pred_mean),
                           torch.zeros_like(pred_mean))

    provisioned = _masked_mean(tps, tps_mask & ~region)
    ones = torch.ones_like(provisioned)
    p_now = ones if pods_now is None else torch.maximum(pods_now.to(_F), ones * 1e-6)
    p_hist = ones if pods_hist is None else torch.maximum(pods_hist.to(_F), ones * 1e-6)
    demand_per_pod = demand / p_now
    capacity_per_pod = provisioned / p_hist

    hist_sel = sla_mask & ~region
    sla_mu = _masked_mean(sla, hist_sel)
    dv = sla - sla_mu[:, None]
    sla_sd = torch.sqrt(torch.maximum(_masked_mean(dv * dv, hist_sel), ones * 1e-12))
    dyn_limit = sla_mu + 3.0 * sla_sd
    static_eff = (sla_static_limit if sla_absolute is None
                  else torch.where(sla_absolute, sla_static_limit, sla_static_limit * sla_mu))
    limit = torch.where(sla_mode == SLA_STATIC, static_eff,
                        torch.where(sla_mode == SLA_DYNAMIC, dyn_limit,
                                    torch.minimum(static_eff, dyn_limit)))
    sla_current = _masked_mean(sla, sla_mask & region)
    sla_violated = sla_current > limit

    safe = ones * 0.7 if sla_safe_fraction is None else sla_safe_fraction.to(_F)
    h = sla_current / torch.maximum(limit, ones * 1e-9)
    base = 50.0 * demand_per_pod / torch.maximum(capacity_per_pod, ones * 1e-6)
    w = _clip((1.0 - h) / torch.maximum(1.0 - safe, ones * 1e-6), 0.0, 1.0)
    shaped = torch.where(base < 50.0, 50.0 - (50.0 - base) * w, base)
    viol_floor = 75.0 + 25.0 * _clip(h - 1.0, 0.0, 1.0)
    score = torch.where(sla_violated, torch.maximum(base, viol_floor), shaped)
    score = _clip(score, 0.0, 100.0)

    suppressed = ~sla_violated & (base < 50.0) & (w < 1.0)
    reason = torch.where(sla_violated, REASON_SLA_VIOLATION,
                         torch.where(suppressed, REASON_SLA_HEADROOM,
                                     torch.where(anomalous, REASON_ANOMALY_TREND,
                                                 REASON_PREDICTED_TREND)))
    return {
        "score": score,
        "reason": reason.to(torch.int32),
        "demand": demand,
        "demand_per_pod": demand_per_pod,
        "pods_now": p_now,
        "current_tps": current_tps,
        "sla_current": sla_current,
        "sla_limit": limit,
        "tps_pred": pred_mean,
        "tps_upper": upper_mean,
        "tps_lower": lower_mean,
    }


def hpa_from_preds_plain(tps, tps_mask, region, tps_pred, sla, sla_mask, sla_static_limit,
                         sla_mode, threshold, sla_safe_fraction=None, pods_now=None,
                         pods_hist=None, sla_absolute=None):
    """Plain twin of kernel I's second entry: `forecast.residual_sigma`
    over tps_mask & ~region, then `hpa_scores_plain`; adds "tps_sigma"."""
    hist = tps_mask & ~region
    sigma = fc.residual_sigma(tps, tps_pred, hist, ~region)
    out = hpa_scores_plain(tps, tps_mask, region, tps_pred, sigma, sla, sla_mask,
                           sla_static_limit, sla_mode, threshold, sla_safe_fraction, pods_now,
                           pods_hist, sla_absolute)
    out["tps_sigma"] = sigma
    return out


_OPTIONAL = (("sla_safe_fraction", _F), ("pods_now", _F), ("pods_hist", _F),
             ("sla_absolute", torch.bool))


def _placed(device, series, rows, optional):
    """(device, [(B, T) tensors], [(B,) tensors], [optional (B,) or None])."""
    dev = resolve_device(device)
    (n0, v0, d0), *rest = series
    x = as_tensor(v0, d0, dev, n0)
    B, T = x.shape
    s = [x] + [as_tensor(v, d, dev, n, (B, T)) for n, v, d in rest]
    r = [as_tensor(v, d, dev, n, (B,)) for n, v, d in rows]
    o = [None if v is None else as_tensor(v, d, dev, n, (B,))
         for v, (n, d) in zip(optional, _OPTIONAL)]
    return dev, s, r, o


def hpa_scores(tps, tps_mask, region, tps_pred, tps_sigma, sla, sla_mask, sla_static_limit,
               sla_mode, threshold, sla_safe_fraction=None, pods_now=None, pods_hist=None,
               sla_absolute=None, *, device=None):
    """Fleet HPA scores, one kernel I launch for B rows (the reference's
    arguments: tps, tps_mask, region, tps_pred (B, T); tps_sigma (B,);
    sla, sla_mask (B, T); sla_static_limit (B,), sla_mode (B,) int32,
    threshold (B,); optional (B,) sla_safe_fraction (default 0.7),
    pods_now and pods_hist (default 1), sla_absolute (bool, default all
    absolute)). numpy inputs move to `device` (default "cuda").

    Returns score, reason (int32), demand, demand_per_pod, pods_now,
    current_tps, sla_current, sla_limit, tps_pred, tps_upper, tps_lower,
    each (B,).
    """
    dev, (x, tm, rg, p, y, sm), (sigma, lim, mode, thr), opt = _placed(
        device,
        (("tps", tps, _F), ("tps_mask", tps_mask, torch.bool), ("region", region, torch.bool),
         ("tps_pred", tps_pred, _F), ("sla", sla, _F), ("sla_mask", sla_mask, torch.bool)),
        (("tps_sigma", tps_sigma, _F), ("sla_static_limit", sla_static_limit, _F),
         ("sla_mode", sla_mode, torch.int32), ("threshold", threshold, _F)),
        (sla_safe_fraction, pods_now, pods_hist, sla_absolute))
    if dev.type == "cpu":
        return hpa_scores_plain(x, tm, rg, p, sigma, y, sm, lim, mode, thr, *opt)
    safe, pn, ph, ab = opt
    return kernels.hpa_score(x, tm, rg, p, y, sm, lim, mode, thr, tps_sigma=sigma, safe=safe,
                             pods_now=pn, pods_hist=ph, sla_absolute=ab)


def hpa_from_preds(tps, tps_mask, region, tps_pred, sla, sla_mask, sla_static_limit, sla_mode,
                   threshold, sla_safe_fraction=None, pods_now=None, pods_hist=None,
                   sla_absolute=None, *, device=None):
    """The residual sigma of tps_pred over the history (tps_mask & ~region)
    and `hpa_scores` from it, in one kernel I launch (the twin for
    device="cpu"). Same arguments as `hpa_scores` without tps_sigma;
    returns its dict plus tps_sigma (B,)."""
    dev, (x, tm, rg, p, y, sm), (lim, mode, thr), opt = _placed(
        device,
        (("tps", tps, _F), ("tps_mask", tps_mask, torch.bool), ("region", region, torch.bool),
         ("tps_pred", tps_pred, _F), ("sla", sla, _F), ("sla_mask", sla_mask, torch.bool)),
        (("sla_static_limit", sla_static_limit, _F), ("sla_mode", sla_mode, torch.int32),
         ("threshold", threshold, _F)),
        (sla_safe_fraction, pods_now, pods_hist, sla_absolute))
    if dev.type == "cpu":
        return hpa_from_preds_plain(x, tm, rg, p, y, sm, lim, mode, thr, *opt)
    safe, pn, ph, ab = opt
    return kernels.hpa_score(x, tm, rg, p, y, sm, lim, mode, thr, safe=safe, pods_now=pn,
                             pods_hist=ph, sla_absolute=ab)


@dataclass
class BreathState:
    """Host-side scale cooldowns: fast up, slow down, no flip-flop.

    A scale-up signal passes after `breath_up_s` of sustained score > 50; a
    scale-down needs `breath_down_s` (longer). Between decisions the emitted
    score is pinned to 50 so the HPA holds replicas steady. The armed
    timers persist through `export` / `load` (the engine keeps them in its
    job store), so a restart mid-cooldown does not let a flip through.
    """

    breath_up_s: float = 120.0
    breath_down_s: float = 600.0
    _since: dict = field(default_factory=dict)  # service -> (direction, t0)

    def apply(self, service: str, raw_score: float, now: float | None = None) -> float:
        now = time.time() if now is None else now
        direction = 1 if raw_score > 50.0 else (-1 if raw_score < 50.0 else 0)
        if direction == 0:
            self._since.pop(service, None)
            return 50.0
        prev = self._since.get(service)
        if prev is None or prev[0] != direction:
            self._since[service] = (direction, now)
            return 50.0
        held = now - prev[1]
        need = self.breath_up_s if direction > 0 else self.breath_down_s
        if held >= need:
            return float(raw_score)
        return 50.0

    def export(self) -> dict:
        """JSON-safe {service: [direction, t0]} snapshot of armed timers."""
        return {svc: [d, t0] for svc, (d, t0) in self._since.items()}

    def load(self, state: dict) -> None:
        """Restore timers from `export()` output; bad entries are dropped
        (a corrupt snapshot must not stop scoring: at worst a cooldown
        re-arms from scratch)."""
        restored = {}
        for svc, pair in (state or {}).items():
            try:
                d, t0 = pair
                restored[str(svc)] = (int(d), float(t0))
            except (TypeError, ValueError):
                continue
        self._since = restored
