"""The band family: forecasters, period detection, residual sigma and the
band check (plain PyTorch twins and the entry points).

Counterpart of the reference's ``ops/forecast.py`` on the band path: the
causal moving average, the sequential smoothers (SES, DES, additive
Holt-Winters), seasonal-period detection, the Holt-Winters grid fit, the
residual sigma over history and the band check. All functions take (B, T)
tensors, one series per row.

Entry points run on the card (default) or, for device="cpu", their plain
twins:
- `moving_average_band`: the chain under moving_average_all, kernel B;
- `ses_predictions`, `des_predictions`, `holt_winters_predictions`:
  kernel C; the long-window SES/DES scans are in ``ops.seqscan`` (kernel E);
- `detect_period`: kernel F; `fit_holt_winters`: kernel D, then kernel C
  for the winner's predictions;
- `fit_seasonal_trend`: the Prophet-core trend + Fourier seasonality ridge
  fit, kernel J;
- `band_from_preds`: residual sigma + band from given predictions, kernel
  B's second entry;
- `forecast_band`: the engine's band launch for any univariate algorithm
  (the reference's ``Analyzer._predict`` + ``_detect_periods`` +
  ``band_fn``).

Deliberate numeric differences from the reference, each toward the exact
value: windowed moving-average sums are differences of float64 prefix sums
(the reference differences float32 cumsums), so a constant history
predicts its level exactly and keeps sigma = 0 (the semantics the
reference documents; its float32 cancellation leaves sigma ~1e-5 on a
constant row at a high level); period detection sums in float64 and
solves the trend from centred sums, so a constant row detrends to exactly
0 and keeps its fallback; the Holt-Winters fit sums squared errors in
float64. The seasonal-trend fit sums its normal equations and solves
them in float64 (the reference: float32 sums and a float32 LU solve).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .._device import as_tensor, resolve_device

__all__ = [
    "ALGO_MOVING_AVERAGE",
    "ALGO_SES",
    "ALGO_DES",
    "ALGO_HOLT_WINTERS",
    "BOUND_BOTH",
    "BOUND_UPPER",
    "BOUND_LOWER",
    "DEFAULT_GRID",
    "masked_mean_std",
    "moving_average_predictions",
    "residual_sigma",
    "band_anomalies",
    "moving_average_band",
    "moving_average_band_plain",
    "ses_predictions",
    "des_predictions",
    "holt_winters_predictions",
    "smooth_plain",
    "detect_period",
    "detect_period_plain",
    "fit_holt_winters",
    "fit_holt_winters_plain",
    "st_columns",
    "fit_seasonal_trend",
    "fit_seasonal_trend_plain",
    "band_from_preds",
    "band_from_preds_plain",
    "forecast_band",
]

_F = torch.float32

ALGO_MOVING_AVERAGE = 0
ALGO_SES = kernels.SMOOTH_SES
ALGO_DES = kernels.SMOOTH_DES
ALGO_HOLT_WINTERS = kernels.SMOOTH_HW

# the reference's _default_grid, (alpha, beta, gamma) in its meshgrid
# order: alpha slowest, gamma fastest (60, 3)
_GRID_ALPHA = (0.1, 0.3, 0.5, 0.7, 0.9)
_GRID_BETA = (0.0, 0.1, 0.3)
_GRID_GAMMA = (0.05, 0.1, 0.3, 0.5)
DEFAULT_GRID = tuple((a, b, g) for a in _GRID_ALPHA for b in _GRID_BETA for g in _GRID_GAMMA)

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


# ---------------------------------------------------------------------------
# Sequential smoothers (kernel C) and the Holt-Winters grid fit (kernel D)
# ---------------------------------------------------------------------------
def _row_vector(v, B: int, dtype: torch.dtype, dev: torch.device, name: str) -> torch.Tensor:
    """A per-row parameter as a (B,) tensor on dev: a scalar broadcasts."""
    if isinstance(v, (int, float)) or (hasattr(v, "ndim") and v.ndim == 0):
        return torch.full((B,), float(v) if dtype.is_floating_point else int(v),
                          dtype=dtype, device=dev)
    return as_tensor(v, dtype, dev, name, (B,))


def smooth_plain(kind: int, x, mask, alpha, beta=None, gamma=None, period=None, fit=None):
    """Plain twin of kernels C and D: the reference's SES / DES / additive
    Holt-Winters recurrences, one Python step per slot on (..., B) states.

    alpha (and beta, gamma) are (B,) or (G, B): a leading candidate axis
    runs G parameter sets over the same rows, as kernel D does. period is a
    (B,) integer tensor (HW only), read as min(max(period, 1), T). Returns
    the predictions (..., B, T); with fit, a (B, T) bool mask, returns
    instead the float64 sum of squared one-step errors over fit & mask.
    """
    B, T = x.shape
    dev = x.device
    x = x.to(_F)
    shape = alpha.shape
    zero = torch.zeros(shape, dtype=_F, device=dev)
    oma = 1.0 - alpha
    be = beta if beta is not None else zero
    ga = gamma if gamma is not None else zero
    omb, omg = 1.0 - be, 1.0 - ga
    if kind == ALGO_HOLT_WINTERS:
        P = torch.clamp(period.to(torch.int64), 1, T)
        Pm = int(P.max()) if B else 1
        cols = torch.arange(Pm, device=dev)
        first = mask[:, :Pm] & (cols < P[:, None])
        # the masked mean in float64, rounded once (see hw_level0 in
        # csrc/smoothers.cu)
        l0 = (torch.sum(torch.where(first, x[:, :Pm], 0.0).double(), dim=-1)
              / torch.clamp(first.sum(-1), min=1).double()).to(_F)
        ring = torch.where(first, x[:, :Pm] - l0[:, None], 0.0).expand(shape + (Pm,)).clone()
        lvl = l0.expand(shape).clone()
    else:
        lvl = _first_valid(x, mask).expand(shape).clone()
    trend = zero.clone()
    season = zero
    preds = None if fit is not None else torch.empty(shape + (T,), dtype=_F, device=dev)
    sse = torch.zeros(shape, dtype=torch.float64, device=dev)
    for t in range(T):
        xt, mt = x[:, t], mask[:, t]
        if kind == ALGO_SES:
            pred = lvl
            lvl = torch.where(mt, alpha * xt + oma * lvl, lvl)
        else:
            lb = lvl + trend
            if kind == ALGO_HOLT_WINTERS:
                k = torch.remainder(torch.full_like(P, t), P).expand(shape)[..., None]
                season = torch.gather(ring, -1, k)[..., 0]
                pred = lb + season
                ln = torch.where(mt, alpha * (xt - season) + oma * lb, lb)
            else:
                pred = lb
                ln = torch.where(mt, alpha * xt + oma * lb, lb)
            trend = torch.where(mt, be * (ln - lvl) + omb * trend, trend)
            if kind == ALGO_HOLT_WINTERS:
                season = torch.where(mt, ga * (xt - ln) + omg * season, season)
                ring.scatter_(-1, k, season[..., None])
            lvl = ln
        if fit is None:
            preds[..., t] = pred
        else:
            r = torch.where(mt & fit[:, t], xt - pred, 0.0).double()
            sse += r * r
    return preds if fit is None else sse


def _smooth(kind: int, x, mask, alpha, beta=None, gamma=None, period=None,
            max_period: int | None = None):
    """Kernel C on the card, its twin on the CPU (tensors already placed)."""
    if x.device.type == "cpu":
        return smooth_plain(kind, x, mask, alpha, beta, gamma, period)
    return kernels.smooth(kind, x, mask, alpha, beta, gamma, period, max_period=max_period)


def _placed(x, mask, device):
    dev = resolve_device(device)
    x = as_tensor(x, _F, dev, "x")
    return dev, x, as_tensor(mask, torch.bool, dev, "mask", tuple(x.shape))


def ses_predictions(x, mask, alpha, *, device=None):
    """One-step SES predictions (B, T): pred_t = s_{t-1}, s starting at the
    first valid value, a masked step carrying s. alpha (B,) or a scalar."""
    dev, x, mask = _placed(x, mask, device)
    alpha = _row_vector(alpha, x.shape[0], _F, dev, "alpha")
    return _smooth(ALGO_SES, x, mask, alpha)


def des_predictions(x, mask, alpha, beta, *, device=None):
    """One-step Holt linear (DES) predictions (B, T): level from the first
    valid value, trend from 0, a masked step advancing the level by the
    trend."""
    dev, x, mask = _placed(x, mask, device)
    B = x.shape[0]
    alpha = _row_vector(alpha, B, _F, dev, "alpha")
    beta = _row_vector(beta, B, _F, dev, "beta")
    return _smooth(ALGO_DES, x, mask, alpha, beta)


def holt_winters_predictions(x, mask, period, alpha, beta, gamma, *, device=None):
    """One-step additive Holt-Winters predictions (B, T). period is an int
    or a (B,) int32 (the reference's static period per row); the level
    starts at the masked mean of the first period, the season at x - l0
    where the mask is set."""
    dev, x, mask = _placed(x, mask, device)
    B = x.shape[0]
    period = _row_vector(period, B, torch.int32, dev, "period")
    alpha, beta, gamma = (_row_vector(v, B, _F, dev, n)
                          for v, n in ((alpha, "alpha"), (beta, "beta"), (gamma, "gamma")))
    return _smooth(ALGO_HOLT_WINTERS, x, mask, alpha, beta, gamma, period)


def _argmin_nan_first(v):
    """jnp.argmin over the last axis: the first NaN, else the first minimum."""
    return torch.argmin(torch.where(torch.isnan(v), -torch.inf, v), dim=-1)


# The plain twins of kernels D and F work through the rows in chunks, so
# that their (G, rows, period) season rings, and float64 temporaries, stay
# bounded at the path's full size.
_PLAIN_RING_BYTES = 1 << 32
_PLAIN_CHUNK_SLOTS = 1 << 27


def fit_holt_winters_plain(x, mask, fit_mask, period, grid):
    """Plain twin of kernel D: the mean squared one-step error of every
    grid candidate over fit_mask & mask (float64, over max(n, 1) points),
    and the argmin. Returns params (B, 3), best (B,) int32 and mse (B, G)
    float64."""
    B, T = x.shape
    G = grid.shape[0]
    P = torch.clamp(period.to(torch.int64), 1, T)
    ring_row = G * (int(P.max()) if B else 1) * 4
    step = max(1, _PLAIN_RING_BYTES // ring_row)
    n = torch.clamp((fit_mask & mask).sum(-1), min=1).double()
    mse = torch.empty((B, G), dtype=torch.float64, device=x.device)
    for lo in range(0, B, step):
        hi = min(B, lo + step)
        cand = [grid[:, q, None].expand(G, hi - lo) for q in range(3)]
        sse = smooth_plain(ALGO_HOLT_WINTERS, x[lo:hi], mask[lo:hi], *cand,
                           period=period[lo:hi], fit=fit_mask[lo:hi])
        mse[lo:hi] = (sse / n[None, lo:hi]).T
    best = _argmin_nan_first(mse)
    return {"params": grid[best], "best": best.to(torch.int32), "mse": mse}


def _fit_hw(x, mask, fit_mask, period, grid, max_period: int | None = None):
    """Kernel D then kernel C on the card (twins on the CPU): the fit's
    dict plus the winner's predictions."""
    if x.device.type == "cpu":
        fit = fit_holt_winters_plain(x, mask, fit_mask, period, grid)
    else:
        fit = kernels.hw_fit(x, mask, fit_mask, period, grid, max_period=max_period)
    p = fit["params"]
    fit["preds"] = _smooth(ALGO_HOLT_WINTERS, x, mask, p[:, 0].contiguous(),
                           p[:, 1].contiguous(), p[:, 2].contiguous(), period,
                           max_period=max_period)
    return fit


def fit_holt_winters(x, mask, fit_mask, period, grid=None, *, device=None):
    """Grid-fit Holt-Winters per row: the (alpha, beta, gamma) of `grid`
    ((G, 3), default the reference's 60-point grid) minimising the mean
    squared one-step error over fit_mask & mask, the first minimum winning.
    period is an int or a (B,) int32. Returns (params (B, 3), preds (B, T))
    under each row's best parameters."""
    dev, x, mask = _placed(x, mask, device)
    B, T = x.shape
    fit_mask = as_tensor(fit_mask, torch.bool, dev, "fit_mask", (B, T))
    period = _row_vector(period, B, torch.int32, dev, "period")
    grid = torch.as_tensor(DEFAULT_GRID if grid is None else grid, dtype=_F).to(dev)
    out = _fit_hw(x, mask, fit_mask, period, grid)
    return out["params"], out["preds"]


# ---------------------------------------------------------------------------
# Period detection (kernel F)
# ---------------------------------------------------------------------------
def _acf_plain(d, m, p: int):
    """Masked autocorrelation of d at lag p, float64 sums, -inf where fewer
    than p pairs support it or the denominator is not positive."""
    w = m[:, p:] & m[:, :-p]
    wf = w.to(_F)
    lead, lag = d[:, p:], d[:, :-p]
    num = ((wf * lead) * lag).double().sum(-1)
    sa = ((wf * lead) * lead).double().sum(-1)
    sb = ((wf * lag) * lag).double().sum(-1)
    den = torch.sqrt(sa * sb)
    r = (num / torch.where(den == 0.0, 1.0, den)).to(_F)
    return torch.where((w.sum(-1) >= p) & (den > 0.0), r, -torch.inf)


def detect_period_plain(x, mask, candidates: tuple, fallback, min_acf: float,
                        alias_margin: float = 0.05, contrast_margin: float = 0.01):
    """Plain twin of kernel F: the reference's detect_period with float64
    sums and a centred trend solve (see the module note). fallback is a
    (B,) int32 tensor. Returns (period (B,) int32, scores (B, C) float32)."""
    B, T = x.shape
    step = max(1, _PLAIN_CHUNK_SLOTS // max(T, 1))
    parts = [_detect_rows(x[lo:lo + step], mask[lo:lo + step], candidates,
                          fallback[lo:lo + step], min_acf, alias_margin, contrast_margin)
             for lo in range(0, max(B, 1), step)]
    return torch.cat([p for p, _ in parts]), torch.cat([s for _, s in parts])


def _detect_rows(x, mask, candidates, fallback, min_acf, alias_margin, contrast_margin):
    B, T = x.shape
    dev = x.device
    m = mask
    t = torch.arange(T, device=dev)
    n = m.sum(-1)
    st = torch.where(m, t, 0).sum(-1)
    stt = torch.where(m, t * t, 0).sum(-1)
    xf = torch.where(m, x.to(_F), 0.0)
    sx = xf.double().sum(-1)
    stx = (xf.double() * t.double()).sum(-1)
    det = n * stt - st * st
    nn = torch.clamp(n, min=1).double()
    xbar, tbar = sx / nn, st.double() / nn
    slope = torch.where(det > 0, (stx - st.double() * xbar) / (det.double() / nn), 0.0)
    slope_f, icept_f = slope.to(_F), (xbar - slope * tbar).to(_F)
    d = torch.where(m, (xf - icept_f[:, None]) - slope_f[:, None] * t.to(_F), 0.0)
    del xf
    f32 = dict(dtype=_F, device=dev)
    cm, am = torch.tensor(contrast_margin, **f32), torch.tensor(alias_margin, **f32)
    lags = {}

    def acf(p):
        if p not in lags:
            lags[p] = _acf_plain(d, m, p)
        return lags[p]

    scores, oks = [], []
    for p in candidates:
        if not 2 <= p < T:
            scores.append(torch.full((B,), -torch.inf, **f32))
            oks.append(torch.zeros(B, dtype=torch.bool, device=dev))
            continue
        r = acf(p)
        scores.append(r)
        oks.append(r + cm >= acf(p // 2) if p >= 4 else torch.ones(B, dtype=torch.bool,
                                                                    device=dev))
    C = len(candidates)
    if C == 0:
        return fallback.to(torch.int32).clone(), torch.empty((B, 0), **f32)
    S, ok = torch.stack(scores, -1), torch.stack(oks, -1)
    best = torch.amax(torch.where(ok, S, -torch.inf), dim=-1, keepdim=True)
    cut = torch.maximum(best - am, torch.tensor(min_acf, **f32))
    eligible = ok & (S >= cut)
    pick = torch.argmax(eligible.to(torch.int32), dim=-1)
    cand = torch.tensor(candidates, dtype=torch.int32, device=dev)
    period = torch.where(eligible.any(-1), cand[pick], fallback.to(torch.int32))
    return period, S


def _detect(x, mask, candidates: tuple, fallback, min_acf, alias_margin, contrast_margin):
    if x.device.type == "cpu":
        return detect_period_plain(x, mask, candidates, fallback, min_acf, alias_margin,
                                   contrast_margin)
    cand = torch.tensor(candidates, dtype=torch.int32).to(x.device)
    return kernels.detect_period(x, mask, cand, fallback, min_acf, alias_margin,
                                 contrast_margin)


def detect_period(x, mask, candidates: tuple, fallback, min_acf, alias_margin=0.05,
                  contrast_margin=0.01, *, device=None):
    """Each row's seasonal period among `candidates` (a tuple, in preference
    order, fundamental first), from the masked detrended autocorrelation
    with the reference's support test, half-lag contrast and alias margin;
    `fallback` (an int or (B,)) where no candidate is eligible. Pass the
    history mask. Returns (period (B,) int32, scores (B, C) float32)."""
    dev, x, mask = _placed(x, mask, device)
    fallback = _row_vector(fallback, x.shape[0], torch.int32, dev, "fallback")
    return _detect(x, mask, tuple(int(p) for p in candidates), fallback, float(min_acf),
                   float(alias_margin), float(contrast_margin))


# ---------------------------------------------------------------------------
# The seasonal-trend (Prophet-core) fit (kernel J)
# ---------------------------------------------------------------------------
_F32 = np.float32


def st_columns(T: int, period: int, order: int = 3, n_changepoints: int = 0,
               device=None) -> torch.Tensor:
    """The (T, D) float32 design of one period: [1, tn, relu(tn - s_j) for
    the C knots, sin and cos of k w for k = 1..order].

    Rounded as the reference's compiled program rounds it (XLA folds its
    divisions by constants into products with float32 reciprocals and its
    chain of constant factors into one): tn = t * fl(1 / max(T - 1, 1)),
    s_j = fl(fl(j * fl(1 / (C + 1))) * 0.8), and the k-th Fourier argument
    t * c_k with c_k = fl(fl(fl(2 pi) * fl(1 / period)) * k). Kernel J
    computes every column from the same float32 steps.
    """
    t = torch.arange(T, dtype=_F, device=device)
    one = _F32(1.0)
    tn = t * torch.tensor(one / _F32(max(T - 1, 1)), device=device)
    cols = [torch.ones(T, dtype=_F, device=device), tn]
    C = int(n_changepoints)
    inv_c = one / _F32(C + 1)
    for j in range(1, C + 1):
        knot = _F32(_F32(_F32(j) * inv_c) * _F32(0.8))
        cols.append(torch.clamp(tn - torch.tensor(knot, device=device), min=0.0))
    c1 = _F32(_F32(2 * np.pi) * _F32(one / _F32(period)))
    for k in range(1, int(order) + 1):
        arg = t * torch.tensor(_F32(c1 * _F32(k)), device=device)
        cols += [torch.sin(arg), torch.cos(arg)]
    return torch.stack(cols, dim=-1)


def _st_penalty(is_cp, beta, ridge: float, cp_shrink: float):
    """The reference's per-column ridge weights, float64: ridge +
    cp_shrink on the hinge columns for the first solve (beta None), ridge +
    cp_shrink / (|beta| + 1e-3) on them for each IRLS round."""
    if beta is None:
        return ridge + cp_shrink * is_cp
    return ridge + cp_shrink * is_cp / (torch.abs(beta) + 1e-3)


def _st_solve(G, rhs, pen):
    """Cholesky solve of (G + diag(pen)) beta = rhs, float64; a row whose
    matrix is not positive definite (or not finite) gets NaN."""
    A = G + torch.diag_embed(pen)
    L, info = torch.linalg.cholesky_ex(A)
    beta = torch.cholesky_solve(rhs[..., None], L)[..., 0]
    bad = (info != 0) | ~torch.isfinite(A).all(-1).all(-1)
    return torch.where(bad[:, None], torch.nan, beta)


def fit_seasonal_trend_plain(x, mask, fit_mask, period, order: int = 3, ridge: float = 1e-4,
                             n_changepoints: int = 0, cp_shrink: float = 3e-3,
                             l1_iters: int = 3):
    """Plain twin of kernel J: the reference's fit_seasonal_trend with a
    (B,) int32 period per row. The gram X^T diag(sel) X and the rhs
    X^T (sel x) over sel = mask & fit_mask (masked slots skipped, as the
    reference's compiled select does) are float64 sums of the float32
    columns; the ridge solve (penalty ridge + cp_shrink on the hinge
    columns), then l1_iters - 1 reweighted solves when n_changepoints > 0,
    are float64 Cholesky solves; preds = X beta at every slot, summed in
    float64 and rounded once. Returns (beta (B, D) float32, preds (B, T)
    float32)."""
    B, T = x.shape
    C = int(n_changepoints)
    D = 2 + C + 2 * int(order)
    dev = x.device
    beta = torch.empty((B, D), dtype=_F, device=dev)
    preds = torch.empty((B, T), dtype=_F, device=dev)
    sel = mask & fit_mask
    is_cp = torch.zeros(D, dtype=torch.float64, device=dev)
    is_cp[2:2 + C] = 1.0
    step = max(1, _PLAIN_CHUNK_SLOTS // max(T * D, 1))
    for p in torch.unique(period).tolist():
        X = st_columns(T, p, order, C, dev).double()
        rows = torch.nonzero(period == p)[:, 0]
        for lo in range(0, rows.numel(), step):
            r = rows[lo:lo + step]
            s = sel[r].double()
            xw = s[:, :, None] * X  # (n, T, D)
            G = xw.transpose(1, 2) @ X
            rhs = torch.where(sel[r], x[r].double(), 0.0) @ X
            b = _st_solve(G, rhs, _st_penalty(is_cp, None, ridge, cp_shrink).expand(
                r.numel(), D))
            for _ in range(max(l1_iters - 1, 0) if C > 0 else 0):
                b = _st_solve(G, rhs, _st_penalty(is_cp, b, ridge, cp_shrink))
            beta[r] = b.to(_F)
            preds[r] = (b @ X.T).to(_F)
    return beta, preds


def _fit_st(x, mask, fit_mask, period, order, ridge=1e-4, n_changepoints=0, cp_shrink=3e-3,
            l1_iters=3):
    """Kernel J on the card, its twin on the CPU (tensors already placed).
    A negative order or n_changepoints is taken as 0, as the reference's
    range(1, order + 1) and its knot grid take it."""
    order, n_changepoints = max(int(order), 0), max(int(n_changepoints), 0)
    if x.device.type == "cpu":
        return fit_seasonal_trend_plain(x, mask, fit_mask, period, order, ridge,
                                        n_changepoints, cp_shrink, l1_iters)
    return kernels.st_fit(x, mask, fit_mask, period, int(order), int(n_changepoints),
                          float(ridge), float(cp_shrink), int(l1_iters))


def fit_seasonal_trend(x, mask, fit_mask, period, order: int = 3, ridge: float = 1e-4,
                       n_changepoints: int = 0, cp_shrink: float = 3e-3, l1_iters: int = 3,
                       *, device=None):
    """Fit a linear trend with n_changepoints hinges and a Fourier
    seasonality of `order` harmonics per row by masked ridge least squares
    over fit_mask & mask, the hinge slopes shrunk by l1_iters - 1 IRLS
    rounds; the reference's fit_seasonal_trend (the Prophet core). period
    is an int or a (B,) int32, one period per row, where the reference
    takes one static period per call. Returns (beta (B, D), preds (B, T)),
    D = 2 + n_changepoints + 2 order, preds = X beta at every slot."""
    dev, x, mask = _placed(x, mask, device)
    B, T = x.shape
    fit_mask = as_tensor(fit_mask, torch.bool, dev, "fit_mask", (B, T))
    period = _row_vector(period, B, torch.int32, dev, "period")
    return _fit_st(x, mask, fit_mask, period, order, ridge, n_changepoints, cp_shrink,
                   l1_iters)


# ---------------------------------------------------------------------------
# The band from given predictions (kernel B's second entry) and the path
# ---------------------------------------------------------------------------
def band_from_preds_plain(x, mask, region, preds, threshold, bound_mode, min_lower_bound):
    """Plain twin of band_from_preds: residual_sigma over mask & ~region,
    then band_anomalies. Returns band_anomalies' dict plus sigma."""
    hist = mask & ~region
    sigma = residual_sigma(x, preds, hist, ~region)
    out = band_anomalies(x, mask, region, preds, sigma, threshold, bound_mode, min_lower_bound)
    out["sigma"] = sigma
    return out


def _band(x, mask, region, preds, threshold, bound_mode, min_lower_bound):
    if x.device.type == "cpu":
        return band_from_preds_plain(x, mask, region, preds, threshold, bound_mode,
                                     min_lower_bound)
    return kernels.band_from_preds(x, mask, region, preds, threshold, bound_mode,
                                   min_lower_bound)


def _policy(B, dev, threshold, bound_mode, min_lower_bound):
    return (as_tensor(threshold, _F, dev, "threshold", (B,)),
            as_tensor(bound_mode, torch.int32, dev, "bound_mode", (B,)),
            as_tensor(min_lower_bound, _F, dev, "min_lower_bound", (B,)))


def band_from_preds(x, mask, region, preds, threshold, bound_mode, min_lower_bound, *,
                    device=None):
    """Residual sigma over history (mask & ~region) and the band over the
    scored region (mask & region) from given predictions, one launch.
    Returns sigma, upper, lower, flags, count, first_index, checked."""
    dev, x, mask = _placed(x, mask, device)
    B, T = x.shape
    region = as_tensor(region, torch.bool, dev, "region", (B, T))
    preds = as_tensor(preds, _F, dev, "preds", (B, T))
    return _band(x, mask, region, preds, *_policy(B, dev, threshold, bound_mode,
                                                   min_lower_bound))


def forecast_band(x, mask, region, threshold, bound_mode, min_lower_bound, *,
                  algorithm: str = "moving_average_all", ma_window: int = 30,
                  long_window_steps: int = 4096, hw_period: int = 1440,
                  hw_period_auto: bool = True,
                  hw_period_candidates: tuple = (60, 480, 720, 1440),
                  hw_min_seasonal_acf: float = 0.2, hw_alias_margin: float = 0.05,
                  hw_contrast_margin: float = 0.01, st_order: int = 3,
                  st_changepoints: int = 12, device=None):
    """The engine's band launch for one bucket: forecast the history
    (mask & ~region), then judge the region against the band.

    The port's counterpart of the reference's Analyzer._predict,
    _detect_periods and band_fn, dispatched on `algorithm` as the
    reference does (the keyword defaults are EngineConfig's):
    - exponential_smoothing*: SES, alpha 0.3; the affine scan (kernel E)
      when T >= long_window_steps, else kernel C;
    - double_exponential*: DES, alpha 0.5, beta 0.1, always sequential
      (kernel C);
    - holt_winters*: the period per row (kernel F on the history, fallback
      min(hw_period, max(T // 2, 2)); without auto detection or candidates,
      the fallback for every row), the grid fit (kernel D) over the history
      past each row's first 2 periods, the winner's predictions (kernel C);
    - seasonal_trend* and prophet*: the period per row as for holt_winters,
      then the seasonal-trend fit (kernel J) of order st_order with
      st_changepoints hinges over the whole history;
    - anything else: the moving average over ma_window steps (kernel B).
    Every algorithm but the moving average then runs band_from_preds.

    Returns preds, sigma, upper, lower, flags, count, first_index and
    checked; holt_winters adds period (B,) and params (B, 3),
    seasonal_trend period (B,) and beta (B, D).
    """
    dev, x, mask = _placed(x, mask, device)
    B, T = x.shape
    region = as_tensor(region, torch.bool, dev, "region", (B, T))
    policy = _policy(B, dev, threshold, bound_mode, min_lower_bound)
    seasonal_trend = algorithm.startswith(("seasonal_trend", "prophet"))
    if not seasonal_trend and not algorithm.startswith(("exponential_smoothing",
                                                        "double_exponential",
                                                        "holt_winters")):
        if dev.type == "cpu":
            return moving_average_band_plain(x, mask, region, int(ma_window), *policy)
        return kernels.ma_band(x, mask, region, int(ma_window), *policy)

    hist = mask & ~region
    extra = {}
    if algorithm.startswith("exponential_smoothing"):
        alpha = torch.full((B,), 0.3, dtype=_F, device=dev)
        if T >= long_window_steps:
            from .seqscan import _ses_assoc
            preds = _ses_assoc(x, hist, alpha)
        else:
            preds = _smooth(ALGO_SES, x, hist, alpha)
    elif algorithm.startswith("double_exponential"):
        preds = _smooth(ALGO_DES, x, hist, torch.full((B,), 0.5, dtype=_F, device=dev),
                        torch.full((B,), 0.1, dtype=_F, device=dev))
    else:
        fallback = min(int(hw_period), max(T // 2, 2))
        cands = tuple(int(p) for p in hw_period_candidates if int(p) >= 2)
        fb = torch.full((B,), fallback, dtype=torch.int32, device=dev)
        if hw_period_auto and cands:
            period, _ = _detect(x, hist, cands, fb, float(hw_min_seasonal_acf),
                                float(hw_alias_margin), float(hw_contrast_margin))
            max_period = max(cands + (fallback,))
        else:
            period, max_period = fb, fallback
    if seasonal_trend:
        # the whole history fits, with no skip of the first periods
        beta, preds = _fit_st(x, hist, hist, period, st_order, n_changepoints=st_changepoints)
        extra = {"period": period, "beta": beta}
    elif algorithm.startswith("holt_winters"):
        fit = hist & (torch.arange(T, device=dev) >= 2 * period[:, None])
        grid = torch.tensor(DEFAULT_GRID, dtype=_F).to(dev)
        hw = _fit_hw(x, hist, fit, period, grid, max_period)
        preds = hw["preds"]
        extra = {"period": period, "params": hw["params"]}
    out = _band(x, mask, region, preds, *policy)
    out["preds"] = preds
    out.update(extra)
    return out
