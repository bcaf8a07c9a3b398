"""Long-window exponential smoothers as scans of affine maps.

Counterpart of the reference's ``ops/seqscan.py``. A masked SES or DES step
is an affine map of the state, state_t = A_t state_{t-1} + c_t, scalar for
SES and 2 x 2 for DES, built from the mask exactly as the reference builds
them (a gap step is the identity for SES and (l, b) -> (l + b, b) for DES);
pred_t = h . state_{t-1}. The engine runs the SES form for buckets of
LONG_WINDOW_STEPS and more; DES stays sequential there, and its scan form
serves time-split callers. The DES form steps its maps in float64 and
rounds only the predictions to float32: in float32 the 2 x 2 products
compound rounding over long masked stretches (kernel E's composed shears
drifted past the scan check's 1e-4 of a row's scale at T = 16384, and a
float32 walk of the same steps drifts by up to the same order there).

`ses_predictions_assoc` and `des_predictions_assoc` run kernel E
(``csrc/seqscan.cu``) on the card, on the path `kernels.scan_path` picks:
SES, and DES over fewer than `kernels.WALK_ROWS` rows, take a block-wide
scan of the maps per row, so the order in which maps combine differs from
XLA's tree and the results agree with the reference within a tolerance,
not to the bit; DES over more rows walks each row's maps one step at a
time, a lane a row, as the twin does, and gives the twin's bits. On the
CPU they run the plain twins, which apply the same maps one step at a time.
"""
from __future__ import annotations

import torch

from .. import kernels
from .forecast import _first_valid, _placed, _row_vector

__all__ = ["ses_predictions_assoc", "des_predictions_assoc",
           "ses_predictions_assoc_plain", "des_predictions_assoc_plain"]

_F = torch.float32


def ses_predictions_assoc_plain(x, mask, alpha):
    """Plain twin of kernel E for SES: s_t = (1 - alpha m_t) s_{t-1} +
    (alpha m_t) x_t from the first valid value; pred_t = s_{t-1}."""
    B, T = x.shape
    x = x.to(_F)
    m = mask.to(_F)
    s = _first_valid(x, mask)
    preds = torch.empty((B, T), dtype=_F, device=x.device)
    for t in range(T):
        preds[:, t] = s
        am = alpha * m[:, t]
        s = (1.0 - am) * s + am * x[:, t]
    return preds


def des_predictions_assoc_plain(x, mask, alpha, beta):
    """Plain twin of kernel E for DES: (l, b)_t = A_t (l, b)_{t-1} + c_t with
    A_t = m A_obs + (1 - m) A_gap, c_t = (alpha m x, beta alpha m x), from
    (first valid value, 0), in float64 as the kernel composes them;
    pred_t = l_{t-1} + b_{t-1}, rounded to float32."""
    B, T = x.shape
    first = _first_valid(x.to(_F), mask).double()
    x = x.double()
    m = mask.double()
    alpha, beta = alpha.double(), beta.double()
    oma = 1.0 - alpha
    o00, o01 = oma, oma
    o10, o11 = -beta * alpha, beta * oma + (1.0 - beta)
    ba = beta * alpha
    lvl = first
    trend = torch.zeros_like(lvl)
    preds = torch.empty((B, T), dtype=torch.float64, device=x.device)
    for t in range(T):
        mt = m[:, t]
        g = 1.0 - mt
        a00, a01 = mt * o00 + g * 1.0, mt * o01 + g * 1.0
        a10, a11 = mt * o10 + g * 0.0, mt * o11 + g * 1.0
        c0, c1 = (alpha * mt) * x[:, t], (ba * mt) * x[:, t]
        preds[:, t] = lvl + trend
        lvl, trend = (a00 * lvl + a01 * trend) + c0, (a10 * lvl + a11 * trend) + c1
    return preds.to(_F)


def _ses_assoc(x, mask, alpha):
    if x.device.type == "cpu":
        return ses_predictions_assoc_plain(x, mask, alpha)
    return kernels.affine_scan(kernels.SMOOTH_SES, x, mask, alpha)


def _des_assoc(x, mask, alpha, beta):
    if x.device.type == "cpu":
        return des_predictions_assoc_plain(x, mask, alpha, beta)
    return kernels.affine_scan(kernels.SMOOTH_DES, x, mask, alpha, beta)


def ses_predictions_assoc(x, mask, alpha, *, device=None):
    """SES one-step predictions (B, T) as a scan of affine maps; alpha (B,)
    or a scalar. Same semantics as forecast.ses_predictions."""
    dev, x, mask = _placed(x, mask, device)
    return _ses_assoc(x, mask, _row_vector(alpha, x.shape[0], _F, dev, "alpha"))


def des_predictions_assoc(x, mask, alpha, beta, *, device=None):
    """DES one-step predictions (B, T) as a scan of 2 x 2 affine maps."""
    dev, x, mask = _placed(x, mask, device)
    B = x.shape[0]
    return _des_assoc(x, mask, _row_vector(alpha, B, _F, dev, "alpha"),
                      _row_vector(beta, B, _F, dev, "beta"))
