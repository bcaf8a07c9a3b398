"""LSTM-autoencoder multivariate anomaly scorer: the plain twin, the
carry-over of parameters trained by the reference, and the scoring entry
points (kernel K).

Counterpart of the reference's ``models/lstm_ae.py`` on the scoring path.
A seq2seq autoencoder of (B, W, F) windows: an encoder LSTM over the
values and the mask ([x, mask], 2F channels; x is fed as given at masked
slots), a Dense latent of the last step's output, a decoder LSTM fed the
latent at every step, a Dense head back to F features. A window's score is
its masked mean squared reconstruction error, z-scored against the errors
of healthy windows.

The cells are flax's LSTMCell: gates i, f, g, o, each ``dense_i(x)`` (no
bias) + ``dense_h(h)`` (with bias), activations sigmoid, sigmoid, tanh,
sigmoid, ``c' = f c + i g``, ``h' = o tanh(c')``, the carry starting at
zeros. The module's top-level names mirror flax's tree (``LSTMCell_0``,
``Dense_0``, ``LSTMCell_1``, ``Dense_1``); a cell keeps its four gates'
kernels side by side, ``wi`` (in, 4H) from flax's ii, if, ig, io and ``wh``
(H, 4H) from hi, hf, hg, ho, with ``b`` (4H) from the hi..ho biases.

Parameters move between the two as flat float32 vectors, one per job, in
the layout of PARAM_NAMES (each tensor row-major):
    LSTMCell_0.wi (2F, 4H), LSTMCell_0.wh (H, 4H), LSTMCell_0.b (4H),
    Dense_0.kernel (H, Z), Dense_0.bias (Z),
    LSTMCell_1.wi (Z, 4H), LSTMCell_1.wh (H, 4H), LSTMCell_1.b (4H),
    Dense_1.kernel (H, F), Dense_1.bias (F).
P = 12,180 floats at F = 4, H = 32, Z = 16 (the engine's LSTM_HIDDEN and
LSTM_LATENT); 177,732 at the module's default H = 128, Z = 64.

Entry points run on the card (kernel K) or, for device="cpu", the twin:
`reconstruction_errors`, `fit_score_normalizer`, `anomaly_scores`,
`anomaly_scores_fleet`. Training (the reference's
init_state, train_step, train, train_fleet) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from .._device import as_tensor, resolve_device

__all__ = ["PARAM_NAMES", "LstmAutoencoder", "param_shapes", "param_count", "params_from_flax",
           "flat_params", "stack_params", "unflatten_params", "reconstruction_errors_plain",
           "reconstruction_errors", "fit_score_normalizer", "anomaly_scores",
           "anomaly_scores_fleet"]

_F = torch.float32

PARAM_NAMES = ("LSTMCell_0.wi", "LSTMCell_0.wh", "LSTMCell_0.b", "Dense_0.kernel",
               "Dense_0.bias", "LSTMCell_1.wi", "LSTMCell_1.wh", "LSTMCell_1.b",
               "Dense_1.kernel", "Dense_1.bias")
_GATES = ("i", "f", "g", "o")


def param_shapes(features: int, hidden: int, latent: int) -> dict:
    """Each parameter's shape, in the flat layout's order."""
    F, H, Z = int(features), int(hidden), int(latent)
    return {"LSTMCell_0.wi": (2 * F, 4 * H), "LSTMCell_0.wh": (H, 4 * H),
            "LSTMCell_0.b": (4 * H,), "Dense_0.kernel": (H, Z), "Dense_0.bias": (Z,),
            "LSTMCell_1.wi": (Z, 4 * H), "LSTMCell_1.wh": (H, 4 * H), "LSTMCell_1.b": (4 * H,),
            "Dense_1.kernel": (H, F), "Dense_1.bias": (F,)}


def param_count(features: int, hidden: int, latent: int) -> int:
    return sum(int(np.prod(s)) for s in param_shapes(features, hidden, latent).values())


class LstmCell(nn.Module):
    """flax's LSTMCell with its four gates' kernels side by side."""

    def __init__(self, in_features: int, hidden: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(in_features, 4 * hidden))
        self.wh = nn.Parameter(torch.zeros(hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(4 * hidden))


class Dense(nn.Module):
    """flax's Dense: y = x kernel + bias, kernel (in, out)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))


class LstmAutoencoder(nn.Module):
    """Plain twin of the reference's LstmAutoencoder (float32 only)."""

    def __init__(self, hidden: int = 128, latent: int = 64, features: int = 4):
        super().__init__()
        self.hidden, self.latent, self.features = hidden, latent, features
        self.LSTMCell_0 = LstmCell(2 * features, hidden)
        self.Dense_0 = Dense(hidden, latent)
        self.LSTMCell_1 = LstmCell(latent, hidden)
        self.Dense_1 = Dense(hidden, features)

    def forward(self, x, mask):
        """(B, W, F) values and bool mask -> (B, W, F) reconstruction."""
        p = {k: v[None] for k, v in self.named_parameters()}
        return _recon(p, x[None], mask[None], self.hidden)[0]


def _cell_step(ax, h, c, wh, b, H: int):
    """One step of J x K cells: gates from the input projection ax (J, K, 4H)
    plus h wh + b, then the state update."""
    g = ax + (torch.bmm(h, wh) + b[:, None, :])
    i, f, gg, o = g.split(H, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _recon(p: dict, x, mask, H: int):
    """The autoencoder's reconstruction of x (J, K, W, F) under per-job
    parameters p (name -> (J, ...) tensors): (J, K, W, F)."""
    J, K, W, F = x.shape
    inp = torch.cat([x, mask.to(x.dtype)], dim=-1)
    h = torch.zeros((J, K, H), dtype=x.dtype, device=x.device)
    c = torch.zeros_like(h)
    for t in range(W):
        ax = torch.bmm(inp[:, :, t], p["LSTMCell_0.wi"])
        h, c = _cell_step(ax, h, c, p["LSTMCell_0.wh"], p["LSTMCell_0.b"], H)
    z = torch.bmm(h, p["Dense_0.kernel"]) + p["Dense_0.bias"][:, None, :]
    dz = torch.bmm(z, p["LSTMCell_1.wi"])
    h = torch.zeros_like(h)
    c = torch.zeros_like(h)
    out = []
    for _ in range(W):
        h, c = _cell_step(dz, h, c, p["LSTMCell_1.wh"], p["LSTMCell_1.b"], H)
        out.append(torch.bmm(h, p["Dense_1.kernel"]) + p["Dense_1.bias"][:, None, :])
    return torch.stack(out, dim=2)


# ---------------------------------------------------------------------------
# parameters: the carry-over from flax, the flat layout, stacks
# ---------------------------------------------------------------------------
def params_from_flax(tree) -> dict:
    """The port's parameters from the reference's trained flax ``params``
    tree, given as nested dicts of numpy arrays (after jax.device_get; a
    top-level "params" key is accepted). Returns name -> float32 CPU tensor,
    the names of PARAM_NAMES (LstmAutoencoder's state_dict keys)."""
    tree = tree.get("params", tree)
    out = {}
    for cell in ("LSTMCell_0", "LSTMCell_1"):
        t = tree[cell]
        out[f"{cell}.wi"] = np.concatenate([t["i" + g]["kernel"] for g in _GATES], axis=1)
        out[f"{cell}.wh"] = np.concatenate([t["h" + g]["kernel"] for g in _GATES], axis=1)
        out[f"{cell}.b"] = np.concatenate([t["h" + g]["bias"] for g in _GATES])
    for dense in ("Dense_0", "Dense_1"):
        out[f"{dense}.kernel"] = tree[dense]["kernel"]
        out[f"{dense}.bias"] = tree[dense]["bias"]
    return {k: torch.from_numpy(np.array(out[k], dtype=np.float32)) for k in PARAM_NAMES}


def _as_dict(params) -> dict:
    return params.state_dict() if isinstance(params, nn.Module) else params


def _dims(params) -> tuple:
    """(features, hidden, latent) of a parameter dict or module."""
    p = _as_dict(params)
    H, F = p["Dense_1.kernel"].shape
    return int(F), int(H), int(p["Dense_0.kernel"].shape[1])


def flat_params(params) -> torch.Tensor:
    """(P,) float32: a parameter dict (or LstmAutoencoder) in the flat
    layout."""
    p = _as_dict(params)
    shapes = param_shapes(*_dims(p))
    for k, s in shapes.items():
        if tuple(p[k].shape) != s:
            raise ValueError(f"{k} has shape {tuple(p[k].shape)}, expected {s}")
    return torch.cat([torch.as_tensor(p[k]).detach().reshape(-1).to(_F) for k in PARAM_NAMES])


def stack_params(params_list) -> torch.Tensor:
    """(J, P) float32: one job's parameters a row (dicts, modules or flat
    (P,) vectors)."""
    return torch.stack([p if isinstance(p, torch.Tensor) and p.dim() == 1 else flat_params(p)
                        for p in params_list])


def unflatten_params(stack, features: int, hidden: int, latent: int) -> dict:
    """name -> (J, ...) views of a (J, P) stack (or a (P,) vector, without
    the J axis)."""
    one = stack.dim() == 1
    s = stack[None] if one else stack
    out, at = {}, 0
    for k, shape in param_shapes(features, hidden, latent).items():
        n = int(np.prod(shape))
        out[k] = s[:, at:at + n].reshape((s.shape[0],) + shape)
        at += n
    if at != s.shape[1]:
        raise ValueError(f"a parameter row of {s.shape[1]} floats is not F, H, Z = "
                         f"{features}, {hidden}, {latent} ({at} floats)")
    return {k: v[0] for k, v in out.items()} if one else out


# ---------------------------------------------------------------------------
# scoring: the twin of kernel K and the entry points
# ---------------------------------------------------------------------------
def reconstruction_errors_plain(stack, x, mask, hidden: int, latent: int, mu=None,
                                sigma=None):
    """Plain twin of kernel K: the masked mean squared reconstruction error
    (J, K) of x (J, K, W, F) under each job's row of the (J, P) stack,
    sum((recon - x)^2 over mask) / max(sum mask, 1) (masked slots skipped);
    with mu and sigma (J,), also z = (err - mu) / sigma, as (err, z)."""
    F = x.shape[-1]
    p = unflatten_params(stack, F, hidden, latent)
    recon = _recon(p, x, mask, int(hidden))
    se = torch.where(mask, (recon - x) ** 2, 0.0)
    err = se.sum(dim=(2, 3)) / torch.clamp(mask.sum(dim=(2, 3)).to(_F), min=1.0)
    if mu is None:
        return err
    return err, (err - mu[:, None]) / sigma[:, None]


def _windows(x, mask, dev):
    """x and mask as float32 / bool tensors of one shape on dev."""
    x = as_tensor(x, _F, dev, "x", tuple(np.shape(x)))
    return x, as_tensor(mask, torch.bool, dev, "mask", tuple(x.shape))


def _errors(stack, x, mask, hidden, latent, mu=None, sigma=None):
    """Kernel K on the card, its twin on the CPU (tensors already placed)."""
    if x.device.type == "cpu":
        return reconstruction_errors_plain(stack, x, mask, hidden, latent, mu, sigma)
    return kernels.lstm_ae(stack, x, mask, hidden, latent, mu, sigma)


def _single(params, x, mask, device):
    """One model's flat (1, P) row and its windows as (1, B, W, F)."""
    dev = resolve_device(device)
    F, H, Z = _dims(params)
    stack = flat_params(params)[None].to(dev)
    x, mask = _windows(x, mask, dev)
    if x.dim() != 3 or x.shape[-1] != F:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (B, W, {F})")
    return dev, stack, x[None], mask[None], H, Z


def reconstruction_errors(params, x, mask, *, device=None):
    """Per-window masked MSE (B,) of x (B, W, F) under one model's
    parameters (a dict from params_from_flax, or an LstmAutoencoder)."""
    dev, stack, x, mask, H, Z = _single(params, x, mask, device)
    return _errors(stack, x, mask, H, Z)[0]


def fit_score_normalizer(params, x_healthy, mask, *, device=None):
    """(mu, sigma) of the reconstruction errors of healthy windows: their
    mean and max(population std, 1e-6), as 0-d tensors."""
    errs = reconstruction_errors(params, x_healthy, mask, device=device)
    return errs.mean(), torch.clamp(errs.std(unbiased=False), min=1e-6)


def _fleet(params_stack, x, mask, hidden, latent, device):
    dev = resolve_device(device)
    x, mask = _windows(x, mask, dev)
    if x.dim() != 4:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (J, K, W, F)")
    stack = as_tensor(params_stack, _F, dev, "params_stack", tuple(np.shape(params_stack)))
    return dev, stack, x, mask, int(hidden), int(latent)


def anomaly_scores(params, x, mask, mu, sigma, *, device=None):
    """z = (err - mu) / sigma per window (B,) under one model; mu and sigma
    are scalars (fit_score_normalizer's)."""
    dev, stack, x, mask, H, Z = _single(params, x, mask, device)
    mu = torch.as_tensor(mu, dtype=_F).reshape(1).to(dev)
    sigma = torch.as_tensor(sigma, dtype=_F).reshape(1).to(dev)
    return _errors(stack, x, mask, H, Z, mu, sigma)[1][0]


def anomaly_scores_fleet(params_stack, x, mask, mu, sigma, *, hidden: int, latent: int,
                         device=None):
    """Fleet scoring in one launch: J jobs' models (params_stack (J, P) from
    stack_params) over their K windows each (x, mask (J, K, W, F)), each
    job's mu and sigma (J,). Returns z (J, K)."""
    dev, stack, x, mask, H, Z = _fleet(params_stack, x, mask, hidden, latent, device)
    J = x.shape[0]
    mu = torch.as_tensor(mu, dtype=_F).reshape(J).to(dev).contiguous()
    sigma = torch.as_tensor(sigma, dtype=_F).reshape(J).to(dev).contiguous()
    return _errors(stack, x, mask, H, Z, mu, sigma)[1]
