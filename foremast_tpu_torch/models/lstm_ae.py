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

Entry points run on the card or, for device="cpu", the twins: scoring
(kernel K) by `reconstruction_errors`, `fit_score_normalizer`,
`anomaly_scores`, `anomaly_scores_fleet`; training by `train_step`,
`train` and `train_fleet`, from the reference's initial parameters
(`init_state`, models/lstm_init.py). A training step is the masked MSE's
value and gradient (kernel L, `LstmAeLoss`; the twin is torch autograd
through the same recurrences) and optax's Adam (kernel M; the twin,
`adam_plain`, is Adam written out in optax's order of operations).
`adam_state_from_optax` carries the reference's Adam state across.
`param_shardings` gives the parameters' placements on a (fleet, model)
mesh, the reference's tensor-parallel rule.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from .._device import as_tensor, resolve_device

__all__ = ["PARAM_NAMES", "LstmAutoencoder", "param_shapes", "param_count", "params_from_flax",
           "param_shardings",
           "flat_params", "stack_params", "unflatten_params", "reconstruction_errors_plain",
           "reconstruction_errors", "fit_score_normalizer", "anomaly_scores",
           "anomaly_scores_fleet", "LEARNING_RATE", "ADAM_B1", "ADAM_B2", "ADAM_EPS",
           "init_state", "adam_state_from_optax", "loss_plain", "LstmAeLoss", "loss_and_grad",
           "wgrad_plain", "bias_corrections", "reduce_partials_plain", "adam_plain",
           "train_step_plain", "train_step", "train", "train_fleet"]

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


def param_shardings(params, mesh, model_axis: str | None = None, min_shard_width: int = 8):
    """Tensor-parallel placements of the scorer's parameters on a (fleet,
    model) DeviceMesh (``parallel.mesh.fleet_mesh``): name -> a tuple of
    one placement per mesh axis, Replicate() on every axis but the model
    axis.

    The reference's rule (its models/lstm_ae.py:96-128), a Megatron-style
    column split: a kernel (2-D or more) whose output (last) dim is a
    multiple of the model axis' size and at least `min_shard_width` wide
    is Shard on that dim along the model axis; biases, indivisible kernels
    and narrow heads replicate. A cell's wi and wh keep the four gates'
    (in, H) kernels side by side, so the width the rule reads is one gate's
    H, as it reads each of the reference's per-gate kernels. With a model
    axis of 1 (the fleet mesh's default) nothing is split.
    """
    from torch.distributed.tensor import Replicate, Shard

    from ..parallel.mesh import MODEL_AXIS

    model_axis = MODEL_AXIS if model_axis is None else model_axis
    names = mesh.mesh_dim_names
    axis_size = mesh.size(names.index(model_axis))
    out = {}
    for name, x in _as_dict(params).items():
        width = x.shape[-1] // 4 if name.split(".")[-1] in ("wi", "wh") else x.shape[-1]
        split = x.dim() >= 2 and width % axis_size == 0 and width >= min_shard_width
        out[name] = tuple(Shard(x.dim() - 1) if split and ax == model_axis else Replicate()
                          for ax in names)
    return out


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


# ---------------------------------------------------------------------------
# training: the twins of kernels L and M, and the entry points
# ---------------------------------------------------------------------------
# optax.adam(1e-3)'s constants (the reference's init_state)
LEARNING_RATE = 1e-3
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def init_state(features: int, hidden: int, latent: int, jobs: int = 1, seed: int = 0):
    """The reference's init_state at PRNGKey(seed), broadcast to `jobs` rows:
    parameters (J, P) float32, Adam's step count (J,) int32 and moments
    (J, P), all on the CPU."""
    from .lstm_init import init_params

    row = init_params(features, hidden, latent, seed)
    params = row[None].repeat(int(jobs), 1).contiguous()
    return (params, torch.zeros(int(jobs), dtype=torch.int32), torch.zeros_like(params),
            torch.zeros_like(params))


def adam_state_from_optax(opt_state) -> tuple:
    """(count, mu (P,), nu (P,)) from the reference's optax.adam state (the
    chain's ScaleByAdamState, after jax.device_get), moments in the flat
    layout."""
    adam = opt_state[0] if isinstance(opt_state, (tuple, list)) else opt_state
    return (int(np.asarray(adam.count)), flat_params(params_from_flax(adam.mu)),
            flat_params(params_from_flax(adam.nu)))


def loss_plain(stack, x, mask, hidden: int, latent: int):
    """Twin of kernel L's value: each job's masked MSE over all its windows,
    sum((recon - x)^2 over mask) / max(sum mask, 1), as (J,). Differentiable
    in stack (J, P) by torch autograd."""
    F = x.shape[-1]
    recon = _recon(unflatten_params(stack, F, hidden, latent), x, mask, int(hidden))
    se = torch.where(mask, (recon - x) ** 2, 0.0)
    return se.sum(dim=(1, 2, 3)) / torch.clamp(mask.sum(dim=(1, 2, 3)).to(_F), min=1.0)


class LstmAeLoss(torch.autograd.Function):
    """Each job's masked MSE (J,) and, backward, its gradient in the (J, P)
    parameters: kernel L's forward and backward on the card (the
    reference's jax.value_and_grad of _loss_fn, vmapped over jobs). The
    backward scales L's gradient row (the numerator's) by grad_out /
    max(sum mask, 1). L's backward overwrites the saved activations, so a
    graph's backward runs once (a second, under retain_graph, raises)."""

    @staticmethod
    def forward(ctx, stack, x, mask, hidden: int, latent: int):
        num, cnt, act = kernels.lstm_train_forward(stack, x, mask, hidden, latent)
        ctx.save_for_backward(stack, x, mask, act, cnt)
        ctx.dims = (int(hidden), int(latent))
        ctx.consumed = False
        return num.sum(1).to(_F) / cnt.sum(1).to(_F).clamp(min=1.0)

    @staticmethod
    def backward(ctx, grad_out):
        if ctx.consumed:
            raise RuntimeError("LstmAeLoss: kernel L's backward consumed the activations; "
                               "run the forward again")
        ctx.consumed = True
        stack, x, mask, act, cnt = ctx.saved_tensors
        gpart = kernels.lstm_train_backward(stack, x, mask, act, *ctx.dims)
        scale = grad_out / cnt.sum(1).to(_F).clamp(min=1.0)
        return gpart[:, 0] * scale[:, None], None, None, None, None


def loss_and_grad(stack, x, mask, *, hidden: int, latent: int, device=None):
    """(loss (J,), grad (J, P)) of each job's masked MSE: kernel L on the
    card, torch autograd through the twin for device="cpu"."""
    dev, stack, x, mask, H, Z = _fleet(stack, x, mask, hidden, latent, device)
    p = stack.detach().clone().requires_grad_(True)
    loss = (LstmAeLoss.apply(p, x, mask, H, Z) if dev.type == "cuda"
            else loss_plain(p, x, mask, H, Z))
    grad, = torch.autograd.grad(loss.sum(), p)
    return loss.detach(), grad


def wgrad_plain(act, rec, features: int, hidden: int, latent: int):
    """Twin of kernel L's weight-gradient entry (kernels.lstm_train_wgrad):
    from the activations as its recurrence entry rewrites them, act (J, K,
    2, W, 5H) with each step's slot (da_t, h_{t-1}), and its window records
    rec (J, K, S), each job's gradient row (J, 1, P) in float32. Per LSTM,
    the recurrent kernel sum h_{t-1}^T da_t over the job's (window, step)
    rows and the bias sum da_t; the encoder's input kernel from its rows'
    [x_t, m_t]; the decoder's from each window's z and its da summed over
    the steps; Dense_0 from the encoder's last h and the latent's gradient;
    Dense_1's gradients summed over the windows. A record holds z (Z), the
    decoder's sum of da (4H), the encoder's last h (H), the latent's
    gradient (Z), Dense_1's kernel (H F) and bias (F) gradients and the
    encoder's input (W 2F)."""
    F, H, Z = int(features), int(hidden), int(latent)
    G = 4 * H
    J, K, _, W, _ = act.shape
    da, hp = act[..., :G], act[..., G:]
    z, ddz, hlast, dzl, d1, inp = torch.split(rec, [Z, G, H, Z, H * F + F, 2 * F * W], dim=-1)
    rows = "jkwa,jkwg->jag"
    parts = [torch.einsum(rows, inp.reshape(J, K, W, 2 * F), da[:, :, 0]),
             torch.einsum(rows, hp[:, :, 0], da[:, :, 0]), da[:, :, 0].sum((1, 2)),
             torch.einsum("jkh,jkz->jhz", hlast, dzl), dzl.sum(1),
             torch.einsum("jkz,jkg->jzg", z, ddz),
             torch.einsum(rows, hp[:, :, 1], da[:, :, 1]), ddz.sum(1), d1.sum(1)]
    return torch.cat([t.reshape(J, -1) for t in parts], 1)[:, None]


def bias_corrections(step):
    """optax's bias corrections 1 - b1^t and 1 - b2^t (float32, (J,)) at
    each job's step t (after the increment): b^t in float64 from float32 b,
    rounded, then 1 - b^t in float32 (XLA's float32 power rounds as this
    does up to t ~ 2,900 for b2)."""
    t = step.to(torch.float64)
    out = []
    for b in (ADAM_B1, ADAM_B2):
        bt = torch.pow(torch.tensor(float(np.float32(b)), dtype=torch.float64), t).to(_F)
        out.append(torch.ones_like(bt) - bt)
    return out


def reduce_partials_plain(gpart, cnt):
    """Kernel M's gradient: kernel L's gradient blocks (J, NG, P; one since
    L writes a row a job) summed in block order in float32, times 1 /
    max(sum mask, 1) (cnt (J, NC) float64, the forward's window blocks)."""
    g = gpart[:, 0].clone()
    for b in range(1, gpart.shape[1]):
        g += gpart[:, b]
    inv = torch.ones(cnt.shape[0], dtype=_F, device=cnt.device) / torch.clamp(
        cnt.sum(1).to(_F), min=1.0)
    return g * inv[:, None]


def adam_plain(params, grad, mu, nu, step, lr: float = LEARNING_RATE):
    """Twin of kernel M's update, in place: optax.adam in its order of
    operations, in float32 with one rounding an operation. mu = (1 - b1) g
    + b1 mu, nu = (1 - b2) g^2 + b2 nu, u = -lr (mu / bc1) / (sqrt(nu /
    bc2) + eps), params + u; step (J,) is each job's count after the
    increment."""
    f32 = np.float32
    c1, c2 = float(f32(1 - ADAM_B1)), float(f32(1 - ADAM_B2))
    b1, b2, eps, nlr = float(f32(ADAM_B1)), float(f32(ADAM_B2)), float(f32(ADAM_EPS)), \
        float(f32(-lr))
    bc1, bc2 = bias_corrections(step.to(grad.device))
    mu.copy_(c1 * grad + b1 * mu)
    nu.copy_(c2 * (grad * grad) + b2 * nu)
    # the square root in float64, rounded: correctly rounded as the card's
    # sqrtf (torch's float32 sqrt on the CPU can be one ulp off)
    root = torch.sqrt((nu / bc2[:, None]).double()).to(_F)
    u = (mu / bc1[:, None]) / (root + eps)
    params.copy_(params + u * nlr)


def train_step_plain(params, step, mu, nu, x, mask, hidden: int, latent: int,
                     lr: float = LEARNING_RATE):
    """Twin of one training step of J jobs, in place: each job's loss and
    gradient by torch autograd, step + 1, then adam_plain. Returns the
    per-job loss (J,) before the update."""
    p = params.detach().clone().requires_grad_(True)
    loss = loss_plain(p, x, mask, hidden, latent)
    grad, = torch.autograd.grad(loss.sum(), p)
    step += 1
    with torch.no_grad():
        adam_plain(params, grad, mu, nu, step, lr)
    return loss.detach()


def train_step(params, step, mu, nu, x, mask, *, hidden: int, latent: int,
               lr: float = LEARNING_RATE):
    """One training step of J jobs, in place on their rows: params, mu, nu
    (J, P) float32 and step (J,) int32 on one device, x and mask (J, K, W,
    F). On the card kernel L's forward and backward (which consumes the
    forward's activations), then kernel M (the gradient's scale and Adam);
    on the CPU train_step_plain. Returns the per-job loss (J,), on the
    device."""
    if x.device.type == "cpu":
        return train_step_plain(params, step, mu, nu, x, mask, hidden, latent, lr)
    num, cnt, act = kernels.lstm_train_forward(params, x, mask, hidden, latent)
    gpart = kernels.lstm_train_backward(params, x, mask, act, hidden, latent)
    del act
    step += 1
    return kernels.adam(params, mu, nu, step, gpart, num, cnt, lr, ADAM_B1, ADAM_B2, ADAM_EPS)


# plateau early stop, the reference's constants and rule (models/lstm_ae.py
# :161-175): checked every 5 epochs from the 10th, stop once the loss
# improves by less than 2% (relative) between consecutive checks
_ES_CHECK_EVERY = 5
_ES_MIN_EPOCHS = 10
_ES_REL_TOL = 0.02


class _Plateau:
    """The reference's stateful plateau check: `stop(done, loss)` is True
    once the loss improves by less than _ES_REL_TOL relatively between
    consecutive checks. `due(done)` says whether `stop` would look at the
    loss at all (so a caller syncs to the host only then)."""

    def __init__(self):
        self._prev = None

    @staticmethod
    def due(done: int) -> bool:
        return done >= _ES_MIN_EPOCHS and done % _ES_CHECK_EVERY == 0

    def stop(self, done: int, loss_scalar: float) -> bool:
        if not self.due(done):
            return False
        prev, self._prev = self._prev, loss_scalar
        return (prev is not None
                and prev - loss_scalar < _ES_REL_TOL * max(prev, 1e-12))


def _train_loop(params, step, mu, nu, x, mask, hidden, latent, epochs, lr, history):
    """Run train_step up to `epochs` times, early-stopped by _Plateau on the
    jobs' mean loss; the mean is read on the host only at the epochs the
    rule looks. history, a list, receives each epoch's mean loss (a 0-d
    tensor on the device)."""
    plateau = _Plateau()
    for e in range(int(epochs)):
        loss = train_step(params, step, mu, nu, x, mask, hidden=hidden, latent=latent, lr=lr)
        mean = loss.mean()
        if history is not None:
            history.append(mean)
        if plateau.due(e + 1) and plateau.stop(e + 1, float(mean)):
            break


def train(x, mask, *, hidden: int, latent: int, epochs: int = 50, lr: float = LEARNING_RATE,
          state=None, device=None):
    """One job's full-batch training on its windows x, mask (K, W, F), from
    state (params (P,), step, mu, nu; init_state's by default), early
    stopped on its loss. Returns ((params, step, mu, nu), loss (0-d)) on the
    device, as the reference's train returns its TrainState and last loss."""
    dev = resolve_device(device)
    x, mask = _windows(x, mask, dev)
    if x.dim() != 3:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (K, W, F)")
    if state is None:
        p, s, m, v = init_state(x.shape[-1], hidden, latent)
    else:
        p, s, m, v = (torch.as_tensor(t)[None].clone() for t in state)
    p, m, v = (t.to(dev, _F).contiguous() for t in (p, m, v))
    s = s.to(dev, torch.int32).contiguous()
    hist = []
    _train_loop(p, s, m, v, x[None], mask[None], int(hidden), int(latent), epochs, lr, hist)
    return (p[0], s[0], m[0], v[0]), (hist[-1] if hist else None)


def train_fleet(x, mask, *, hidden: int, latent: int, epochs: int = 50,
                lr: float = LEARNING_RATE, device=None, history=None):
    """Train J same-shape jobs' autoencoders in one loop, as the reference's
    train_fleet: every job starts from init_state's row (PRNGKey(0)), each
    epoch is one train_step of all J jobs, the plateau rule reads the
    jobs' mean loss (so a job's trained parameters depend on the others in
    its group), then each job's normalizer over its own windows: (mu,
    max(population std, 1e-6)) of its reconstruction errors (kernel K).

    x, mask: (J, K, W, F) training windows. Returns (params (J, P), mu (J,),
    sigma (J,)) on the device. history, a list, receives each epoch's mean
    loss (0-d device tensors)."""
    H, Z = int(hidden), int(latent)
    dev = resolve_device(device)
    x, mask = _windows(x, mask, dev)
    if x.dim() != 4:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected (J, K, W, F)")
    J, F = x.shape[0], x.shape[-1]
    params, step, mu, nu = (t.to(dev) for t in init_state(F, H, Z, J))
    _train_loop(params, step, mu, nu, x, mask, H, Z, epochs, lr, history)
    err = _errors(params, x, mask, H, Z)
    return params, err.mean(1), torch.clamp(err.std(1, unbiased=False), min=1e-6)
