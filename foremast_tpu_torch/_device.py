"""Device choice and input checks shared by the port's entry points."""
from __future__ import annotations

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: "cuda" unless the caller names one.

    Without a card, "cuda" raises rather than falling back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch version")
    return dev


def as_tensor(a, dtype: torch.dtype, device: torch.device, name: str,
              shape: tuple | None = None) -> torch.Tensor:
    """`a` as a contiguous tensor of `dtype` on `device`.

    numpy (or list) input is converted and moved; a tensor must already lie
    on `device` and have `dtype`. `shape`, when given, must match exactly.
    """
    if isinstance(a, torch.Tensor):
        if a.device.type != device.type or (
                device.index is not None and a.device != device):
            raise ValueError(f"{name} is on {a.device}, not on {device}")
        if a.dtype != dtype:
            raise TypeError(f"{name} has dtype {a.dtype}, expected {dtype}")
        t = a.contiguous()
    else:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=_NP_DTYPES[dtype])).to(device)
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if shape is None and t.dim() != 2:
        raise ValueError(f"{name} must be (B, T), got shape {tuple(t.shape)}")
    return t
