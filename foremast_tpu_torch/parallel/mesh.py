"""The fleet mesh and its placements, on torch.distributed.

Counterpart of the reference's ``parallel/mesh.py``. The reference lays a
(fleet, model) jax Mesh over its chips and shards the batch axis across
the fleet axis. Here one process drives one card, so the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the processes of the
world, of shape (world / model_parallel, model_parallel) named
("fleet", "model"); its "fleet" process group carries the fleet
reductions (``parallel.fleet``).

Axes, as in the reference:
  fleet - the (service x metric x window) batch axis: each process scores
          its own slice, and only the final reductions communicate;
  model - reserved for the LSTM scorer's tensor parallelism
          (``models.lstm_ae.param_shardings``), size 1 in the common case.

Without a world (no ``parallel.distributed.initialize`` before), the mesh
makes a world of one on a ``torch.distributed.HashStore``, so the fleet
collectives are real collectives on one card too.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["fleet_mesh", "fleet_sharding", "replicated", "pad_to_multiple", "world_of_one",
           "FLEET_AXIS", "MODEL_AXIS"]

FLEET_AXIS = "fleet"
MODEL_AXIS = "model"


def backend_for(device) -> str:
    """NCCL for the card, gloo for device="cpu"."""
    return "gloo" if resolve_device(device).type == "cpu" else "nccl"


def world_of_one(device=None) -> bool:
    """Start a world of one process on a HashStore unless a world exists.
    Returns True if it started one (the caller may destroy it with
    torch.distributed.destroy_process_group)."""
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        kw["device_id"] = torch.device("cuda", torch.cuda.current_device()
                                       if dev.index is None else dev.index)
    dist.init_process_group(backend_for(dev), store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    return True


def fleet_mesh(devices: Sequence[int] | None = None, model_parallel: int = 1, device=None):
    """(fleet, model) DeviceMesh over the given ranks (default: every
    process of the world), one card (or, for device="cpu", one CPU process)
    a rank."""
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    world_of_one(dev)
    ranks = list(devices if devices is not None else range(dist.get_world_size()))
    n = len(ranks)
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    mesh = torch.tensor(ranks, dtype=torch.int64).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(dev.type, mesh, mesh_dim_names=(FLEET_AXIS, MODEL_AXIS))


def fleet_sharding(mesh):
    """Batch-dim placements: the leading axis split across the fleet axis,
    replicated across the model axis."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicated(mesh):
    """Placements of a value every process holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(), Replicate())


def pad_to_multiple(arrs, multiple: int, batch_axis: int = 0):
    """Right-pad every array's batch axis to a multiple (shardability).

    Returns (padded_arrays, original_B). Pads with zeros; callers carry
    masks, so padded rows score as fully-masked no-ops.
    """
    B = arrs[0].shape[batch_axis]
    rem = B % multiple
    if rem == 0:
        return list(arrs), B
    pad = multiple - rem
    out = []
    for a in arrs:
        widths = [(0, 0)] * a.ndim
        widths[batch_axis] = (0, pad)
        out.append(np.pad(np.asarray(a), widths))
    return out, B
