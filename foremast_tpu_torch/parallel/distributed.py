"""Multi-process scale-out: torch.distributed initialization and the global mesh.

Counterpart of the reference's ``parallel/distributed.py``. There each host
joins a jax.distributed world and the fleet-sharded program spans every
host's chips. Here each process drives one card and joins a
torch.distributed world (NCCL between cards, gloo for device="cpu"); the
fleet scorer (``parallel/fleet.py``) then runs one program per process on
its slice of the batch, and only the fleet reductions cross processes.

Env contract (the reference's variables, read through ``utils.knobs``):

  COORDINATOR_ADDRESS   host:port of process 0 (e.g. "10.0.0.2:8476")
  NUM_PROCESSES         world size
  PROCESS_ID            this process's rank
  LOCAL_DEVICE_IDS      comma-separated local card ids; the first is the
                        card this process drives (default: rank modulo the
                        cards this host has)

The reference's fourth way in, Cloud TPU pod metadata (TPU_WORKER_HOSTNAMES),
becomes a world a launcher has already described: torchrun's WORLD_SIZE,
RANK, MASTER_ADDR and MASTER_PORT, joined through ``env://``.

`HostInfo` and `process_batch_slice` give the host-side scheduler the
slice of a global batch this process scores.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .mesh import backend_for, fleet_mesh
from .._device import resolve_device
from ..utils import knobs

log = logging.getLogger("foremast_tpu_torch.parallel")

__all__ = ["initialize", "HostInfo", "host_info", "global_fleet_mesh",
           "process_batch_slice", "replica_identity"]

_initialized = False

_LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")


def _launcher_world(env) -> bool:
    """torchrun (or any launcher of its contract) described a world of more
    than one process."""
    env = os.environ if env is None else env
    if not all(env.get(k) for k in _LAUNCHER_VARS):
        return False
    try:
        return int(env["WORLD_SIZE"]) > 1
    except ValueError:
        return False


def _card(pid: int, env, dev: torch.device):
    """The card this process drives: LOCAL_DEVICE_IDS' first id, else the
    rank modulo this host's cards. None for the CPU."""
    if dev.type == "cpu":
        return None
    local = knobs.read("LOCAL_DEVICE_IDS", env)
    idx = int(local.split(",")[0]) if local else pid % torch.cuda.device_count()
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, env: dict | None = None, device=None) -> bool:
    """Join (or skip joining) the multi-process world. Idempotent.

    Returns True if this call joined a torch.distributed world, False if
    running single-process (no coordinator configured) or already joined.
    Safe to call unconditionally at startup: single-host deploys proceed
    with their one card. Cards talk over NCCL; device="cpu" joins over
    gloo.
    """
    global _initialized
    if _initialized or dist.is_initialized():
        return False
    coordinator = coordinator or knobs.read("COORDINATOR_ADDRESS", env)
    n = num_processes if num_processes is not None else knobs.read("NUM_PROCESSES", env)
    pid = process_id if process_id is not None else knobs.read("PROCESS_ID", env)
    if not coordinator or n <= 1 or pid < 0:
        # a world the launcher set up (torchrun) is the counterpart of the
        # reference's pod auto-detection; a partial config must not kill a
        # process that works fine alone: warn and proceed local
        if _launcher_world(env):
            e = os.environ if env is None else env
            dev = resolve_device(device)
            kw = {}
            card = _card(int(e["RANK"]), env, dev)
            if card is not None:
                kw["device_id"] = card
            dist.init_process_group(backend_for(dev), init_method="env://",
                                    world_size=int(e["WORLD_SIZE"]), rank=int(e["RANK"]), **kw)
            _initialized = True
            return True
        if coordinator or n > 1:
            log.warning(
                "incomplete multi-process config (COORDINATOR_ADDRESS=%r, "
                "NUM_PROCESSES=%s, PROCESS_ID=%s); need all three — continuing "
                "single-process", coordinator, n, pid,
            )
        return False
    dev = resolve_device(device)
    kw = {}
    card = _card(pid, env, dev)
    if card is not None:
        kw["device_id"] = card
    dist.init_process_group(backend_for(dev), init_method=f"tcp://{coordinator}",
                            world_size=n, rank=pid, **kw)
    _initialized = True
    return True


def replica_identity(env: dict | None = None):
    """(replica_id, static_members) for the sharded brain: each process of a
    multi-process world is one shard-ring replica, its membership fixed by
    the launcher. Once a world is joined it is authoritative; before it
    (or single-process) the NUM_PROCESSES / PROCESS_ID knobs decide.
    Returns ("", None) for a single process."""
    if dist.is_initialized():
        n, pid = dist.get_world_size(), dist.get_rank()
    else:
        n = knobs.read("NUM_PROCESSES", env)
        pid = knobs.read("PROCESS_ID", env)
    if n and n > 1 and pid is not None and pid >= 0:
        return f"proc-{pid}", [f"proc-{i}" for i in range(n)]
    return "", None


@dataclass(frozen=True)
class HostInfo:
    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int


def host_info(env: dict | None = None) -> HostInfo:
    """This process's place in the world: the live world once joined (one
    card a process), else the knobs (a single process unless NUM_PROCESSES
    and PROCESS_ID name a larger world)."""
    if dist.is_initialized():
        n, pid = dist.get_world_size(), dist.get_rank()
    else:
        n = knobs.read("NUM_PROCESSES", env)
        pid = knobs.read("PROCESS_ID", env)
        if n <= 1 or pid < 0:
            n, pid = 1, 0
    return HostInfo(process_id=pid, num_processes=n, local_devices=1, global_devices=n)


def global_fleet_mesh(model_parallel: int = 1, device=None):
    """Fleet mesh over EVERY process of the world (== fleet_mesh single-process)."""
    return fleet_mesh(model_parallel=model_parallel, device=device)


def process_batch_slice(global_batch: int, info: HostInfo | None = None) -> slice:
    """This process's contiguous slice of a fleet-sharded global batch.

    The global batch must divide evenly by the process count (pad first
    with parallel.mesh.pad_to_multiple); each process materializes only its
    slice and hands it to the fleet scorer.
    """
    info = info or host_info()
    if global_batch % info.num_processes != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by "
            f"{info.num_processes} processes; pad it first"
        )
    per = global_batch // info.num_processes
    return slice(info.process_id * per, (info.process_id + 1) * per)
