"""Host staging between the engine's packers and the card.

The reference's launch halves hand numpy arrays to jitted programs, which
copy them to the device and return at once (JAX's async dispatch); its
collect halves block on the results. This is the port's counterpart:

- `pack` hands a launch half page-locked host buffers for one (family, T,
  rung) key, which it fills straight from the job windows; `to_device`
  copies them to the card with non_blocking=True on the engine's one
  stream and records an event. A buffer is handed out again only after
  its event has passed (the copy that read it finished), from a small pool
  per key, so pipelined launches never repack a buffer a copy still reads.
- `fetch` copies a launch's outputs back into pinned buffers on the same
  stream; `sync` waits for them once per collect.
- The device copies of the packed inputs are dropped as soon as the launch
  is queued (the counterpart of the reference's buffer donation): the
  caching allocator reuses their memory for later work on the same stream.

On the CPU nothing is pinned or copied: buffers are plain arrays that the
plain twins read directly.
"""
from __future__ import annotations

import contextlib
import itertools

import numpy as np
import torch

__all__ = ["Staging"]

_NP = {torch.float32: np.float32, torch.int32: np.int32, torch.bool: np.bool_}

# pinned input buffers per (family, T, rung) key: launches in flight before
# the oldest copy must have finished
_POOL_DEPTH = 4


class _Slot:
    __slots__ = ("host", "tensors", "event", "order")

    def __init__(self, tensors: dict):
        self.tensors = tensors
        self.host = {k: t.numpy() for k, t in tensors.items()}
        self.event = None  # recorded after the copy that reads the buffers
        self.order = 0


class Staging:
    """One engine's host<->card staging (single-threaded use per phase,
    like CyclePipeline: launches from the cycle thread, collects from it or
    its watchdog thread, never both at once)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._inputs: dict = {}    # key -> [_Slot]
        self._outputs: dict = {}   # (key, name) -> [pinned tensor]
        self._taken: dict = {}     # (key, name) -> outputs fetched this collect
        self._order = itertools.count()  # copy order: a full pool waits on its oldest

    def on_stream(self):
        """Context for launches and copies: the engine's stream on the card."""
        return torch.cuda.stream(self.stream) if self.cuda else contextlib.nullcontext()

    def pack(self, key, specs, rows: int, T: int) -> _Slot:
        """Host buffers for one launch: `specs` is [(name, dtype, cols)],
        cols "T" for (rows, T), None for (rows,), an int k for (rows, k)."""
        def shape(cols):
            return (rows,) if cols is None else (rows, T if cols == "T" else cols)

        if not self.cuda:
            return _Slot({n: torch.from_numpy(np.zeros(shape(c), _NP[dt]))
                          for n, dt, c in specs})
        pool = self._inputs.setdefault(key, [])
        for slot in pool:
            if slot.event is None or slot.event.query():
                return slot
        if len(pool) < _POOL_DEPTH:
            slot = _Slot({n: torch.empty(shape(c), dtype=dt, pin_memory=True)
                          for n, dt, c in specs})
            pool.append(slot)
            return slot
        slot = min(pool, key=lambda s: s.order)
        slot.event.synchronize()
        return slot

    def to_device(self, slot: _Slot) -> dict:
        """The slot's buffers on the card (call inside `on_stream`)."""
        if not self.cuda:
            return dict(slot.tensors)
        dev = {k: t.to(self.device, non_blocking=True) for k, t in slot.tensors.items()}
        slot.event = torch.cuda.Event()
        slot.event.record(self.stream)
        slot.order = next(self._order)
        return dev

    def begin_collect(self) -> None:
        self._taken = {}

    def fetch(self, key, outs: dict) -> dict:
        """Enqueue the copy of a launch's outputs into pinned buffers (call
        inside `on_stream`, then `sync`); returns their numpy views."""
        if not self.cuda:
            return {k: v.numpy() for k, v in outs.items()}
        host = {}
        for name, t in outs.items():
            i = self._taken.get((key, name), 0)
            self._taken[(key, name)] = i + 1
            pool = self._outputs.setdefault((key, name), [])
            if i == len(pool) or pool[i].shape != t.shape or pool[i].dtype != t.dtype:
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                if i == len(pool):
                    pool.append(buf)
                else:
                    pool[i] = buf
            pool[i].copy_(t, non_blocking=True)
            host[name] = pool[i].numpy()
        return host

    def sync(self) -> None:
        if self.cuda:
            self.stream.synchronize()
