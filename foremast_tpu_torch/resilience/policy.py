"""Cycle deadlines for fetches and their retries.

A copy of the reference's `Deadline` (``resilience/policy.py``); the retry
policy and budget around it are not ported yet. The analyzer arms one per
cycle on a data source that accepts it (`set_cycle_deadline`), so retries
inside a resilient source can never overrun the cycle.
"""
from __future__ import annotations

import time
from typing import Callable

__all__ = ["Deadline"]


class Deadline:
    """Monotonic-clock deadline threaded through a fetch and its retries.

    Immutable after construction, so one instance is safely shared by every
    worker thread of a cycle (analyzer sets one per cycle; each retry loop
    only reads it)."""

    __slots__ = ("at", "_clock")

    def __init__(self, at: float, clock: Callable[[], float] = time.monotonic):
        self.at = float(at)
        self._clock = clock

    @classmethod
    def after(cls, seconds: float,
              clock: Callable[[], float] = time.monotonic) -> "Deadline":
        return cls(clock() + float(seconds), clock)

    def remaining(self) -> float:
        return self.at - self._clock()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def clip(self, delay: float) -> float:
        """Largest sleep <= delay that still wakes before the deadline."""
        return max(0.0, min(float(delay), self.remaining()))
