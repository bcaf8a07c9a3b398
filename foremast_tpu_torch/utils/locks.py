"""Lock factory: every lock of the port's threaded modules (engine/,
dataplane/, resilience/) is built here with a stable dotted name.

The reference routes these names to its lock tracer when
FOREMAST_DEBUG_LOCKS=1; the port has no lock tracer yet (its devtools are
not ported), so the factory returns the plain threading primitives and the
names document which lock is which.
"""
from __future__ import annotations

import threading

__all__ = ["make_lock", "make_rlock"]


def make_lock(name: str):
    """A mutex for ``with``/acquire/release use, named for the reader."""
    return threading.Lock()


def make_rlock(name: str):
    """Re-entrant variant of make_lock."""
    return threading.RLock()
