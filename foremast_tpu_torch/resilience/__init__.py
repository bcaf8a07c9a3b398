"""Resilience primitives the engine cycle needs (the rest of the
reference's resilience layer is not ported yet)."""
from .policy import Deadline  # noqa: F401
