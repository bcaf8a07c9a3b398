"""The port's configuration knobs.

The kernel-grid constants the scoring path reads at import, the native
parser's switch and compiler, and the multi-process world
(``parallel/distributed.py``). They are read from the same environment
variables, with the same defaults and the same tolerant parse, as the
reference's registry, so both packages configure alike. (The engine's own
knobs are EngineConfig's, ``engine/config.py``.)

The reference's TPU_WORKER_HOSTNAMES (Cloud TPU pod metadata, whose
presence selects jax.distributed's auto-detection) has no knob here: its
GPU counterpart is a world a launcher has already described, torchrun's
WORLD_SIZE, RANK, MASTER_ADDR and MASTER_PORT, which
``parallel.distributed.initialize`` joins through ``env://``.
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger("foremast_tpu_torch.knobs")

__all__ = ["read", "parse_bool"]


def parse_bool(raw: str) -> bool:
    """One definition of env truthiness (0/1, true/false, yes/no, on/off)."""
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


_KNOBS = {
    # max per-side sample count served by the exact finite-n KS null
    "FOREMAST_KS_EXACT_MAX_T": (256, int),
    # max n served by the exact Wilcoxon signed-rank null
    "FOREMAST_WILCOXON_EXACT_MAX_N": (50, int),
    # 0 disables the native parser (native/); the Python fallback stays
    "FOREMAST_NATIVE": (True, parse_bool),
    # compiler for the native parser's build on first use
    "CXX": ("g++", str),
    # the multi-process world: host:port of process 0, world size, this
    # process's rank, and the local card ids (comma-separated; the first is
    # the card this process drives)
    "COORDINATOR_ADDRESS": ("", str),
    "NUM_PROCESSES": (0, int),
    "PROCESS_ID": (-1, int),
    "LOCAL_DEVICE_IDS": ("", str),
}


def read(name: str, env=None):
    """Current value of knob `name` in `env` (default os.environ); an empty
    or unparsable value falls back to the default with a log line."""
    default, cast = _KNOBS[name]
    raw = (os.environ if env is None else env).get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except ValueError:
        log.warning("ignoring invalid %s=%r; using %r", name, raw, default)
        return default
