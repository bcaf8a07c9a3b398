"""The port's configuration knobs.

Only the two kernel-grid constants the scoring path reads at import. They are
read from the same environment variables, with the same defaults and the same
tolerant parse, as the reference's registry, so both packages configure
alike.
"""
from __future__ import annotations

import logging
import os

log = logging.getLogger("foremast_tpu_torch.knobs")

__all__ = ["read"]

_KNOBS = {
    # max per-side sample count served by the exact finite-n KS null
    "FOREMAST_KS_EXACT_MAX_T": 256,
    # max n served by the exact Wilcoxon signed-rank null
    "FOREMAST_WILCOXON_EXACT_MAX_N": 50,
}


def read(name: str) -> int:
    """Current value of knob `name`; an empty or unparsable value falls back
    to the default with a log line."""
    default = _KNOBS[name]
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        log.warning("ignoring invalid %s=%r; using %r", name, raw, default)
        return default
