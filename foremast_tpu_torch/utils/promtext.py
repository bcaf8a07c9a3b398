"""Prometheus/Wavefront text-exposition helpers shared by every renderer.

Label values reach these formats from user input (request paths, app
names); unescaped quotes/backslashes/newlines corrupt the whole scrape or
point batch, so every producer must go through escape_label_value().
"""
from __future__ import annotations

import re

_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def escape_label_value(v: str) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def sanitize_metric_name(name: str) -> str:
    """Replace anything outside the Prometheus name charset with '_'."""
    return _NAME_BAD.sub("_", name)
