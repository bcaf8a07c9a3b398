"""RFC3339 <-> unix seconds (wire format of the healthcheck API)."""
from __future__ import annotations

from datetime import datetime, timezone


def from_rfc3339(s: str) -> float:
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    return datetime.fromisoformat(s).timestamp()


def to_rfc3339(t: float) -> str:
    return (
        datetime.fromtimestamp(t, tz=timezone.utc)
        .isoformat(timespec="seconds")
        .replace("+00:00", "Z")
    )
