"""Object helpers copied from ``kubeflow_tpu/runtime/objects.py``: RFC3339
timestamps as the apiserver writes them (``fmt_iso``, ``parse_iso``) and
a dict-shaped object's metadata (``get_meta``, ``name_of``)."""

from __future__ import annotations

import calendar
import time

ISO_FORMAT = "%Y-%m-%dT%H:%M:%SZ"  # k8s RFC3339 second precision


def fmt_iso(ts: float) -> str:
    return time.strftime(ISO_FORMAT, time.gmtime(ts))


def parse_iso(value: str) -> float | None:
    # Fractional seconds are split off and re-added: strptime's %f parses
    # them but struct_time cannot carry them.
    frac = 0.0
    if "." in value:
        head, _, tail = value.partition(".")
        digits = tail.rstrip("Zz")
        if digits.isdigit():
            frac = float(f"0.{digits}")
            value = head + "Z"
    try:
        return calendar.timegm(time.strptime(value, ISO_FORMAT)) + frac
    except ValueError:
        return None


def get_meta(obj: dict) -> dict:
    return obj.setdefault("metadata", {})


def name_of(obj: dict) -> str:
    return get_meta(obj).get("name", "")
