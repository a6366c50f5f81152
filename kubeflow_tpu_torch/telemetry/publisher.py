"""Single-writer export path for step telemetry.

A copy of ``kubeflow_tpu/telemetry/publisher.py`` (it has no JAX): the
annotation key is a constant here, equal to the JAX package's
``api.keys.NOTEBOOK_TPU_TELEMETRY``, and the series go to the port's
``runtime/metrics.py`` copy.

The summary travels in ONE compact, capped JSON annotation
(``TELEMETRY_ANNOTATION``) so it survives controller restarts and is
readable by the notebook controller, the web app's status and the
scheduler without a side channel. This module is the annotation's only
writer; everything else (controller fold, status message, efficiency
ledger) is a *reader*.

Wire format (short keys — the cap is bytes, not fields)::

    {"v": 1, "seq": 7, "at": 1754550000.0, "family": "moe",
     "step": 1200, "mfu": 0.57, "basis": "accelerator",
     "step_sec": 0.012, "tok_s": 81000, "overlap": 0.41,
     "compile_sec": 8.2, "hbm": 123456789}

Publishes are rate-limited (``KFTPU_TELEMETRY_PUBLISH_SECONDS``) and the
encoded payload is capped (``KFTPU_TELEMETRY_MAX_CHARS``) by dropping
optional fields, never by emitting torn JSON.
"""

from __future__ import annotations

import json
import logging
import os
import time

from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry

logger = logging.getLogger(__name__)

# The notebook annotation this module alone writes (the JAX package's
# ``api.keys.NOTEBOOK_TPU_TELEMETRY``).
TELEMETRY_ANNOTATION = "notebooks.kubeflow.org/tpu-telemetry"

PUBLISH_SECONDS_ENV = "KFTPU_TELEMETRY_PUBLISH_SECONDS"
DEFAULT_PUBLISH_SECONDS = 30.0

MAX_CHARS_ENV = "KFTPU_TELEMETRY_MAX_CHARS"
DEFAULT_MAX_CHARS = 2048

STALE_SECONDS_ENV = "KFTPU_TELEMETRY_STALE_SECONDS"
DEFAULT_STALE_SECONDS = 120.0

# Dropped one by one (front first) when the encoded payload exceeds the
# cap; the core fields (v/seq/at/family/step/mfu/step_sec) always fit.
_OPTIONAL_FIELDS = ("hbm", "compile_sec", "tok_s", "basis", "overlap")


def publish_seconds(environ=os.environ) -> float:
    raw = environ.get(PUBLISH_SECONDS_ENV)
    try:
        return float(raw) if raw is not None else DEFAULT_PUBLISH_SECONDS
    except ValueError:
        return DEFAULT_PUBLISH_SECONDS


def max_chars(environ=os.environ) -> int:
    raw = environ.get(MAX_CHARS_ENV)
    try:
        value = int(raw) if raw is not None else DEFAULT_MAX_CHARS
    except ValueError:
        return DEFAULT_MAX_CHARS
    return max(256, value)


def stale_after_seconds(environ=os.environ) -> float:
    raw = environ.get(STALE_SECONDS_ENV)
    try:
        return float(raw) if raw is not None else DEFAULT_STALE_SECONDS
    except ValueError:
        return DEFAULT_STALE_SECONDS


def _round(value, digits):
    return None if value is None else round(float(value), digits)


def encode(summary: dict, *, seq: int, at: float,
           cap: int | None = None) -> str:
    """Profiler summary -> capped wire JSON (compact separators)."""
    entry = {
        "v": 1,
        "seq": int(seq),
        "at": round(float(at), 3),
        "family": str(summary.get("family") or "")[:48],
        "step": int(summary.get("step") or 0),
        "mfu": _round(summary.get("mfu"), 4),
        "step_sec": _round(summary.get("step_p50_sec"), 6),
        "overlap": _round(summary.get("overlap_fraction"), 4),
        "basis": summary.get("mfu_basis"),
        "tok_s": _round(summary.get("tokens_per_sec"), 1),
        "compile_sec": _round(summary.get("compile_sec"), 3),
        "hbm": summary.get("hbm_high_water_bytes"),
    }
    entry = {k: v for k, v in entry.items() if v is not None}
    cap = cap if cap is not None else max_chars()
    payload = json.dumps(entry, separators=(",", ":"))
    for field in _OPTIONAL_FIELDS:
        if len(payload) <= cap:
            break
        entry.pop(field, None)
        payload = json.dumps(entry, separators=(",", ":"))
    return payload


def decode(annotations: dict | None) -> dict | None:
    """Annotation map -> telemetry entry, or None when absent/corrupt.
    Corruption degrades to 'no telemetry' (the stale path), never an
    exception into a reconcile."""
    raw = (annotations or {}).get(TELEMETRY_ANNOTATION)
    if not raw:
        return None
    try:
        entry = json.loads(raw)
    except (TypeError, ValueError):
        logger.warning("undecodable telemetry annotation: %.80r", raw)
        return None
    if not isinstance(entry, dict) or "at" not in entry:
        return None
    try:
        entry["at"] = float(entry["at"])
        entry["seq"] = int(entry.get("seq", 0))
        entry["step"] = int(entry.get("step", 0))
    except (TypeError, ValueError):
        return None
    return entry


def is_stale(entry: dict, now: float,
             stale_after: float | None = None) -> bool:
    window = stale_after if stale_after is not None else stale_after_seconds()
    return (now - float(entry.get("at", 0.0))) > window


def publish_metrics(summary: dict, registry: Registry | None = None) -> None:
    """Update the Prometheus series from a summary/entry dict. Used by
    the SDK-side publisher and by the controller fold (so the manager's
    /metrics carries fleet-wide training telemetry)."""
    registry = registry or global_registry
    family = str(summary.get("family") or "unknown")
    pairs = (
        ("tpu_training_mfu",
         "achieved model FLOPs utilization (rolling-window p50)",
         summary.get("mfu")),
        ("tpu_training_step_seconds",
         "training step wall time p50 over the rolling window",
         summary.get("step_p50_sec", summary.get("step_sec"))),
        ("tpu_training_overlap_fraction",
         "fraction of serialized step time hidden by comm/compute overlap",
         summary.get("overlap_fraction", summary.get("overlap"))),
        ("tpu_training_hbm_bytes",
         "HBM high-water mark for the training step",
         summary.get("hbm_high_water_bytes", summary.get("hbm"))),
    )
    for name, help_, value in pairs:
        if value is None:
            continue
        registry.gauge(name, help_, ["family"]).labels(
            family=family).set(float(value))


class TelemetryPublisher:
    """The one writer of the telemetry annotation.

    ``patcher(body)`` applies a merge-patch to the owning Notebook (the
    SDK wires ``sdk._in_cluster_patcher``; tests inject a recorder).
    Publishes are rate-limited to ``min_interval`` seconds unless
    ``force=True`` (final flush). A failed patch is counted and retried
    at the next window — telemetry must never take down the loop.
    """

    def __init__(self, patcher, *, min_interval: float | None = None,
                 cap: int | None = None, registry: Registry | None = None,
                 now_fn=time.time, clock=time.monotonic,
                 environ=os.environ):
        self._patcher = patcher
        self._min_interval = (min_interval if min_interval is not None
                              else publish_seconds(environ))
        self._cap = cap if cap is not None else max_chars(environ)
        self._registry = registry
        self._now_fn = now_fn
        self._clock = clock
        self.seq = 0
        self.errors = 0
        self.last_error: str | None = None
        self._last_publish: float | None = None

    def publish(self, summary: dict, *, force: bool = False) -> bool:
        now = self._clock()
        if (not force and self._last_publish is not None
                and now - self._last_publish < self._min_interval):
            return False
        self.seq += 1
        payload = encode(summary, seq=self.seq, at=self._now_fn(),
                         cap=self._cap)
        publish_metrics(summary, self._registry)
        try:
            self._patcher(
                {"metadata": {"annotations": {TELEMETRY_ANNOTATION: payload}}}
            )
        except Exception as exc:
            # Counted + logged; a failed telemetry patch must never take
            # down the training loop — the next window retries.
            self.errors += 1
            self.last_error = repr(exc)
            logger.warning("telemetry publish failed (attempt %d): %s",
                           self.seq, exc)
            return False
        self._last_publish = now
        return True
