"""Step-level training telemetry: profiler -> annotation -> scheduler.

The port of ``kubeflow_tpu/telemetry``. A low-overhead per-step recorder
(:mod:`profiler`) runs inside the training loop and summarizes rolling
windows (never raw streams) into achieved MFU, the compile-vs-run split
(in the port: the first step's allocations and kernel builds),
collective-overlap attribution (:mod:`sections`) and the card's memory
high-water; a single writer (:mod:`publisher`) exports the summary as a
compact capped annotation plus Prometheus series; and the per-family x
shape efficiency ledger (:mod:`ledger`) folds the numbers into the
placement signal. Only the profiler touches the device: its sync and its
memory read are torch.

Master switch is ``KFTPU_TELEMETRY`` (default on). ``set_enabled`` is the
in-process override a paired A/B flips between trials.
"""

from __future__ import annotations

import os

TELEMETRY_ENABLED_ENV = "KFTPU_TELEMETRY"

_DISABLED_VALUES = ("off", "false", "0", "no", "disabled")

# In-process override for paired A/B benches: None -> follow the env
# var; True/False -> forced.
_enabled_override: bool | None = None


def telemetry_enabled(environ=os.environ) -> bool:
    """Default-on parse of the master switch."""
    raw = environ.get(TELEMETRY_ENABLED_ENV)
    if raw is None:
        return True
    return raw.strip().lower() not in _DISABLED_VALUES


def set_enabled(on: bool | None) -> None:
    """Force telemetry on/off in-process (``None`` restores the env)."""
    global _enabled_override
    _enabled_override = on


def is_enabled(environ=os.environ) -> bool:
    if _enabled_override is not None:
        return _enabled_override
    return telemetry_enabled(environ)


from kubeflow_tpu_torch.telemetry.ledger import EfficiencyLedger  # noqa: E402
from kubeflow_tpu_torch.telemetry.profiler import (  # noqa: E402
    StepProfiler,
    overlap_fraction,
)
from kubeflow_tpu_torch.telemetry.publisher import (  # noqa: E402
    TelemetryPublisher,
)

__all__ = [
    "EfficiencyLedger",
    "StepProfiler",
    "TELEMETRY_ENABLED_ENV",
    "TelemetryPublisher",
    "is_enabled",
    "overlap_fraction",
    "set_enabled",
    "telemetry_enabled",
]
