"""GPU fleet scheduler: gang admission, fair-share queueing, idle
preemption. The port of ``kubeflow_tpu/scheduler`` in GPU units: the
ledger's "chips" are cards (``nvidia.com/gpu``) and its "hosts" nodes.

Three layers, least pure on top:

- :mod:`kubeflow_tpu_torch.scheduler.fleet` — node-pool inventory + chip
  ledger (pure; invariant: admitted never exceeds capacity, gangs are
  all-or-nothing);
- :mod:`kubeflow_tpu_torch.scheduler.policy` — deterministic arbitration
  (priority classes, DRF fair share on chips, aging, preemption);
- :mod:`kubeflow_tpu_torch.scheduler.runtime` — the async admission point the
  notebook controller's capacity stage consults, with tracing, metrics,
  Events and ``/debug/scheduler``.

Kill switch: ``KFTPU_SCHEDULER=off`` (see :func:`scheduler_enabled`)
restores the pre-scheduler behavior — the capacity stage goes straight
to queued provisioning. With the scheduler on but no fleet configured,
admission is a transparent pass-through (also today's behavior), so the
subsystem only bites once an operator declares or auto-infers a fleet.
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.scheduler.fleet import (  # noqa: F401
    Allocation,
    ChipLedger,
    Fleet,
    FleetConfigError,
    LedgerError,
    NodePool,
)
from kubeflow_tpu_torch.scheduler.policy import (  # noqa: F401
    GangRequest,
    PolicyConfig,
    PolicyQueue,
    ScheduleResult,
)
from kubeflow_tpu_torch.scheduler.elastic import (  # noqa: F401
    DefragMove,
    ElasticConfig,
    IntentBook,
    ScaleUpIntent,
    defrag_enabled,
    elastic_enabled,
)
from kubeflow_tpu_torch.scheduler.runtime import (  # noqa: F401
    Admission,
    SchedulerOptions,
    GpuFleetScheduler,
    parse_priority,
)


SCHEDULER_ENV = "KFTPU_SCHEDULER"


def scheduler_enabled() -> bool:
    """The ``KFTPU_SCHEDULER`` kill switch: anything but off/false/0/no
    leaves the scheduler on (it is inert until a fleet is configured)."""
    return os.environ.get(SCHEDULER_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )
