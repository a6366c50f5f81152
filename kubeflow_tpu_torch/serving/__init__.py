"""The serving workload class on PyTorch: the data plane and its control
plane.

- :mod:`kubeflow_tpu_torch.serving.engine` — the serving loop: paged KV
  admission, prefill/decode lanes, warm model standbys, park / warm
  restore, over the burn-in transformer.
- :mod:`kubeflow_tpu_torch.serving.kvcache` — the KV block pool.
- :mod:`kubeflow_tpu_torch.serving.loadgen` — seeded open-loop traces.
- :mod:`kubeflow_tpu_torch.serving.autoscaler` — pure replica-count
  policy (request-rate/concurrency driven, min/max bounds,
  scale-to-zero after an idle window, scale-down stabilization).
- :mod:`kubeflow_tpu_torch.serving.controller` — the InferenceService
  reconciler: per-replica GPU slice StatefulSets + a Service, each
  replica admitted through the fleet scheduler as a gang
  (``GpuFleetScheduler.serving_admission`` — one card ledger with the
  notebooks), scale-to-zero parking through a checkpoint drain, and
  warm restore on the first burst.

Kill switch: ``KFTPU_SERVING=off`` (:func:`serving_enabled`) keeps the
notebook-only control plane: no serving controller and no serving
webhooks.
"""

from __future__ import annotations

import os

SERVING_ENV = "KFTPU_SERVING"


def serving_enabled(environ=os.environ) -> bool:
    """The ``KFTPU_SERVING`` master switch — anything but off/false/0/no
    leaves the serving workload class on (it is inert until an
    InferenceService CR exists)."""
    return environ.get(SERVING_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )
