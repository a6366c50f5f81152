"""InferenceService semantics the fleet scheduler needs: a trimmed copy of
``kubeflow_tpu/api/inferenceservice.py``.

The scheduler tells a serving replica's gang from a notebook's by the
workload-class label, and names a replica's gang ``<service>#r<i>``. The
rest of the module (the CRD's spec, defaulting, validation and the park
protocol) comes with the serving controller.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.objects import get_meta

WORKLOAD_CLASS_LABEL = keys.WORKLOAD_CLASS_LABEL
SERVING_CLASS = "serving"


def parse_replica_key(key: tuple) -> tuple[str, int] | None:
    """(service name, replica index) for a serving replica key, else None."""
    name = key[1]
    if "#r" not in name:
        return None
    base, _, idx = name.rpartition("#r")
    try:
        return base, int(idx)
    except ValueError:
        return None


def is_serving_class(obj: dict) -> bool:
    """Does this object (any kind) carry the serving workload-class
    label? The culler and the victim search key their guards on this."""
    return (get_meta(obj).get("labels") or {}).get(
        WORKLOAD_CLASS_LABEL) == SERVING_CLASS
