"""PodDefault CRD semantics.

Reference: ``admission-webhook/pkg/apis/settings/v1alpha1/poddefault_types.go:27-112``.
A PodDefault is a namespace-scoped bundle of pod mutations selected by a
label query; the admission webhook merges matching PodDefaults into pods at
create time (see ``kubeflow_tpu_torch.webhooks.poddefault`` for the merge engine).

Spec fields (all optional except ``selector``): ``desc``, ``env``,
``envFrom``, ``volumes``, ``volumeMounts``, ``initContainers``, ``sidecars``,
``tolerations``, ``labels``, ``annotations``, ``imagePullSecrets``,
``serviceAccountName``, ``automountServiceAccountToken``, ``command``,
``args``.

The port's copy of ``kubeflow_tpu/api/poddefault.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, name_of

KIND = "PodDefault"
API_VERSION = keys.API_V1ALPHA1

LIST_FIELDS = (
    "env",
    "envFrom",
    "volumes",
    "volumeMounts",
    "initContainers",
    "sidecars",
    "tolerations",
    "imagePullSecrets",
    "command",
    "args",
)
MAP_FIELDS = ("labels", "annotations")


def new(name: str, namespace: str, selector: dict, **spec_fields) -> dict:
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"selector": selector, **spec_fields},
    }


def validate(pd: dict) -> None:
    name = name_of(pd)
    selector = deep_get(pd, "spec", "selector")
    if selector is None:
        raise Invalid(f"PodDefault {name}: spec.selector is required")
    if not isinstance(selector, dict):
        raise Invalid(f"PodDefault {name}: spec.selector must be a label selector")
    for field in LIST_FIELDS:
        val = deep_get(pd, "spec", field)
        if val is not None and not isinstance(val, list):
            raise Invalid(f"PodDefault {name}: spec.{field} must be a list")
    for field in MAP_FIELDS:
        val = deep_get(pd, "spec", field)
        if val is not None and not isinstance(val, dict):
            raise Invalid(f"PodDefault {name}: spec.{field} must be a map")
