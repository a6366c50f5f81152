"""PVCViewer CRD semantics (the port of ``kubeflow_tpu/api/pvcviewer.py``).

Reference: ``pvcviewer-controller/api/v1alpha1/pvcviewer_types.go:27-93`` —
spec names a PVC plus an optional podSpec (defaulted by webhook from a file)
and networking overrides; the controller renders a filebrowser Deployment +
Service + VirtualService over the claim.
"""

from __future__ import annotations

import copy

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, name_of

KIND = "PVCViewer"
API_VERSION = keys.API_V1ALPHA1

DEFAULT_TARGET_PORT = 8080
DEFAULT_BASE_PREFIX = "/pvcviewer"

# Default viewer pod (the reference ships this as a mounted file read by the
# defaulting webhook, pvcviewer_webhook.go:33-60; we inline the equivalent).
DEFAULT_POD_SPEC = {
    "containers": [
        {
            "name": "pvcviewer",
            "image": "filebrowser/filebrowser:latest",
            "args": ["--noauth", "--root", "/data", "--port", str(DEFAULT_TARGET_PORT)],
            "ports": [{"containerPort": DEFAULT_TARGET_PORT}],
            "volumeMounts": [{"name": "viewer-volume", "mountPath": "/data"}],
            "securityContext": {
                "runAsNonRoot": True,
                "runAsUser": 1000,
                "allowPrivilegeEscalation": False,
            },
        }
    ],
}


def new(name: str, namespace: str, pvc: str, *, rwo_scheduling: bool = True) -> dict:
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name, "namespace": namespace},
        "spec": {"pvc": pvc, "rwoScheduling": rwo_scheduling},
    }


def default(viewer: dict) -> None:
    """Defaulting webhook equivalent: fill podSpec + networking + volume."""
    spec = viewer.setdefault("spec", {})
    if not spec.get("podSpec"):
        spec["podSpec"] = copy.deepcopy(DEFAULT_POD_SPEC)
    networking = spec.setdefault("networking", {})
    networking.setdefault("targetPort", DEFAULT_TARGET_PORT)
    networking.setdefault("basePrefix", DEFAULT_BASE_PREFIX)
    spec.setdefault("rwoScheduling", False)
    # Wire the PVC into the pod spec volume named viewer-volume.
    pvc = spec.get("pvc")
    if pvc:
        volumes = spec["podSpec"].setdefault("volumes", [])
        if not any(v.get("name") == "viewer-volume" for v in volumes):
            volumes.append(
                {"name": "viewer-volume", "persistentVolumeClaim": {"claimName": pvc}}
            )


def validate(viewer: dict) -> None:
    name = name_of(viewer)
    if not deep_get(viewer, "spec", "pvc"):
        raise Invalid(f"PVCViewer {name}: spec.pvc is required")
