"""Tensorboard CRD semantics (the port of ``kubeflow_tpu/api/tensorboard.py``).

Reference: ``tensorboard-controller/api/v1alpha1/tensorboard_types.go:28-63``
— spec is a single ``logspath``; the controller renders it into a Deployment
+ Service (+ VirtualService). Supported schemes
(``tensorboard_controller.go:380-410``):

- ``pvc://<claim>/<subpath>`` — mount the PVC at /tensorboard_logs
- ``gs://…``                  — GCS, read directly
- ``s3://…``                  — S3 via creds secret

``spec.profilerPlugin: bool`` — serve the TensorBoard profile plugin over
the logdir, where ``sdk.trace`` and ``sdk.capture_profile`` write their
``torch.profiler`` traces (``*.pt.trace.json``) and the plugin's capture
button, pointed at a notebook running ``sdk.start_profiler_server``, its
``*.xplane.pb``.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, name_of

KIND = "Tensorboard"
API_VERSION = keys.TENSORBOARD_API_V1ALPHA1

SCHEME_PVC = "pvc"
SCHEME_GCS = "gs"
SCHEME_S3 = "s3"


def new(name: str, namespace: str, logspath: str, *, profiler: bool = False) -> dict:
    spec: dict = {"logspath": logspath}
    if profiler:
        spec["profilerPlugin"] = True
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec,
    }


def parse_logspath(logspath: str) -> tuple[str, str, str]:
    """→ (scheme, pvc_name, container_path).

    For pvc:// the mount path is a fixed /tensorboard_logs[/subpath]
    (reference ``tensorboard_controller.go:380-410``); for object stores the
    path is passed straight to --logdir.
    """
    if logspath.startswith("pvc://"):
        rest = logspath[len("pvc://"):]
        claim, _, sub = rest.partition("/")
        if not claim:
            raise Invalid(f"malformed logspath {logspath!r}: missing pvc name")
        mount = "/tensorboard_logs"
        return SCHEME_PVC, claim, f"{mount}/{sub}" if sub else mount
    if logspath.startswith("gs://"):
        return SCHEME_GCS, "", logspath
    if logspath.startswith("s3://"):
        return SCHEME_S3, "", logspath
    # bare paths are treated as in-container paths (reference default branch)
    return "", "", logspath


def validate(tb: dict) -> None:
    name = name_of(tb)
    logspath = deep_get(tb, "spec", "logspath")
    if not logspath:
        raise Invalid(f"Tensorboard {name}: spec.logspath is required")
    parse_logspath(str(logspath))
