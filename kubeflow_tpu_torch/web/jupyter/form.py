"""Form → Notebook CR assembly.

Reference: ``crud-web-apps/jupyter/backend/apps/common/form.py`` (setters
for image/cpu/memory/gpus/tolerations/affinity/shm/configurations, composed
by ``apps/default/routes/post.py:12-77`` over ``notebook_template.yaml``).
Ours builds the CR directly (the template is the ``api.notebook.new``
contract), with the same readOnly enforcement and the GPU slice picker
replacing the GPU vendor spinner.

The port of ``kubeflow_tpu/web/jupyter/form.py``: the picker's choice
becomes ``spec.gpu`` (``accelerator``, ``topology``, ``numSlices``,
``queuedProvisioning``), and a form that posts the JAX package's ``tpu``
block is refused with ``Invalid`` naming ``gpu``, as the API refuses a
``spec.tpu`` Notebook.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.web.jupyter.spawner_config import (
    SERVER_TYPE_GROUP_ONE,
    SERVER_TYPE_GROUP_TWO,
    SERVER_TYPE_JUPYTER,
    get_form_value,
)


def notebook_from_form(config: dict, body: dict, namespace: str, user: str) -> tuple[dict, list[dict]]:
    """→ (notebook CR, PVCs to create). Raises Invalid on bad input."""
    name = body.get("name", "")
    if not name:
        raise Invalid("form: name is required")

    server_type = body.get("serverType", SERVER_TYPE_JUPYTER)
    image = _image_for(config, body, server_type)

    cpu = str(get_form_value(config, body, "cpu"))
    memory = str(get_form_value(config, body, "memory"))
    cpu_limit = _scaled(cpu, config.get("cpu", {}).get("limitFactor"))
    memory_limit = _scaled_mem(memory, config.get("memory", {}).get("limitFactor"))

    container: dict = {
        "name": name,
        "image": image,
        "imagePullPolicy": get_form_value(config, body, "imagePullPolicy"),
        "resources": {
            "requests": {"cpu": cpu, "memory": memory},
            "limits": {"cpu": cpu_limit, "memory": memory_limit},
        },
        "env": [],
        "volumeMounts": [],
    }
    pod_spec: dict = {"containers": [container], "volumes": []}

    for k, v in (get_form_value(config, body, "environment") or {}).items():
        container["env"].append({"name": k, "value": str(v)})

    pvcs = _apply_volumes(config, body, name, namespace, pod_spec, container)

    if get_form_value(config, body, "shm"):
        pod_spec["volumes"].append(
            {"name": "dshm", "emptyDir": {"medium": "Memory"}}
        )
        container["volumeMounts"].append({"name": "dshm", "mountPath": "/dev/shm"})

    _apply_tolerations(config, body, pod_spec)
    _apply_affinity(config, body, pod_spec)

    nb = {
        "apiVersion": nbapi.API_VERSION,
        "kind": nbapi.KIND,
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": dict(body.get("labels") or {}),
            "annotations": {
                nbapi.SERVER_TYPE_ANNOTATION: server_type,
                nbapi.CREATOR_ANNOTATION: user,
            },
        },
        "spec": {"template": {"spec": pod_spec}},
    }
    # Record the spawner's image pick so the admission catalog can pin it
    # (odh's last-image-selection contract, notebook_webhook.go:556). Any
    # tagged, non-digest image qualifies — the catalog key is the full
    # repository path (e.g. "kubeflow-tpu/jupyter-jax").
    if ":" in image.rsplit("/", 1)[-1] and "@sha256:" not in image:
        nb["metadata"]["annotations"][nbapi.IMAGE_SELECTION_ANNOTATION] = image
    if server_type == SERVER_TYPE_GROUP_ONE:
        nb["metadata"]["annotations"][nbapi.ANNOTATION_REWRITE_URI] = "/"
    elif server_type == SERVER_TYPE_GROUP_TWO:
        nb["metadata"]["annotations"][nbapi.ANNOTATION_HEADERS_REQUEST_SET] = (
            '{"X-RStudio-Root-Path": "/notebook/%s/%s/"}' % (namespace, name)
        )

    # "configurations": labels selecting PodDefaults to apply (yaml:163-171).
    for label in get_form_value(config, body, "configurations") or []:
        nb["metadata"]["labels"][label] = "true"
        nb["spec"]["template"].setdefault("metadata", {}).setdefault(
            "labels", {}
        )[label] = "true"

    gpu = _gpu_from_form(config, body)
    if gpu:
        nb["spec"]["gpu"] = gpu
    return nb, pvcs


def _image_for(config: dict, body: dict, server_type: str) -> str:
    field = {
        SERVER_TYPE_JUPYTER: "image",
        SERVER_TYPE_GROUP_ONE: "imageGroupOne",
        SERVER_TYPE_GROUP_TWO: "imageGroupTwo",
    }.get(server_type)
    if field is None:
        raise Invalid(f"form: unknown serverType {server_type!r}")
    if body.get("customImage") and config.get("allowCustomImage", True):
        return str(body["customImage"]).strip()
    return get_form_value(config, body, field, "image")


def _gpu_from_form(config: dict, body: dict) -> dict | None:
    """GPU slice picker (replaces the reference's gpus vendor/num block)."""
    if body.get("tpu") not in (None, "none", {}):
        raise Invalid("form: tpu is not supported on GPU nodes — request "
                      "the accelerator in gpu: {accelerator, topology"
                      "[, numSlices]}")
    entry = config.get("gpus", {})
    if entry.get("readOnly"):
        value = entry.get("value")
        if not value or value == "none":
            return None
        return dict(value)
    gpu = body.get("gpu")
    if not gpu or gpu in ("none", {}):
        return None
    if not isinstance(gpu, dict) or "accelerator" not in gpu:
        raise Invalid("form: gpu must be {accelerator, topology[, numSlices]}")
    out = {
        "accelerator": str(gpu["accelerator"]),
        "topology": str(gpu.get("topology", "1x1")),
    }
    num_slices = gpu.get("numSlices")
    # Strict typing BEFORE the default-membership test: `true == 1` and
    # `1.0 == 1` in Python, so a membership check first would silently
    # admit bools/floats as "one slice" instead of rejecting them.
    if num_slices is not None and (
        isinstance(num_slices, bool) or not isinstance(num_slices, (int, str))
    ):
        raise Invalid(f"form: numSlices must be an integer, got {num_slices!r}")
    if num_slices not in (None, "", 1, "1"):
        try:
            out["numSlices"] = int(num_slices)
        except ValueError:
            raise Invalid(f"form: numSlices must be an integer, got {num_slices!r}")
    queued = gpu.get("queuedProvisioning")
    if queued not in (None, False, True):
        raise Invalid(
            f"form: queuedProvisioning must be a boolean, got {queued!r}")
    if queued:
        out["queuedProvisioning"] = True
    return out


def _apply_volumes(config, body, name, namespace, pod_spec, container) -> list[dict]:
    """Workspace + data volumes; '{notebook-name}' templating like the
    reference; returns new PVCs to create (dry-run-first in the route)."""
    pvcs: list[dict] = []

    def add_volume(spec: dict, default_mount: str, idx: int) -> None:
        mount = spec.get("mount", default_mount)
        if "existingSource" in spec:
            source = spec["existingSource"]
            vol_name = f"vol-{idx}"
            pod_spec["volumes"].append({"name": vol_name, **source})
        else:
            new_pvc = spec.get("newPvc") or {}
            pvc_name = (
                (new_pvc.get("metadata") or {}).get("name")
                or f"{name}-vol-{idx}"
            ).replace("{notebook-name}", name)
            pvc = {
                "apiVersion": "v1",
                "kind": "PersistentVolumeClaim",
                "metadata": {"name": pvc_name, "namespace": namespace},
                "spec": new_pvc.get("spec")
                or {
                    "accessModes": ["ReadWriteOnce"],
                    "resources": {"requests": {"storage": "5Gi"}},
                },
            }
            pvcs.append(pvc)
            vol_name = pvc_name
            pod_spec["volumes"].append(
                {
                    "name": vol_name,
                    "persistentVolumeClaim": {"claimName": pvc_name},
                }
            )
        container["volumeMounts"].append({"name": vol_name, "mountPath": mount})

    workspace = get_form_value(config, body, "workspaceVolume")
    if workspace:
        add_volume(dict(workspace), "/home/jovyan", 0)
    for i, vol in enumerate(get_form_value(config, body, "dataVolumes") or [], 1):
        add_volume(dict(vol), f"/home/jovyan/data-{i}", i)
    return pvcs


def _apply_tolerations(config, body, pod_spec) -> None:
    group_key = get_form_value(config, body, "tolerationGroup")
    if not group_key:
        return
    for group in config.get("tolerationGroup", {}).get("options", []):
        if group.get("groupKey") == group_key:
            pod_spec["tolerations"] = list(group.get("tolerations", []))
            return
    raise Invalid(f"form: unknown tolerationGroup {group_key!r}")


def _apply_affinity(config, body, pod_spec) -> None:
    affinity_key = get_form_value(config, body, "affinityConfig")
    if not affinity_key:
        return
    for option in config.get("affinityConfig", {}).get("options", []):
        if option.get("configKey") == affinity_key:
            pod_spec["affinity"] = option.get("affinity", {})
            return
    raise Invalid(f"form: unknown affinityConfig {affinity_key!r}")


def _scaled(value: str, factor) -> str:
    if factor in (None, "", "none"):
        return value
    try:
        return str(round(float(value) * float(factor), 3))
    except ValueError:
        return value


def _scaled_mem(value: str, factor) -> str:
    if factor in (None, "", "none"):
        return value
    for suffix in ("Gi", "Mi", "Ki", "G", "M", "K"):
        if value.endswith(suffix):
            try:
                scaled = float(value[: -len(suffix)]) * float(factor)
                return f"{round(scaled, 3)}{suffix}"
            except ValueError:
                return value
    return _scaled(value, factor)
