"""The admin-facing spawner configuration ("flag system" of the spawner UI).

Reference: ``crud-web-apps/jupyter/backend/apps/common/yaml/
spawner_ui_config.yaml:10-220`` — per-field ``value`` / ``options`` /
``readOnly``; the server enforces readOnly regardless of what the form
POSTs (form.py:16-60).

The port of ``kubeflow_tpu/web/jupyter/spawner_config.py``. Where the
reference's ``gpus.vendors`` block (nvidia.com/gpu / amd.com/gpu,
yaml:120-141) offers a vendor and a count, the ``gpus`` block here offers
GKE GPU node types and their **shapes** from the node-shape library
(``gpu/topology.py``) — the UI renders a slice picker, as the JAX
package's ``tpus`` block does, because a card count alone does not say
how the cards fall on nodes. The option keys keep the JAX package's names:
``chips`` is the cards of a shape, ``hosts`` its nodes, ``hbmGiBPerChip``
a card's memory. The image strings stay the JAX package's.
"""

from __future__ import annotations

import copy

from kubeflow_tpu_torch.gpu.topology import ACCELERATORS, GpuSlice

SERVER_TYPE_JUPYTER = "jupyter"      # NB_PREFIX-aware images
SERVER_TYPE_GROUP_ONE = "group-one"  # vscode-like: rewrite to /
SERVER_TYPE_GROUP_TWO = "group-two"  # rstudio-like: X-RStudio-Root-Path header


def gpu_options() -> list[dict]:
    """Accelerator picker options straight from the node-shape library."""
    out = []
    for acc in ACCELERATORS.values():
        topologies = []
        for topo in acc.topologies:
            s = GpuSlice.parse(acc.name, topo)
            topologies.append(
                {
                    "topology": topo,
                    "chips": s.num_chips,
                    "hosts": s.num_hosts,
                    "multiHost": s.multi_host,
                }
            )
        out.append(
            {
                "accelerator": acc.name,
                "gkeAccelerator": acc.name,
                "hbmGiBPerChip": acc.hbm_gib_per_gpu,
                "topologies": topologies,
            }
        )
    return out


DEFAULT_CONFIG: dict = {
    "image": {
        "value": "kubeflow-tpu/jupyter-jax:latest",
        "options": [
            "kubeflow-tpu/jupyter-scipy:latest",
            "kubeflow-tpu/jupyter-jax:latest",
            "kubeflow-tpu/jupyter-jax-full:latest",
            "kubeflow-tpu/jupyter-pytorch-xla:latest",
            "kubeflow-tpu/jupyter-pytorch-xla-full:latest",
        ],
        "readOnly": False,
    },
    "imageGroupOne": {
        "value": "kubeflow-tpu/codeserver-python:latest",
        "options": ["kubeflow-tpu/codeserver-python:latest"],
    },
    "imageGroupTwo": {
        "value": "kubeflow-tpu/rstudio-tidyverse:latest",
        "options": ["kubeflow-tpu/rstudio-tidyverse:latest"],
    },
    "allowCustomImage": True,
    "imagePullPolicy": {"value": "IfNotPresent", "readOnly": False},
    "cpu": {"value": "0.5", "limitFactor": "1.2", "readOnly": False},
    "memory": {"value": "1.0Gi", "limitFactor": "1.2", "readOnly": False},
    # The GPU slice block (replaces the reference's gpus.vendors).
    "gpus": {
        "value": "none",
        "readOnly": False,
        "options": gpu_options(),
    },
    "workspaceVolume": {
        "value": {
            "mount": "/home/jovyan",
            "newPvc": {
                "metadata": {"name": "{notebook-name}-workspace"},
                "spec": {
                    "resources": {"requests": {"storage": "5Gi"}},
                    "accessModes": ["ReadWriteOnce"],
                },
            },
        },
        "readOnly": False,
    },
    "dataVolumes": {"value": [], "readOnly": False},
    "shm": {"value": True, "readOnly": False},
    "configurations": {"value": [], "readOnly": False},
    "affinityConfig": {"value": "", "options": [], "readOnly": False},
    "tolerationGroup": {
        "value": "",
        "options": [
            {
                "groupKey": "gpu-reserved",
                "displayName": "GPU reserved pool",
                # GKE taints its GPU nodes nvidia.com/gpu=present:NoSchedule.
                "tolerations": [
                    {"key": "nvidia.com/gpu", "operator": "Exists",
                     "effect": "NoSchedule"}
                ],
            }
        ],
        "readOnly": False,
    },
    "environment": {"value": {}, "readOnly": False},
}


def load_config(path: str | None = None) -> dict:
    """Admin config from YAML (mounted ConfigMap in deployment) merged over
    the defaults; None → defaults."""
    config = copy.deepcopy(DEFAULT_CONFIG)
    if path:
        import yaml

        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        config.update(loaded.get("spawnerFormDefaults", loaded))
    return config


def get_form_value(config: dict, body: dict, field: str, body_field: str | None = None):
    """readOnly enforcement (form.py:16-60): a readOnly field always takes
    the admin-configured value, no matter what the form sent."""
    entry = config.get(field, {})
    if not isinstance(entry, dict):
        return entry
    if entry.get("readOnly"):
        return entry.get("value")
    return body.get(body_field or field, entry.get("value"))
