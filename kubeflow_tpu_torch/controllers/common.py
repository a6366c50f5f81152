"""Shared reconciler helpers.

The port's copy of ``kubeflow_tpu/controllers/common.py``: it keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib

from kubeflow_tpu_torch.runtime.objects import deep_get, namespace_of

# Pod-informer secondary index: pods by the PVC claims they mount,
# namespace-qualified (shared by the tensorboard and pvcviewer RWO
# co-scheduling probes).
POD_PVC_INDEX = "pvc"


def index_pod_by_pvc(pod: dict) -> list:
    ns = namespace_of(pod)
    return [
        (ns, claim)
        for vol in deep_get(pod, "spec", "volumes", default=[])
        if (claim := deep_get(vol, "persistentVolumeClaim", "claimName"))
    ]


def bounded_name(name: str, limit: int = 253) -> str:
    """Clamp a generated child-object name to the apiserver's limit.

    Kubernetes object names are DNS subdomains (≤253 chars); generated
    names composed from user-controlled parts (role + notebook names) can
    exceed that and fail the create. Over-long names are truncated and
    suffixed with a short content hash so distinct inputs stay distinct
    and the result is stable across reconciles.
    """
    if len(name) <= limit:
        return name
    digest = hashlib.sha256(name.encode()).hexdigest()[:10]
    return f"{name[: limit - 11].rstrip('-.')}-{digest}"


async def rwo_affinity(kube, ns: str, claim: str, pod_informer=None) -> dict | None:
    """Node affinity pinning to the node of the pod already mounting an RWO
    claim, so a second mount succeeds (reference
    ``tensorboard_controller.go:428-471``; same logic in the pvcviewer
    controller). Returns None when the claim is not RWO or not mounted.

    With a ``pod_informer`` carrying the POD_PVC_INDEX (wired by the
    controller setups), the mounting pod comes from an O(1) index lookup;
    the namespace-wide apiserver LIST remains only as the bare-reconciler
    fallback."""
    pvc = await kube.get_or_none("PersistentVolumeClaim", claim, ns)
    modes = deep_get(pvc or {}, "spec", "accessModes", default=[])
    if "ReadWriteOnce" not in modes:
        return None
    if pod_informer is not None and pod_informer.has_indexer(POD_PVC_INDEX):
        candidates = pod_informer.by_index(POD_PVC_INDEX, (ns, claim))
    else:
        candidates = await kube.list("Pod", ns)
    for pod in candidates:
        node = deep_get(pod, "spec", "nodeName")
        if not node or deep_get(pod, "status", "phase") not in ("Running", "Pending"):
            continue
        for vol in deep_get(pod, "spec", "volumes", default=[]):
            if deep_get(vol, "persistentVolumeClaim", "claimName") == claim:
                return {
                    "nodeAffinity": {
                        "requiredDuringSchedulingIgnoredDuringExecution": {
                            "nodeSelectorTerms": [
                                {
                                    "matchFields": [
                                        {
                                            "key": "metadata.name",
                                            "operator": "In",
                                            "values": [node],
                                        }
                                    ]
                                }
                            ]
                        }
                    }
                }
    return None
