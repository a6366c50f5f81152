"""Per-node GPU env injection at pod admission: the port of
``kubeflow_tpu/webhooks/tpu.py``.

A StatefulSet template cannot vary env by ordinal, but at *pod* admission
the pod already has its final name ``<notebook>-<ordinal>``, so this
mutator is a pure function of the pod: it reads the slice annotations the
notebook controller stamped on the template (accelerator, shape, slice id
and slice count), parses the ordinal, and injects the node's ordinal in
its slice (``TPU_WORKER_ID``) and its rank in the job's rank space
(``PET_NODE_RANK`` = ``slice_id * nodes_per_slice + ordinal``), which
``torchrun`` and the SDK read (``gpu/topology.py``).
"""

from __future__ import annotations

import logging

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.gpu.topology import (NODE_RANK_ENV, GpuSlice,
                                             TopologyError)
from kubeflow_tpu_torch.runtime.objects import get_meta, name_of

log = logging.getLogger(__name__)


def ordinal_of(pod_name: str) -> int | None:
    base, _, ordinal = pod_name.rpartition("-")
    if base and ordinal.isdigit():
        return int(ordinal)
    return None


def mutate_pod(pod: dict) -> None:
    """Inject per-node env into every container of an annotated GPU pod."""
    annotations = get_meta(pod).get("annotations") or {}
    accelerator = annotations.get(keys.TPU_ACCELERATOR)
    topology = annotations.get(keys.TPU_TOPOLOGY)
    if not accelerator or not topology:
        return
    ordinal = ordinal_of(name_of(pod))
    if ordinal is None:
        return
    try:
        gpu = GpuSlice.parse(accelerator, topology)
    except TopologyError as e:
        log.warning("pod %s: bad GPU annotations: %s", name_of(pod), e)
        return
    try:
        slice_id = int(annotations.get(keys.TPU_SLICE_ID, 0))
        num_slices = int(annotations.get(keys.TPU_NUM_SLICES, 1))
    except ValueError:
        log.warning("pod %s: bad multislice annotations", name_of(pod))
        return
    if ordinal >= gpu.num_hosts or slice_id >= num_slices:
        log.warning(
            "pod %s: ordinal %d / slice %d outside %d-node × %d-slice job",
            name_of(pod), ordinal, slice_id, gpu.num_hosts, num_slices,
        )
        return
    worker_env = {
        "TPU_WORKER_ID": str(ordinal),
        NODE_RANK_ENV: str(slice_id * gpu.num_hosts + ordinal),
    }
    for ctr in pod.get("spec", {}).get("containers", []):
        env = list(ctr.get("env", []) or [])
        have = {e.get("name") for e in env}
        for k, v in worker_env.items():
            if k not in have:
                env.append({"name": k, "value": v})
            else:
                # Replace the whole entry: the controller bakes a downward
                # API valueFrom fallback into the template, and an entry
                # with both value and valueFrom is invalid.
                env = [
                    {"name": k, "value": v} if e.get("name") == k else e
                    for e in env
                ]
        ctr["env"] = env
