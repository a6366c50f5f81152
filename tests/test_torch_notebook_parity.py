"""The port's notebook control plane against the reference's, fed the same
CR in two fake apiservers: the same admission chain, manager, notebook
controller and kubelet simulator, one from each package.

- A notebook with no accelerator block: every child (StatefulSet,
  Services, NetworkPolicy, VirtualService, pods) and the status are equal
  leaf for leaf; only the status block's name differs (``status.gpu``
  for ``status.tpu``).
- A TPU slice against the GPU slice of as many nodes (``v5e`` ``4x4``, 2
  hosts, against ``nvidia-h100-80gb`` ``2x8``; ``4x8``, 4 hosts, against
  ``4x8``), at one and two slices: the children are equal once the
  accelerator leaves are taken out — the node selector, the accelerator
  resource, the accelerator env, the rendezvous port and its name, and
  the accelerator and topology annotations' values. Each of those leaves
  is then held to ``gpu/topology.py`` directly.
"""

import copy

import pytest

from kubeflow_tpu_torch.gpu.topology import (GPU_RESOURCE, MASTER_PORT,
                                             MultiSlice)
from torch_control import PORT, REFERENCE, clear_kftpu_env, make_harness

H100 = "nvidia-h100-80gb"
KINDS = ("StatefulSet", "Service", "NetworkPolicy", "VirtualService", "Pod",
         "ConfigMap", "RoleBinding", "ProvisioningRequest", "PodTemplate")
# Stamped by the apiserver or the clock, never by the controller's logic.
VOLATILE = ("uid", "creationTimestamp", "resourceVersion", "lastProbeTime",
            "lastTransitionTime")
TIMELINE = "notebooks.kubeflow.org/timeline"
ACCEL_ANNOTATIONS = ("tpu.kubeflow.org/accelerator", "tpu.kubeflow.org/topology")
ACCEL_RESOURCES = ("google.com/tpu", GPU_RESOURCE)
RENDEZVOUS_PORTS = ("jax-coord", "torch-rdzv")
PER_NODE = ("TPU_WORKER_ID", "PET_NODE_RANK")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


def _accel_env(name: str) -> bool:
    return name.startswith(("TPU_", "JAX_", "MEGASCALE_", "PET_")) or name in (
        "KFTPU_ACCELERATOR", "KFTPU_SLICE_PEERS")


def _scrub(node):
    """Drop the volatile leaves, recursively."""
    if isinstance(node, dict):
        return {k: _scrub(v) for k, v in node.items()
                if k not in VOLATILE and k != TIMELINE}
    if isinstance(node, list):
        return [_scrub(v) for v in node]
    return node


def _strip_pod_spec(spec: dict) -> None:
    spec.pop("nodeSelector", None)
    for ctr in spec.get("containers", []):
        ctr["env"] = [e for e in ctr.get("env", []) if not _accel_env(e["name"])]
        ctr["ports"] = [p for p in ctr.get("ports", [])
                        if p.get("name") not in RENDEZVOUS_PORTS]
        for bucket in (ctr.get("resources") or {}).values():
            for res in ACCEL_RESOURCES:
                bucket.pop(res, None)


def _strip_accelerator(kind: str, obj: dict) -> dict:
    """The object with its accelerator leaves taken out (module docstring)."""
    obj = copy.deepcopy(obj)
    meta = obj.get("metadata", {})
    if kind == "Pod":
        _strip_pod_spec(obj["spec"])
    if kind == "StatefulSet":
        meta = obj["spec"]["template"]["metadata"]
        _strip_pod_spec(obj["spec"]["template"]["spec"])
    if kind == "PodTemplate":
        _strip_pod_spec(obj["template"]["spec"])
    for key in ACCEL_ANNOTATIONS:
        if key in (meta.get("annotations") or {}):
            meta["annotations"][key] = "<accelerator>"
    if kind == "Service" and obj["spec"].get("clusterIP") == "None":
        obj["spec"]["ports"] = [p for p in obj["spec"]["ports"]
                                if p.get("name") not in RENDEZVOUS_PORTS]
    return obj


async def _run(pkg: str, nb_args: dict, **opts) -> tuple:
    """Spawn one notebook; return (children by kind, the CR's status)."""
    h = await make_harness(pkg, use_istio=True, create_network_policies=True,
                           **opts)
    try:
        await h.kube.create("Notebook", h.m.nbapi.new("nb", "ns", **nb_args))
        await h.settle(8)
        children = {kind: _scrub(await h.kube.list(kind, "ns"))
                    for kind in KINDS}
        status = _scrub((await h.kube.get("Notebook", "nb", "ns"))["status"])
    finally:
        await h.stop()
    return children, status


def _status_as_port(status: dict) -> dict:
    status = dict(status)
    status["gpu"] = status.pop("tpu")
    return status


async def test_a_cpu_notebook_renders_as_the_reference_renders_it():
    ref, ref_status = await _run(REFERENCE, {"image": "img:1"})
    got, got_status = await _run(PORT, {"image": "img:1"})
    assert {k: len(v) for k, v in got.items()} == {
        "StatefulSet": 1, "Service": 1, "NetworkPolicy": 1,
        "VirtualService": 1, "Pod": 1, "ConfigMap": 0, "RoleBinding": 0,
        "ProvisioningRequest": 0, "PodTemplate": 0}
    assert got == ref
    assert "tpu" not in got_status
    assert got_status == _status_as_port(ref_status)
    assert got_status["readyReplicas"] == 1
    assert "running" in got_status["containerState"]
    assert [c["type"] for c in got_status["conditions"]] == ["Running"]


SHAPES = [("4x4", "2x8"), ("4x8", "4x8")]


@pytest.mark.parametrize("num_slices", [1, 2])
@pytest.mark.parametrize("tpu_topology,gpu_topology", SHAPES)
async def test_a_gpu_slice_renders_as_the_tpu_slice_outside_its_accelerator(
        tpu_topology, gpu_topology, num_slices):
    ref, ref_status = await _run(REFERENCE, {
        "accelerator": "v5e", "topology": tpu_topology,
        "num_slices": num_slices})
    got, got_status = await _run(PORT, {
        "accelerator": H100, "topology": gpu_topology,
        "num_slices": num_slices})
    ms = MultiSlice.parse(H100, gpu_topology, num_slices)
    assert len(got["Pod"]) == ms.total_hosts
    assert len(got["StatefulSet"]) == num_slices
    for kind in KINDS:
        assert [_strip_accelerator(kind, o) for o in got[kind]] == \
            [_strip_accelerator(kind, o) for o in ref[kind]], kind
    assert got_status == _status_as_port(ref_status)
    assert got_status["gpu"] == {"hosts": ms.total_hosts,
                                 "readyHosts": ms.total_hosts,
                                 "chips": ms.num_chips, "slices": num_slices}
    _check_accelerator_leaves(got, ms)


def _check_accelerator_leaves(got: dict, ms: MultiSlice) -> None:
    """The leaves the comparison took out, each from gpu/topology.py."""
    gpu = ms.slice
    hostnames = ms.worker_hostnames("nb", "nb-workers", "ns")
    rendezvous = {"containerPort": MASTER_PORT, "name": "torch-rdzv",
                  "protocol": "TCP"}
    for slice_id, sts in enumerate(got["StatefulSet"]):
        assert sts["metadata"]["name"] == ms.slice_sts_name("nb", slice_id)
        template = sts["spec"]["template"]
        assert template["spec"]["nodeSelector"] == gpu.node_selectors()
        main = template["spec"]["containers"][0]
        assert main["resources"] == {"requests": gpu.resource_requests(),
                                     "limits": gpu.resource_requests()}
        assert rendezvous in main["ports"]
        annotations = template["metadata"]["annotations"]
        assert annotations["tpu.kubeflow.org/accelerator"] == H100
        assert annotations["tpu.kubeflow.org/topology"] == gpu.topology_str
        static = ms.worker_env(slice_id, 0, hostnames)
        for key in PER_NODE:
            static.pop(key)
        env = {e["name"]: e.get("value") for e in main["env"]
               if _accel_env(e["name"]) and "valueFrom" not in e}
        assert env == static
        fallback = {e["name"] for e in main["env"] if "valueFrom" in e}
        assert fallback == ({"TPU_WORKER_ID"} if ms.multi else set(PER_NODE))
    for pod in got["Pod"]:
        sts_name, _, ordinal = pod["metadata"]["name"].rpartition("-")
        slice_id = [ms.slice_sts_name("nb", j)
                    for j in range(ms.num_slices)].index(sts_name)
        main = pod["spec"]["containers"][0]
        env = {e["name"]: e["value"] for e in main["env"]
               if _accel_env(e["name"])}
        assert env == ms.worker_env(slice_id, int(ordinal), hostnames)
        # The rendezvous every pod dials: node 0 of slice 0, on the port the
        # container and the headless Service open.
        assert (env["PET_MASTER_ADDR"], env["PET_MASTER_PORT"]) == (
            hostnames[0][0], str(MASTER_PORT))
        assert env["PET_NODE_RANK"] == str(
            slice_id * gpu.num_hosts + int(ordinal))
        assert (env["PET_NNODES"], env["PET_NPROC_PER_NODE"]) == (
            str(ms.total_hosts), str(gpu.chips_per_host))
        assert pod["spec"]["nodeSelector"] == gpu.node_selectors()
    headless = [s for s in got["Service"] if s["spec"].get("clusterIP") == "None"]
    assert [s["spec"]["ports"] for s in headless] == [
        [{"name": "torch-rdzv", "port": MASTER_PORT, "protocol": "TCP"}]]
