"""The port's GPU node shapes (``kubeflow_tpu_torch.gpu.topology``) and its
per-ordinal webhook (``kubeflow_tpu_torch.webhooks.gpu``), against the JAX
package's TPU library where the two share a contract: the same strict
shape parser, the same StatefulSet names and hostnames, and the same rank
space over slices (the node rank equals ``JAX_PROCESS_ID`` for the same
slice count and hosts a slice)."""

import copy
import dataclasses
import logging

import pytest

from kubeflow_tpu.api import keys as jax_keys
from kubeflow_tpu.tpu import topology as jax_topology
from kubeflow_tpu.webhooks import tpu as jax_webhook
from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.gpu import topology
from kubeflow_tpu_torch.gpu.topology import (ACCELERATORS, GpuSlice,
                                             MultiSlice, TopologyError,
                                             parse_topology)
from kubeflow_tpu_torch.webhooks import gpu as webhook

H100 = "nvidia-h100-80gb"
MEGA = "nvidia-h100-mega-80gb"

SHAPES = ["4x4", "2x2x2", "1x1", "2x8", "16X8", "4x", "0x4", "abc", "",
          "4 x 4", "+2x8", "2x-8", "1.5x8", "x", "08x8", "2xx8"]


@pytest.mark.parametrize("shape", SHAPES)
def test_parse_topology_equals_the_reference(shape):
    try:
        want = jax_topology.parse_topology(shape)
    except jax_topology.TopologyError as e:
        with pytest.raises(TopologyError) as got:
            parse_topology(shape)
        assert str(got.value) == str(e)
    else:
        assert parse_topology(shape) == want


@pytest.mark.parametrize(
    "acc,shape,gpus,nodes,per_node",
    [(H100, "1x1", 1, 1, 1), (H100, "1x2", 2, 1, 2), (H100, "1x4", 4, 1, 4),
     (H100, "1x8", 8, 1, 8), (H100, "2x8", 16, 2, 8), (H100, "4x8", 32, 4, 8),
     (MEGA, "1x8", 8, 1, 8), (MEGA, "8x8", 64, 8, 8)])
def test_nodes_and_cards(acc, shape, gpus, nodes, per_node):
    s = GpuSlice.parse(acc, shape)
    assert (s.num_chips, s.num_hosts, s.chips_per_host) == \
        (gpus, nodes, per_node)
    assert s.multi_host == (nodes > 1)
    assert s.host_grid() == (nodes, 1)
    assert s.peak_bf16_tflops() == pytest.approx(989.0 * gpus)


def test_a_share_must_fit_one_node_and_nodes_come_whole():
    with pytest.raises(TopologyError, match="does not fit one"):
        GpuSlice.parse(H100, "1x16")
    for shape in ("2x4", "2x1", "3x16"):
        with pytest.raises(TopologyError, match="whole"):
            GpuSlice.parse(H100, shape)
    with pytest.raises(TopologyError, match="<nodes>x<gpus"):
        GpuSlice.parse(H100, "2x2x2")
    with pytest.raises(TopologyError, match="unknown accelerator"):
        GpuSlice.parse("v5e", "2x2")
    # Strict: only the node type's documented shapes (A3 Mega has no share).
    assert GpuSlice.parse(H100, "1x4", strict=True).num_chips == 4
    with pytest.raises(TopologyError, match="not a documented"):
        GpuSlice.parse(MEGA, "1x4", strict=True)
    assert GpuSlice.parse(MEGA, "1x4").chips_per_host == 4
    for acc in ACCELERATORS.values():
        for shape in acc.topologies:
            GpuSlice.parse(acc.name, shape, strict=True)


def test_table_rows_are_h100_sxm_node_types():
    for acc in ACCELERATORS.values():
        assert acc.gpus_per_node == 8 and acc.hbm_gib_per_gpu == 80
        assert acc.peak_bf16_tflops_per_gpu == 989.0
        assert acc.nvlink_gbps_per_gpu == 450.0
    assert ACCELERATORS[H100].machine_type == "a3-highgpu-8g"
    assert ACCELERATORS[MEGA].machine_type == "a3-megagpu-8g"
    assert ACCELERATORS[MEGA].nic_gbps_per_node == \
        2 * ACCELERATORS[H100].nic_gbps_per_node


def test_selectors_and_resources():
    s = GpuSlice.parse(H100, "2x8")
    assert s.node_selectors() == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    assert s.resource_requests() == {"nvidia.com/gpu": "8"}
    assert GpuSlice.parse(H100, "1x4").resource_requests() == \
        {"nvidia.com/gpu": "4"}


def test_bandwidth_estimates():
    assert GpuSlice.parse(H100, "1x1").allreduce_algo_bandwidth_gbps() == \
        float("inf")
    for shape in ("1x2", "1x4", "1x8"):
        assert GpuSlice.parse(H100, shape).allreduce_algo_bandwidth_gbps() \
            == 450.0
    assert GpuSlice.parse(H100, "2x8").allreduce_algo_bandwidth_gbps() == \
        100.0 / 8
    assert GpuSlice.parse(MEGA, "4x8").allreduce_algo_bandwidth_gbps() == \
        200.0 / 8
    assert MultiSlice.parse(H100, "1x8", 1).dcn_ring_bandwidth_gbps() == \
        float("inf")
    assert MultiSlice.parse(H100, "1x8", 2).dcn_ring_bandwidth_gbps() == 100.0
    assert MultiSlice.parse(MEGA, "2x8", 3).peak_bf16_tflops() == \
        pytest.approx(3 * 16 * 989.0)


def test_worker_env_per_node():
    s = GpuSlice.parse(H100, "2x8")
    hosts = s.worker_hostnames("nb", "nb-workers", "team")
    assert hosts == jax_topology.TpuSlice.parse("v5e", "4x4") \
        .worker_hostnames("nb", "nb-workers", "team")
    env = s.worker_env(1, hosts)
    assert env == {
        "TPU_WORKER_ID": "1",
        "TPU_WORKER_HOSTNAMES": ",".join(hosts),
        "TPU_ACCELERATOR_TYPE": "a3-highgpu-8g",
        "TPU_TOPOLOGY": "2x8",
        "KFTPU_ACCELERATOR": H100,
        "PET_NPROC_PER_NODE": "8",
        "PET_MASTER_ADDR": hosts[0],
        "PET_MASTER_PORT": "29500",
        "PET_NNODES": "2",
        "PET_NODE_RANK": "1",
    }
    with pytest.raises(TopologyError, match="out of range"):
        s.worker_env(2, hosts)
    # Without hostnames no rendezvous is named.
    assert "PET_MASTER_ADDR" not in GpuSlice.parse(H100, "1x4").worker_env(
        0, [])


@pytest.mark.parametrize("shape,num_slices,want", [
    ("1x1", 1, "loopback"), ("1x2", 1, "loopback"), ("1x4", 1, "loopback"),
    ("1x8", 1, "loopback"), ("2x8", 1, "node 0"), ("1x8", 2, "node 0"),
    ("4x8", 2, "node 0")])
def test_a_one_node_slice_set_rendezvous_on_its_loopback(shape, num_slices,
                                                         want):
    """A slice set of one node has no headless Service (the controller
    creates it for multi-node shapes only), so its rendezvous is its own
    loopback; a set of several nodes dials node 0 of slice 0."""
    ms = MultiSlice.parse(H100, shape, num_slices)
    hosts = ms.worker_hostnames("nb", "nb-workers", "team")
    addrs = {ms.worker_env(j, i, hosts)["PET_MASTER_ADDR"]
             for j in range(num_slices) for i in range(ms.slice.num_hosts)}
    assert addrs == {topology.LOOPBACK_ADDR if want == "loopback"
                     else hosts[0][0]}
    assert (ms.total_hosts == 1) == (want == "loopback")


@pytest.mark.parametrize("num_slices,jax_shape,gpu_shape",
                         [(1, "4x4", "2x8"), (2, "4x4", "2x8"),
                          (3, "4x8", "4x8"), (2, "2x4", "1x8")])
def test_multislice_node_rank_equals_the_jax_process_id(num_slices,
                                                        jax_shape, gpu_shape):
    ms = MultiSlice.parse(H100, gpu_shape, num_slices)
    ref = jax_topology.MultiSlice.parse("v5e", jax_shape, num_slices)
    assert ms.slice.num_hosts == ref.slice.num_hosts
    assert ms.total_hosts == ref.total_hosts
    hosts = ms.worker_hostnames("nb", "nb-workers", "team")
    assert hosts == ref.worker_hostnames("nb", "nb-workers", "team")
    ranks = []
    for slice_id in range(num_slices):
        for worker in range(ms.slice.num_hosts):
            env = ms.worker_env(slice_id, worker, hosts)
            want = ref.worker_env(slice_id, worker, hosts)
            assert env["PET_NODE_RANK"] == want["JAX_PROCESS_ID"]
            assert env["PET_NNODES"] == want["JAX_NUM_PROCESSES"]
            assert env["TPU_WORKER_ID"] == want["TPU_WORKER_ID"]
            assert env["TPU_WORKER_HOSTNAMES"] == want["TPU_WORKER_HOSTNAMES"]
            assert env["PET_MASTER_ADDR"] == hosts[0][0]
            for key in ("KFTPU_SLICE_PEERS", "MEGASCALE_SLICE_ID",
                        "MEGASCALE_NUM_SLICES"):
                assert env.get(key) == want.get(key)
            ranks.append(int(env["PET_NODE_RANK"]))
    assert ranks == list(range(ms.total_hosts))
    with pytest.raises(TopologyError, match="out of range"):
        ms.worker_env(num_slices, 0, hosts)


@pytest.mark.parametrize("base", ["nb", "a" * 53, "b" * 54, "c" * 70,
                                  "team-notebook-" + "x" * 45])
@pytest.mark.parametrize("num_slices", [1, 2, 12])
def test_slice_sts_name_equals_the_reference(base, num_slices):
    ms = MultiSlice.parse(H100, "2x8", num_slices)
    ref = jax_topology.MultiSlice.parse("v5e", "4x4", num_slices)
    for slice_id in range(num_slices):
        assert ms.slice_sts_name(base, slice_id) == \
            ref.slice_sts_name(base, slice_id)


def test_multislice_parse_bounds():
    assert MultiSlice.parse(H100, "2x8", 64).total_hosts == 128
    for bad in (0, -1, 65, True, "2"):
        with pytest.raises(TopologyError):
            MultiSlice.parse(H100, "2x8", bad)
    with pytest.raises(TopologyError):
        MultiSlice.parse(H100, "2x4", 2)


# ---- the per-ordinal webhook ---------------------------------------------------------


def test_the_slice_annotation_keys_equal_the_reference():
    for name in ("TPU_ACCELERATOR", "TPU_TOPOLOGY", "TPU_SLICE_ID",
                 "TPU_NUM_SLICES"):
        assert getattr(keys, name) == getattr(jax_keys, name)


@pytest.mark.parametrize("name", ["nb-0", "nb-12", "nb", "nb-", "-3",
                                  "nb-s1-2", "nb-x", ""])
def test_ordinal_of_equals_the_reference(name):
    assert webhook.ordinal_of(name) == jax_webhook.ordinal_of(name)


def _pod(name, annotations, env=None):
    return {"metadata": {"name": name, "annotations": annotations},
            "spec": {"containers": [{"name": "nb", "env": env or []},
                                    {"name": "sidecar"}]}}


def _env(pod, ctr=0):
    return {e["name"]: e for e in pod["spec"]["containers"][ctr]["env"]}


def test_mutate_pod_injects_the_node_rank_of_its_ordinal():
    pod = _pod("nb-s1-1", {keys.TPU_ACCELERATOR: H100,
                           keys.TPU_TOPOLOGY: "2x8",
                           keys.TPU_SLICE_ID: "1", keys.TPU_NUM_SLICES: "2"})
    webhook.mutate_pod(pod)
    for ctr in (0, 1):
        env = _env(pod, ctr)
        assert env["PET_NODE_RANK"] == {"name": "PET_NODE_RANK",
                                        "value": "3"}
        assert env["TPU_WORKER_ID"]["value"] == "1"
    # The node rank is the JAX webhook's JAX_PROCESS_ID for the same
    # slice count and hosts a slice.
    ref = _pod("nb-s1-1", {jax_keys.TPU_ACCELERATOR: "v5e",
                           jax_keys.TPU_TOPOLOGY: "4x4",
                           jax_keys.TPU_SLICE_ID: "1",
                           jax_keys.TPU_NUM_SLICES: "2"})
    jax_webhook.mutate_pod(ref)
    assert _env(ref)["JAX_PROCESS_ID"]["value"] == "3"


def test_mutate_pod_replaces_a_baked_value_from():
    baked = [{"name": "PET_NODE_RANK",
              "valueFrom": {"fieldRef": {"fieldPath": "metadata.labels['x']"}}},
             {"name": "KEEP", "value": "1"}]
    pod = _pod("nb-1", {keys.TPU_ACCELERATOR: H100, keys.TPU_TOPOLOGY: "2x8"},
               env=copy.deepcopy(baked))
    webhook.mutate_pod(pod)
    env = pod["spec"]["containers"][0]["env"]
    assert env[0] == {"name": "PET_NODE_RANK", "value": "1"}
    assert env[1] == {"name": "KEEP", "value": "1"}
    assert [e["name"] for e in env].count("PET_NODE_RANK") == 1
    assert env[2] == {"name": "TPU_WORKER_ID", "value": "1"}


@pytest.mark.parametrize("annotations,name", [
    ({keys.TPU_ACCELERATOR: H100, keys.TPU_TOPOLOGY: "2x4"}, "nb-0"),
    ({keys.TPU_ACCELERATOR: "h200", keys.TPU_TOPOLOGY: "2x8"}, "nb-0"),
    ({keys.TPU_ACCELERATOR: H100, keys.TPU_TOPOLOGY: "2x8",
      keys.TPU_SLICE_ID: "x"}, "nb-0"),
    ({keys.TPU_ACCELERATOR: H100, keys.TPU_TOPOLOGY: "2x8"}, "nb-2"),
    ({keys.TPU_ACCELERATOR: H100, keys.TPU_TOPOLOGY: "2x8",
      keys.TPU_SLICE_ID: "2", keys.TPU_NUM_SLICES: "2"}, "nb-0"),
], ids=["bad-shape", "unknown-accelerator", "bad-slice-id",
        "ordinal-outside", "slice-outside"])
def test_mutate_pod_ignores_bad_annotations_with_a_warning(annotations, name,
                                                          caplog):
    pod = _pod(name, annotations)
    before = copy.deepcopy(pod)
    with caplog.at_level(logging.WARNING, logger=webhook.__name__):
        webhook.mutate_pod(pod)
    assert pod == before
    assert caplog.records and caplog.records[0].levelno == logging.WARNING


@pytest.mark.parametrize("annotations,name", [
    ({}, "nb-0"),
    ({keys.TPU_ACCELERATOR: H100}, "nb-0"),
    ({keys.TPU_ACCELERATOR: H100, keys.TPU_TOPOLOGY: "2x8"}, "nb"),
])
def test_mutate_pod_leaves_pods_without_a_slice_alone(annotations, name):
    pod = _pod(name, annotations)
    before = copy.deepcopy(pod)
    webhook.mutate_pod(pod)
    assert pod == before


def test_a_custom_node_type_parses_through_the_table(monkeypatch):
    two = dataclasses.replace(ACCELERATORS[H100], name="two-card",
                              gpus_per_node=2)
    monkeypatch.setitem(topology.ACCELERATORS, "two-card", two)
    s = GpuSlice.parse("two-card", "2x2")
    assert (s.num_hosts, s.chips_per_host) == (2, 2)
    assert s.worker_env(1, ["a", "b"])["PET_NPROC_PER_NODE"] == "2"
