"""Pure GPU node-shape math: the port of ``kubeflow_tpu/tpu/topology.py``.

One library maps ``(accelerator, shape)`` to everything the control plane
needs: node count (StatefulSet replicas), cards a node (``nvidia.com/gpu``
requests), the GKE node selector, the worker env of each node, and stable
node hostnames for the rendezvous. Pure; no Kubernetes imports.

A shape is ``<nodes>x<gpus per node>``: ``1x1`` and ``1x4`` are a share of
one node, ``1x8`` is one whole node and ``2x8`` two. A share must fit one
node, and a shape of several nodes takes them whole, as a sub-host TPU
slice must fit one host and a multi-host one tiles whole hosts.

**The env contract: one process per card across the slice.** A pod is a
node. Its env (:meth:`GpuSlice.worker_env`, :meth:`MultiSlice.worker_env`)
carries what ``torchrun`` reads with no flags:

- ``PET_NNODES``: the node count (every node of every slice);
- ``PET_NODE_RANK``: this node's rank, ``slice_id * nodes_per_slice +
  ordinal`` (the counterpart of ``JAX_PROCESS_ID``); the per-ordinal
  webhook (``webhooks/gpu.py``) injects it;
- ``PET_NPROC_PER_NODE``: the cards a node;
- ``PET_MASTER_ADDR`` / ``PET_MASTER_PORT``: the rendezvous on
  torchrun's default port: node 0 of slice 0 through the headless
  Service, or the loopback address where the whole slice set is one node
  (the controller creates the headless Service for multi-node shapes
  only, so a one-node gang's own DNS name never resolves).

``torchrun`` gives each child ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT``; a process launched per card by other
means sets ``LOCAL_RANK`` and has the global rank ``node_rank *
cards_per_node + LOCAL_RANK``. The slice's identity stays under the names
the SDK's ``SliceInfo`` reads: ``TPU_WORKER_ID`` (the node's ordinal in
its slice), ``TPU_WORKER_HOSTNAMES`` (the slice's nodes, which the DCN
ring needs), ``TPU_ACCELERATOR_TYPE`` (the node's machine type),
``TPU_TOPOLOGY`` (the shape), ``MEGASCALE_SLICE_ID`` /
``MEGASCALE_NUM_SLICES`` and ``KFTPU_SLICE_PEERS`` (node 0 of each
slice); ``KFTPU_ACCELERATOR`` names the table row for the probe CLI.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field

# GKE's node label and the device plugin's resource for GPU scheduling.
GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
GPU_RESOURCE = "nvidia.com/gpu"

# torchrun's default --master-port, where node 0 serves the rendezvous.
MASTER_PORT = 29500
# The rendezvous of a slice set of one node: its own loopback.
LOOPBACK_ADDR = "127.0.0.1"

NNODES_ENV = "PET_NNODES"
NODE_RANK_ENV = "PET_NODE_RANK"
NPROC_PER_NODE_ENV = "PET_NPROC_PER_NODE"
MASTER_ADDR_ENV = "PET_MASTER_ADDR"
MASTER_PORT_ENV = "PET_MASTER_PORT"
ACCELERATOR_ENV = "KFTPU_ACCELERATOR"
SLICE_PEERS_ENV = "KFTPU_SLICE_PEERS"


class TopologyError(ValueError):
    """Invalid accelerator/shape combination."""


@dataclass(frozen=True)
class GpuAccelerator:
    """Static facts about one GKE GPU node type.

    Peak numbers are published figures used only for bandwidth and
    utilisation *estimates* in diagnostics (never for scheduling)."""

    name: str                    # the CR's name: GKE's accelerator label value
    machine_type: str            # the node's GCE machine type
    gpus_per_node: int
    hbm_gib_per_gpu: int
    peak_bf16_tflops_per_gpu: float  # dense, without sparsity
    hbm_gbps_per_gpu: float      # HBM bandwidth, GB/s
    nvlink_gbps_per_gpu: float   # NVLink, GB/s in one direction a card
    nic_gbps_per_node: float     # the node's GPU NICs together, GB/s
    topologies: tuple[str, ...]  # the shapes GKE offers


# H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU data sheet): 989 dense bf16
# TFLOP/s, 80 GB of HBM3 at 3.35 TB/s, NVLink 4 at 900 GB/s both ways
# (450 GB/s a direction) through the node's NVSwitches. The NICs are
# Google Cloud's published A3 figures (GPU machine types, "A3 High" and
# "A3 Mega"): a3-highgpu-8g has 4 GPU NICs of 200 Gbps (GPUDirect-TCPX,
# 800 Gbps = 100 GB/s), a3-megagpu-8g 8 of 200 Gbps (GPUDirect-TCPXO,
# 1600 Gbps = 200 GB/s).
_H100 = dict(gpus_per_node=8, hbm_gib_per_gpu=80,
             peak_bf16_tflops_per_gpu=989.0, hbm_gbps_per_gpu=3350.0,
             nvlink_gbps_per_gpu=450.0)

ACCELERATORS: dict[str, GpuAccelerator] = {
    acc.name: acc
    for acc in (
        GpuAccelerator(
            name="nvidia-h100-80gb", machine_type="a3-highgpu-8g",
            nic_gbps_per_node=100.0,
            topologies=("1x1", "1x2", "1x4", "1x8", "2x8", "4x8", "8x8",
                        "16x8", "32x8", "64x8"),
            **_H100),
        GpuAccelerator(
            name="nvidia-h100-mega-80gb", machine_type="a3-megagpu-8g",
            nic_gbps_per_node=200.0,
            topologies=("1x8", "2x8", "4x8", "8x8", "16x8", "32x8", "64x8"),
            **_H100),
    )
}


def parse_topology(topology: str) -> tuple[int, ...]:
    """Parse "2x8" into an int tuple.

    Strict by design: every axis must be a bare decimal integer — no
    whitespace, signs, or floats. ``int()`` alone would accept "2 x 8",
    and the raw string flows into env values and the scheduler's shape
    matching, where "2 x 8" and "2x8" must not name two shapes."""
    parts = topology.lower().split("x")
    try:
        if any(not part.isdigit() for part in parts):
            raise ValueError
        dims = tuple(int(part) for part in parts)
    except ValueError:
        raise TopologyError(f"malformed topology {topology!r}") from None
    if not dims or any(d < 1 for d in dims):
        raise TopologyError(f"malformed topology {topology!r}")
    return dims


@dataclass(frozen=True)
class GpuSlice:
    """A resolved (accelerator, shape) pair with all derived scheduling
    facts: the controller sizes the StatefulSet from it, the webhook
    injects its worker env, the probes score against its peaks."""

    accelerator: GpuAccelerator
    topology: tuple[int, ...]
    topology_str: str = field(default="", compare=False)

    @classmethod
    def parse(cls, accelerator: str, topology: str, *,
              strict: bool = False) -> "GpuSlice":
        """Resolve an accelerator name + ``<nodes>x<gpus>`` shape. With
        ``strict=True`` only the shapes of the table are accepted;
        otherwise any share of one node or any count of whole nodes."""
        acc = ACCELERATORS.get(accelerator.lower())
        if acc is None:
            raise TopologyError(
                f"unknown accelerator {accelerator!r}; known: "
                f"{sorted(ACCELERATORS)}")
        dims = parse_topology(topology)
        if len(dims) != 2:
            raise TopologyError(
                f"GPU shapes are <nodes>x<gpus per node>, got {topology!r}")
        if strict and topology.lower() not in acc.topologies:
            raise TopologyError(
                f"{topology!r} is not a documented {acc.name} shape; "
                f"known: {acc.topologies}")
        slice_ = cls(accelerator=acc, topology=dims,
                     topology_str=topology.lower())
        slice_._validate()
        return slice_

    def _validate(self) -> None:
        nodes, gpus = self.topology
        per_node = self.accelerator.gpus_per_node
        if nodes == 1 and gpus > per_node:
            raise TopologyError(
                f"shape {self.topology_str} does not fit one "
                f"{self.accelerator.name} node of {per_node} GPUs")
        if nodes > 1 and gpus != per_node:
            raise TopologyError(
                f"multi-node shape {self.topology_str} must take whole "
                f"{self.accelerator.name} nodes of {per_node} GPUs")

    # ---- derived scheduling facts -------------------------------------------------

    @property
    def num_chips(self) -> int:
        return math.prod(self.topology)

    @property
    def num_hosts(self) -> int:
        return self.topology[0]

    @property
    def chips_per_host(self) -> int:
        return self.topology[1]

    @property
    def multi_host(self) -> bool:
        return self.num_hosts > 1

    @property
    def accelerator_type(self) -> str:
        """The node's GCE machine type."""
        return self.accelerator.machine_type

    def host_grid(self) -> tuple[int, ...]:
        """How nodes tile the shape, per axis."""
        return (self.num_hosts, 1)

    # ---- Kubernetes-facing outputs ------------------------------------------------

    def node_selectors(self) -> dict[str, str]:
        return {GKE_ACCELERATOR_LABEL: self.accelerator.name}

    def resource_requests(self) -> dict[str, str]:
        """Per-pod resources: each pod takes its node's share of cards."""
        return {GPU_RESOURCE: str(self.chips_per_host)}

    def worker_hostnames(
        self, name: str, headless_service: str, namespace: str,
        cluster_domain: str = "cluster.local",
    ) -> list[str]:
        """Stable per-node DNS names via the headless Service: StatefulSet
        pods ``<name>-<i>`` get ``<name>-<i>.<svc>.<ns>.svc.<domain>``."""
        return [
            f"{name}-{i}.{headless_service}.{namespace}.svc.{cluster_domain}"
            for i in range(self.num_hosts)
        ]

    def worker_env(self, worker_id: int, hostnames: list[str]) -> dict[str, str]:
        """The env of node ``worker_id`` of this slice (module docstring)."""
        if not 0 <= worker_id < self.num_hosts:
            raise TopologyError(
                f"worker_id {worker_id} out of range for "
                f"{self.num_hosts}-node slice")
        env = {
            "TPU_WORKER_ID": str(worker_id),
            "TPU_WORKER_HOSTNAMES": ",".join(hostnames),
            "TPU_ACCELERATOR_TYPE": self.accelerator_type,
            "TPU_TOPOLOGY": self.topology_str,
            ACCELERATOR_ENV: self.accelerator.name,
            NPROC_PER_NODE_ENV: str(self.chips_per_host),
        }
        if hostnames:
            env[MASTER_ADDR_ENV] = (LOOPBACK_ADDR if self.num_hosts == 1
                                    else hostnames[0])
            env[MASTER_PORT_ENV] = str(MASTER_PORT)
            env[NNODES_ENV] = str(self.num_hosts)
            env[NODE_RANK_ENV] = str(worker_id)
        return env

    # ---- diagnostics estimates ----------------------------------------------------

    def peak_bf16_tflops(self) -> float:
        return self.num_chips * self.accelerator.peak_bf16_tflops_per_gpu

    def with_slices(self, num_slices: int) -> "MultiSlice":
        return MultiSlice(slice=self, num_slices=num_slices)

    def allreduce_algo_bandwidth_gbps(self) -> float:
        """Estimated bus bandwidth of a ring all-reduce, GB/s a card: the
        rate at which ``2*(k-1)/k`` bytes per byte reduced can move.
        Inside one node NVSwitch gives every card its full NVLink rate in
        each direction; across nodes a card gets its share of the node's
        NICs. ``inf`` at one card. Used by the all-reduce probe to score
        its fraction of peak."""
        if self.num_chips <= 1:
            return float("inf")
        acc = self.accelerator
        if not self.multi_host:
            return acc.nvlink_gbps_per_gpu
        return acc.nic_gbps_per_node / acc.gpus_per_node


@dataclass(frozen=True)
class MultiSlice:
    """``num_slices`` identical GPU slices joined over the data-center
    network. Each slice schedules as its own gang (one StatefulSet,
    ``slice_sts_name``); every node of every slice shares one rank space,
    node rank ``slice_id * nodes_per_slice + ordinal``."""

    slice: GpuSlice
    num_slices: int

    @classmethod
    def parse(
        cls, accelerator: str, topology: str, num_slices: int = 1,
        *, strict: bool = False,
    ) -> "MultiSlice":
        if not isinstance(num_slices, int) or isinstance(num_slices, bool) \
                or num_slices < 1:
            raise TopologyError(
                f"numSlices must be a positive int, got {num_slices!r}")
        if num_slices > 64:
            raise TopologyError(
                f"numSlices {num_slices} exceeds the supported 64")
        return cls(
            slice=GpuSlice.parse(accelerator, topology, strict=strict),
            num_slices=num_slices,
        )

    @property
    def multi(self) -> bool:
        return self.num_slices > 1

    @property
    def num_chips(self) -> int:
        return self.slice.num_chips * self.num_slices

    @property
    def total_hosts(self) -> int:
        return self.slice.num_hosts * self.num_slices

    def slice_sts_name(self, base: str, slice_id: int) -> str:
        """StatefulSet (and pod-name prefix) for one slice; a single slice
        keeps the bare name. Clamped so that pod hostnames
        (``<sts>-<ordinal>``) stay valid DNS labels (≤63 chars)."""
        if not self.multi:
            return base
        name = f"{base}-s{slice_id}"
        limit = 56  # + "-<ordinal>" keeps the pod hostname ≤ 63
        if len(name) <= limit:
            return name
        digest = hashlib.sha256(base.encode()).hexdigest()[:8]
        suffix = f"-{digest}-s{slice_id}"
        return base[: limit - len(suffix)].rstrip("-.") + suffix

    def worker_hostnames(
        self, name: str, headless_service: str, namespace: str,
        cluster_domain: str = "cluster.local",
    ) -> list[list[str]]:
        """Per-slice stable DNS names (every slice's pods share one
        headless Service)."""
        return [
            self.slice.worker_hostnames(
                self.slice_sts_name(name, j), headless_service, namespace,
                cluster_domain,
            )
            for j in range(self.num_slices)
        ]

    def worker_env(
        self, slice_id: int, worker_id: int, hostnames: list[list[str]]
    ) -> dict[str, str]:
        """Full env of node ``worker_id`` of slice ``slice_id``: the
        slice's own env, then the global rank space over every slice."""
        if not 0 <= slice_id < self.num_slices:
            raise TopologyError(
                f"slice_id {slice_id} out of range for {self.num_slices} "
                "slices")
        env = self.slice.worker_env(worker_id, hostnames[slice_id])
        if self.multi:
            env[MASTER_ADDR_ENV] = hostnames[0][0]
            env[NNODES_ENV] = str(self.total_hosts)
            env[NODE_RANK_ENV] = str(
                slice_id * self.slice.num_hosts + worker_id)
            env["MEGASCALE_SLICE_ID"] = str(slice_id)
            env["MEGASCALE_NUM_SLICES"] = str(self.num_slices)
            # DCN probe peers: node 0 of every slice (probe/dcn.py runs
            # one rank per slice to validate the cross-slice network).
            env[SLICE_PEERS_ENV] = ",".join(h[0] for h in hostnames)
        return env

    def peak_bf16_tflops(self) -> float:
        return self.num_slices * self.slice.peak_bf16_tflops()

    def dcn_ring_bandwidth_gbps(self) -> float:
        """Estimated per-direction rate of the cross-slice ring (one rank
        a slice: node 0's NICs bound it), which probe/dcn.py scores
        against. One slice has no cross-slice traffic: inf."""
        if self.num_slices <= 1:
            return float("inf")
        return self.slice.accelerator.nic_gbps_per_node
