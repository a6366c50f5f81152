"""GPU node shapes: the port's counterpart of ``kubeflow_tpu.tpu``, the
one source of truth for accelerator decisions (accelerator + shape →
nodes, cards a node, GKE node selector, worker env, resource requests,
peak estimates)."""

from kubeflow_tpu_torch.gpu.topology import (
    ACCELERATORS,
    GpuAccelerator,
    GpuSlice,
    MultiSlice,
    TopologyError,
    parse_topology,
)

__all__ = [
    "ACCELERATORS",
    "GpuAccelerator",
    "GpuSlice",
    "MultiSlice",
    "TopologyError",
    "parse_topology",
]
