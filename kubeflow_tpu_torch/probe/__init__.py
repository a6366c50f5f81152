"""Slice burn-in probes: the port of ``kubeflow_tpu.probe``.

Two probes validate a freshly spawned GPU slice:

- :mod:`kubeflow_tpu_torch.probe.ici`: ``torch.distributed`` all-reduce
  bandwidth (NCCL over NVLink inside a node, the GPU NICs across nodes),
  scored as a fraction of the node shape's estimate
  (``GpuSlice.allreduce_algo_bandwidth_gbps``).
- :mod:`kubeflow_tpu_torch.probe.dcn`: TCP ring bandwidth between nodes
  (the repo's native C++ engine in ``native/``), validating the
  headless-Service path the rendezvous bootstraps over.

Run in-notebook or as a Job: ``python -m kubeflow_tpu_torch.probe`` (alone
it covers the node's cards; under ``torchrun`` it runs in that world).
"""

from kubeflow_tpu_torch.probe.ici import IciReport, run_ici_probe

__all__ = ["run_ici_probe", "IciReport"]
