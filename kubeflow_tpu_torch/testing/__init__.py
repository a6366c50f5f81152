"""Test harness of the port (the counterpart of ``kubeflow_tpu.testing``):
the in-memory fake kube-apiserver (``fakekube``), the kubelet simulator
that materialises StatefulSet pods (``podsim``), and
``distributed_worker``, the process that proves a pod's injected node env
bootstraps a ``torch.distributed`` world."""

from kubeflow_tpu_torch.testing.fakekube import FakeKube, FaultPlan
from kubeflow_tpu_torch.testing.podsim import PodSimulator

__all__ = ["FakeKube", "FaultPlan", "PodSimulator"]
