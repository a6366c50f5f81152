"""Test harness of the port (the counterpart of ``kubeflow_tpu.testing``):
the in-memory fake kube-apiserver (``fakekube``), the kubelet simulator
that materialises StatefulSet pods (``podsim``),
``distributed_worker``, the process that proves a pod's injected node env
bootstraps a ``torch.distributed`` world, and the control plane's two
harnesses: the chaos soak with its poison-pill and shard-kill scenarios
(``chaos``) and the notebook load test (``loadtest``)."""

from kubeflow_tpu_torch.testing.fakekube import FakeKube, FaultPlan
from kubeflow_tpu_torch.testing.podsim import PodSimulator

__all__ = ["FakeKube", "FaultPlan", "PodSimulator"]
