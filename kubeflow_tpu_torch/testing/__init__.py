"""Test harness pieces of the port (the counterpart of
``kubeflow_tpu.testing``): ``distributed_worker``, the process that proves
the injected node env bootstraps a ``torch.distributed`` world."""
