"""Admission for GPU pods: the port's counterpart of
``kubeflow_tpu.webhooks.tpu`` (``gpu.mutate_pod``, the per-ordinal node
env)."""
