"""The control plane's wire names the port's SDK speaks (trimmed copies
of ``kubeflow_tpu.api``)."""
