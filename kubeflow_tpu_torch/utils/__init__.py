"""Utilities of the port (the counterpart of ``kubeflow_tpu.utils``)."""
