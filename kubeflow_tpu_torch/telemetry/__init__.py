"""Telemetry of the parallel stack: the registered named sections around
its collectives (``sections``), trimmed from ``kubeflow_tpu.telemetry``."""
