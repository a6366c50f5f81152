"""Entrypoint wiring of the port (the counterpart of ``kubeflow_tpu.cmd``).

Only the env contract the notebook controller's setup reads is here so
far (``envconfig``); the manager, webhook and web-app entrypoints come
with their controllers.
"""
