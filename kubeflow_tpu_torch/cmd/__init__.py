"""Deployment entrypoints of the port (the counterpart of
``kubeflow_tpu.cmd``).

One process per deployment unit, matching the manifests:

- ``python -m kubeflow_tpu_torch.cmd.controller_manager`` — all reconcilers
- ``python -m kubeflow_tpu_torch.cmd.webhook``            — admission server

Configuration is env-var based like the reference (GetEnvDefault pattern,
``culling_controller.go:491-544``), unified here through ``envconfig``.
The web apps' entrypoint (``cmd.webapp``) is not ported yet.
"""
