"""Deployment entrypoints of the port (the counterpart of
``kubeflow_tpu.cmd``).

One process per deployment unit, matching the manifests:

- ``python -m kubeflow_tpu_torch.cmd.controller_manager`` — all reconcilers
- ``python -m kubeflow_tpu_torch.cmd.webhook``            — admission server
- ``python -m kubeflow_tpu_torch.cmd.webapp``             — web-app backends
- ``python -m kubeflow_tpu_torch.cmd.devserver``          — every web app on
  the in-memory control plane (development, no cluster)

Configuration is env-var based like the reference (GetEnvDefault pattern,
``culling_controller.go:491-544``), unified here through ``envconfig``.
"""
