"""Jupyter web app (JWA) backend — notebook CRUD for the spawner UI."""

from kubeflow_tpu_torch.web.jupyter.app import create_app

__all__ = ["create_app"]
