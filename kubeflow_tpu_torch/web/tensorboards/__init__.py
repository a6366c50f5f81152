"""Tensorboards web app (TWA) backend."""

from kubeflow_tpu_torch.web.tensorboards.app import create_app

__all__ = ["create_app"]
