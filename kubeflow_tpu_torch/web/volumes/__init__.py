"""Volumes web app (VWA) backend."""

from kubeflow_tpu_torch.web.volumes.app import create_app

__all__ = ["create_app"]
