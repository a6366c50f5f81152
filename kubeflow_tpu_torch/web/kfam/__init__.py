"""Kubeflow Access Management (KFAM) service."""

from kubeflow_tpu_torch.web.kfam.app import create_app

__all__ = ["create_app"]
