"""Central dashboard backend-for-frontend."""

from kubeflow_tpu_torch.web.dashboard.app import create_app

__all__ = ["create_app"]
