"""Shared CRUD-backend library (reference: ``crud-web-apps/common/backend/
kubeflow/kubeflow/crud_backend`` — app factory, authn, authz, CSRF, status).
"""

from kubeflow_tpu_torch.web.common.app import create_base_app, json_error, json_success
from kubeflow_tpu_torch.web.common.auth import AllowAll, Authorizer, SarAuthorizer

__all__ = [
    "create_base_app",
    "json_success",
    "json_error",
    "Authorizer",
    "AllowAll",
    "SarAuthorizer",
]
