"""Authentication + authorization for the web backends.

Reference: ``crud_backend/authn.py:13-67`` (trusted ``kubeflow-userid``
header injected by the auth proxy at the gateway; the backend never sees
credentials) and ``crud_backend/authz.py:45-132`` (SubjectAccessReview per
request: may <user> <verb> <resource> in <namespace>?).
"""

from __future__ import annotations

from typing import Protocol

from kubeflow_tpu_torch.runtime.errors import Forbidden
from kubeflow_tpu_torch.runtime.scheme import DEFAULT_SCHEME

USERID_HEADER = "kubeflow-userid"  # crud_backend/settings.py:3-6


class Authorizer(Protocol):
    async def check(
        self, user: str, verb: str, kind: str, namespace: str | None
    ) -> bool: ...


class AllowAll:
    """Dev-mode authorizer (reference APP_SECURE_COOKIES/dev config)."""

    async def check(self, user, verb, kind, namespace) -> bool:
        return True


class SarAuthorizer:
    """SubjectAccessReview-backed authorizer (authz.py:45-132): delegates the
    decision to the cluster's RBAC by creating a SAR and reading
    ``status.allowed``."""

    def __init__(self, kube):
        self.kube = kube

    async def check(self, user, verb, kind, namespace) -> bool:
        gvk = DEFAULT_SCHEME.by_kind(kind)
        sar = {
            "apiVersion": "authorization.k8s.io/v1",
            "kind": "SubjectAccessReview",
            "metadata": {"generateName": "web-app-sar-"},
            "spec": {
                "user": user,
                "resourceAttributes": {
                    "group": gvk.group,
                    "resource": gvk.plural,
                    "verb": verb,
                    "namespace": namespace,
                },
            },
        }
        created = await self.kube.create("SubjectAccessReview", sar)
        return bool((created.get("status") or {}).get("allowed"))


async def ensure(
    authorizer: Authorizer, user: str, verb: str, kind: str, namespace: str | None
) -> None:
    if not await authorizer.check(user, verb, kind, namespace):
        raise Forbidden(
            f"User {user!r} cannot {verb} {kind} in namespace {namespace!r}"
        )
