"""KFAM client boundary for the dashboard BFF.

Reference: the Express dashboard talks to KFAM over HTTP
(``centraldashboard/app/api_workgroup.ts`` handleContributor /
getContributors, env ``PROFILES_KFAM_SERVICE_HOST``, server.ts:27-37).
Two drivers here: ``HttpKfam`` reproduces that hop for split deployments;
``InProcessKfam`` collapses it when KFAM shares the process (the single
controller-manager shape this framework prefers, SURVEY.md §7c).
"""

from __future__ import annotations

import re

from kubeflow_tpu_torch.runtime.errors import Forbidden, Invalid, NotFound
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of

EMAIL_RGX = re.compile(r"^[^@\s]+@[^@\s]+\.[^@\s]+$")


class InProcessKfam:
    """Contributor management straight against the apiserver, with the
    same owner-or-cluster-admin gate KFAM's HTTP handlers apply."""

    def __init__(self, kube, *, cluster_admins: set[str] | None = None,
                 use_istio: bool = False):
        self.kube = kube
        self.cluster_admins = cluster_admins or set()
        self.use_istio = use_istio

    async def _ensure_owner(self, caller: str, namespace: str) -> None:
        if caller in self.cluster_admins:
            return
        profile = await self.kube.get_or_none("Profile", namespace)
        if profile is None:
            raise NotFound(f"no profile for namespace {namespace!r}")
        owner = deep_get(profile, "spec", "owner", default={}) or {}
        if owner.get("name") != caller:
            raise Forbidden(
                f"only the owner of {namespace!r} (or a cluster admin) "
                "may manage contributors"
            )

    async def list_contributors(self, caller: str, namespace: str) -> list[str]:
        # Reference getContributors: bindings filtered to role=contributor.
        from kubeflow_tpu_torch.web.kfam.app import ROLE_MAP

        await self._ensure_owner(caller, namespace)
        users = []
        for rb in await self.kube.list("RoleBinding", namespace):
            annotations = get_meta(rb).get("annotations") or {}
            if annotations.get("role") == ROLE_MAP.get("edit") and \
                    annotations.get("user"):
                users.append(annotations["user"])
        return sorted(set(users))

    async def add_contributor(self, caller: str, namespace: str,
                              email: str) -> None:
        from kubeflow_tpu_torch.web.kfam.app import ROLE_MAP, binding_name

        if not EMAIL_RGX.match(email or ""):
            raise Invalid(f"contributor must be an email, got {email!r}")
        await self._ensure_owner(caller, namespace)
        role = ROLE_MAP["edit"]
        rb = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {
                "name": binding_name(email, "edit"),
                "namespace": namespace,
                "annotations": {"user": email, "role": role},
            },
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "ClusterRole",
                "name": role,
            },
            "subjects": [
                {"kind": "User", "name": email,
                 "apiGroup": "rbac.authorization.k8s.io"}
            ],
        }
        await self.kube.create("RoleBinding", rb)

    async def remove_contributor(self, caller: str, namespace: str,
                                 email: str) -> None:
        from kubeflow_tpu_torch.web.kfam.app import binding_name

        await self._ensure_owner(caller, namespace)
        await self.kube.delete(
            "RoleBinding", binding_name(email, "edit"), namespace
        )


class HttpKfam:
    """The reference's HTTP hop: every call forwards the caller identity in
    the userid header so KFAM applies its own authz."""

    def __init__(self, base_url: str, *,
                 userid_header: str = "kubeflow-userid"):
        self.base_url = base_url.rstrip("/")
        self.userid_header = userid_header
        self._session = None

    async def _request(self, method: str, path: str, caller: str,
                       json_body=None):
        import aiohttp

        if self._session is None:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=15)
            )
        async with self._session.request(
            method,
            self.base_url + path,
            headers={self.userid_header: caller},
            json=json_body,
        ) as resp:
            body = await resp.json()
            if resp.status >= 400 or body.get("success") is False:
                raise Invalid(body.get("log") or f"KFAM HTTP {resp.status}")
            return body

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    async def list_contributors(self, caller: str, namespace: str) -> list[str]:
        body = await self._request(
            "GET", f"/kfam/v1/bindings?namespace={namespace}&role=edit", caller
        )
        return sorted(
            {b["user"]["name"] for b in body.get("bindings", [])}
        )

    async def add_contributor(self, caller: str, namespace: str,
                              email: str) -> None:
        if not EMAIL_RGX.match(email or ""):
            raise Invalid(f"contributor must be an email, got {email!r}")
        await self._request(
            "POST", "/kfam/v1/bindings", caller,
            {
                "user": {"kind": "User", "name": email},
                "referredNamespace": namespace,
                "roleRef": {"kind": "ClusterRole", "name": "edit"},
            },
        )

    async def remove_contributor(self, caller: str, namespace: str,
                                 email: str) -> None:
        await self._request(
            "DELETE", "/kfam/v1/bindings", caller,
            {
                "user": {"kind": "User", "name": email},
                "referredNamespace": namespace,
                "roleRef": {"kind": "ClusterRole", "name": "edit"},
            },
        )
