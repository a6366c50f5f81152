"""KFAM: profiles + contributor bindings REST service.

Reference: ``components/access-management/kfam`` — router (routers.go:32-106),
handlers (api_default.go:104-310), binding ⇄ RoleBinding (+ Istio
AuthorizationPolicy) materialisation (bindings.go:79-238), role-name map
(bindings.go:38-46), owner-or-cluster-admin authorization.

Binding model: ``{user: {kind: User, name}, referredNamespace,
roleRef: {kind: ClusterRole, name: admin|edit|view}}`` — materialised as a
RoleBinding ``user-<safe-email>-clusterrole-<role>`` annotated with
user/role (the annotations are the source of truth for listing).

The port of ``kubeflow_tpu/web/kfam/app.py``: a created profile's
accelerator ceiling is ``spec.gpuQuota`` (cards), where the JAX package's
is ``spec.tpuQuota`` (chips).
"""

from __future__ import annotations

import re

from aiohttp import web

from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.runtime.errors import Invalid, NotFound
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of
from kubeflow_tpu_torch.web.common.app import create_base_app, json_error, json_success

# bindings.go:38-46
ROLE_MAP = {"admin": "kubeflow-admin", "edit": "kubeflow-edit", "view": "kubeflow-view"}


def safe_user_name(user: str) -> str:
    return re.sub(r"[^a-z0-9]", "-", user.lower())


def binding_name(user: str, role: str) -> str:
    return f"user-{safe_user_name(user)}-clusterrole-{role}"


def create_app(
    kube,
    *,
    cluster_admins: set[str] | None = None,
    use_istio: bool = False,
    userid_header: str = "kubeflow-userid",
    **kwargs,
) -> web.Application:
    app = create_base_app(kube, userid_header=userid_header, **kwargs)
    app["cluster_admins"] = cluster_admins or set()
    app["use_istio"] = use_istio
    app.add_routes(routes)
    return app


routes = web.RouteTableDef()


async def _is_owner_or_admin(request, namespace: str) -> bool:
    user = request.get("user", "")
    if user in request.app["cluster_admins"]:
        return True
    kube = request.app["kube"]
    profile = await kube.get_or_none("Profile", namespace)
    if profile is None:
        return False
    return profileapi.owner_of(profile).get("name") == user


@routes.get("/kfam/v1/role-clusteradmin")
async def get_cluster_admin(request):
    caller = request.get("user", "")
    user = request.query.get("user", caller)
    # Only admins may query someone else's role.
    if user != caller and caller not in request.app["cluster_admins"]:
        return json_error("forbidden: cannot query another user's role", 403)
    return json_success({"clusterAdmin": user in request.app["cluster_admins"]})


@routes.post("/kfam/v1/profiles")
async def post_profile(request):
    kube = request.app["kube"]
    caller = request.get("user", "")
    body = await request.json()
    name = body.get("name") or deep_get(body, "metadata", "name")
    owner = deep_get(body, "spec", "owner", "name") or body.get("user", caller)
    if not name:
        raise Invalid("profile: name required")
    # A non-admin may only create a profile owned by THEMSELF — otherwise
    # any user could claim any unregistered namespace name for (or as)
    # someone else (same invariant as the dashboard registration flow).
    if owner != caller and caller not in request.app["cluster_admins"]:
        return json_error(
            "forbidden: only cluster admins may create profiles for others", 403
        )
    profile = profileapi.new(name, owner)
    if deep_get(body, "spec", "resourceQuotaSpec"):
        profile["spec"]["resourceQuotaSpec"] = body["spec"]["resourceQuotaSpec"]
    if deep_get(body, "spec", "gpuQuota") is not None:
        profile["spec"]["gpuQuota"] = body["spec"]["gpuQuota"]
    await kube.create("Profile", profile)
    return json_success({"message": f"Profile {name} created"})


@routes.delete("/kfam/v1/profiles/{name}")
async def delete_profile(request):
    kube = request.app["kube"]
    name = request.match_info["name"]
    if not await _is_owner_or_admin(request, name):
        return json_error("forbidden: only the owner or a cluster admin", 403)
    await kube.delete("Profile", name)
    return json_success({"message": f"Profile {name} deleted"})


@routes.get("/kfam/v1/bindings")
async def list_bindings(request):
    kube = request.app["kube"]
    caller = request.get("user", "")
    namespace = request.query.get("namespace")
    role_filter = request.query.get("role")
    user_filter = request.query.get("user")
    bindings = []
    if namespace:
        # Owner, cluster admin, or an existing contributor of the namespace.
        if not await _is_owner_or_admin(request, namespace):
            member = any(
                (get_meta(rb).get("annotations") or {}).get("user") == caller
                for rb in await kube.list("RoleBinding", namespace)
            )
            if not member:
                return json_error(
                    "forbidden: not a member of this namespace", 403
                )
        namespaces = [namespace]
    elif caller in request.app["cluster_admins"]:
        namespaces = [name_of(p) for p in await kube.list("Profile")]
    else:
        return json_error(
            "forbidden: cluster-wide binding listing requires cluster admin", 403
        )
    for ns in namespaces:
        for rb in await kube.list("RoleBinding", ns):
            annotations = get_meta(rb).get("annotations") or {}
            if "user" not in annotations or "role" not in annotations:
                continue
            role = annotations["role"]
            short = next((k for k, v in ROLE_MAP.items() if v == role), role)
            if role_filter and short != role_filter:
                continue
            if user_filter and annotations["user"] != user_filter:
                continue
            bindings.append(
                {
                    "user": {"kind": "User", "name": annotations["user"]},
                    "referredNamespace": ns,
                    "roleRef": {"kind": "ClusterRole", "name": short},
                }
            )
    return json_success({"bindings": bindings})


@routes.post("/kfam/v1/bindings")
async def post_binding(request):
    kube = request.app["kube"]
    body = await request.json()
    user = deep_get(body, "user", "name")
    ns = body.get("referredNamespace")
    role = deep_get(body, "roleRef", "name", default="edit")
    if not user or not ns:
        raise Invalid("binding: user.name and referredNamespace required")
    if role not in ROLE_MAP:
        raise Invalid(f"binding: unknown role {role!r} (admin|edit|view)")
    if not await _is_owner_or_admin(request, ns):
        return json_error("forbidden: only the owner or a cluster admin", 403)
    rb = {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {
            "name": binding_name(user, role),
            "namespace": ns,
            "annotations": {"user": user, "role": ROLE_MAP[role]},
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": ROLE_MAP[role],
        },
        "subjects": [
            {"kind": "User", "name": user, "apiGroup": "rbac.authorization.k8s.io"}
        ],
    }
    await kube.create("RoleBinding", rb)
    if request.app["use_istio"]:
        ap = {
            "apiVersion": "security.istio.io/v1beta1",
            "kind": "AuthorizationPolicy",
            "metadata": {
                "name": binding_name(user, role),
                "namespace": ns,
                "annotations": {"user": user, "role": ROLE_MAP[role]},
            },
            "spec": {
                "rules": [
                    {
                        "when": [
                            {
                                "key": "request.headers[kubeflow-userid]",
                                "values": [user],
                            }
                        ]
                    }
                ]
            },
        }
        await kube.create("AuthorizationPolicy", ap)
    return json_success({"message": f"Binding for {user} in {ns} created"})


@routes.delete("/kfam/v1/bindings")
async def delete_binding(request):
    kube = request.app["kube"]
    body = await request.json()
    user = deep_get(body, "user", "name")
    ns = body.get("referredNamespace")
    role = deep_get(body, "roleRef", "name", default="edit")
    if not user or not ns:
        raise Invalid("binding: user.name and referredNamespace required")
    if not await _is_owner_or_admin(request, ns):
        return json_error("forbidden: only the owner or a cluster admin", 403)
    name = binding_name(user, role)
    await kube.delete("RoleBinding", name, ns)
    if request.app["use_istio"]:
        try:
            await kube.delete("AuthorizationPolicy", name, ns)
        except NotFound:
            pass
    return json_success({"message": f"Binding for {user} in {ns} deleted"})
