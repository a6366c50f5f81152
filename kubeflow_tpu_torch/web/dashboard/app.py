"""Dashboard BFF: namespace/workgroup aggregation + cluster metrics.

Reference: ``components/centraldashboard/app`` — workgroup/registration flow
against KFAM (api_workgroup.ts, 394 LoC), k8s info (k8s_service.ts), metrics
abstraction with pluggable drivers (metrics_service.ts:1-53,
prometheus_metrics_service.ts:1-90), user header middleware
(attach_user_middleware.ts), env contract in server.ts:27-37.

The KFAM dependency is injected as an in-process callable boundary (the
reference's HTTP hop): pass ``kfam_client=HttpKfam(url)`` in production or
leave the default in-process implementation when KFAM shares the process.

Accelerator metrics: alongside the reference's CPU/memory panels the
dashboard aggregates card demand per namespace straight from the
apiserver (pod resource requests), so the landing page answers "who is
holding cards" without a Prometheus round-trip.

The port of ``kubeflow_tpu/web/dashboard/app.py``:
``/api/namespaces/<ns>/gpu-usage`` sums ``nvidia.com/gpu`` requests
against the profile quota's ``requests.nvidia.com/gpu``, where the JAX
package's ``tpu-usage`` sums ``google.com/tpu``; the answer keeps the
leaves ``chipsRequested`` / ``chipsQuota`` (here: cards).
"""

from __future__ import annotations

from aiohttp import web

from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of
from kubeflow_tpu_torch.gpu.topology import GPU_RESOURCE
from kubeflow_tpu_torch.web.common.app import create_base_app, json_success
from kubeflow_tpu_torch.web.common.serving import add_spa
from kubeflow_tpu_torch.web.common.auth import ensure

DEFAULT_LINKS = [
    {"type": "item", "link": "/jupyter/", "text": "Notebooks", "icon": "book"},
    {"type": "item", "link": "/tensorboards/", "text": "TensorBoards",
     "icon": "assessment"},
    {"type": "item", "link": "/volumes/", "text": "Volumes",
     "icon": "device:storage"},
]


def create_app(
    kube,
    *,
    links: list[dict] | None = None,
    settings: dict | None = None,
    registration_flow: bool = True,
    metrics_service=None,
    kfam_client=None,
    cluster_admins: set[str] | None = None,
    **kwargs,
) -> web.Application:
    import os

    from kubeflow_tpu_torch.web.dashboard.kfam import HttpKfam, InProcessKfam
    from kubeflow_tpu_torch.web.dashboard.metrics import metrics_service_from_env

    app = create_base_app(kube, **kwargs)
    app["links"] = links or DEFAULT_LINKS
    app["settings"] = settings or {}
    app["registration_flow"] = registration_flow
    app["metrics_service"] = metrics_service or metrics_service_from_env(
        dict(os.environ)
    )
    # KFAM boundary (reference PROFILES_KFAM_SERVICE_HOST): HTTP hop when a
    # split KFAM deployment is configured, in-process otherwise.
    kfam_url = os.environ.get("KFAM_URL")
    app["kfam"] = kfam_client or (
        HttpKfam(kfam_url) if kfam_url
        else InProcessKfam(kube, cluster_admins=cluster_admins)
    )
    app.add_routes(routes)
    add_spa(app, __file__)

    async def _close_clients(app):
        await app["metrics_service"].close()
        if hasattr(app["kfam"], "close"):
            await app["kfam"].close()

    app.on_cleanup.append(_close_clients)
    return app


routes = web.RouteTableDef()


async def _namespaces_for(kube, user: str) -> list[dict]:
    """Namespaces the user owns or contributes to (api_workgroup.ts
    getWorkgroupInfo): owner annotation or KFAM binding annotations.
    Contributor lookups across namespaces run concurrently — this backs the
    dashboard landing page, so no serial per-profile round-trips."""
    import asyncio

    profiles = await kube.list("Profile")

    async def role_in(profile: dict) -> dict | None:
        ns = name_of(profile)
        if profileapi.owner_of(profile).get("name") == user:
            return {"namespace": ns, "role": "owner", "user": user}
        for rb in await kube.list("RoleBinding", ns):
            annotations = get_meta(rb).get("annotations") or {}
            if annotations.get("user") == user and "role" in annotations:
                role = annotations["role"].removeprefix("kubeflow-")
                return {"namespace": ns, "role": role, "user": user}
        return None

    results = await asyncio.gather(*(role_in(p) for p in profiles))
    return [r for r in results if r]


@routes.get("/api/workgroup/exists")
async def workgroup_exists(request):
    kube, user = request.app["kube"], request.get("user", "")
    namespaces = await _namespaces_for(kube, user)
    return json_success(
        {
            "hasAuth": True,
            "hasWorkgroup": any(n["role"] == "owner" for n in namespaces),
            "user": user,
            "registrationFlowAllowed": request.app["registration_flow"],
        }
    )


@routes.get("/api/workgroup/env-info")
async def env_info(request):
    kube, user = request.app["kube"], request.get("user", "")
    namespaces = await _namespaces_for(kube, user)
    return json_success(
        {
            "user": user,
            "namespaces": namespaces,
            "platform": {"provider": "gke", "logoutUrl": "/logout"},
            "isClusterAdmin": False,
        }
    )


@routes.post("/api/workgroup/create")
async def create_workgroup(request):
    """Self-serve registration (api_workgroup.ts create flow): the user's
    first profile, named from their email local part."""
    kube, user = request.app["kube"], request.get("user", "")
    if not request.app["registration_flow"]:
        raise Invalid("registration flow is disabled")
    # The namespace name is DERIVED from the authenticated identity, never
    # taken from the body — a body override would let any user claim any
    # unregistered namespace name (e.g. kube-system) as their profile.
    name = user.split("@")[0].replace(".", "-").lower()
    await kube.create("Profile", profileapi.new(name, user))
    return json_success({"message": f"Created namespace {name}"})


@routes.delete("/api/workgroup/nuke-self")
async def nuke_self(request):
    """Self-serve deregistration (reference api_workgroup.ts nuke-self):
    delete every profile the caller owns; cascade removes the namespaces."""
    kube, user = request.app["kube"], request.get("user", "")
    from kubeflow_tpu_torch.api import profile as papi

    deleted = []
    for profile in await kube.list("Profile"):
        if papi.owner_of(profile).get("name") == user:
            await kube.delete("Profile", name_of(profile))
            deleted.append(name_of(profile))
    if not deleted:
        raise Invalid(f"user {user!r} owns no profiles")
    return json_success({"message": f"Deleted profiles: {', '.join(deleted)}"})


@routes.get("/api/workgroup/get-contributors/{namespace}")
async def get_contributors(request):
    """Reference api_workgroup.ts get-contributors/:namespace."""
    kfam, user = request.app["kfam"], request.get("user", "")
    namespace = request.match_info["namespace"]
    users = await kfam.list_contributors(user, namespace)
    return json_success({"contributors": users})


@routes.post("/api/workgroup/add-contributor/{namespace}")
async def add_contributor(request):
    """Reference api_workgroup.ts add-contributor/:namespace."""
    kfam, user = request.app["kfam"], request.get("user", "")
    namespace = request.match_info["namespace"]
    body = await request.json()
    await kfam.add_contributor(user, namespace, body.get("contributor", ""))
    return json_success(
        {"contributors": await kfam.list_contributors(user, namespace)}
    )


@routes.delete("/api/workgroup/remove-contributor/{namespace}")
async def remove_contributor(request):
    """Reference api_workgroup.ts remove-contributor/:namespace."""
    kfam, user = request.app["kfam"], request.get("user", "")
    namespace = request.match_info["namespace"]
    body = await request.json()
    await kfam.remove_contributor(user, namespace, body.get("contributor", ""))
    return json_success(
        {"contributors": await kfam.list_contributors(user, namespace)}
    )


@routes.get("/api/dashboard-links")
async def dashboard_links(request):
    return json_success({"menuLinks": request.app["links"]})


@routes.get("/debug")
async def debug_info(request):
    """Deployment self-description (reference server.ts /debug): who the
    request resolved to and which env contract is active."""
    from kubeflow_tpu_torch.runtime.deployment import controller_namespace

    return json_success({
        "user": request.get("user", ""),
        "kfamBoundary": type(request.app["kfam"]).__name__,
        "metricsDriver": type(request.app["metrics_service"]).__name__,
        "registrationFlowAllowed": request.app["registration_flow"],
        "controllerNamespace": controller_namespace(),
        "headersForIdentity": {
            "USERID_HEADER": request.app["userid_header"],
            "USERID_PREFIX": request.app["userid_prefix"],
        },
    })


@routes.get("/api/dashboard-settings")
async def dashboard_settings(request):
    """Admin settings blob (reference api.ts /dashboard-settings: the
    links ConfigMap's data["settings"] JSON; default {})."""
    return json_success({"settings": request.app.get("settings") or {}})


@routes.get("/api/activities/{namespace}")
async def activities(request):
    """Recent events in the namespace, newest first (reference api.ts
    /activities/:namespace → k8sService.getEventsForNamespace)."""
    kube = request.app["kube"]
    ns = request.match_info["namespace"]
    await ensure(
        request.app["authorizer"], request.get("user", ""), "list", "Event", ns
    )
    from kubeflow_tpu_torch.web.common.status import event_stamp as stamp

    events = await kube.list("Event", ns)
    events.sort(key=stamp, reverse=True)
    return json_success({
        "activities": [
            {
                "time": stamp(ev),
                "type": ev.get("type", "Normal"),
                "reason": ev.get("reason", ""),
                "message": ev.get("message", ""),
                "involved": {
                    "kind": (ev.get("involvedObject") or {}).get("kind", ""),
                    "name": (ev.get("involvedObject") or {}).get("name", ""),
                },
            }
            for ev in events[:100]
        ]
    })


@routes.get("/api/metrics")
async def cluster_metrics(request):
    """Time-series metrics via the configured driver (reference
    ``server.ts`` /api/metrics + resource-chart.js consumption): query
    params ``type`` (node_cpu|pod_cpu|pod_mem|gpu_duty) and ``interval``
    (Last5m..Last180m)."""
    from kubeflow_tpu_torch.web.dashboard.metrics import INTERVALS_MIN, QUERIES

    svc = request.app["metrics_service"]
    series = request.query.get("type", "node_cpu")
    interval = request.query.get("interval", "Last15m")
    if series not in QUERIES or interval not in INTERVALS_MIN:
        raise Invalid(f"unknown metrics type/interval {series!r}/{interval!r}")
    points = await svc.query(series, interval)
    return json_success(
        {
            "type": series,
            "interval": interval,
            "points": [p.to_dict() for p in points],
            **svc.charts_link(),
        }
    )


@routes.get("/api/namespaces/{namespace}/gpu-usage")
async def gpu_usage(request):
    """GPU card demand in a namespace, from pod resource requests."""
    kube = request.app["kube"]
    ns = request.match_info["namespace"]
    await ensure(
        request.app["authorizer"], request.get("user", ""), "list", "Pod", ns
    )
    chips_requested = 0
    pods = []
    for pod in await kube.list("Pod", ns):
        pod_chips = 0
        for ctr in deep_get(pod, "spec", "containers", default=[]):
            val = deep_get(ctr, "resources", "requests", GPU_RESOURCE)
            if val is not None:
                pod_chips += int(val)
        if pod_chips:
            pods.append({"pod": name_of(pod), "chips": pod_chips})
            chips_requested += pod_chips
    quota = await kube.get_or_none("ResourceQuota", profileapi.QUOTA_NAME, ns)
    limit = deep_get(quota or {}, "spec", "hard", profileapi.GPU_QUOTA_KEY)
    return json_success(
        {
            "namespace": ns,
            "chipsRequested": chips_requested,
            "chipsQuota": int(limit) if limit is not None else None,
            "pods": pods,
        }
    )
