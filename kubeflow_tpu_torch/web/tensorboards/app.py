"""TWA routes: Tensorboard CRUD.

Reference: ``crud-web-apps/tensorboards/backend/app/routes/{get,post,delete}.py``.
"""

from __future__ import annotations

from aiohttp import web

from kubeflow_tpu_torch.api import tensorboard as tbapi
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of
from kubeflow_tpu_torch.web.common.app import create_base_app, json_success
from kubeflow_tpu_torch.web.common.serving import add_spa
from kubeflow_tpu_torch.web.common.auth import ensure
from kubeflow_tpu_torch.web.common.status import events_for, filter_events


def create_app(kube, **kwargs) -> web.Application:
    app = create_base_app(kube, **kwargs)
    app.add_routes(routes)
    add_spa(app, __file__)
    return app


routes = web.RouteTableDef()


def _ctx(request: web.Request):
    return (
        request.app["kube"],
        request.app["authorizer"],
        request.get("user", ""),
        request.match_info.get("namespace"),
    )


@routes.get("/api/namespaces/{namespace}/tensorboards")
async def list_tensorboards(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "Tensorboard", ns)
    tensorboards = [
        {
            "name": name_of(tb),
            "namespace": ns,
            "logspath": deep_get(tb, "spec", "logspath"),
            "ready": bool(deep_get(tb, "status", "readyReplicas", default=0)),
            "age": get_meta(tb).get("creationTimestamp"),
        }
        for tb in await kube.list("Tensorboard", ns)
    ]
    return json_success({"tensorboards": tensorboards})


@routes.post("/api/namespaces/{namespace}/tensorboards")
async def post_tensorboard(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "create", "Tensorboard", ns)
    body = await request.json()
    name, logspath = body.get("name", ""), body.get("logspath", "")
    if not name or not logspath:
        raise Invalid("tensorboard form: name and logspath are required")
    tb = tbapi.new(name, ns, logspath, profiler=bool(body.get("profilerPlugin")))
    await kube.create("Tensorboard", tb)
    return json_success({"message": f"Tensorboard {name} created"})


@routes.get("/api/namespaces/{namespace}/pvcs")
async def list_pvcs(request):
    """PVC names for the pvc:// logspath picker (the reference TWA serves
    pvcs + poddefaults alongside tensorboards for its form)."""
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "PersistentVolumeClaim", ns)
    pvcs = [
        {
            "name": name_of(pvc),
            "capacity": deep_get(pvc, "spec", "resources", "requests", "storage"),
            "modes": deep_get(pvc, "spec", "accessModes", default=[]),
        }
        for pvc in await kube.list("PersistentVolumeClaim", ns)
    ]
    return json_success({"pvcs": pvcs})


@routes.get("/api/namespaces/{namespace}/poddefaults")
async def list_poddefaults(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "PodDefault", ns)
    contents = [
        {
            "label": next(
                iter(deep_get(pd, "spec", "selector", "matchLabels", default={})),
                name_of(pd),
            ),
            "desc": deep_get(pd, "spec", "desc", default=name_of(pd)),
        }
        for pd in await kube.list("PodDefault", ns)
    ]
    return json_success({"poddefaults": contents})


@routes.get("/api/namespaces/{namespace}/tensorboards/{name}/events")
async def tensorboard_events(request):
    """Events involving the Tensorboard CR or its Deployment (the details
    drawer's events table — VWA's pvc_events twin). Filtered to the
    current incarnation like the JWA events route."""
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "list", "Event", ns)
    events = await events_for(kube, ns, name, ("Tensorboard", "Deployment"))
    tb = await kube.get_or_none("Tensorboard", name, ns)
    if tb is not None:
        events = filter_events(tb, events)
    return json_success({"events": events})


@routes.delete("/api/namespaces/{namespace}/tensorboards/{name}")
async def delete_tensorboard(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "delete", "Tensorboard", ns)
    await kube.delete("Tensorboard", name, ns)
    return json_success({"message": f"Tensorboard {name} deleted"})
