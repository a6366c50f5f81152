"""VWA routes: PVC CRUD + PVCViewer lifecycle.

Reference: ``crud-web-apps/volumes/backend/apps/default/routes/
{get,post,delete}.py`` — list pvcs with attached-pod detection (get.py:9-45),
create pvc (post.py:11-27), create/delete viewer (post.py/delete.py:12-52).
"""

from __future__ import annotations

from aiohttp import web

from kubeflow_tpu_torch.api import pvcviewer as pvcapi
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, name_of
from kubeflow_tpu_torch.web.common.app import create_base_app, json_success
from kubeflow_tpu_torch.web.common.serving import add_spa
from kubeflow_tpu_torch.web.common.auth import ensure
from kubeflow_tpu_torch.web.common.status import events_for


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


def _claims_to_pods(pods: list[dict], *, exclude_viewers: bool = False) -> dict:
    """claim name → [pod names] from one Pod list (avoids an N+1 list per
    PVC). ``exclude_viewers`` drops pods that exist only to *view* a claim
    (labelled ``pvcviewer`` by the pvcviewer controller) — they must not
    block deleting it."""
    out: dict[str, list[str]] = {}
    for pod in pods:
        if exclude_viewers and "pvcviewer" in (
            deep_get(pod, "metadata", "labels", default={}) or {}
        ):
            continue
        for vol in deep_get(pod, "spec", "volumes", default=[]):
            claim = deep_get(vol, "persistentVolumeClaim", "claimName")
            if claim:
                out.setdefault(claim, []).append(name_of(pod))
    return out


@routes.get("/api/namespaces/{namespace}/pvcs")
async def list_pvcs(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "PersistentVolumeClaim", ns)
    viewers = {
        deep_get(v, "spec", "pvc"): v for v in await kube.list("PVCViewer", ns)
    }
    claims_to_pods = _claims_to_pods(await kube.list("Pod", ns))
    pvcs = []
    for pvc in await kube.list("PersistentVolumeClaim", ns):
        claim = name_of(pvc)
        used_by = claims_to_pods.get(claim, [])
        viewer = viewers.get(claim)
        pvcs.append(
            {
                "name": claim,
                "namespace": ns,
                "capacity": deep_get(
                    pvc, "spec", "resources", "requests", "storage"
                ),
                "modes": deep_get(pvc, "spec", "accessModes", default=[]),
                "class": deep_get(pvc, "spec", "storageClassName"),
                "status": deep_get(pvc, "status", "phase", default="Bound"),
                "usedBy": used_by,
                "viewer": {
                    "name": name_of(viewer),
                    "ready": deep_get(viewer, "status", "ready", default=False),
                    "url": deep_get(viewer, "status", "url"),
                }
                if viewer
                else None,
            }
        )
    return json_success({"pvcs": pvcs})


@routes.post("/api/namespaces/{namespace}/pvcs")
async def post_pvc(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "create", "PersistentVolumeClaim", ns)
    body = await request.json()
    name = body.get("name", "")
    if not name:
        raise Invalid("pvc form: name is required")
    pvc = {
        "apiVersion": "v1",
        "kind": "PersistentVolumeClaim",
        "metadata": {"name": name, "namespace": ns},
        "spec": {
            "accessModes": body.get("mode") and [body["mode"]]
            or body.get("accessModes", ["ReadWriteOnce"]),
            "resources": {"requests": {"storage": body.get("size", "5Gi")}},
            **(
                {"storageClassName": body["class"]}
                if body.get("class") not in (None, "", "$empty")
                else {}
            ),
        },
    }
    await kube.create("PersistentVolumeClaim", pvc)
    return json_success({"message": f"PVC {name} created"})


@routes.delete("/api/namespaces/{namespace}/pvcs/{name}")
async def delete_pvc(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "delete", "PersistentVolumeClaim", ns)
    used_by = _claims_to_pods(
        await kube.list("Pod", ns), exclude_viewers=True
    ).get(name, [])
    if used_by:
        raise Invalid(f"PVC {name} is in use by pods: {', '.join(used_by)}")
    # Delete the viewer first like the reference (delete.py:24-40).
    for viewer in await kube.list("PVCViewer", ns):
        if deep_get(viewer, "spec", "pvc") == name:
            await kube.delete("PVCViewer", name_of(viewer), ns)
    await kube.delete("PersistentVolumeClaim", name, ns)
    return json_success({"message": f"PVC {name} deleted"})


@routes.get("/api/namespaces/{namespace}/pvcs/{name}/events")
async def pvc_events(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "list", "Event", ns)
    events = await events_for(kube, ns, name, ("PersistentVolumeClaim",))
    return json_success({"events": events})


@routes.post("/api/namespaces/{namespace}/viewers")
async def post_viewer(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "create", "PVCViewer", ns)
    body = await request.json()
    pvc = body.get("pvc", "")
    if not pvc:
        raise Invalid("viewer form: pvc is required")
    viewer = pvcapi.new(pvc, ns, pvc)
    await kube.create("PVCViewer", viewer)
    return json_success({"message": f"PVCViewer for {pvc} created"})


@routes.delete("/api/namespaces/{namespace}/viewers/{name}")
async def delete_viewer(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "delete", "PVCViewer", ns)
    await kube.delete("PVCViewer", name, ns)
    return json_success({"message": f"PVCViewer {name} deleted"})
