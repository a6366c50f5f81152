"""JWA routes.

Reference: ``crud-web-apps/jupyter/backend/apps/common/routes/get.py:13-126``
(config/pvcs/poddefaults/notebooks/pod/logs/events/gpu-vendors),
``apps/default/routes/post.py:12-77`` (dry-run-first create),
``apps/common/routes/patch.py`` (stop/start), DELETE foreground.

REST contract kept wire-compatible:
``/api/namespaces/<ns>/notebooks[...]``, plus ``/api/gpus`` serving
accelerator+shape options instead of the reference's vendor limitsKeys.

The port of ``kubeflow_tpu/web/jupyter/app.py``: ``/api/gpus`` replaces
the JAX package's ``/api/tpus``, and the list rows carry ``gpu`` and
``gpuStatus`` (``spec.gpu``, ``status.gpu``) where it has ``tpu`` and
``tpuStatus``.
"""

from __future__ import annotations

from aiohttp import web

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.errors import Invalid, NotFound
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of, now_iso
from kubeflow_tpu_torch.web.common.app import create_base_app, json_success
from kubeflow_tpu_torch.web.common.serving import add_spa
from kubeflow_tpu_torch.web.common.auth import ensure
from kubeflow_tpu_torch.web.common.status import events_for, filter_events, process_status
from kubeflow_tpu_torch.web.jupyter.form import notebook_from_form
from kubeflow_tpu_torch.web.jupyter.spawner_config import gpu_options, load_config


def create_app(kube, *, config: dict | None = None, config_path: str | None = None,
               **kwargs) -> web.Application:
    app = create_base_app(kube, **kwargs)
    app["config"] = config or load_config(config_path)
    app.add_routes(routes)
    # Serving workload class (KFTPU_SERVING, kubeflow_tpu_torch/serving): the
    # InferenceService routes register only with the switch on, so =off
    # keeps the JWA HTTP surface byte-for-byte notebook-only.
    from kubeflow_tpu_torch.serving import serving_enabled

    if serving_enabled():
        app.add_routes(serving_routes)
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


def _events_by_notebook(events: list[dict]) -> dict[str, list[dict]]:
    """Bucket one Event list by notebook name (one list call per request,
    not per notebook)."""
    out: dict[str, list[dict]] = {}
    for ev in events:
        involved = ev.get("involvedObject") or {}
        if involved.get("kind") == "Notebook" and involved.get("name"):
            out.setdefault(involved["name"], []).append(ev)
    return out


async def _notebook_events(kube, ns: str, name: str) -> list[dict]:
    return await events_for(kube, ns, name, ("Notebook",))


@routes.get("/api/config")
async def get_config(request):
    return json_success({"config": request.app["config"]})


@routes.get("/api/gpus")
async def get_gpus(request):
    """Replaces the reference's /api/namespaces/<ns>/gpus vendor scan
    (get.py:101-126): GPU slice options are static facts of the fleet,
    served from the node-shape library."""
    return json_success({"gpus": gpu_options()})


@routes.get("/api/namespaces/{namespace}/notebooks")
async def list_notebooks(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "Notebook", ns)
    events = _events_by_notebook(await kube.list("Event", ns))
    notebooks = []
    for nb in await kube.list("Notebook", ns):
        status = process_status(nb, events.get(name_of(nb), []))
        notebooks.append(_summarize(nb, status))
    return json_success({"notebooks": notebooks})


def _summarize(nb: dict, status) -> dict:
    meta = get_meta(nb)
    containers = deep_get(nb, "spec", "template", "spec", "containers", default=[{}])
    gpu = deep_get(nb, "spec", "gpu")
    return {
        "name": meta.get("name"),
        "namespace": meta.get("namespace"),
        "serverType": (meta.get("annotations") or {}).get(
            nbapi.SERVER_TYPE_ANNOTATION, "jupyter"
        ),
        "age": meta.get("creationTimestamp"),
        # The culler's annotation (reference JWA "Last activity" column).
        "lastActivity": (meta.get("annotations") or {}).get(
            nbapi.LAST_ACTIVITY_ANNOTATION
        ),
        "image": containers[0].get("image", ""),
        "cpu": deep_get(containers[0], "resources", "requests", "cpu"),
        "memory": deep_get(containers[0], "resources", "requests", "memory"),
        "gpu": gpu,
        "gpuStatus": deep_get(nb, "status", "gpu"),
        "status": {"phase": status.phase, "message": status.message},
        "labels": meta.get("labels") or {},
        "annotations": meta.get("annotations") or {},
    }


@routes.get("/api/namespaces/{namespace}/notebooks/{name}")
async def get_notebook(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "get", "Notebook", ns)
    nb = await kube.get("Notebook", name, ns)
    events = await _notebook_events(kube, ns, name)
    # NB: key must not be "status" — that would clobber the envelope's
    # numeric status field in json_success.
    return json_success(
        {"notebook": nb,
         "processedStatus": process_status(nb, events).__dict__}
    )


@routes.get("/api/namespaces/{namespace}/notebooks/{name}/pod")
async def get_notebook_pod(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "get", "Pod", ns)
    pods = await kube.list(
        "Pod", ns, label_selector={"matchLabels": {nbapi.NOTEBOOK_NAME_LABEL: name}}
    )
    if not pods:
        raise NotFound(f"no pods for notebook {name}")
    return json_success({"pod": pods[0], "pods": pods})


@routes.get("/api/namespaces/{namespace}/notebooks/{name}/pod/{pod}/logs")
async def get_pod_logs(request):
    """Reference: get.py logs route — worker pod logs for the details UI."""
    kube, authz, user, ns = _ctx(request)
    pod = request.match_info["pod"]
    await ensure(authz, user, "get", "Pod", ns)
    logs = await kube.pod_logs(pod, ns, tail_lines=500)
    return json_success({"logs": logs.splitlines()})


@routes.get("/api/namespaces/{namespace}/notebooks/{name}/events")
async def get_notebook_events(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "list", "Event", ns)
    events = await _notebook_events(kube, ns, name)
    # Recreated server with the same name: hide the prior incarnation's
    # events (reference get_notebook_events creationTimestamp filter).
    nb = await kube.get_or_none("Notebook", name, ns)
    if nb is not None:
        events = filter_events(nb, events)
    return json_success({"events": events})


@routes.get("/api/namespaces/{namespace}/pvcs")
async def list_pvcs(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "PersistentVolumeClaim", ns)
    return json_success({"pvcs": await kube.list("PersistentVolumeClaim", ns)})


@routes.get("/api/namespaces/{namespace}/poddefaults")
async def list_poddefaults(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "PodDefault", ns)
    pds = await kube.list("PodDefault", ns)
    # The UI shows label + description pairs (get.py:36-50).
    contents = [
        {
            "label": _pd_label(pd),
            "desc": deep_get(pd, "spec", "desc", default=name_of(pd)),
        }
        for pd in pds
    ]
    return json_success({"poddefaults": contents})


def _pd_label(pd: dict) -> str:
    match_labels = deep_get(pd, "spec", "selector", "matchLabels", default={})
    return next(iter(match_labels), name_of(pd))


@routes.post("/api/namespaces/{namespace}/notebooks")
async def post_notebook(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "create", "Notebook", ns)
    body = await request.json()
    nb, pvcs = notebook_from_form(request.app["config"], body, ns, user)
    if pvcs:
        await ensure(authz, user, "create", "PersistentVolumeClaim", ns)
    # Notebook FIRST: if its create fails (name taken, webhook rejection)
    # no PVCs are orphaned; pods just stay Pending until the claims land a
    # moment later (the reference gets the same guarantee via dry-runs,
    # post.py:51-58).
    await kube.create("Notebook", nb)
    for pvc in pvcs:
        if await kube.get_or_none("PersistentVolumeClaim", name_of(pvc), ns) is None:
            await kube.create("PersistentVolumeClaim", pvc)
    return json_success({"message": f"Notebook {name_of(nb)} created"}, status=200)


@routes.post("/api/namespaces/{namespace}/notebooks/yaml")
async def post_notebook_yaml(request):
    """Create a Notebook from raw YAML (the shared lib's editor dialog —
    reference parity with kubeflow-common-lib's monaco editor module).
    Kind and namespace are enforced server-side; everything else goes
    through the normal admission chain (defaulting, validation, catalog)."""
    import yaml  # lazy like every yaml use here: dependencies = [] by design

    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "create", "Notebook", ns)
    raw = await request.text()
    try:
        nb = yaml.safe_load(raw)
    except yaml.YAMLError as e:
        raise Invalid(f"could not parse YAML: {e}")
    if not isinstance(nb, dict) or nb.get("kind") != nbapi.KIND:
        raise Invalid("YAML must be a single Notebook manifest")
    meta = nb.setdefault("metadata", {})
    if not isinstance(meta, dict) or not isinstance(
        meta.get("annotations", {}), dict
    ):
        raise Invalid("metadata (and metadata.annotations) must be mappings")
    if meta.get("namespace") not in (None, ns):
        raise Invalid(
            f"metadata.namespace {meta.get('namespace')!r} does not match "
            f"the request namespace {ns!r}"
        )
    meta["namespace"] = ns
    # Creator is the authenticated user, never the manifest's claim (the
    # form path stamps it the same way — an audit field must not be
    # spoofable through the YAML door).
    meta.setdefault("annotations", {})[nbapi.CREATOR_ANNOTATION] = user
    await kube.create("Notebook", nb)
    return json_success({"message": f"Notebook {name_of(nb)} created"})


@routes.patch("/api/namespaces/{namespace}/notebooks/{name}")
async def patch_notebook(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "patch", "Notebook", ns)
    body = await request.json()
    if "stopped" not in body:
        raise Invalid("PATCH body must contain 'stopped'")
    if body["stopped"]:
        annotations = {nbapi.STOP_ANNOTATION: now_iso()}
    else:
        annotations = {nbapi.STOP_ANNOTATION: None}
    await kube.patch(
        "Notebook", name, {"metadata": {"annotations": annotations}}, ns
    )
    return json_success({"message": f"Notebook {name} updated"})


@routes.delete("/api/namespaces/{namespace}/notebooks/{name}")
async def delete_notebook(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "delete", "Notebook", ns)
    await kube.delete("Notebook", name, ns)
    return json_success({"message": f"Notebook {name} deleted"})


# ---- serving workload class (registered only with KFTPU_SERVING on) ----------

serving_routes = web.RouteTableDef()


def _summarize_serving(isvc: dict) -> dict:
    from kubeflow_tpu_torch.web.common.status import process_serving_status

    meta = get_meta(isvc)
    status = process_serving_status(isvc)
    return {
        "name": meta.get("name"),
        "namespace": meta.get("namespace"),
        "age": meta.get("creationTimestamp"),
        "gpu": deep_get(isvc, "spec", "gpu"),
        "scaling": deep_get(isvc, "spec", "scaling"),
        "serving": deep_get(isvc, "status", "serving"),
        "readyReplicas": deep_get(isvc, "status", "readyReplicas"),
        "status": {"phase": status.phase, "message": status.message},
    }


@serving_routes.get("/api/namespaces/{namespace}/inferenceservices")
async def list_inferenceservices(request):
    kube, authz, user, ns = _ctx(request)
    await ensure(authz, user, "list", "InferenceService", ns)
    services = [
        _summarize_serving(isvc)
        for isvc in await kube.list("InferenceService", ns)
    ]
    return json_success({"inferenceservices": services})


@serving_routes.get("/api/namespaces/{namespace}/inferenceservices/{name}")
async def get_inferenceservice(request):
    from kubeflow_tpu_torch.web.common.status import process_serving_status

    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "get", "InferenceService", ns)
    isvc = await kube.get("InferenceService", name, ns)
    return json_success(
        {"inferenceservice": isvc,
         "processedStatus": process_serving_status(isvc).__dict__})


@serving_routes.delete("/api/namespaces/{namespace}/inferenceservices/{name}")
async def delete_inferenceservice(request):
    kube, authz, user, ns = _ctx(request)
    name = request.match_info["name"]
    await ensure(authz, user, "delete", "InferenceService", ns)
    await kube.delete("InferenceService", name, ns)
    return json_success({"message": f"InferenceService {name} deleted"})
