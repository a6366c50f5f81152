"""AdmissionReview HTTPS server for real clusters.

The reference runs three separate webhook servers (PodDefault
``/apply-poddefault``, odh notebook ``/mutate-notebook-v1``, pvcviewer
defaulter); this is the single consolidated server, one endpoint per
engine, speaking ``admission.k8s.io/v1`` AdmissionReview with JSONPatch
responses (serve loop contract: ``admission-webhook/main.go:708-773``).

In tests the same engines run in-process on FakeKube's admission chain —
this module only adds the wire protocol.

The port of ``kubeflow_tpu/webhooks/server.py``: the pod route injects the
per-node GPU env (``webhooks/gpu.py``: ``TPU_WORKER_ID``, ``PET_NODE_RANK``)
where the reference injects the per-host TPU env, and the notebook route
holds the card request against ``spec.gpuQuota`` and the GPU fleet.
"""

from __future__ import annotations

import base64
import json
import logging
import ssl

from aiohttp import web

from kubeflow_tpu_torch.api import poddefault as pdapi
from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.api import pvcviewer as pvcapi
from kubeflow_tpu_torch.api import tensorboard as tbapi
from kubeflow_tpu_torch.runtime.errors import ApiError
from kubeflow_tpu_torch.runtime.metrics import global_registry
from kubeflow_tpu_torch.runtime.objects import deepcopy
from kubeflow_tpu_torch.runtime.tracing import Tracer, span
from kubeflow_tpu_torch.webhooks import gpu as gpu_webhook
from kubeflow_tpu_torch.webhooks import jsonpatch
from kubeflow_tpu_torch.webhooks import notebook as nb_webhook
from kubeflow_tpu_torch.webhooks import poddefault as pd_webhook

log = logging.getLogger(__name__)


def _allow(uid: str, patch: list[dict] | None = None) -> dict:
    response: dict = {"uid": uid, "allowed": True}
    if patch:
        response["patchType"] = "JSONPatch"
        response["patch"] = base64.b64encode(
            json.dumps(patch).encode()
        ).decode()
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": response,
    }


def _deny(uid: str, message: str, code: int = 400) -> dict:
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": {
            "uid": uid,
            "allowed": False,
            "status": {"message": message, "code": code},
        },
    }


def create_webhook_app(kube, *, registry=None, tracer=None) -> web.Application:
    registry = registry or global_registry
    app = web.Application()
    app["kube"] = kube
    # Admission spans + flight recorder: the same tracing machinery the
    # controllers use, so /debug/traces on the webhook answers "what did
    # admission do to kind/ns/name and how long did the mutator take".
    tracer = tracer or Tracer(registry)
    app["tracer"] = tracer
    # Admission observability (controller-runtime webhooks expose the same
    # shape; the reference's PodDefault server only klogs).
    m_admissions = registry.counter(
        "webhook_admission_total",
        "AdmissionReview requests by endpoint and outcome",
        ["path", "allowed"],
    )

    async def handle(request: web.Request, mutator) -> web.Response:
        try:
            review = await request.json()
        except ValueError:
            review = None
        if not isinstance(review, dict):
            # Counts valid-JSON-but-not-an-object bodies too — the failure
            # class this metric exists to surface.
            m_admissions.labels(path=request.path, allowed="false").inc()
            return web.json_response(
                _deny("", "could not decode AdmissionReview"), status=400
            )
        req = review.get("request") or {}
        uid = req.get("uid", "")
        obj = req.get("object") or {}
        operation = req.get("operation", "CREATE")
        old = req.get("oldObject") or None
        # Namespace fallback (main.go:616-619).
        if not obj.get("metadata", {}).get("namespace") and req.get("namespace"):
            obj.setdefault("metadata", {})["namespace"] = req["namespace"]
        original = deepcopy(obj)
        meta = obj.get("metadata") or {}
        admission_key = (
            obj.get("kind") or req.get("kind", {}).get("kind") or "?",
            meta.get("namespace"),
            meta.get("name") or meta.get("generateName") or "?",
        )
        # Reuse the apiserver's request id when it sent one, so the
        # admission trace correlates with the apiserver audit log.
        incoming_id = request.headers.get("X-Request-Id")
        with tracer.trace(
            "admission", key=admission_key, controller="webhook",
            trace_id=incoming_id, path=request.path, operation=operation,
        ) as root:
            try:
                with span("mutate"):
                    await mutator(request.app["kube"], obj, operation, old)
            except ApiError as e:
                # The deny response swallows the exception — fail() the
                # root explicitly or the flight recorder would file this
                # admission as outcome ok.
                root.fail(e.message)
                root.set_attribute("allowed", "false")
                m_admissions.labels(path=request.path, allowed="false").inc()
                resp = web.json_response(_deny(uid, e.message, e.code))
            except Exception as e:
                log.exception("webhook mutator failed")
                root.fail(repr(e))
                root.set_attribute("allowed", "false")
                m_admissions.labels(path=request.path, allowed="false").inc()
                resp = web.json_response(
                    _deny(uid, "internal webhook error", 500))
            else:
                root.set_attribute("allowed", "true")
                m_admissions.labels(path=request.path, allowed="true").inc()
                resp = web.json_response(
                    _allow(uid, jsonpatch.diff(original, obj)))
            if root.trace_id:
                resp.headers["X-Request-Id"] = root.trace_id
        return resp

    # -- Pod mutation: PodDefault injection + per-node GPU env --------------
    async def mutate_pod(kube, pod, operation, _old):
        if operation == "CREATE":
            await pd_webhook.mutate_pod(kube, pod)
            gpu_webhook.mutate_pod(pod)

    # -- CR defaulting/validation (+ restart blocking for Notebooks) --------
    async def mutate_notebook(kube, nb, operation, old):
        nb_webhook.mutate(nb, {"operation": operation, "old": old})
        # Image-alias pinning from the catalog ConfigMap (same engine the
        # in-process chain registers; see webhooks/notebook.py).
        await nb_webhook.resolve_image_from_catalog(kube, nb)
        # Capacity fast-fail (CREATE only): a gang that exceeds the
        # namespace gpuQuota or the configured fleet's ceiling can never
        # run — reject it here instead of queueing it forever.
        if operation == "CREATE":
            await nb_webhook.validate_capacity(kube, nb)

    async def mutate_pvcviewer(_kube, viewer, _op, _old):
        pvcapi.default(viewer)
        pvcapi.validate(viewer)

    def route(mutator):
        async def handler(request: web.Request) -> web.Response:
            return await handle(request, mutator)

        return handler

    # /apply-poddefault is the reference's path (main.go:765); /mutate-pods
    # is the canonical alias.
    app.router.add_post("/apply-poddefault", route(mutate_pod))
    app.router.add_post("/mutate-pods", route(mutate_pod))
    app.router.add_post("/mutate-notebooks", route(mutate_notebook))
    app.router.add_post("/mutate-pvcviewers", route(mutate_pvcviewer))

    for path, validator in (
        ("/validate-poddefaults", pdapi.validate),
        ("/validate-profiles", profileapi.validate),
        ("/validate-tensorboards", tbapi.validate),
    ):
        async def validate_handler(request, _v=validator):
            async def fn(_kube, obj, _op, _old):
                _v(obj)

            return await handle(request, fn)

        app.router.add_post(path, validate_handler)

    # -- CRD version conversion (apiextensions.k8s.io/v1 ConversionReview) --
    # Reference: notebook-controller serves v1/v1beta1/v1alpha1 with the
    # hub/spoke no-op conversion (api/v1beta1/notebook_conversion.go) wired
    # via config/crd/patches/webhook_in_notebooks.yaml's /convert path.
    async def convert(request: web.Request) -> web.Response:
        from kubeflow_tpu_torch.api import notebook as nbapi
        from kubeflow_tpu_torch.api import profile as profile_api

        converters = {
            nbapi.KIND: nbapi.convert,
            profile_api.KIND: profile_api.convert,
        }

        try:
            review = await request.json()
        except ValueError:
            return web.json_response(
                {"error": "could not decode ConversionReview"}, status=400
            )
        req = review.get("request") or {}
        uid = req.get("uid", "")
        desired = req.get("desiredAPIVersion", "")
        converted, failed = [], None
        for obj in req.get("objects") or []:
            try:
                fn = converters.get(obj.get("kind"))
                if fn is not None:
                    converted.append(fn(obj, desired))
                else:
                    # Other CRDs are single-version today; identity-convert
                    # anything already at the desired version.
                    if obj.get("apiVersion") != desired:
                        raise ApiError(
                            f"no conversion for {obj.get('kind')} "
                            f"{obj.get('apiVersion')} -> {desired}"
                        )
                    converted.append(obj)
            except ApiError as e:
                failed = e.message
                break
        result = (
            {"status": "Failed", "message": failed}
            if failed
            else {"status": "Success"}
        )
        return web.json_response(
            {
                "apiVersion": "apiextensions.k8s.io/v1",
                "kind": "ConversionReview",
                "response": {
                    "uid": uid,
                    "result": result,
                    **({} if failed else {"convertedObjects": converted}),
                },
            }
        )

    app.router.add_post("/convert", convert)

    async def healthz(_request):
        return web.json_response({"status": "ok"})

    async def metrics(_request):
        return web.Response(text=registry.expose(), content_type="text/plain")

    async def debug_traces(request: web.Request) -> web.Response:
        """Recent admission flight-recorder entries (key=Kind/ns/name)."""
        try:
            limit = int(request.query.get("limit", "50"))
        except ValueError:
            limit = 50
        return web.json_response({
            "traces": tracer.recorder.entries(
                key=request.query.get("key"), limit=limit
            ),
        })

    app.router.add_get("/metrics", metrics)
    app.router.add_get("/healthz", healthz)
    app.router.add_get("/debug/traces", debug_traces)
    return app


def ssl_context(cert_file: str, key_file: str) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    return ctx


async def rotate_certs(ctx: ssl.SSLContext, cert_file: str, key_file: str,
                       *, watcher=None, poll_seconds: float = 30.0) -> None:
    """Reload renewed certs into the live SSLContext — cert-manager /
    service-ca rotate the files in place, and ``load_cert_chain`` on an
    in-use context makes every NEW handshake present the new chain, so
    the admission server never needs the pod restart the reference
    relies on. Half-written files mid-rotation (cert swapped before key)
    fail the load and retry on the next change event. Run as an asyncio
    task; cancel to stop."""
    from kubeflow_tpu_torch.utils.fswatch import FileWatcher

    w = watcher or FileWatcher(cert_file)
    retry_pending = False
    try:
        while True:
            changed = await w.wait(timeout=poll_seconds)
            # Only the cert file's mtime is watched; a renewal that
            # writes cert-then-key can fail the load on the first event
            # and never fire another. While a failed load is pending,
            # retry on every wakeup (timeouts included) until it sticks.
            if not changed and not retry_pending:
                continue
            try:
                # Validate the pair in a throwaway context FIRST:
                # load_cert_chain installs the cert before the key check
                # can raise, so loading a half-rotated pair directly
                # into the live context would leave it serving
                # new-cert/old-key — a handshake outage, not a stale
                # cert. Only a pair that loads cleanly touches ctx.
                probe = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
                probe.load_cert_chain(cert_file, key_file)
                ctx.load_cert_chain(cert_file, key_file)
                log.info("webhook TLS certs reloaded from %s", cert_file)
                retry_pending = False
            except (ssl.SSLError, OSError) as e:
                log.warning("cert reload failed (mid-rotation?): %s — "
                            "will retry; old chain keeps serving", e)
                retry_pending = True
    finally:
        if hasattr(w, "close"):
            w.close()
