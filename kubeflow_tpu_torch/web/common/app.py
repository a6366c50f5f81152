"""aiohttp app factory with the cross-cutting middleware stack.

Reference: ``crud_backend/__init__.py:16-35`` (create_app) with:

- authn: trusted userid header (authn.py:34-67) — 401 when absent unless a
  dev default user is configured
- CSRF double-submit cookie (csrf.py:59-113): safe methods set/refresh the
  ``XSRF-TOKEN`` cookie; mutating methods must echo it in ``X-XSRF-TOKEN``
- error mapping: ApiError subclasses → JSON envelope with the right HTTP
  status (the reference's ``{success, status, log}`` envelope)
- liveness/readiness blueprint (probes.py)
- /metrics in Prometheus text format (the reference exposes metrics from
  controllers only; here every backend serves its registry)
"""

from __future__ import annotations

import logging
import secrets
import time

from aiohttp import web

from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.runtime.errors import ApiError, Unauthorized
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.web.common.auth import USERID_HEADER, AllowAll, Authorizer

log = logging.getLogger(__name__)

CSRF_COOKIE = "XSRF-TOKEN"
CSRF_HEADER = "X-XSRF-TOKEN"
SAFE_METHODS = {"GET", "HEAD", "OPTIONS"}
REQUEST_ID_HEADER = "X-Request-Id"


def _is_probe_path(path: str) -> bool:
    """Probe/scrape endpoints bypass authn/CSRF. Matched by last segment so
    the exemption holds under path-prefixed subapp mounting (WEBAPP=all
    serves /jupyter/healthz etc.)."""
    return path.rstrip("/").rsplit("/", 1)[-1] in ("healthz", "readyz", "metrics")


def json_success(payload: dict | None = None, status: int = 200) -> web.Response:
    return web.json_response({"success": True, "status": status, **(payload or {})},
                             status=status)


def json_error(message: str, status: int = 500) -> web.Response:
    return web.json_response(
        {"success": False, "status": status, "log": message}, status=status
    )


def create_base_app(
    kube,
    *,
    authorizer: Authorizer | None = None,
    userid_header: str = USERID_HEADER,
    userid_prefix: str = "",
    dev_default_user: str | None = None,
    csrf_protect: bool = True,
    secure_cookies: bool | None = None,
    registry: Registry | None = None,
) -> web.Application:
    # Secure cookies default on like the reference (APP_SECURE_COOKIES,
    # crud_backend/config.py): HTTPS deployments must not send the CSRF
    # double-submit cookie cleartext. Dev/test over plain http sets the
    # env var (or the kwarg) to false.
    if secure_cookies is None:
        import os

        secure_cookies = (
            os.environ.get("APP_SECURE_COOKIES", "true").lower() != "false"
        )
    registry = registry or global_registry
    m_requests = registry.counter(
        "web_app_requests_total", "Backend HTTP requests", ["method", "status"]
    )
    m_duration = registry.histogram(
        "web_request_duration_seconds",
        "Backend HTTP request latency per route",
        ["route", "method"],
    )

    def _route_of(request: web.Request) -> str:
        """The matched route PATTERN (bounded label cardinality), not the
        raw path — /api/namespaces, not whatever the client typed."""
        resource = getattr(request.match_info.route, "resource", None)
        canonical = getattr(resource, "canonical", None)
        return canonical or "unmatched"

    @web.middleware
    async def request_id_middleware(request: web.Request, handler):
        """Correlation + latency, outermost: every request runs under a
        trace whose id comes from (or becomes) the X-Request-Id header —
        the same header the controllers stamp on their apiserver calls —
        and every response echoes it. The per-route duration histogram
        observes even error responses."""
        rid = request.headers.get(REQUEST_ID_HEADER) or tracing.new_trace_id()
        request["request_id"] = rid
        t0 = time.perf_counter()
        try:
            with tracing.span(
                "http_request", trace_id=rid,
                method=request.method, path=request.path,
            ):
                resp = await handler(request)
            resp.headers[REQUEST_ID_HEADER] = rid
            return resp
        except web.HTTPException as e:
            # aiohttp HTTP exceptions ARE responses; echo the id on them.
            e.headers[REQUEST_ID_HEADER] = rid
            raise
        finally:
            # Every request lands in the histogram — error responses and
            # escaped exceptions included.
            m_duration.labels(
                route=_route_of(request), method=request.method
            ).observe(time.perf_counter() - t0)

    @web.middleware
    async def error_middleware(request: web.Request, handler):
        try:
            resp = await handler(request)
        except web.HTTPException:
            raise
        except ApiError as e:
            log.info("%s %s -> %s", request.method, request.path, e.reason)
            resp = json_error(e.message, e.code)
        except Exception:
            log.exception("%s %s failed", request.method, request.path)
            resp = json_error("internal error", 500)
        m_requests.labels(method=request.method, status=str(resp.status)).inc()
        return resp

    @web.middleware
    async def authn_middleware(request: web.Request, handler):
        if _is_probe_path(request.path):
            return await handler(request)
        user = request.headers.get(userid_header)
        if user is None:
            if dev_default_user is None:
                raise Unauthorized(f"missing {userid_header} header")
            user = dev_default_user
        if userid_prefix and user.startswith(userid_prefix):
            user = user[len(userid_prefix):]
        request["user"] = user
        return await handler(request)

    @web.middleware
    async def csrf_middleware(request: web.Request, handler):
        if not csrf_protect or _is_probe_path(request.path):
            return await handler(request)
        cookie = request.cookies.get(CSRF_COOKIE)
        if request.method not in SAFE_METHODS:
            header = request.headers.get(CSRF_HEADER)
            if not cookie or not header or not secrets.compare_digest(cookie, header):
                return json_error("CSRF token missing or invalid", 403)
        resp = await handler(request)
        if request.method in SAFE_METHODS and not cookie:
            # Secure by default like the reference (APP_SECURE_COOKIES,
            # csrf.py) — double-submit cookies must not travel cleartext
            # on HTTPS deployments. Dev mode (plain http) turns it off.
            resp.set_cookie(
                CSRF_COOKIE, secrets.token_urlsafe(32),
                samesite="Strict", secure=secure_cookies, httponly=False,
            )
        return resp

    app = web.Application(
        middlewares=[
            request_id_middleware,
            error_middleware,
            authn_middleware,
            csrf_middleware,
        ]
    )
    app["kube"] = kube
    app["authorizer"] = authorizer or AllowAll()
    # The resolved identity contract, for introspection (/debug) — never
    # re-derive from env, the kwargs are the truth.
    app["userid_header"] = userid_header
    app["userid_prefix"] = userid_prefix

    async def healthz(_request):
        return web.json_response({"status": "ok"})

    async def metrics(_request):
        return web.Response(text=registry.expose(), content_type="text/plain")

    async def namespaces(_request):
        """Common to every app (reference crud_backend/routes/get.py:10-15):
        namespace names for the UI's picker."""
        names = sorted(
            (ns.get("metadata") or {}).get("name", "")
            for ns in await kube.list("Namespace")
        )
        return json_success({"namespaces": [n for n in names if n]})

    DEFAULT_SC_ANNOTATIONS = (
        "storageclass.kubernetes.io/is-default-class",
        "storageclass.beta.kubernetes.io/is-default-class",  # GKE legacy
    )

    async def storageclasses(_request):
        """Names for the volume form's class picker (reference
        crud_backend/routes/get.py:18-23)."""
        names = sorted(
            (sc.get("metadata") or {}).get("name", "")
            for sc in await kube.list("StorageClass")
        )
        return json_success({"storageClasses": [n for n in names if n]})

    async def default_storageclass(_request):
        """The cluster default, or "" when none is marked (reference
        crud_backend/routes/get.py:26-52 — both annotation spellings)."""
        for sc in await kube.list("StorageClass"):
            annotations = (sc.get("metadata") or {}).get("annotations") or {}
            if any(annotations.get(key) == "true"
                   for key in DEFAULT_SC_ANNOTATIONS):
                return json_success(
                    {"defaultStorageClass": sc["metadata"]["name"]})
        return json_success({"defaultStorageClass": ""})

    app.router.add_get("/healthz", healthz)
    app.router.add_get("/readyz", healthz)
    app.router.add_get("/metrics", metrics)
    app.router.add_get("/api/namespaces", namespaces)
    app.router.add_get("/api/storageclasses", storageclasses)
    app.router.add_get("/api/storageclasses/default", default_storageclass)
    return app
