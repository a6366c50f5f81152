"""Real-apiserver client over aiohttp (the port of
``kubeflow_tpu/runtime/httpclient.py``).

Same ``KubeApi`` surface as ``FakeKube``, speaking the actual Kubernetes REST
conventions: GVR paths from the scheme, merge-patch content types, watch via
``?watch=true`` chunked JSON lines, in-cluster auth from the mounted
ServiceAccount (token + CA), or kubeconfig-less host/token injection for dev.
"""

from __future__ import annotations

import asyncio
import json
import os
import ssl
from typing import AsyncIterator

import aiohttp

from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.runtime.errors import ServerTimeout, error_for_code
from kubeflow_tpu_torch.runtime.flowcontrol import FlowControl, _env_float
from kubeflow_tpu_torch.runtime.objects import name_of, namespace_of, selector_to_string
from kubeflow_tpu_torch.runtime.scheme import DEFAULT_SCHEME, Scheme

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# Client deadlines + connection pool, env-tunable (docs/operations.md).
# A session with NO total timeout lets one hung apiserver socket pin a
# reconcile worker forever; the watch path opts back out explicitly
# (streams are expected to idle).
TIMEOUT_ENV = "KUBE_CLIENT_TIMEOUT"
LIST_TIMEOUT_ENV = "KUBE_CLIENT_LIST_TIMEOUT"
CONNECT_TIMEOUT_ENV = "KUBE_CLIENT_CONNECT_TIMEOUT"
MAX_CONNS_ENV = "KUBE_CLIENT_MAX_CONNS"
RETRY_429_ENV = "KUBE_CLIENT_RETRY_429"
DEFAULT_TIMEOUT_SEC = 30.0
# LISTs are the one legitimately-slow request class (an informer relist
# of a big kind can stream hundreds of MB) — a 30 s blanket deadline
# would fail every attempt and the cache could never sync. Still
# bounded: a truly hung apiserver must not pin the relist loop forever.
DEFAULT_LIST_TIMEOUT_SEC = 300.0
DEFAULT_CONNECT_TIMEOUT_SEC = 5.0
# Must exceed the flow-control lanes' combined concurrency (16 reads +
# 8 writes + 1 event by default) PLUS the long-lived watch streams the
# informers hold on the same connector (~one per watched kind) — an
# undersized pool would queue watch (re)connects behind a reconcile
# burst exactly when the cluster is busiest.
DEFAULT_MAX_CONNS = 64
DEFAULT_RETRY_429 = 2
RETRY_AFTER_CAP_SEC = 30.0


def _parse_retry_after(value: str | None) -> float:
    """Seconds form only (the apiserver sends integral seconds); an
    unparseable or HTTP-date value falls back to 1 s."""
    try:
        return max(0.0, float(value))
    except (TypeError, ValueError):
        return 1.0


class HttpKube:
    def __init__(
        self,
        base_url: str | None = None,
        token: str | None = None,
        ca_file: str | None = None,
        scheme: Scheme | None = None,
        verify_tls: bool = True,
        flow: FlowControl | None = None,
        timeout: float | None = None,
        connect_timeout: float | None = None,
    ):
        self.scheme = scheme or DEFAULT_SCHEME
        # Client-side priority & fairness: every request passes a lane
        # gate (reads / writes / low-priority events) so one traffic
        # class can't monopolize the connection pool.
        self.flow = flow or FlowControl()
        self._timeout_total = (
            timeout if timeout is not None
            else _env_float(TIMEOUT_ENV, DEFAULT_TIMEOUT_SEC))
        self._timeout_list = max(
            _env_float(LIST_TIMEOUT_ENV, DEFAULT_LIST_TIMEOUT_SEC),
            self._timeout_total)
        self._timeout_connect = (
            connect_timeout if connect_timeout is not None
            else _env_float(CONNECT_TIMEOUT_ENV, DEFAULT_CONNECT_TIMEOUT_SEC))
        self._max_conns = int(_env_float(MAX_CONNS_ENV, DEFAULT_MAX_CONNS))
        self._max_429_retries = int(_env_float(RETRY_429_ENV, DEFAULT_RETRY_429))
        host = os.environ.get("KUBERNETES_SERVICE_HOST")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        self.base_url = base_url or (f"https://{host}:{port}" if host else "http://127.0.0.1:8001")
        if token is None and os.path.exists(f"{SA_DIR}/token"):
            with open(f"{SA_DIR}/token") as f:
                token = f.read().strip()
        self.token = token
        if ca_file is None and os.path.exists(f"{SA_DIR}/ca.crt"):
            ca_file = f"{SA_DIR}/ca.crt"
        self._ssl: ssl.SSLContext | bool | None = None
        if self.base_url.startswith("https"):
            if ca_file:
                self._ssl = ssl.create_default_context(cafile=ca_file)
            elif not verify_tls:
                self._ssl = False
        self._session: aiohttp.ClientSession | None = None

    async def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            headers = {}
            if self.token:
                headers["Authorization"] = f"Bearer {self.token}"
            self._session = aiohttp.ClientSession(
                headers=headers,
                # Default deadline for every request (watch overrides it
                # per-request): a hung apiserver surfaces as a retriable
                # ServerTimeout instead of pinning the worker forever.
                timeout=aiohttp.ClientTimeout(
                    total=self._timeout_total, connect=self._timeout_connect),
                # One shared pool: connection reuse across requests, and
                # a hard cap so a reconcile burst can't exhaust sockets.
                connector=aiohttp.TCPConnector(limit=self._max_conns),
            )
        return self._session

    async def close(self) -> None:
        if self._session and not self._session.closed:
            await self._session.close()

    def _url(self, kind: str, namespace: str | None, name: str | None = None) -> str:
        gvk = self.scheme.by_kind(kind)
        url = self.base_url + gvk.rest_base(namespace)
        if name:
            url += f"/{name}"
        return url

    async def _request(
        self, method: str, url: str, *, verb: str | None = None,
        kind: str | None = None, **kw,
    ) -> dict:
        sess = await self._sess()
        verb = verb or method.lower()
        # Correlate with the active reconcile trace: the trace id travels
        # as X-Request-Id, so the apiserver audit log and this process's
        # flight recorder describe the same request by the same id. The
        # verb/kind tag lands on the trace's root span (api_calls).
        tracing.note_api_call(verb, kind)
        trace_id = tracing.current_trace_id()
        if trace_id:
            headers = dict(kw.pop("headers", None) or {})
            headers.setdefault("X-Request-Id", trace_id)
            kw["headers"] = headers
        for attempt in range(self._max_429_retries + 1):
            try:
                # The lane slot (and the pooled connection) is held only
                # for the request itself — NOT across the Retry-After
                # sleep below, or a 429 storm would park the whole write
                # lane for the server's pacing interval.
                async with self.flow.slot(verb, kind):
                    async with sess.request(
                        method, url, ssl=self._ssl, **kw
                    ) as resp:
                        body = await resp.text()
                        status, headers = resp.status, resp.headers
            except asyncio.TimeoutError:
                raise ServerTimeout(
                    f"{method} {url}: no response within the client "
                    "deadline"
                ) from None
            if status == 429 and attempt < self._max_429_retries:
                # Server-side APF pushed back; honor its pacing (bounded)
                # instead of re-slamming it.
                await asyncio.sleep(min(
                    _parse_retry_after(headers.get("Retry-After")),
                    RETRY_AFTER_CAP_SEC))
                continue
            if status >= 400:
                # The apiserver returns a Status object; its ``reason``
                # is the authoritative error discriminator (409
                # AlreadyExists vs Conflict), not the free-text message.
                reason = None
                try:
                    reason = json.loads(body).get("reason")
                except (ValueError, AttributeError):
                    pass
                raise error_for_code(
                    status, f"{method} {url}: {body[:500]}", reason=reason,
                )
            return json.loads(body) if body else {}
        raise AssertionError("unreachable")  # loop always returns or raises

    # ---- KubeApi surface -----------------------------------------------------

    async def get(self, kind: str, name: str, namespace: str | None = None) -> dict:
        return await self._request(
            "GET", self._url(kind, namespace, name), verb="get", kind=kind
        )

    async def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        field_selector=None,
    ) -> list[dict]:
        items, _ = await self.list_with_rv(kind, namespace, label_selector, field_selector)
        return items

    async def list_with_rv(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        field_selector=None,
    ) -> tuple[list[dict], str | None]:
        """List plus the collection resourceVersion, for list→watch continuity."""
        params = {}
        sel = selector_to_string(label_selector)
        if sel:
            params["labelSelector"] = sel
        data = await self._request(
            "GET", self._url(kind, namespace), verb="list", kind=kind,
            params=params,
            # LIST gets its own (longer, still bounded) deadline — see
            # DEFAULT_LIST_TIMEOUT_SEC.
            timeout=aiohttp.ClientTimeout(
                total=self._timeout_list, connect=self._timeout_connect),
        )
        items = data.get("items", [])
        gvk = self.scheme.by_kind(kind)
        for item in items:
            item.setdefault("kind", kind)
            item.setdefault("apiVersion", gvk.api_version)
        if field_selector:
            items = [o for o in items if field_selector(o)]
        return items, (data.get("metadata") or {}).get("resourceVersion")

    async def create(self, kind: str, obj: dict, namespace: str | None = None) -> dict:
        ns = namespace or namespace_of(obj)
        return await self._request(
            "POST", self._url(kind, ns), verb="create", kind=kind, json=obj
        )

    async def update(self, kind: str, obj: dict) -> dict:
        return await self._request(
            "PUT", self._url(kind, namespace_of(obj), name_of(obj)),
            verb="update", kind=kind, json=obj,
        )

    async def update_status(self, kind: str, obj: dict) -> dict:
        url = self._url(kind, namespace_of(obj), name_of(obj)) + "/status"
        return await self._request(
            "PUT", url, verb="update_status", kind=kind, json=obj
        )

    async def patch(
        self,
        kind: str,
        name: str,
        patch: dict,
        namespace: str | None = None,
        subresource: str | None = None,
    ) -> dict:
        url = self._url(kind, namespace, name)
        if subresource:
            url += f"/{subresource}"
        return await self._request(
            "PATCH",
            url,
            verb="patch",
            kind=kind,
            data=json.dumps(patch),
            headers={"Content-Type": "application/merge-patch+json"},
        )

    async def delete(self, kind: str, name: str, namespace: str | None = None) -> None:
        await self._request(
            "DELETE",
            self._url(kind, namespace, name),
            verb="delete",
            kind=kind,
            json={"propagationPolicy": "Background"},
        )

    async def watch(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        *,
        send_initial: bool = True,
        resource_version: str | None = None,
    ) -> AsyncIterator[tuple[str, dict]]:
        if send_initial:
            for obj in await self.list(kind, namespace, label_selector):
                yield ("ADDED", obj)
        params = {"watch": "true"}
        sel = selector_to_string(label_selector)
        if sel:
            params["labelSelector"] = sel
        if resource_version:
            # Continue exactly where the priming list left off; a 410 Gone
            # surfaces as ApiError and the informer relists.
            params["resourceVersion"] = resource_version
        sess = await self._sess()
        gvk = self.scheme.by_kind(kind)
        async with sess.get(
            self._url(kind, namespace),
            params=params,
            ssl=self._ssl,
            # Streams idle by design — no total/read deadline; connect
            # keeps the session default so a dead endpoint still fails fast.
            timeout=aiohttp.ClientTimeout(
                total=None, sock_read=None, connect=self._timeout_connect),
        ) as resp:
            if resp.status >= 400:
                raise error_for_code(resp.status, await resp.text())
            # Manual line buffering: aiohttp's line iterator raises on JSON
            # lines beyond its 64 KiB readline limit, which real objects
            # (managedFields, big ConfigMaps) exceed routinely.
            buf = b""
            async for chunk in resp.content.iter_any():
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    line = line.strip()
                    if not line:
                        continue
                    evt = json.loads(line)
                    obj = evt.get("object", {})
                    if evt.get("type") == "ERROR":
                        # e.g. 410 Gone on an expired resourceVersion — the
                        # Status object is not a resource; surface as an
                        # ApiError so the informer relists.
                        raise error_for_code(
                            obj.get("code", 500), obj.get("message", "watch error")
                        )
                    obj.setdefault("kind", kind)
                    obj.setdefault("apiVersion", gvk.api_version)
                    yield (evt.get("type", "MODIFIED"), obj)

    async def pod_logs(
        self, name: str, namespace: str, container: str | None = None,
        tail_lines: int | None = None,
    ) -> str:
        """Text response, so it can't ride _request — but it gets the
        same treatment: read lane, trace header, and the session
        deadline surfacing as a retriable ServerTimeout rather than a
        raw asyncio.TimeoutError no error middleware maps."""
        url = self._url("Pod", namespace, name) + "/log"
        params: dict = {}
        if container:
            params["container"] = container
        if tail_lines is not None:
            params["tailLines"] = str(tail_lines)
        sess = await self._sess()
        tracing.note_api_call("get", "Pod")
        headers = {}
        trace_id = tracing.current_trace_id()
        if trace_id:
            headers["X-Request-Id"] = trace_id
        try:
            async with self.flow.slot("get", "Pod"):
                async with sess.get(
                    url, params=params, ssl=self._ssl, headers=headers
                ) as resp:
                    body = await resp.text()
                    if resp.status >= 400:
                        raise error_for_code(resp.status, body[:500])
                    return body
        except asyncio.TimeoutError:
            raise ServerTimeout(
                f"GET {url}: no response within the client deadline"
            ) from None

    async def get_or_none(self, kind: str, name: str, namespace: str | None = None):
        from kubeflow_tpu_torch.runtime.errors import NotFound

        try:
            return await self.get(kind, name, namespace)
        except NotFound:
            return None
