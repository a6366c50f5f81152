"""Frontend-execution harness (the port of ``kubeflow_tpu/testing/jsweb.py``,
on the port's manager, notebook controller, kubelet simulator and
admission chain): the vendored JS runtime driving the real
aiohttp backends over real HTTP.

``JsWebHarness`` owns a private asyncio loop so the Browser's synchronous
``fetch`` bridge can run aiohttp coroutines to completion mid-JS — the
control plane (manager + pod simulator) lives on the same loop, so
reconciles progress while the frontend polls, exactly like the reference's
Cypress runs against a live backend (SURVEY.md §4.3), except here the
backend is real, not fixture-mocked.
"""

from __future__ import annotations

import asyncio

import aiohttp
from aiohttp.test_utils import TestClient, TestServer

from kubeflow_tpu_torch.testing.jsrt import Browser

USER_HEADERS = {"kubeflow-userid": "alice@example.com"}


class JsWebHarness:
    """Sync facade over the async control plane + one web app + a Browser.

    Use as a context manager from *synchronous* tests::

        with JsWebHarness(create_jwa) as h:
            h.browser.load("/")
            h.settle()                      # let controllers reconcile
            h.browser.advance(5000)         # fire the poller
    """

    def __init__(self, create_app, *, user=None, extra_controllers=()):
        from kubeflow_tpu_torch.controllers.notebook import setup_notebook_controller
        from kubeflow_tpu_torch.runtime.manager import Manager
        from kubeflow_tpu_torch.testing.fakekube import FakeKube
        from kubeflow_tpu_torch.testing.podsim import PodSimulator
        from kubeflow_tpu_torch.webhooks import register_all

        self.loop = asyncio.new_event_loop()
        self.kube = FakeKube()
        register_all(self.kube)
        self.mgr = Manager(self.kube)
        setup_notebook_controller(self.mgr)
        for setup in extra_controllers:
            setup(self.mgr)
        self.sim = PodSimulator(self.kube)
        self._create_app = create_app
        self.user = dict(user or USER_HEADERS)
        self.client: TestClient | None = None
        self.browser = Browser(self._http)

    # -- lifecycle ---------------------------------------------------------------

    def __enter__(self) -> "JsWebHarness":
        self.loop.run_until_complete(self._astart())
        return self

    def __exit__(self, *exc) -> None:
        self.loop.run_until_complete(self._astop())
        self.loop.close()

    async def _astart(self) -> None:
        await self.mgr.start()
        await self.sim.start()
        self.client = TestClient(
            TestServer(self._create_app(self.kube)),
            cookie_jar=aiohttp.DummyCookieJar(),  # the Browser owns cookies
        )
        await self.client.start_server()

    async def _astop(self) -> None:
        if self.client is not None:
            await self.client.close()
        await self.sim.stop()
        await self.mgr.stop()
        self.kube.close_watches()

    # -- the Browser's transport -------------------------------------------------

    def _http(self, method, path, headers, body):
        return self.loop.run_until_complete(
            self._arequest(method, path, headers, body))

    async def _arequest(self, method, path, headers, body):
        send = {**self.user, **headers}
        resp = await self.client.request(
            method, path, headers=send, data=body)
        text = await resp.text()
        header_pairs = []
        for key in resp.headers:
            for value in resp.headers.getall(key):
                header_pairs.append((key, value))
        await resp.release()
        return resp.status, resp.reason or "", header_pairs, text

    # -- control-plane helpers ---------------------------------------------------

    def settle(self, rounds: int = 6) -> None:
        async def go():
            for _ in range(rounds):
                await self.mgr.wait_idle(timeout=20)
                await asyncio.sleep(0.02)
        self.loop.run_until_complete(go())

    def kube_get(self, kind, name, ns=None):
        return self.loop.run_until_complete(
            self.kube.get_or_none(kind, name, ns))

    def kube_list(self, kind, ns=None):
        return self.loop.run_until_complete(self.kube.list(kind, ns))

    def kube_create(self, kind, obj):
        return self.loop.run_until_complete(self.kube.create(kind, obj))

    def kube_patch(self, kind, name, patch, ns=None):
        return self.loop.run_until_complete(
            self.kube.patch(kind, name, patch, ns))

    def poll_ui(self, ms_per_round: int = 5000, rounds: int = 2) -> None:
        """Settle the control plane and step the UI's pollers."""
        for _ in range(rounds):
            self.settle()
            self.browser.advance(ms_per_round)
