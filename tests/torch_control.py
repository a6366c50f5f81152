"""The notebook control plane's harness for the port's tests: the fake
apiserver, the admission chain, the manager with the notebook controller
and the kubelet simulator, built from either package — the reference's
(``kubeflow_tpu``) or the port's (``kubeflow_tpu_torch``) — as
tests/test_notebook_controller.py builds the reference's. On request it
also builds the package's fleet scheduler (shared by every controller),
the InferenceService controller and the culler, as tests/test_serving.py
and tests/test_culling.py build the reference's.

Each package keeps its own metric registry and tracer, so the tests
compare children and status, never metric names or trace ids.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "kubeflow_tpu_torch"
REFERENCE = "kubeflow_tpu"
WORKER_TIMEOUT = 120


def ported(name: str) -> dict:
    """The namespace of the reference's test module ``tests/<name>``, run
    with every ``kubeflow_tpu`` module it names read from
    ``kubeflow_tpu_torch``: its imports, the dotted names it passes to
    ``__import__`` / ``importlib`` and the package directory it reads
    files from. Its cases, unchanged, on the port."""
    import re

    path = os.path.join(REPO, "tests", name)
    with open(path) as f:
        src = f.read()
    src, n = re.subn(r"\bkubeflow_tpu(?=\.|[\"'])", "kubeflow_tpu_torch", src)
    assert n and "kubeflow_tpu." not in src.replace("kubeflow_tpu_torch.", "")
    namespace = {"__name__": f"ported_{name[:-3]}", "__file__": path}
    exec(compile(src, path, "exec"), namespace)
    return namespace


def run_case(fn, **fixtures) -> None:
    """Run a test function of a ``ported`` module with the fixtures it
    names (async ones on a fresh event loop)."""
    import inspect

    params = inspect.signature(fn).parameters
    kwargs = {name: fixtures[name] for name in params}
    if inspect.iscoroutinefunction(fn):
        asyncio.run(fn(**kwargs))
    else:
        fn(**kwargs)


def fixtures_of(request, fn) -> dict:
    """The pytest fixtures a ``ported`` case names, by name."""
    import inspect

    return {name: request.getfixturevalue(name)
            for name in inspect.signature(fn).parameters}


@contextlib.contextmanager
def spa(create_app, *, extra_controllers=()):
    """The port's ``JsWebHarness`` over one web app, its page loaded in
    namespace ``team``, as the reference's frontend fixtures load it."""
    from kubeflow_tpu_torch.testing.jsweb import JsWebHarness

    with JsWebHarness(create_app, extra_controllers=extra_controllers) as h:
        h.browser.local_storage["kubeflow.namespace"] = "team"
        h.browser.load("/")
        yield h


def clear_kftpu_env(monkeypatch) -> None:
    """``NotebookOptions``, the migration switch and the admission chain
    read ``KFTPU_*`` at construction: clear them, so that both packages'
    harnesses run the defaults."""
    for key in list(os.environ):
        if key.startswith("KFTPU_"):
            monkeypatch.delenv(key)


def modules(pkg: str = PORT) -> SimpleNamespace:
    def load(name):
        return importlib.import_module(f"{pkg}.{name}")

    scheduler = load("scheduler")
    return SimpleNamespace(
        nbapi=load("api.notebook"), controller=load("controllers.notebook"),
        manager=load("runtime.manager"), metrics=load("runtime.metrics"),
        fakekube=load("testing.fakekube"), podsim=load("testing.podsim"),
        webhooks=load("webhooks"), isvcapi=load("api.inferenceservice"),
        culling=load("controllers.culling"),
        serving=load("serving.controller"),
        autoscaler=load("serving.autoscaler"), scheduler=scheduler,
        FleetScheduler=getattr(scheduler, "GpuFleetScheduler", None)
        or scheduler.TpuFleetScheduler,
        migration=load("migration.protocol"),
        objects=load("runtime.objects"), errors=load("runtime.errors"))


class Harness:
    def __init__(self, pkg, kube, mgr, sim):
        self.pkg = pkg
        self.m = modules(pkg)
        self.kube = kube
        self.mgr = mgr
        self.sim = sim

    async def settle(self, rounds: int = 6) -> None:
        # Let podsim + controller exchange a few rounds of events.
        for _ in range(rounds):
            await self.mgr.wait_idle(timeout=20)
            await asyncio.sleep(0.02)
        await self.mgr.wait_idle(timeout=20)

    async def stop(self) -> None:
        await self.sim.stop()
        await self.mgr.stop()
        self.kube.close_watches()

    async def pod_env(self, name: str, ns: str = "ns") -> dict:
        """The server container's env of a pod, after admission."""
        pod = await self.kube.get("Pod", name, ns)
        return {e["name"]: e.get("value")
                for e in pod["spec"]["containers"][0]["env"]}

    async def annotations(self, name: str, ns: str = "ns",
                          kind: str = "Notebook") -> dict:
        nb = await self.kube.get(kind, name, ns)
        return nb["metadata"].get("annotations") or {}

    async def stamp_load(self, rate: float, *, fresh: bool = True,
                         name: str = "svc", ns: str = "user") -> None:
        """What the serving gateway stamps on an InferenceService: the
        observed rate and the last request's time (an hour ago where
        ``fresh`` is false)."""
        isvcapi = self.m.isvcapi
        await self.kube.patch("InferenceService", name, {"metadata": {
            "annotations": {
                isvcapi.OBSERVED_RATE_ANNOTATION: str(rate),
                isvcapi.LAST_REQUEST_AT_ANNOTATION: self.m.objects.fmt_iso(
                    time.time() if fresh else time.time() - 3600)}}}, ns)

    def replica_admitted(self, i: int, name: str = "svc",
                         ns: str = "user") -> bool:
        return self.m.isvcapi.replica_key(ns, name, i) in \
            self.sched.policy.ledger.allocations

    async def until(self, predicate, what: str, timeout: float = 15.0):
        """Wait for a plain (not awaitable) predicate."""
        async def check():
            return predicate()

        return await self.wait_for(check, what, timeout)

    async def wait_for(self, predicate, what: str, timeout: float = 15.0):
        deadline = asyncio.get_running_loop().time() + timeout
        while True:
            value = await predicate()
            if value:
                return value
            assert asyncio.get_running_loop().time() < deadline, \
                f"timed out: {what}"
            await asyncio.sleep(0.01)


async def make_harness(pkg: str = PORT, *, sim_kwargs=None, wire=None,
                       fleet: str | None = None, scheduler=None,
                       serving=None, culling=None, **opts) -> Harness:
    """``wire(kube, mgr)`` returns the keyword arguments of
    ``setup_notebook_controller`` (a scheduler, a warm pool); without it
    the setup reads them from ``KFTPU_*`` as the reference's manager
    does. ``fleet`` (a fleet spec) builds the package's fleet scheduler
    with ``SchedulerOptions(**scheduler)`` instead, as ``h.sched``.
    ``serving`` (``ServingOptions`` keyword arguments) adds the
    InferenceService controller on the same scheduler, as
    ``h.serving``; ``culling`` (``prober``, ``options`` and an optional
    ``clock``) adds the culler, as ``h.culler``."""
    m = modules(pkg)
    kube = m.fakekube.FakeKube()
    m.webhooks.register_all(kube)
    mgr = m.manager.Manager(kube, registry=m.metrics.Registry())
    wired = wire(kube, mgr) if wire is not None else {}
    if fleet is not None:
        wired["scheduler"] = m.FleetScheduler(
            kube, m.scheduler.SchedulerOptions(**(scheduler or {})),
            fleet=m.scheduler.Fleet.parse(fleet), registry=mgr.registry)
    rec = m.controller.setup_notebook_controller(
        mgr, m.controller.NotebookOptions(**opts), **wired)
    serving_rec = None
    if serving is not None:
        serving_rec = m.serving.setup_serving_controller(
            mgr, m.serving.ServingOptions(**serving),
            scheduler=wired.get("scheduler"))
    culler = None
    if culling is not None:
        culler = m.culling.setup_culling_controller(
            mgr, culling["prober"],
            m.culling.CullingOptions(**culling.get("options", {})),
            clock=culling.get("clock", time.time))
    sim = m.podsim.PodSimulator(kube, **(sim_kwargs or {}))
    await mgr.start()
    await sim.start()
    h = Harness(pkg, kube, mgr, sim)
    h.rec, h.sched = rec, wired.get("scheduler")
    h.serving, h.culler = serving_rec, culler
    return h


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def facade_port():
    """Hold the fake apiserver's fixed address (``chip_smoke.Entrypoints``
    serves it on 127.0.0.1:8001, where the entry points' ``HttpKube``
    looks) for the block. Test files that serve it may run at once on
    separate workers, so they take turns on a lock file."""
    import fcntl
    import tempfile

    path = os.path.join(tempfile.gettempdir(),
                        "kubeflow-tpu-torch-facade-8001.lock")
    with open(path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def run_workers(pod_envs: list, **overrides) -> list:
    """Run ``kubeflow_tpu_torch.testing.distributed_worker`` once per pod,
    each under that pod's env as admission rendered it, with
    ``overrides`` on top; return each worker's stdout. Every worker is
    reaped even when an early one fails (a dead rank 0 leaves the rest in
    the collective until the timeout)."""
    procs = []
    for pod_env in pod_envs:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PET_", "TPU_", "JAX_", "MEGASCALE_",
                                    "KFTPU_"))
               and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                             "MASTER_ADDR", "MASTER_PORT")}
        env.update({k: v for k, v in pod_env.items() if v is not None})
        env.update(overrides)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "kubeflow_tpu_torch.testing.distributed_worker"],
            env=env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs
