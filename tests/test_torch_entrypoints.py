"""The port's entry points: the env contract of ``cmd/envconfig.py`` (the
cases of tests/test_entrypoints.py that do not build a web app, on the
port), the controller manager's ``build_manager_app`` routes that
tests/test_tracing.py, tests/test_slo.py and
tests/test_scheduler_integration.py drive on the reference (the
``/debug/*`` surface, the scheduler's in cards), and both entry points as
processes: ``python -m kubeflow_tpu_torch.cmd.controller_manager`` and
``python -m kubeflow_tpu_torch.cmd.webhook`` (over TLS) against the fake
apiserver that ``chip_smoke.py`` serves over HTTP; and the web apps'
entry point: tests/test_entrypoints.py's ``build_app`` cases on the port,
and ``python -m kubeflow_tpu_torch.cmd.webapp`` as a process spawning a
GPU notebook through the webhook process.
"""

import asyncio
import contextlib
import importlib.util
import signal
import time
from pathlib import Path

import pytest
from aiohttp.test_utils import TestClient, TestServer

from torch_control import (PORT, clear_kftpu_env, facade_port, free_port,
                           make_harness, ported, run_case)

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.api import tensorboard as tbapi
from kubeflow_tpu_torch.cmd import envconfig
from kubeflow_tpu_torch.cmd.controller_manager import build_manager_app
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime import timeline as timeline_mod
from kubeflow_tpu_torch.runtime.objects import annotations_of
from kubeflow_tpu_torch.webhooks.jsonpatch import apply

REPO = Path(__file__).resolve().parents[1]
GPU = "nvidia-h100-80gb"
FLEET = f"pool-a={GPU}:1x8:1"
PROCESS_TIMEOUT = 60


# ---- envconfig (tests/test_entrypoints.py, on the port) ---------------------


def test_envconfig_builds_every_options_block(monkeypatch):
    monkeypatch.setenv("USE_ISTIO", "true")
    monkeypatch.setenv("POD_NAMESPACE", "custom-ns")
    monkeypatch.setenv("TRUSTED_CA_BUNDLE_CONFIGMAP", "corp-ca")
    monkeypatch.setenv("PIPELINE_ACCESS_ROLE", "")
    monkeypatch.setenv("CULL_IDLE_TIME", "60")

    nb = envconfig.notebook_options()
    assert nb.use_istio is True
    assert nb.controller_namespace == "custom-ns"
    assert nb.trusted_ca_configmap == "corp-ca"
    assert nb.pipeline_access_role is None  # empty string disables

    cull = envconfig.culling_options()
    assert cull.cull_idle_seconds == 3600.0

    prof = envconfig.profile_options()
    assert prof.use_istio is True


def test_notebook_options_env_round3(monkeypatch):
    monkeypatch.setenv("MAINTENANCE_TAINTS", "x.io/drain, y.io/maint")
    monkeypatch.setenv("ENABLE_QUEUED_PROVISIONING", "false")
    opts = envconfig.notebook_options()
    assert opts.maintenance_taints == ("x.io/drain", "y.io/maint")
    assert opts.enable_queued_provisioning is False

    monkeypatch.setenv("MAINTENANCE_TAINTS", "")
    assert envconfig.notebook_options().maintenance_taints == ()


def test_serving_engine_options_env_knobs(monkeypatch):
    clear_kftpu_env(monkeypatch)
    opts = envconfig.serving_engine_options()
    assert opts.kv_blocks is None          # auto-sized from the model
    assert opts.kv_block_size == 16
    assert opts.prefill_chunk == 32
    assert opts.chunked_prefill is True
    assert opts.max_resident_models == 2
    assert envconfig.serving_options().slo_autoscale is True

    monkeypatch.setenv("KFTPU_SERVING_KV_BLOCKS", "128")
    monkeypatch.setenv("KFTPU_SERVING_KV_BLOCK_SIZE", "8")
    monkeypatch.setenv("KFTPU_SERVING_PREFILL_CHUNK", "64")
    monkeypatch.setenv("KFTPU_SERVING_CHUNKED_PREFILL", "false")
    monkeypatch.setenv("KFTPU_SERVING_MAX_MODELS", "4")
    monkeypatch.setenv("KFTPU_SERVING_SLO_AUTOSCALE", "false")
    opts = envconfig.serving_engine_options()
    assert opts.kv_blocks == 128
    assert opts.kv_block_size == 8
    assert opts.prefill_chunk == 64
    assert opts.chunked_prefill is False
    assert opts.max_resident_models == 4
    assert envconfig.serving_options().slo_autoscale is False


def test_the_rest_of_the_env_contract_reads_as_the_references(monkeypatch):
    """The blocks the port's envconfig gained with the entry points read
    the same env into the same values as the reference's."""
    from dataclasses import asdict

    reference = importlib.import_module("kubeflow_tpu.cmd.envconfig")
    clear_kftpu_env(monkeypatch)
    for key, value in {
            "USE_ISTIO": "true", "CLUSTER_DOMAIN": "corp.local",
            "TENSORBOARD_IMAGE": "example/tensorboard:torch",
            "RWO_PVC_SCHEDULING": "false",
            "TENSORBOARD_GCP_CREDS_SECRET": "user-gcp-sa",
            "USERID_HEADER": "x-user", "USERID_PREFIX": "acct:",
            "KFTPU_SHARDS": "4", "KFTPU_SHARD_REPLICA": "2",
            "KFTPU_SHARD_REPLICAS": "3", "POD_NAMESPACE": "ctl"}.items():
        monkeypatch.setenv(key, value)
    for block in ("notebook_options", "profile_options",
                  "tensorboard_options", "pvcviewer_options"):
        assert asdict(getattr(envconfig, block)()) == \
            asdict(getattr(reference, block)()), block
    assert envconfig.shard_ring_config() == reference.shard_ring_config() \
        == (4, 2, 3, 0)
    assert envconfig.controller_namespace() == "ctl"
    tb = envconfig.tensorboard_options()
    assert (tb.image, tb.rwo_pvc_scheduling, tb.gcp_creds_secret) == (
        "example/tensorboard:torch", False, "user-gcp-sa")


# ---- the manager's /debug surface -------------------------------------------


async def _client(mgr) -> TestClient:
    client = TestClient(TestServer(build_manager_app(mgr)))
    await client.start_server()
    return client


async def _scheduler_harness(monkeypatch, **kw):
    clear_kftpu_env(monkeypatch)
    return await make_harness(PORT, fleet=FLEET, scheduler=dict(
        queued_requeue_seconds=0.05, enable_migration=True,
        drain_grace_seconds=1.0), **kw)


async def test_debug_endpoints_on_manager_app(monkeypatch):
    """GET /healthz, /readyz, /debug/traces|queue|informers on the
    manager's app (tests/test_tracing.py's case)."""
    clear_kftpu_env(monkeypatch)
    h = await make_harness(PORT, wire=lambda kube, mgr: {
        "scheduler": None, "warmpool": None})
    try:
        await h.kube.create("Notebook", nbapi.new("nb", "team"))
        await h.settle()
        client = await _client(h.mgr)
        try:
            for probe in ("/healthz", "/readyz"):
                resp = await client.get(probe)
                assert resp.status == 200 and (await resp.json()) == {
                    "status": "ok"}
            resp = await client.get("/debug/traces", params={"key": "team/nb"})
            assert resp.status == 200
            traces = (await resp.json())["traces"]
            assert traces and traces[0]["key"] == "team/nb"
            assert any(s["name"] == "queue_wait" for s in traces[-1]["spans"])

            queues = (await (await client.get("/debug/queue")).json())["queues"]
            q = queues["notebook"]
            assert q["depth"] == 0 and q["in_flight"] == []
            assert "backoff_keys" in q and "oldest_wait_sec" in q

            informers = (await (await client.get(
                "/debug/informers")).json())["informers"]
            assert informers["Notebook"]["synced"] is True
            assert informers["Notebook"]["objects"] == 1
            pod_indexes = informers["Pod"]["indexes"]
            assert {"values", "hits", "misses"} <= set(
                pod_indexes["notebook-name"])

            # No scheduler or warm pool wired: no such routes.
            for path in ("/debug/scheduler", "/debug/warmpool"):
                assert (await client.get(path)).status == 404
            assert (await client.get("/debug/telemetry")).status == 200
        finally:
            await client.close()
    finally:
        await h.stop()


async def test_requeue_route_releases_only_quarantined_keys(monkeypatch):
    clear_kftpu_env(monkeypatch)
    h = await make_harness(PORT, wire=lambda kube, mgr: {
        "scheduler": None, "warmpool": None})
    try:
        client = await _client(h.mgr)
        try:
            resp = await client.post("/debug/queue/requeue")
            assert resp.status == 400
            resp = await client.post("/debug/queue/requeue", json=[1])
            assert resp.status == 400
            resp = await client.post("/debug/queue/requeue", params={
                "controller": "notebook", "namespace": "ns", "name": "x"})
            assert resp.status == 404
            assert (await resp.json()) == {
                "released": False, "controller": "notebook", "key": "ns/x"}
        finally:
            await client.close()
    finally:
        await h.stop()


async def test_debug_scheduler_endpoint_in_cards(monkeypatch):
    """tests/test_scheduler_integration.py's case on a one-node H100 fleet:
    the pool, the admitted gang, the queue and each namespace's cards."""
    h = await _scheduler_harness(monkeypatch)
    try:
        for name in ("holder", "waiter"):
            await h.kube.create("Notebook", nbapi.new(
                name, "ns", accelerator=GPU, topology="1x8"))
            await h.settle()
        client = await _client(h.mgr)
        try:
            resp = await client.get("/debug/scheduler")
            assert resp.status == 200
            info = (await resp.json())["scheduler"]
            assert info["active"] is True
            assert info["violations"] == 0
            assert info["pools"][0]["name"] == "pool-a"
            assert info["pools"][0]["free_slices"] == 0
            assert [a["key"] for a in info["admitted"]] == [["ns", "holder"]]
            assert info["queue"][0]["key"] == ["ns", "waiter"]
            assert info["queue"][0]["position"] == 1
            assert info["ns_chips"] == {"ns": 8}
        finally:
            await client.close()
    finally:
        await h.stop()


async def test_lifecycle_timeline_and_slo_routes(monkeypatch):
    """tests/test_slo.py's routes: /debug/slo, /debug/timeline/<ns>/<name>
    and the burn gauges on /metrics, after a queued gang's way to Ready."""
    h = await _scheduler_harness(monkeypatch)
    try:
        await h.kube.create("Notebook", nbapi.new(
            "holder", "ns", accelerator=GPU, topology="1x8"))
        await h.settle()
        await h.kube.create("Notebook", nbapi.new(
            "waiter", "ns2", accelerator=GPU, topology="1x8"))
        await h.settle()
        await h.kube.patch("Notebook", "holder", {"metadata": {"annotations": {
            nbapi.STOP_ANNOTATION: "2030-01-01T00:00:00Z"}}}, "ns")

        async def waiter_ready():
            nb = await h.kube.get("Notebook", "waiter", "ns2")
            return timeline_mod.decode(annotations_of(nb))[-1]["state"] \
                == "Ready"

        await h.wait_for(waiter_ready, "the waiter Ready", timeout=20)
        await h.settle()
        holder = await h.kube.get("Notebook", "holder", "ns")
        hstates = [e["state"] for e in timeline_mod.decode(
            annotations_of(holder))]
        assert hstates[-1] == "Stopped"
        client = await _client(h.mgr)
        try:
            resp = await client.get("/debug/slo")
            assert resp.status == 200
            info = (await resp.json())["slo"]
            assert info["enabled"] is True
            assert {s["sli"] for s in info["slis"]} == {
                s[0] for s in slo.SLI_SPECS}
            rec = next(s for s in info["slis"]
                       if s["sli"] == "reconcile_latency")
            assert rec["windows"]["5m"]["good"] > 0

            resp = await client.get("/debug/timeline/ns/holder")
            assert resp.status == 200
            body = await resp.json()
            assert [e["state"] for e in body["timeline"]] == hstates
            resp = await client.get("/debug/timeline/ns/nosuch")
            assert resp.status == 404

            text = await (await client.get("/metrics")).text()
            assert "tpu_slo_burn_rate" in text
            assert "tpu_slo_budget_remaining" in text
        finally:
            await client.close()
    finally:
        await h.stop()


async def test_scheduler_explain_route(monkeypatch):
    h = await _scheduler_harness(monkeypatch)
    try:
        await h.kube.create("Notebook", nbapi.new(
            "holder", "ns", accelerator=GPU, topology="1x8"))
        await h.settle()
        await h.kube.create("Notebook", nbapi.new(
            "waiter", "ns2", accelerator=GPU, topology="1x8"))
        await h.settle()
        client = await _client(h.mgr)
        try:
            resp = await client.get("/debug/scheduler/explain/ns2/waiter")
            assert resp.status == 200
            explain = (await resp.json())["explain"]
            assert explain["state"] == "Queued"
            assert explain["position"] == 1
            assert explain["blocking_shape"] == f"{GPU}:1x8"
            assert explain["fits_now"] is False
            assert isinstance(explain["timeline"], list)
            resp = await client.get("/debug/scheduler/explain/ns/holder")
            assert (await resp.json())["explain"]["state"] == "Admitted"
            resp = await client.get("/debug/scheduler/explain/nx/ghost")
            assert resp.status == 404
        finally:
            await client.close()
    finally:
        await h.stop()


async def test_warmpool_route_when_pools_are_wired(monkeypatch):
    """/debug/warmpool: each pool's target, slots and ready pods."""
    from kubeflow_tpu_torch.controllers.warmpool import (
        WarmPoolManager, WarmPoolOptions)

    clear_kftpu_env(monkeypatch)
    pools = {}

    def wire(kube, mgr):
        pools["wp"] = WarmPoolManager(kube, WarmPoolOptions(
            spec=f"ns/img:1@{GPU}:1x1:1", replenish_seconds=0.05),
            registry=mgr.registry)
        return {"scheduler": None, "warmpool": pools["wp"]}

    h = await make_harness(PORT, wire=wire)
    try:
        client = await _client(h.mgr)
        try:
            async def ready():
                resp = await client.get("/debug/warmpool")
                info = (await resp.json())["warmpool"]
                return resp.status == 200 and info["pools"] and \
                    info["pools"][0]["ready"] == 1 and info

            info = await h.wait_for(ready, "a ready warm pod")
            assert info["pools"][0]["target"] == 1
            assert info["pools"][0]["shape"] == f"{GPU}:1x1"
        finally:
            await client.close()
    finally:
        pools["wp"].stop()
        await h.stop()


# ---- both entry points as processes -----------------------------------------


def _chip_smoke():
    """``chip_smoke.py`` as a module: it imports torch only inside main."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@contextlib.contextmanager
def _deadline(seconds: float):
    def expire(*_):
        raise TimeoutError(f"the entry points took over {seconds} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def test_both_entry_points_run_as_processes_on_the_facade(tmp_path):
    """The manager process brings a CPU notebook to Running and a
    Tensorboard to Ready through HttpKube; the webhook process, over TLS,
    patches that notebook's pod exactly as the in-process chain did."""
    from kubeflow_tpu_torch.sdk import TELEMETRY_LOGDIR_ENV

    smoke = _chip_smoke()
    with facade_port(), _deadline(PROCESS_TIMEOUT):
        started = time.monotonic()
        ep = smoke.Entrypoints(str(tmp_path), fleet="")
        try:
            kube, call = ep.facade.kube, ep.facade.call
            synced = ep.wait_synced()
            assert synced["readyz"] <= synced["synced"]
            assert {"Notebook", "Tensorboard", "PVCViewer", "Profile",
                    "StatefulSet", "Deployment"} <= set(synced["kinds"])
            call(smoke.entry_objects(kube))
            call(kube.create("Notebook", smoke.entry_notebook("nb", None)))
            pod = call(ep.facade.wait_for(
                lambda: smoke.running_pod(kube, "nb-0"), "nb-0 running"))
            call(kube.create("Tensorboard", tbapi.new(
                "tb", "ns", "pvc://logs/run1", profiler=True)))
            status = call(ep.facade.wait_for(
                lambda: smoke.tensorboard_ready(kube, "tb"), "tb ready"))
            command = call(kube.get("Deployment", "tb", "ns"))["spec"][
                "template"]["spec"]["containers"][0]["command"]

            wire_pod = smoke.pod_from_template(
                call(kube.get("StatefulSet", "nb", "ns")), "nb-0")
            code, answer, _ = ep.review(
                "/apply-poddefault", smoke.admission_review(wire_pod, "pod"))
            patched = apply(wire_pod, smoke.decoded_patch(answer))
            requests = dict(ep.facade.requests)
        finally:
            ended = ep.stop()
    assert time.monotonic() - started < PROCESS_TIMEOUT
    assert status["readyReplicas"] == 1
    assert "--logdir=/tensorboard_logs/run1" in command
    assert "--reload_multifile=true" in command
    assert code == 200 and answer["response"]["allowed"] is True
    assert smoke.container_env(patched) == smoke.container_env(pod)
    assert {"name": TELEMETRY_LOGDIR_ENV, "value": "/home/jovyan/logs/run1"} \
        in smoke.container_env(patched)
    assert requests["watch"] > 0 and requests["list"] > 0
    assert set(ended) == {"manager", "webhook"}
    for how in ended.values():
        assert how["ran_until_stopped"] and how["stopped_by_sigterm"], ended


def test_the_webhook_refuses_plaintext_without_a_cert(tmp_path):
    """No cert and no ALLOW_INSECURE_HTTP: the entry point exits before it
    serves anything."""
    import os
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k not in ("ALLOW_INSECURE_HTTP", "TLS_CERT_FILE")}
    env["TLS_CERT_FILE"] = str(tmp_path / "missing.crt")
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.cmd.webhook"], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=PROCESS_TIMEOUT)
    assert out.returncode != 0
    assert "refusing to serve the admission webhook over plaintext" in \
        out.stderr


def test_the_facade_names_a_port_in_use():
    import socket

    smoke = _chip_smoke()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        s.listen()
        port = s.getsockname()[1]
        try:
            smoke.ApiFacade(port=port)
        except AssertionError as e:
            assert f"127.0.0.1:{port}" in str(e)
        else:
            raise AssertionError("the facade started on a port in use")


async def test_the_facade_serves_the_rest_conventions():
    """HttpKube's verbs through the facade: a grouped and a core kind,
    namespaced and cluster-scoped, the status subresource, a 404 and a
    watch that resumes from a list's version without losing a delete."""
    from kubeflow_tpu_torch.runtime.errors import NotFound
    from kubeflow_tpu_torch.runtime.httpclient import HttpKube

    smoke = _chip_smoke()
    port = free_port()
    facade = await asyncio.to_thread(smoke.ApiFacade, port=port)
    kube = HttpKube(base_url=f"http://127.0.0.1:{port}")
    try:
        await kube.create("ConfigMap", {"metadata": {"name": "a",
                                                     "namespace": "ns"}})
        items, rv = await kube.list_with_rv("ConfigMap", "ns")
        assert [i["metadata"]["name"] for i in items] == ["a"]
        await kube.create("ConfigMap", {"metadata": {"name": "b",
                                                     "namespace": "ns"}})
        await kube.delete("ConfigMap", "a", "ns")
        seen = []

        async def watch():
            async for event, obj in kube.watch(
                    "ConfigMap", "ns", send_initial=False,
                    resource_version=rv):
                seen.append((event, obj["metadata"]["name"]))
                if len(seen) == 3:
                    return

        watching = asyncio.create_task(watch())
        await asyncio.sleep(0.05)
        await kube.patch("ConfigMap", "b", {"data": {"k": "v"}}, "ns")
        await asyncio.wait_for(watching, 10)
        assert seen == [("ADDED", "b"), ("DELETED", "a"), ("MODIFIED", "b")]

        await kube.create("Profile", {"metadata": {"name": "team"},
                                      "spec": {"owner": {
                                          "kind": "User",
                                          "name": "a@example.com"}}})
        await kube.patch("Profile", "team", {"status": {"phase": "Ready"}},
                         subresource="status")
        assert (await kube.get("Profile", "team"))["status"] == {
            "phase": "Ready"}
        try:
            await kube.get("Notebook", "nope", "ns")
        except NotFound:
            pass
        else:
            raise AssertionError("a missing object was found")
    finally:
        await kube.close()
        await asyncio.to_thread(facade.close)


# ---- the web-app entry point (tests/test_entrypoints.py, on the port) --------

REFERENCE_ENTRYPOINTS = ported("test_entrypoints.py")


@pytest.mark.parametrize("which", ["jupyter", "volumes", "tensorboards",
                                   "kfam", "dashboard", "all"])
def test_webapp_builds_and_serves(which, monkeypatch):
    run_case(REFERENCE_ENTRYPOINTS["test_webapp_builds_and_serves"],
             which=which, monkeypatch=monkeypatch)


def test_build_app_rejects_unknown_flavor():
    run_case(REFERENCE_ENTRYPOINTS["test_build_app_rejects_unknown_flavor"])


def test_an_unknown_webapp_exits_with_the_references_message():
    import os
    import subprocess
    import sys

    env = {**os.environ, "WEBAPP": "nope"}
    out = subprocess.run(
        [sys.executable, "-m", "kubeflow_tpu_torch.cmd.webapp"], env=env,
        cwd=REPO, capture_output=True, text=True, timeout=PROCESS_TIMEOUT)
    assert out.returncode != 0
    assert ("unknown WEBAPP 'nope'; options: ['dashboard', 'jupyter', "
            "'kfam', 'tensorboards', 'volumes'] or all") in out.stderr


def test_the_webapp_process_spawns_through_the_webhook_process(tmp_path):
    """``cmd.webapp`` (WEBAPP=all) against the facade, with the manager
    and the webhook as processes and every admission sent to the webhook:
    /healthz, the JWA's /api/gpus, a CSRF-less POST refused, the form's
    1x1 notebook Running and listed ready, the card panel, and a 2x8 form
    refused with the webhook's quota message."""
    from kubeflow_tpu_torch.api import profile as profileapi

    smoke = _chip_smoke()
    with facade_port(), _deadline(PROCESS_TIMEOUT):
        ep = smoke.Entrypoints(str(tmp_path), fleet=FLEET,
                               nodes=(smoke.ENTRY_NODE,),
                               webhook_admission=True)
        web = None
        try:
            port = free_port()
            web = smoke.EntryProcess("kubeflow_tpu_torch.cmd.webapp", {
                "WEBAPP": "all", "PORT": str(port),
                "APP_SECURE_COOKIES": "false"})
            client = smoke.WebClient(web, f"http://127.0.0.1:{port}",
                                     smoke.WEB_USER)
            kube, call = ep.facade.kube, ep.facade.call
            ep.wait_synced()
            smoke._until_up(web, f"{client.base}/healthz")
            call(kube.create("Profile", profileapi.new(
                "ns", smoke.WEB_USER, gpu_quota=8)))
            gpus = client.get("/jupyter/api/gpus")["gpus"]
            nb_list = "/jupyter/api/namespaces/ns/notebooks"
            no_token = smoke.WebClient(web, client.base, smoke.WEB_USER)
            csrf_status, _ = no_token.request(
                "POST", nb_list, smoke._web_form("x", "1x1"))
            client.post(nb_list, smoke._web_form("nb", "1x1"))
            row = client.until(nb_list, lambda body: next(
                (r for r in body["notebooks"]
                 if r["status"]["phase"] == "ready"), None), "nb ready")
            usage = client.get("/dashboard/api/namespaces/ns/gpu-usage")
            refused_status, refused = client.request(
                "POST", nb_list, smoke._web_form("big", "2x8"))
            admissions = list(ep.facade.admissions)
        finally:
            ended = {"webapp": web.stop()} if web is not None else {}
            ended.update(ep.stop())
    assert [t["topology"] for t in next(
        g for g in gpus if g["accelerator"] == GPU)["topologies"]][0] == "1x1"
    assert csrf_status == 403
    assert row["name"] == "nb" and row["status"]["message"] == "Running"
    assert row["gpu"] == {"accelerator": GPU, "topology": "1x1"}
    assert (usage["chipsRequested"], usage["chipsQuota"]) == (1, 8)
    assert refused_status == 422 and "gpuQuota" in refused["log"]
    outcomes = {(kind, allowed) for kind, _, allowed, _ in admissions}
    assert {("Notebook", True), ("Pod", True), ("Notebook", False)} <= outcomes
    assert set(ended) == {"webapp", "manager", "webhook"}
    for how in ended.values():
        assert how["ran_until_stopped"] and how["stopped_by_sigterm"], ended


async def test_the_devserver_seeds_a_notebook_on_an_h100_node(monkeypatch):
    from kubeflow_tpu_torch.cmd.devserver import seed
    from kubeflow_tpu_torch.testing.fakekube import FakeKube
    from kubeflow_tpu_torch.webhooks import register_all

    monkeypatch.setenv("DEV_DEFAULT_USER", "dev@example.com")
    kube = FakeKube()
    register_all(kube)
    await seed(kube)
    nb = await kube.get("Notebook", "demo-h100", "dev")
    assert nb["spec"]["gpu"] == {"accelerator": GPU, "topology": "1x8"}
    assert (await kube.get("Notebook", "demo-cpu", "dev"))["spec"].get(
        "gpu") is None
    assert (await kube.get("Profile", "dev"))["spec"]["owner"]["name"] == \
        "dev@example.com"
