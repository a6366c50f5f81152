"""The port's dashboard and KFAM against the reference's: every case of
tests/test_kfam_dashboard.py and tests/test_dashboard_metrics.py that
names no accelerator runs again on ``kubeflow_tpu_torch``; the
accelerator cases are rewritten on ``nvidia.com/gpu``, ``gpuQuota`` and
the ``gpu_duty`` series; and both packages' ``*-usage`` routes, given the
same pods and quota in their own resource, give the same answer.
"""

import asyncio
import importlib

import pytest
from aiohttp.test_utils import TestClient, TestServer

from torch_control import PORT, REFERENCE, ported, run_case

from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.controllers.profile import setup_profile_controller
from kubeflow_tpu_torch.gpu.topology import GPU_RESOURCE
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.testing.fakekube import FakeKube
from kubeflow_tpu_torch.web.dashboard import create_app as create_dashboard
from kubeflow_tpu_torch.web.dashboard.metrics import (
    QUERIES, CloudMonitoringMetricsService, PrometheusMetricsService)
from kubeflow_tpu_torch.web.kfam import create_app as create_kfam
from kubeflow_tpu_torch.webhooks import register_all

MODULES = {name: ported(name) for name in (
    "test_kfam_dashboard.py", "test_dashboard_metrics.py")}
# The reference's cases that name the accelerator: rewritten below.
ACCELERATOR_CASES = {
    "test_dashboard_workgroup_and_tpu_usage",
    "test_prometheus_driver_parses_range_matrix",
    "test_cloud_monitoring_driver_fixture_backed"}
CASES = sorted(
    (module, name) for module, namespace in MODULES.items()
    for name, fn in namespace.items()
    if name.startswith("test_") and callable(fn)
    and name not in ACCELERATOR_CASES)
KD = MODULES["test_kfam_dashboard.py"]
ALICE, BOB = KD["ALICE"], KD["BOB"]


def test_every_reference_case_is_collected():
    assert CASES == [
        ("test_dashboard_metrics.py", "test_dashboard_metrics_route_and_factory"),
        ("test_kfam_dashboard.py", "test_dashboard_activities_and_settings"),
        ("test_kfam_dashboard.py", "test_dashboard_debug_endpoint"),
        ("test_kfam_dashboard.py", "test_kfam_profile_and_binding_lifecycle")]
    assert KD["create_dashboard"].__module__ == \
        "kubeflow_tpu_torch.web.dashboard.app"


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(module, case):
    run_case(MODULES[module][case])


# ---- the accelerator cases, on nvidia.com/gpu ---------------------------------


async def test_dashboard_workgroup_and_gpu_usage():
    kube = FakeKube()
    register_all(kube)
    clients = []
    try:
        dash = await KD["start_client"](create_dashboard(kube), clients)
        headers = await KD["csrf"](dash, "/api/dashboard-links", ALICE)
        resp = await dash.get("/api/workgroup/exists", headers=headers)
        body = await resp.json()
        assert body["hasWorkgroup"] is False and body["registrationFlowAllowed"]
        resp = await dash.post("/api/workgroup/create", json={},
                               headers=headers)
        assert resp.status == 200
        profile = await kube.get("Profile", "alice")
        assert profileapi.owner_of(profile)["name"] == "alice@example.com"

        # The card panel sums nvidia.com/gpu requests against the quota.
        await kube.create("ResourceQuota", {
            "metadata": {"name": "kf-resource-quota", "namespace": "alice"},
            "spec": {"hard": {profileapi.GPU_QUOTA_KEY: "32"}}})
        for name, resources in (("nb-0", {GPU_RESOURCE: "8"}),
                                ("cpu-0", {"cpu": "1"}),
                                ("tpu-0", {"google.com/tpu": "4"})):
            await kube.create("Pod", {
                "metadata": {"name": name, "namespace": "alice"},
                "spec": {"containers": [
                    {"name": "x", "resources": {"requests": resources}}]}})
        resp = await dash.get("/api/namespaces/alice/gpu-usage",
                              headers=headers)
        usage = await resp.json()
        assert (usage["chipsRequested"], usage["chipsQuota"]) == (8, 32)
        assert usage["pods"] == [{"pod": "nb-0", "chips": 8}]
        resp = await dash.get("/api/namespaces/alice/tpu-usage",
                              headers=headers)
        assert resp.status == 404
    finally:
        for c in clients:
            await c.close()
        kube.close_watches()


async def test_kfam_profile_carries_the_gpu_quota():
    """KFAM's create takes ``spec.gpuQuota``; the profile controller turns
    it into the namespace's ``requests.nvidia.com/gpu`` ceiling."""
    kube = FakeKube()
    register_all(kube)
    mgr = Manager(kube)
    setup_profile_controller(mgr)
    await mgr.start()
    clients = []
    try:
        kfam = await KD["start_client"](create_kfam(kube), clients)
        headers = await KD["csrf"](kfam, "/kfam/v1/bindings", ALICE)
        resp = await kfam.post("/kfam/v1/profiles", json={
            "name": "team", "user": "alice@example.com",
            "spec": {"gpuQuota": 16, "tpuQuota": 99}}, headers=headers)
        assert resp.status == 200, await resp.text()
        profile = await kube.get("Profile", "team")
        assert profile["spec"]["gpuQuota"] == 16
        assert "tpuQuota" not in profile["spec"]
        for _ in range(5):
            await mgr.wait_idle()
            await asyncio.sleep(0.02)
        quota = await kube.get("ResourceQuota", "kf-resource-quota", "team")
        assert quota["spec"]["hard"] == {profileapi.GPU_QUOTA_KEY: "16"}
    finally:
        for c in clients:
            await c.close()
        await mgr.stop()
        kube.close_watches()


DCGM_MATRIX = {"status": "success", "data": {"resultType": "matrix", "result": [
    {"metric": {"Hostname": "a3-0"},
     "values": [[1700000000, "75"], [1700000010, "80"]]},
    {"metric": {"Hostname": "a3-1"},
     "values": [[1700000000, "10"], [1700000010, "bogus"]]}]}}


async def test_prometheus_driver_reads_dcgm_utilization():
    seen = []

    async def fetch_json(params):
        seen.append(params)
        return DCGM_MATRIX

    svc = PrometheusMetricsService("http://prometheus", fetch_json=fetch_json,
                                   clock=lambda: 1700000100.0)
    points = await svc.query("gpu_duty", "Last15m")
    assert [(p.label, p.value) for p in points] == [
        ("Hostname=a3-0", 75.0), ("Hostname=a3-0", 80.0),
        ("Hostname=a3-1", 10.0)]
    assert points[0].timestamp == 1700000000
    assert seen[0]["query"] == "avg(DCGM_FI_DEV_GPU_UTIL) by (Hostname)"
    assert float(seen[0]["end"]) - float(seen[0]["start"]) == 15 * 60
    assert set(QUERIES) == {"node_cpu", "pod_cpu", "pod_mem", "gpu_duty"}
    with pytest.raises(KeyError):
        await svc.query("tpu_duty", "Last15m")


async def test_cloud_monitoring_reads_the_accelerator_duty_cycle():
    calls = []

    async def fetch_json(params):
        calls.append(params)
        return {"timeSeries": [{
            "resource": {"labels": {"node_name": "a3-0"}},
            "metric": {"labels": {}},
            "points": [{"interval": {"endTime": "2026-07-30T01:00:00Z"},
                        "value": {"doubleValue": 91.0}}]}]}

    async def fetch_token():
        return "tok", 1e12

    svc = CloudMonitoringMetricsService(
        "proj-1", cluster="cluster-a", fetch_json=fetch_json,
        fetch_token=fetch_token, clock=lambda: 1_800_000_000.0)
    points = await svc.query("gpu_duty", "Last15m")
    assert calls[0]["filter"] == (
        'metric.type="kubernetes.io/container/accelerator/duty_cycle"'
        ' AND resource.label.cluster_name="cluster-a"')
    assert [(p.label, p.value) for p in points] == [("node_name=a3-0", 91.0)]
    with pytest.raises(KeyError):
        await svc.query("tpu_duty", "Last15m")


async def test_dashboard_metrics_route_serves_gpu_duty():
    async def fetch_json(params):
        return DCGM_MATRIX

    svc = PrometheusMetricsService("http://prometheus", fetch_json=fetch_json)
    dash = TestClient(TestServer(create_dashboard(
        FakeKube(), metrics_service=svc)))
    await dash.start_server()
    try:
        resp = await dash.get("/api/metrics?type=gpu_duty&interval=Last5m",
                              headers=ALICE)
        body = await resp.json()
        assert resp.status == 200 and body["type"] == "gpu_duty"
        assert [p["value"] for p in body["points"]] == [75.0, 80.0, 10.0]
        resp = await dash.get("/api/metrics?type=tpu_duty", headers=ALICE)
        assert resp.status == 422
    finally:
        await dash.close()


# ---- parity: the same pods to both packages ----------------------------------

USAGE_CASES = {
    "one_notebook": ([("nb-0", [8])], 32),
    "several_containers": ([("a-0", [4, 2]), ("b-0", [1])], 8),
    "no_quota": ([("nb-0", [1])], None),
    "no_accelerator_pods": ([], 8),
}


async def _usage(pkg: str, pods, quota) -> dict:
    def load(name):
        return importlib.import_module(f"{pkg}.{name}")

    resource = "google.com/tpu" if pkg == REFERENCE else GPU_RESOURCE
    other = GPU_RESOURCE if pkg == REFERENCE else "google.com/tpu"
    kube = load("testing.fakekube").FakeKube()
    if quota is not None:
        await kube.create("ResourceQuota", {
            "metadata": {"name": "kf-resource-quota", "namespace": "ns"},
            "spec": {"hard": {f"requests.{resource}": str(quota),
                              f"requests.{other}": "1000"}}})
    for name, counts in pods:
        await kube.create("Pod", {
            "metadata": {"name": name, "namespace": "ns"},
            "spec": {"containers": [
                {"name": f"c{i}", "resources": {"requests": {
                    resource: str(n), "cpu": "1"}}}
                for i, n in enumerate(counts)]}})
    # The other package's resource counts for nothing.
    await kube.create("Pod", {
        "metadata": {"name": "foreign-0", "namespace": "ns"},
        "spec": {"containers": [{"name": "x", "resources": {
            "requests": {other: "64"}}}]}})
    route = "tpu-usage" if pkg == REFERENCE else "gpu-usage"
    client = TestClient(TestServer(
        load("web.dashboard").create_app(kube)))
    await client.start_server()
    try:
        resp = await client.get(f"/api/namespaces/ns/{route}", headers=ALICE)
        assert resp.status == 200
        return await resp.json()
    finally:
        await client.close()


@pytest.mark.parametrize("case", sorted(USAGE_CASES))
async def test_gpu_usage_answers_as_tpu_usage(case):
    pods, quota = USAGE_CASES[case]
    ref = await _usage(REFERENCE, pods, quota)
    port = await _usage(PORT, pods, quota)
    assert port == ref
    assert port["chipsRequested"] == sum(sum(c) for _, c in pods)
    assert port["chipsQuota"] == quota
