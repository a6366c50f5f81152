"""The port's notebook spawn path on GPU shapes, in the fake apiserver:
``Notebook`` CR (``spec.gpu``) → admission (defaulting, validation, the
card quota, PodDefaults, the per-node env) → the notebook controller's
StatefulSets, Services, NetworkPolicy, VirtualService and status → pods
whose env forms a ``torch.distributed`` world.

The cases of tests/test_notebook_controller.py (spawn, resources and
selectors, distinct worker ids, the stop annotation, the slice-atomic
restart, pod events, Istio, the invalid spec, PodDefaults) and of
tests/test_multislice.py (one StatefulSet a slice, the gang restart, the
scale-in GC) with the same asserts on GPU shapes, then admission, the
fleet and warm-pool sources each building its GPU fleet scheduler or
warm pod pool at registration and setup, queued provisioning, the
suspend drain, and a world formed from the env the pods were admitted
with.
"""

import time

import pytest

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.controllers.notebook import (
    CONSUME_PR_ANNOTATION,
    PR_CLASS_ANNOTATION,
    PROVISIONING_CLASS,
    RENDEZVOUS_PORT_NAME,
    setup_notebook_controller,
)
from kubeflow_tpu_torch.gpu.topology import MASTER_PORT, GpuSlice
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.runtime.objects import deep_get, fmt_iso, get_meta, name_of
from kubeflow_tpu_torch.scheduler import Fleet
from kubeflow_tpu_torch.testing.fakekube import FakeKube
from kubeflow_tpu_torch.webhooks import register_all
from torch_control import clear_kftpu_env, free_port, make_harness, run_workers

H100 = "nvidia-h100-80gb"
POD_INDEX = "metadata.labels['apps.kubernetes.io/pod-index']"


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


def _env(container: dict) -> dict:
    return {e["name"]: e.get("value") for e in container.get("env", [])}


# ---- tests/test_notebook_controller.py on GPU shapes -------------------------


async def test_single_host_notebook_spawns_sts_service_and_runs():
    h = await make_harness()
    try:
        nb = nbapi.new("nb1", "user-ns", image="img:1")
        await h.kube.create("Notebook", nb)
        await h.settle()

        sts = await h.kube.get("StatefulSet", "nb1", "user-ns")
        assert deep_get(sts, "spec", "replicas") == 1
        assert deep_get(sts, "spec", "podManagementPolicy") == "Parallel"
        tmpl = deep_get(sts, "spec", "template")
        assert deep_get(tmpl, "metadata", "labels")["notebook-name"] == "nb1"
        main = deep_get(tmpl, "spec", "containers")[0]
        assert _env(main)["NB_PREFIX"] == "/notebook/user-ns/nb1"
        assert deep_get(tmpl, "spec", "securityContext", "fsGroup") == 100

        svc = await h.kube.get("Service", "nb1", "user-ns")
        port = deep_get(svc, "spec", "ports")[0]
        assert port["port"] == 80 and port["targetPort"] == 8888
        assert deep_get(svc, "spec", "selector")[
            "statefulset.kubernetes.io/pod-name"] == "nb1-0"

        pod = await h.kube.get("Pod", "nb1-0", "user-ns")
        assert deep_get(pod, "status", "phase") == "Running"

        nb = await h.kube.get("Notebook", "nb1", "user-ns")
        assert deep_get(nb, "status", "readyReplicas") == 1
        assert "running" in deep_get(nb, "status", "containerState", default={})
        conds = deep_get(nb, "status", "conditions", default=[])
        assert conds and conds[0]["type"] == "Running"
        assert deep_get(nb, "status", "gpu") == {
            "hosts": 1, "readyHosts": 1, "chips": 0, "slices": 0}
    finally:
        await h.stop()


async def test_gpu_single_node_resources_and_selectors():
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "gpu1", "ns", accelerator=H100, topology="1x4"))
        await h.settle()

        sts = await h.kube.get("StatefulSet", "gpu1", "ns")
        assert deep_get(sts, "spec", "replicas") == 1
        tmpl_spec = deep_get(sts, "spec", "template", "spec")
        assert tmpl_spec["nodeSelector"] == {
            "cloud.google.com/gke-accelerator": H100}
        main = tmpl_spec["containers"][0]
        assert main["resources"]["requests"]["nvidia.com/gpu"] == "4"
        assert main["resources"]["limits"]["nvidia.com/gpu"] == "4"
        env = _env(main)
        assert env["TPU_ACCELERATOR_TYPE"] == "a3-highgpu-8g"
        assert env["PET_NPROC_PER_NODE"] == "4"
        assert env["PET_NNODES"] == "1"
        # Single-node slice: no headless service needed.
        assert await h.kube.get_or_none("Service", "gpu1-workers", "ns") is None
        # Node env injected at admission: node 0.
        pod_env = await h.pod_env("gpu1-0")
        assert pod_env["TPU_WORKER_ID"] == "0"
        assert pod_env["PET_NODE_RANK"] == "0"
    finally:
        await h.stop()


async def test_gpu_multi_node_slice_spawns_workers_with_distinct_ranks():
    h = await make_harness(create_network_policies=True)
    try:
        await h.kube.create("Notebook", nbapi.new(
            "big", "ns", accelerator=H100, topology="2x8"))
        await h.settle()

        sts = await h.kube.get("StatefulSet", "big", "ns")
        assert deep_get(sts, "spec", "replicas") == 2  # one pod a node
        assert deep_get(sts, "spec", "serviceName") == "big-workers"
        main = deep_get(sts, "spec", "template", "spec", "containers")[0]
        assert main["resources"]["requests"] == {"nvidia.com/gpu": "8"}
        assert {"containerPort": MASTER_PORT, "name": RENDEZVOUS_PORT_NAME,
                "protocol": "TCP"} in main["ports"]

        headless = await h.kube.get("Service", "big-workers", "ns")
        assert deep_get(headless, "spec", "clusterIP") == "None"
        assert deep_get(headless, "spec", "publishNotReadyAddresses") is True
        assert deep_get(headless, "spec", "ports") == [
            {"name": "torch-rdzv", "port": 29500, "protocol": "TCP"}]

        envs = {i: await h.pod_env(f"big-{i}") for i in range(2)}
        assert envs[0]["TPU_WORKER_ID"] == "0"
        assert envs[1]["TPU_WORKER_ID"] == "1"
        assert envs[1]["PET_NODE_RANK"] == "1"
        # The webhook replaced the template's downward-API fallback with a
        # plain value: an env entry carrying both is invalid.
        for i in range(2):
            pod = await h.kube.get("Pod", f"big-{i}", "ns")
            for e in deep_get(pod, "spec", "containers")[0]["env"]:
                if e["name"] in ("TPU_WORKER_ID", "PET_NODE_RANK"):
                    assert "valueFrom" not in e, e
        # The template carries the fallback (webhook-down safety) and the
        # slice label the Fail-policy registration selects on.
        tmpl = deep_get(sts, "spec", "template")
        tmpl_env = {e["name"]: e for e in main["env"]}
        for key in ("TPU_WORKER_ID", "PET_NODE_RANK"):
            assert tmpl_env[key]["valueFrom"]["fieldRef"]["fieldPath"] \
                == POD_INDEX
        assert deep_get(tmpl, "metadata", "labels")[
            "tpu.kubeflow.org/slice"] == "true"
        hosts = envs[0]["TPU_WORKER_HOSTNAMES"].split(",")
        assert hosts == ["big-0.big-workers.ns.svc.cluster.local",
                         "big-1.big-workers.ns.svc.cluster.local"]
        for i in range(2):
            assert envs[i]["PET_MASTER_ADDR"] == hosts[0]
            assert envs[i]["PET_MASTER_PORT"] == "29500"
            assert envs[i]["PET_NNODES"] == "2"
            assert envs[i]["PET_NPROC_PER_NODE"] == "8"

        policy = await h.kube.get("NetworkPolicy", "notebook-big", "ns")
        assert {"from": [{"podSelector": {"matchLabels": {
            "notebook-name": "big"}}}]} in deep_get(policy, "spec", "ingress")

        nb = await h.kube.get("Notebook", "big", "ns")
        assert deep_get(nb, "status", "gpu") == {
            "hosts": 2, "readyHosts": 2, "chips": 16, "slices": 1}
        assert deep_get(nb, "status", "tpu") is None
        assert 'notebook_gpus_requested{namespace="ns"} 16' in \
            h.mgr.registry.expose()
    finally:
        await h.stop()


async def test_stop_annotation_scales_to_zero_and_restart_restores():
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "nb", "ns", accelerator=H100, topology="2x8"))
        await h.settle()
        assert await h.kube.get_or_none("Pod", "nb-1", "ns") is not None

        await h.kube.patch("Notebook", "nb", {"metadata": {"annotations": {
            nbapi.STOP_ANNOTATION: "2026-07-29"}}}, "ns")
        await h.settle()
        sts = await h.kube.get("StatefulSet", "nb", "ns")
        assert deep_get(sts, "spec", "replicas") == 0
        assert await h.kube.get_or_none("Pod", "nb-0", "ns") is None

        await h.kube.patch("Notebook", "nb", {"metadata": {"annotations": {
            nbapi.STOP_ANNOTATION: None}}}, "ns")
        await h.settle()
        sts = await h.kube.get("StatefulSet", "nb", "ns")
        assert deep_get(sts, "spec", "replicas") == 2
        assert await h.kube.get_or_none("Pod", "nb-1", "ns") is not None
    finally:
        await h.stop()


async def test_slice_atomic_restart_on_worker_failure():
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "frag", "ns", accelerator=H100, topology="2x8"))
        await h.settle()
        uid_before = get_meta(await h.kube.get("Pod", "frag-1", "ns"))["uid"]

        # Node 0 dies: the whole NCCL world must restart.
        await h.kube.patch("Pod", "frag-0", {"status": {"phase": "Failed"}},
                           "ns", subresource="status")
        await h.settle()

        pod1 = await h.kube.get("Pod", "frag-1", "ns")
        assert get_meta(pod1)["uid"] != uid_before  # healthy node restarted too
        events = await h.kube.list("Event", "ns")
        restarts = [e for e in events if e.get("reason") == "SliceRestart"]
        assert restarts and "GPU slices restart atomically" in \
            restarts[0]["message"]
    finally:
        await h.stop()


async def test_pod_events_are_mirrored_onto_notebook():
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "evt", "ns", accelerator=H100, topology="1x8"))
        await h.settle()
        await h.kube.create("Event", {
            "metadata": {"name": "evt-0.pull", "namespace": "ns"},
            "involvedObject": {"kind": "Pod", "name": "evt-0",
                               "namespace": "ns"},
            "reason": "Pulled", "message": "Successfully pulled image",
            "type": "Normal"})
        await h.settle()
        events = await h.kube.list("Event", "ns")
        mirrored = [e for e in events
                    if e.get("involvedObject", {}).get("kind") == "Notebook"
                    and e.get("reason") == "Pulled"]
        assert mirrored and "[pod evt-0]" in mirrored[0]["message"]
    finally:
        await h.stop()


async def test_istio_virtualservice_generated_with_rewrite():
    h = await make_harness(use_istio=True)
    try:
        nb = nbapi.new("code", "ns", accelerator=H100, topology="1x1")
        get_meta(nb)["annotations"] = {nbapi.ANNOTATION_REWRITE_URI: "/"}
        await h.kube.create("Notebook", nb)
        await h.settle()
        vs = await h.kube.get("VirtualService", "notebook-ns-code", "ns")
        http = deep_get(vs, "spec", "http")[0]
        assert http["match"][0]["uri"]["prefix"] == "/notebook/ns/code/"
        assert http["rewrite"] == {"uri": "/"}
        assert deep_get(vs, "spec", "gateways") == ["kubeflow/kubeflow-gateway"]
    finally:
        await h.stop()


async def test_invalid_gpu_spec_rejected_at_admission():
    kube = FakeKube()
    register_all(kube)
    with pytest.raises(Invalid):
        await kube.create("Notebook", nbapi.new(
            "bad", "ns", accelerator="h200", topology="2x8"))
    with pytest.raises(Invalid):  # several nodes take whole nodes of 8
        await kube.create("Notebook", nbapi.new(
            "bad2", "ns", accelerator=H100, topology="3x5"))
    assert await kube.list("Notebook", "ns") == []


async def test_poddefault_injected_into_notebook_pod():
    h = await make_harness()
    try:
        await h.kube.create("PodDefault", {
            "metadata": {"name": "add-gcs", "namespace": "ns"},
            "spec": {
                "selector": {"matchLabels": {"notebook-name": "pd-nb"}},
                "env": [{"name": "GOOGLE_CLOUD_PROJECT", "value": "proj"}],
                "volumes": [{"name": "dshm",
                             "emptyDir": {"medium": "Memory"}}],
                "volumeMounts": [{"name": "dshm", "mountPath": "/dev/shm"}],
            }})
        await h.kube.create("Notebook", nbapi.new(
            "pd-nb", "ns", accelerator=H100, topology="2x8"))
        await h.settle()
        pod = await h.kube.get("Pod", "pd-nb-1", "ns")
        env = await h.pod_env("pd-nb-1")
        assert env["GOOGLE_CLOUD_PROJECT"] == "proj"
        # The per-node env runs after PodDefaults.
        assert env["PET_NODE_RANK"] == "1"
        assert any(v["name"] == "dshm"
                   for v in deep_get(pod, "spec", "volumes", default=[]))
        annotations = get_meta(pod).get("annotations", {})
        assert "poddefault.admission.kubeflow.org/poddefault-add-gcs" \
            in annotations
    finally:
        await h.stop()


# ---- tests/test_multislice.py on GPU shapes ----------------------------------


async def test_multislice_spawns_one_sts_per_slice():
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "ms", "ns", accelerator=H100, topology="2x8", num_slices=2))
        await h.settle(8)

        s0 = await h.kube.get("StatefulSet", "ms-s0", "ns")
        s1 = await h.kube.get("StatefulSet", "ms-s1", "ns")
        for sts in (s0, s1):
            assert deep_get(sts, "spec", "replicas") == 2
            assert deep_get(sts, "spec", "serviceName") == "ms-workers"
        assert (deep_get(s0, "spec", "selector", "matchLabels")
                != deep_get(s1, "spec", "selector", "matchLabels"))
        # Across slices only the ordinal falls back to the pod index: the
        # global rank needs the webhook.
        tmpl_env = {e["name"]: e for e in deep_get(
            s1, "spec", "template", "spec", "containers")[0]["env"]}
        assert "valueFrom" in tmpl_env["TPU_WORKER_ID"]
        assert "PET_NODE_RANK" not in tmpl_env

        headless = await h.kube.get("Service", "ms-workers", "ns")
        assert deep_get(headless, "spec", "clusterIP") == "None"
        assert deep_get(headless, "spec", "selector") == {
            nbapi.NOTEBOOK_NAME_LABEL: "ms"}
        svc = await h.kube.get("Service", "ms", "ns")
        assert deep_get(svc, "spec", "selector")[
            "statefulset.kubernetes.io/pod-name"] == "ms-s0-0"

        env = {p: await h.pod_env(p)
               for p in ("ms-s0-0", "ms-s0-1", "ms-s1-0", "ms-s1-1")}
        assert [env[p]["TPU_WORKER_ID"] for p in sorted(env)] == \
            ["0", "1", "0", "1"]
        assert [env[p]["PET_NODE_RANK"] for p in sorted(env)] == \
            ["0", "1", "2", "3"]
        assert {env[p]["PET_NNODES"] for p in env} == {"4"}
        assert env["ms-s1-1"]["MEGASCALE_SLICE_ID"] == "1"
        assert env["ms-s0-0"]["MEGASCALE_NUM_SLICES"] == "2"
        assert env["ms-s1-0"]["PET_MASTER_ADDR"].startswith(
            "ms-s0-0.ms-workers.ns.svc")
        # Node hostnames stay per-slice.
        assert "ms-s0" not in env["ms-s1-0"]["TPU_WORKER_HOSTNAMES"]

        nb = await h.kube.get("Notebook", "ms", "ns")
        assert deep_get(nb, "status", "gpu") == {
            "hosts": 4, "readyHosts": 4, "chips": 32, "slices": 2}
    finally:
        await h.stop()


async def test_multislice_gang_restart_spans_slices():
    """A worker crash in slice 1 restarts every worker of every slice —
    all nodes are one torch.distributed job."""
    crashed = {"done": False}

    def injector(pod):
        if name_of(pod) == "gang-s1-0" and not crashed["done"]:
            crashed["done"] = True
            return "crash"
        return None

    h = await make_harness(sim_kwargs={"failure_injector": injector})
    try:
        await h.kube.create("Notebook", nbapi.new(
            "gang", "ns", accelerator=H100, topology="2x8", num_slices=2))
        await h.settle(14)
        events = await h.kube.list("Event", "ns")
        restarts = [e for e in events if e.get("reason") == "SliceRestart"]
        assert restarts, "no gang restart"
        assert "all 4 workers" in restarts[0]["message"]
        nb = await h.kube.get("Notebook", "gang", "ns")
        assert deep_get(nb, "status", "readyReplicas") == 4
    finally:
        await h.stop()


async def test_multislice_scale_in_garbage_collects():
    """numSlices 2 → 1 on a stopped notebook: the -s* StatefulSets go away
    and the bare-name single-slice StatefulSet takes over."""
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "shrink", "ns", accelerator=H100, topology="2x8", num_slices=2))
        await h.settle(8)
        assert await h.kube.get_or_none("StatefulSet", "shrink-s1", "ns")

        # Stop first (live gpu-block edits are restart-blocked by design).
        await h.kube.patch("Notebook", "shrink", {"metadata": {"annotations": {
            nbapi.STOP_ANNOTATION: "t"}}}, "ns")
        await h.settle(8)
        nb = await h.kube.get("Notebook", "shrink", "ns")
        del nb["spec"]["gpu"]["numSlices"]
        await h.kube.update("Notebook", nb)
        await h.settle(8)

        assert await h.kube.get_or_none("StatefulSet", "shrink-s0", "ns") is None
        assert await h.kube.get_or_none("StatefulSet", "shrink-s1", "ns") is None
        sts = await h.kube.get("StatefulSet", "shrink", "ns")
        assert deep_get(sts, "spec", "replicas") == 0  # still stopped
    finally:
        await h.stop()


# ---- admission -----------------------------------------------------------------


async def test_a_tpu_notebook_is_refused_not_spawned_without_it():
    kube = FakeKube()
    register_all(kube)
    nb = nbapi.new("old", "ns")
    nb["spec"]["tpu"] = {"accelerator": "v5e", "topology": "2x2"}
    with pytest.raises(Invalid, match="spec.gpu"):
        await kube.create("Notebook", nb)
    assert await kube.list("Notebook", "ns") == []


@pytest.mark.parametrize("quota,admitted", [(8, False), (16, True)])
async def test_the_card_quota_gates_a_gang(quota, admitted):
    kube = FakeKube()
    register_all(kube)
    await kube.create("Profile", profileapi.new("team", "a@example.com",
                                                gpu_quota=quota))
    profile = await kube.get("Profile", "team")
    assert profileapi.quota_spec_of(profile) == {
        "hard": {"requests.nvidia.com/gpu": str(quota)}}
    nb = nbapi.new("nb", "team", accelerator=H100, topology="2x8")
    if admitted:
        await kube.create("Notebook", nb)
        assert await kube.get("Notebook", "nb", "team")
    else:
        with pytest.raises(Invalid) as e:
            await kube.create("Notebook", nb)
        assert "requests 16 GPUs" in str(e.value)
        assert f"(Profile team spec.gpuQuota) is {quota}" in str(e.value)
        assert await kube.list("Notebook", "team") == []


@pytest.mark.parametrize("gpu", [
    {"accelerator": "h200", "topology": "1x8"},
    {"accelerator": H100, "topology": "2x4"},
    {"accelerator": H100, "topology": "1x16"},
    {"accelerator": H100, "topology": "2x8x1"},
    {"accelerator": H100, "topology": "two"},
    {"accelerator": H100, "topology": "1x8", "numSlices": "two"},
    {"accelerator": H100, "topology": "1x8", "numSlices": 0},
    {"accelerator": H100, "topology": "1x8", "queuedProvisioning": "yes"},
], ids=lambda g: ",".join(f"{k}={v}" for k, v in g.items()))
def test_a_malformed_gpu_block_raises_invalid(gpu):
    nb = nbapi.new("nb", "ns")
    nb["spec"]["gpu"] = gpu
    with pytest.raises(Invalid, match="spec.gpu"):
        nbapi.validate(nb)


FLEET = f"a={H100}:1x8:1"


async def _fleet_source(monkeypatch, kube, env):
    """Point ``env`` at a one-node fleet: the spec itself, or a ConfigMap
    in the controller namespace holding it."""
    if env == "KFTPU_FLEET_CONFIGMAP":
        await kube.create("ConfigMap", {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "kftpu-fleet", "namespace": "kubeflow-tpu"},
            "data": {"fleet": FLEET}})
        monkeypatch.setenv(env, "kftpu-fleet")
    else:
        monkeypatch.setenv(env, FLEET)


@pytest.mark.parametrize("env", ["KFTPU_FLEET", "KFTPU_FLEET_CONFIGMAP"])
async def test_a_fleet_source_fast_fails_a_gang_it_can_never_hold(
        monkeypatch, env):
    kube = FakeKube()
    await _fleet_source(monkeypatch, kube, env)
    monkeypatch.setenv("KFTPU_ELASTIC", "off")
    register_all(kube)
    with pytest.raises(Invalid, match=f"no configured node pool hosts "
                       f"{H100}:2x8 slices"):
        await kube.create("Notebook", nbapi.new(
            "big", "ns", accelerator=H100, topology="2x8"))
    await kube.create("Notebook", nbapi.new(
        "fits", "ns", accelerator=H100, topology="1x8"))


@pytest.mark.parametrize("env", ["KFTPU_FLEET", "KFTPU_FLEET_CONFIGMAP",
                                 "KFTPU_WARM_POOLS",
                                 "KFTPU_WARM_POOLS_CONFIGMAP"])
async def test_each_env_source_builds_its_scheduler_or_warm_pool(
        monkeypatch, env):
    from kubeflow_tpu_torch.controllers.warmpool import WarmPoolManager
    from kubeflow_tpu_torch.scheduler import GpuFleetScheduler

    kube = FakeKube()
    if env.startswith("KFTPU_WARM"):
        monkeypatch.setenv(env, f"ns/img@{H100}:1x1:1"
                           if env == "KFTPU_WARM_POOLS" else "warm-pools")
    else:
        await _fleet_source(monkeypatch, kube, env)
    mgr = Manager(kube)
    rec = setup_notebook_controller(mgr)
    assert isinstance(rec._scheduler, GpuFleetScheduler)
    assert mgr.scheduler is rec._scheduler
    if env.startswith("KFTPU_WARM"):
        assert isinstance(rec._warmpool, WarmPoolManager)
        assert mgr.warmpool is rec._warmpool
        assert rec._warmpool.scheduler is rec._scheduler
        assert rec._warmpool.options.enabled
    else:
        assert rec._warmpool is None
        # The env spec is read at construction, the ConfigMap on the
        # first admission.
        assert rec._scheduler.active == (env == "KFTPU_FLEET")
        assert await rec._scheduler._ensure_fleet()
        assert rec._scheduler.policy.fleet == Fleet.parse(FLEET)


@pytest.mark.parametrize("arg", ["scheduler", "warmpool"])
def test_each_argument_is_wired(arg):
    from kubeflow_tpu_torch.controllers.warmpool import (WarmPoolManager,
                                                         WarmPoolOptions)
    from kubeflow_tpu_torch.scheduler import GpuFleetScheduler, SchedulerOptions

    kube = FakeKube()
    mgr = Manager(kube)
    given = (GpuFleetScheduler(kube, SchedulerOptions(fleet_spec=FLEET))
             if arg == "scheduler" else
             WarmPoolManager(kube, WarmPoolOptions(
                 spec=f"ns/img@{H100}:1x1:1")))
    rec = setup_notebook_controller(mgr, **{arg: given})
    assert getattr(rec, f"_{arg}") is given
    assert [c.name for c in mgr.controllers] == ["notebook"]
    if arg == "scheduler":
        assert mgr.scheduler is given and rec._warmpool is None
    else:
        # The scheduler the setup built from the env, one ledger for both.
        assert isinstance(rec._scheduler, GpuFleetScheduler)
        assert given.scheduler is rec._scheduler
        assert mgr.warmpool is given


# ---- queued provisioning and the drain ---------------------------------------


async def test_queued_slice_waits_then_starts():
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "big", "ns", accelerator=H100, topology="2x8", queued=True))
        await h.settle(8)
        # No workers yet — but the reservation exists, sized to the gang.
        assert await h.kube.get_or_none("StatefulSet", "big", "ns") is None
        pr = await h.kube.get("ProvisioningRequest", "big-capacity", "ns")
        assert deep_get(pr, "spec", "provisioningClassName") == \
            PROVISIONING_CLASS
        assert deep_get(pr, "spec", "podSets")[0]["count"] == 2
        pt = await h.kube.get("PodTemplate", "big-capacity", "ns")
        res = deep_get(pt, "template", "spec", "containers")[0]["resources"]
        assert res["limits"]["nvidia.com/gpu"] == "8"
        nb = await h.kube.get("Notebook", "big", "ns")
        assert deep_get(nb, "status", "gpu", "capacityPending") is True

        await h.kube.patch("ProvisioningRequest", "big-capacity", {
            "status": {"conditions": [
                {"type": "Provisioned", "status": "True"}]}},
            "ns", subresource="status")
        await h.settle(12)
        sts = await h.kube.get("StatefulSet", "big", "ns")
        anns = deep_get(sts, "spec", "template", "metadata", "annotations")
        assert anns[CONSUME_PR_ANNOTATION] == "big-capacity"
        assert anns[PR_CLASS_ANNOTATION] == PROVISIONING_CLASS
        nb = await h.kube.get("Notebook", "big", "ns")
        assert deep_get(nb, "status", "readyReplicas") == 2
        assert not deep_get(nb, "status", "gpu", "capacityPending")
    finally:
        await h.stop()


async def test_suspend_resume_rides_the_drain_protocol():
    """Suspend → drain requested → the SDK's ack → parked at replicas 0
    with the restore hint; dropping the annotation un-parks and the
    StatefulSet carries the restore env."""
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "nb", "ns", accelerator=H100, topology="2x8"))
        await h.settle()
        await h.kube.patch("Notebook", "nb", {"metadata": {"annotations": {
            nbapi.SUSPEND_ANNOTATION: fmt_iso(time.time())}}}, "ns")

        async def drain_requested():
            return migration.drain_reason(await h.annotations("nb")) == \
                "suspend"
        await h.wait_for(drain_requested, "suspend drain request")
        assert nbapi.STOP_ANNOTATION not in await h.annotations("nb")

        await h.kube.patch("Notebook", "nb", {"metadata": {
            "annotations": migration.ack_patch(
                "/home/jovyan/ckpt/nb", 1234, time.time())}}, "ns")

        async def parked():
            return nbapi.STOP_ANNOTATION in await h.annotations("nb")
        await h.wait_for(parked, "suspend parked on ack")
        await h.settle()
        nb = await h.kube.get("Notebook", "nb", "ns")
        assert deep_get(nb, "status", "migration", "state") == \
            migration.PARKED
        sts = await h.kube.get("StatefulSet", "nb", "ns")
        assert deep_get(sts, "spec", "replicas") == 0

        await h.kube.patch("Notebook", "nb", {"metadata": {"annotations": {
            nbapi.SUSPEND_ANNOTATION: None}}}, "ns")

        async def resumed():
            sts = await h.kube.get("StatefulSet", "nb", "ns")
            return deep_get(sts, "spec", "replicas") == 2
        await h.wait_for(resumed, "resumed")
        sts = await h.kube.get("StatefulSet", "nb", "ns")
        env = _env(deep_get(sts, "spec", "template", "spec", "containers")[0])
        assert env[migration.RESTORE_PATH_ENV] == "/home/jovyan/ckpt/nb"
        assert env[migration.RESTORE_STEP_ENV] == "1234"
    finally:
        await h.stop()


# ---- a world from the rendered env --------------------------------------------


async def test_the_rendered_pods_form_a_world():
    """The two pods of a ``2x8`` notebook, as admission rendered them, run
    the bootstrap worker over gloo: one process a pod (no ``LOCAL_RANK``:
    a node's one rank), the rendezvous moved to localhost and a free port
    (cluster DNS does not resolve here)."""
    h = await make_harness()
    try:
        await h.kube.create("Notebook", nbapi.new(
            "nb", "ns", accelerator=H100, topology="2x8"))
        await h.settle()
        envs = [await h.pod_env(f"nb-{i}") for i in range(2)]
    finally:
        await h.stop()
    gpu = GpuSlice.parse(H100, "2x8")
    assert [e["PET_NODE_RANK"] for e in envs] == ["0", "1"]
    assert all(e["PET_NNODES"] == str(gpu.num_hosts) for e in envs)
    outs = run_workers(envs, PET_MASTER_ADDR="127.0.0.1",
                       PET_MASTER_PORT=str(free_port()))
    for out in outs:
        assert "PSUM_RESULT 3.0 NPROC 2" in out.splitlines(), out
    assert sorted(line for out in outs for line in out.splitlines()
                  if line.startswith("RANK ")) == ["RANK 0 OF 2", "RANK 1 OF 2"]
