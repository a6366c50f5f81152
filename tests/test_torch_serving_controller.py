"""The port's serving workload class (``kubeflow_tpu_torch/serving/
controller.py``, ``api/inferenceservice.py``, ``webhooks/
inferenceservice.py``) against the reference's, over either package's
fake apiserver, admission chain, manager, shared fleet scheduler,
notebook controller and kubelet simulator (``tests/torch_control.py``),
as tests/test_serving.py drives the reference's.

Every scenario runs once on each package: the same InferenceService and
Notebooks, a ``spec.tpu`` ``v5e`` slice for the reference and the
``spec.gpu`` H100 slice of as many nodes and accelerators for the port,
on the fleet of the same pools (tests/test_torch_scheduler_parity.py's
shape map: ``2x2`` → ``1x4``, ``4x4`` → ``2x8``). What each scenario
reads back (annotations, status, children, Event reasons, the ledger)
must be equal across the two, and the port's is then held to the
reference test's expectations. Each replica's StatefulSet and the
Services equal the reference's outside the accelerator block, whose
leaves are held to ``gpu/topology.py``.
"""

import asyncio
import copy
import importlib
import time

import pytest

from kubeflow_tpu_torch.api import inferenceservice as isvcapi
from kubeflow_tpu_torch.gpu.topology import (GPU_RESOURCE, LOOPBACK_ADDR,
                                             MASTER_PORT, MultiSlice)
from kubeflow_tpu_torch.runtime.errors import Invalid
from torch_control import PORT, REFERENCE, clear_kftpu_env, make_harness, modules

H100 = "nvidia-h100-80gb"
SHAPES = {REFERENCE: {"2x2": ("v5e", "2x2"), "4x4": ("v5e", "4x4"),
                      "none": ("v5p", "2x2x1")},
          PORT: {"2x2": (H100, "1x4"), "4x4": (H100, "2x8"),
                 "none": (H100, "1x8")}}
SCHEDULER = dict(queued_requeue_seconds=0.05, enable_migration=True,
                 drain_grace_seconds=5.0, idle_preempt_after_seconds=0.3)
SERVING = dict(enabled=True, autoscale_period_seconds=0.05,
               park_grace_seconds=1.0, default_stabilization=0.1)
ACCEL_RESOURCES = ("google.com/tpu", GPU_RESOURCE)
ACCEL_ANNOTATIONS = ("tpu.kubeflow.org/accelerator",
                     "tpu.kubeflow.org/topology")
RENDEZVOUS_PORTS = ("jax", "torch-rdzv")
VOLATILE = ("uid", "creationTimestamp", "resourceVersion")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


def fleet_of(pkg: str, pools: str) -> str:
    """``name:shape:count[:spot]`` pools → the package's fleet spec."""
    out = []
    for pool in pools.split(","):
        name, shape, rest = pool.split(":", 2)
        acc, topo = SHAPES[pkg][shape]
        out.append(f"{name}={acc}:{topo}:{rest}")
    return ",".join(out)


def isvc(m, pkg, name="svc", shape="2x2", **kw):
    acc, topo = SHAPES[pkg][shape]
    return m.isvcapi.new(name, "user", accelerator=acc, topology=topo, **kw)


def notebook(m, pkg, name, shape="2x2"):
    acc, topo = SHAPES[pkg][shape]
    return m.nbapi.new(name, "user", accelerator=acc, topology=topo)


async def run_both(scenario, pools="pool-a:2x2:2", *, scheduler=None,
                   serving=None, culling=None):
    """Run ``scenario(h)`` in each package's harness; the two results must
    be equal. Returns the port's."""
    got = {}
    for pkg in (REFERENCE, PORT):
        h = await make_harness(
            pkg, fleet=fleet_of(pkg, pools),
            scheduler={**SCHEDULER, **(scheduler or {})},
            serving={**SERVING, **(serving or {})},
            culling=culling() if culling else None)
        try:
            got[pkg] = await scenario(h)
            h.sched.policy.ledger.assert_consistent()
            assert h.sched.policy.ledger.violations == 0
        finally:
            await h.stop()
    assert got[PORT] == got[REFERENCE]
    return got[PORT]


async def events(h, ns="user") -> list:
    return sorted({e.get("reason") for e in await h.kube.list("Event", ns)})


async def isvc_of(h, name="svc"):
    return await h.kube.get("InferenceService", name, "user")


def ann(obj) -> dict:
    return dict(obj["metadata"].get("annotations") or {})


def serving_status(obj) -> dict:
    return dict((obj.get("status") or {}).get("serving") or {})


async def ack_park(h, path="/ckpt/svc", step="77"):
    """The engine's side of the park protocol: ack the current request
    with a committed checkpoint, echoing it."""
    i = h.m.isvcapi
    while True:
        live = await h.kube.get_or_none("InferenceService", "svc", "user")
        anns = ann(live or {"metadata": {}})
        requested = anns.get(i.PARK_REQUESTED_ANNOTATION)
        if requested and anns.get(i.PARK_CHECKPOINT_FOR_ANNOTATION) \
                != requested:
            await h.kube.patch("InferenceService", "svc", {"metadata": {
                "annotations": {i.PARK_CHECKPOINT_PATH_ANNOTATION: path,
                                i.PARK_CHECKPOINT_STEP_ANNOTATION: step,
                                i.PARK_CHECKPOINT_FOR_ANNOTATION:
                                    requested}}}, "user")
            return
        await asyncio.sleep(0.01)


async def ack_notebook_drain(h, name, path, step):
    """The in-pod SDK's side of a notebook drain."""
    mig = h.m.migration
    while True:
        nb = await h.kube.get_or_none("Notebook", name, "user")
        anns = ann(nb or {"metadata": {}})
        if mig.drain_requested_at(anns) is not None \
                and not mig.drain_acked(anns):
            await h.kube.patch("Notebook", name, {"metadata": {
                "annotations": mig.ack_patch(
                    path, step, time.time(), for_request=anns.get(
                        h.m.nbapi.DRAIN_REQUESTED_ANNOTATION))}}, "user")
            return
        await asyncio.sleep(0.01)


def env_of(sts) -> dict:
    return {e["name"]: e.get("value") for e in
            sts["spec"]["template"]["spec"]["containers"][0].get("env", [])}


# ---- scale up, park, restore -------------------------------------------------


async def test_serving_scales_up_and_becomes_ready():
    async def scenario(h):
        i = h.m.isvcapi
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=0, max_replicas=2, target_rate=5.0))
        await h.stamp_load(12.0)
        await h.until(lambda: h.replica_admitted(0)
                      and h.replica_admitted(1), "2 replicas")
        await h.mgr.wait_idle(timeout=20)
        sts = await h.kube.get("StatefulSet", "svc-r0", "user")
        labels = sts["spec"]["template"]["metadata"]["labels"]
        svc = await h.kube.get("Service", "svc", "user")
        return {"serving": serving_status(await isvc_of(h)),
                "labels": {k: labels.get(k) for k in (
                    i.SERVICE_LABEL, i.WORKLOAD_CLASS_LABEL,
                    h.m.nbapi.TPU_SLICE_LABEL)},
                "hostnames": "TPU_WORKER_HOSTNAMES" in env_of(sts),
                "selector": svc["spec"]["selector"],
                "children": sorted(s["metadata"]["name"] for s in
                                   await h.kube.list("StatefulSet", "user"))}

    got = await run_both(scenario)
    assert got["serving"]["state"] == "Ready"
    assert got["serving"]["admittedReplicas"] == 2
    assert got["labels"] == {isvcapi.SERVICE_LABEL: "svc",
                             isvcapi.WORKLOAD_CLASS_LABEL: "serving",
                             "tpu.kubeflow.org/slice": "true"}
    assert got["hostnames"]
    assert got["selector"] == {isvcapi.SERVICE_LABEL: "svc"}
    assert got["children"] == ["svc-r0", "svc-r1"]


async def test_scale_to_zero_parks_and_warm_restores_with_the_restore_env():
    async def scenario(h):
        i, mig = h.m.isvcapi, h.m.migration
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=0, max_replicas=1, target_rate=5.0,
            scale_to_zero_after=0.3))
        await h.stamp_load(4.0)
        await h.until(lambda: h.replica_admitted(0), "replica 0")
        await h.mgr.wait_idle(timeout=20)
        acker = asyncio.create_task(ack_park(h))
        await h.stamp_load(0.0, fresh=False)
        await h.until(lambda: not h.replica_admitted(0), "park release")
        await h.mgr.wait_idle(timeout=20)
        acker.cancel()

        async def no_pods():
            return not await h.kube.list("Pod", "user")

        await h.wait_for(no_pods, "the parked replica's pod gone")
        live = await isvc_of(h)
        parked = {"parked_at": i.PARKED_AT_ANNOTATION in ann(live),
                  "checkpoint": i.parked_checkpoint(ann(live)),
                  "state": serving_status(live)["state"],
                  "parked_checkpoint": serving_status(live).get(
                      "parkedCheckpoint"),
                  "replicas": (await h.kube.get(
                      "StatefulSet", "svc-r0", "user"))["spec"]["replicas"],
                  "events": await events(h)}
        await h.stamp_load(4.0)
        await h.until(lambda: h.replica_admitted(0), "warm re-admission")
        await h.mgr.wait_idle(timeout=20)
        sts = await h.kube.get("StatefulSet", "svc-r0", "user")
        env = env_of(sts)
        live = await isvc_of(h)
        return parked, {
            "replicas": sts["spec"]["replicas"],
            "restore": [env.get(mig.RESTORE_PATH_ENV),
                        env.get(mig.RESTORE_STEP_ENV)],
            "warm_restores": h.serving.m_warm_restores.labels().value,
            "parked_at": i.PARKED_AT_ANNOTATION in ann(live),
            "events": await events(h)}

    parked, restored = await run_both(scenario)
    assert parked == {"parked_at": True, "checkpoint": ("/ckpt/svc", 77),
                      "state": "Parked",
                      "parked_checkpoint": {"path": "/ckpt/svc", "step": 77},
                      "replicas": 0, "events": ["ParkRequested", "Parked"]}
    assert restored == {"replicas": 1, "restore": ["/ckpt/svc", "77"],
                        "warm_restores": 1.0, "parked_at": False,
                        "events": ["ParkRequested", "Parked",
                                   "WarmRestored"]}


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
def test_park_ack_requires_echo_of_current_request(pkg):
    i = modules(pkg).isvcapi
    anns = {i.PARK_REQUESTED_ANNOTATION: "t1",
            i.PARK_CHECKPOINT_PATH_ANNOTATION: "/c",
            i.PARK_CHECKPOINT_STEP_ANNOTATION: "5"}
    assert not i.park_acked(anns)          # stale, no echo
    anns[i.PARK_CHECKPOINT_FOR_ANNOTATION] = "t0"
    assert not i.park_acked(anns)          # echo of an OLD request
    anns[i.PARK_CHECKPOINT_FOR_ANNOTATION] = "t1"
    assert i.park_acked(anns)
    assert not i.park_acked({i.PARK_CHECKPOINT_FOR_ANNOTATION: "t1"})


async def test_park_grace_fallback_without_ack():
    async def scenario(h):
        i = h.m.isvcapi
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=0, max_replicas=1,
            scale_to_zero_after=0.2))
        await h.stamp_load(4.0)
        await h.until(lambda: h.replica_admitted(0), "replica 0")
        await h.stamp_load(0.0, fresh=False)
        await h.until(lambda: not h.replica_admitted(0),
                      "grace-deadline park", timeout=20)
        await h.mgr.wait_idle(timeout=20)
        live = await isvc_of(h)
        return (i.PARKED_AT_ANNOTATION in ann(live),
                i.parked_checkpoint(ann(live)), await events(h))

    assert await run_both(scenario, serving={"park_grace_seconds": 0.2}) \
        == (True, None, ["ParkRequested", "Parked"])


async def test_spot_reclaim_of_serving_replica_requeues_off_pool():
    async def scenario(h):
        await h.kube.create("Node", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "spot-node", "labels": {
                "cloud.google.com/gke-nodepool": "spot-a",
                "cloud.google.com/gke-spot": "true"}}})
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=1, max_replicas=1))
        await h.until(lambda: h.replica_admitted(0), "replica on spot")
        await h.mgr.wait_idle(timeout=20)
        await h.kube.patch("Node", "spot-node", {"spec": {"taints": [{
            "key": "cloud.google.com/gke-spot-termination",
            "effect": "NoSchedule"}]}})
        await h.until(lambda: not h.replica_admitted(0)
                      and ("user", "svc#r0") in h.sched.policy.pending,
                      "replica released and queued", timeout=20)
        await asyncio.sleep(0.4)   # several sweeps: no re-seat churn
        held = (h.replica_admitted(0),
                "spot-a" in h.sched.policy.ledger.unavailable)
        await h.kube.patch("Node", "spot-node", {"spec": {"taints": None}})
        await h.until(lambda: h.replica_admitted(0), "re-admission",
                      timeout=20)
        await h.mgr.wait_idle(timeout=20)
        return held

    assert await run_both(scenario, "spot-a:2x2:1:spot",
                          scheduler={"enable_elastic": True}) == (False, True)


# ---- the shared ledger ------------------------------------------------------------


async def test_admission_collision_serving_burst_vs_notebook_gang():
    async def scenario(h):
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=0, max_replicas=2, target_rate=5.0))
        await h.stamp_load(30.0)  # burst: wants both slices
        await h.kube.create("Notebook", notebook(h.m, h.pkg, "nb"))
        await h.until(lambda: h.replica_admitted(0)
                      and h.replica_admitted(1), "serving burst")
        await h.mgr.wait_idle(timeout=20)
        nb = await h.kube.get("Notebook", "nb", "user")
        queued = (("user", "nb") in h.sched.policy.pending,
                  nb["status"]["scheduler"]["state"])
        await h.stamp_load(2.0)   # cool down → one replica
        await h.until(lambda: ("user", "nb")
                      in h.sched.policy.ledger.allocations,
                      "notebook admission after scale-down", timeout=20)
        return queued

    assert await run_both(scenario) == (True, "Queued")


async def test_a_serving_burst_drains_an_idle_notebook():
    async def scenario(h):
        await h.kube.create("Notebook", notebook(h.m, h.pkg, "idle-nb"))
        await h.mgr.wait_idle(timeout=20)
        await h.kube.patch("Notebook", "idle-nb", {"metadata": {
            "annotations": {h.m.nbapi.LAST_ACTIVITY_ANNOTATION:
                            h.m.objects.fmt_iso(time.time() - 3600)}}},
            "user")
        await asyncio.sleep(0.4)  # age past idle_preempt_after (0.3 s)
        acker = asyncio.create_task(ack_notebook_drain(
            h, "idle-nb", "/ckpt/idle-nb", 9))
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=1, max_replicas=1))
        await h.stamp_load(4.0)
        await h.until(lambda: h.replica_admitted(0),
                      "replica admitted over the drained notebook",
                      timeout=20)
        acker.cancel()
        await h.mgr.wait_idle(timeout=20)
        anns = await h.annotations("idle-nb", "user")
        return (h.m.nbapi.STOP_ANNOTATION in anns,
                anns.get(h.m.nbapi.DRAIN_REASON_ANNOTATION),
                h.sched.m_preemptions.labels(reason="idle").value >= 1)

    assert await run_both(scenario, "pool-a:2x2:1") == \
        (True, "preempt:idle", True)


async def test_the_cullers_own_probes_let_a_serving_burst_drain_a_notebook():
    """No hand-stamped idle signal: the culler probes the notebook's
    kernels (idle for an hour), writes ``last-activity`` itself, and the
    scheduler then drains that notebook for a queued serving replica."""
    def culling():
        async def prober(url):
            stamp = modules(PORT).objects.fmt_iso(time.time() - 3600)
            return ([{"execution_state": "idle", "last_activity": stamp}]
                    if url.endswith("kernels") else [])

        return {"prober": prober, "options": {
            "enable_culling": True, "cull_idle_seconds": 10 ** 6,
            "check_period_seconds": 0.05}}

    async def scenario(h):
        nbapi = h.m.nbapi
        await h.kube.create("Notebook", notebook(h.m, h.pkg, "idle-nb"))

        async def stamped():
            anns = await h.annotations("idle-nb", "user")
            return nbapi.LAST_ACTIVITY_ANNOTATION in anns \
                and nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION in anns

        await h.wait_for(stamped, "the culler's activity stamp")
        await asyncio.sleep(0.4)  # age past idle_preempt_after (0.3 s)
        acker = asyncio.create_task(ack_notebook_drain(
            h, "idle-nb", "/ckpt/idle-nb", 9))
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=1, max_replicas=1))
        await h.stamp_load(4.0)
        await h.until(lambda: h.replica_admitted(0),
                      "replica admitted over the culler-idle notebook",
                      timeout=20)
        acker.cancel()
        await h.mgr.wait_idle(timeout=20)
        anns = await h.annotations("idle-nb", "user")
        return (nbapi.STOP_ANNOTATION in anns,
                anns.get(nbapi.DRAIN_REASON_ANNOTATION),
                anns.get(nbapi.CHECKPOINT_STEP_ANNOTATION),
                ("user", "idle-nb") in h.sched.policy.ledger.allocations)

    assert await run_both(scenario, "pool-a:2x2:1", culling=culling) == \
        (True, "preempt:idle", "9", False)


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
async def test_restart_gcs_replicas_above_desired(pkg):
    """A restarted controller that computes a lower desired count still
    deletes (and releases) the old replicas' StatefulSets."""
    m = modules(pkg)
    kube = m.fakekube.FakeKube()
    m.webhooks.register_all(kube)

    async def run_manager(rate):
        mgr = m.manager.Manager(kube, registry=m.metrics.Registry())
        sched = m.FleetScheduler(
            kube, m.scheduler.SchedulerOptions(queued_requeue_seconds=0.05),
            fleet=m.scheduler.Fleet.parse(fleet_of(pkg, "pool-a:2x2:4")),
            registry=mgr.registry)
        m.controller.setup_notebook_controller(
            mgr, m.controller.NotebookOptions(), scheduler=sched)
        m.serving.setup_serving_controller(mgr, m.serving.ServingOptions(
            enabled=True, autoscale_period_seconds=0.05,
            default_stabilization=0.1), scheduler=sched)
        sim = m.podsim.PodSimulator(kube)
        await mgr.start()
        await sim.start()
        await kube.patch("InferenceService", "svc", {"metadata": {
            "annotations": {
                m.isvcapi.OBSERVED_RATE_ANNOTATION: str(rate),
                m.isvcapi.LAST_REQUEST_AT_ANNOTATION:
                    m.objects.fmt_iso(time.time())}}}, "user")
        await mgr.wait_idle(timeout=20)
        await asyncio.sleep(0.3)
        await mgr.wait_idle(timeout=20)
        await sim.stop()
        await mgr.stop()
        return sched

    await kube.create("InferenceService", isvc(
        m, pkg, min_replicas=0, max_replicas=3, target_rate=5.0))
    sched = await run_manager(14.0)  # 3 replicas
    assert sum(1 for k in sched.policy.ledger.allocations
               if "#r" in k[1]) == 3
    sched2 = await run_manager(2.0)  # 1 replica, a fresh manager
    assert [k for k in sched2.policy.ledger.allocations if "#r" in k[1]] \
        == [("user", "svc#r0")]
    assert await kube.get_or_none("StatefulSet", "svc-r1", "user") is None
    assert await kube.get_or_none("StatefulSet", "svc-r2", "user") is None
    sched2.policy.ledger.assert_consistent()
    assert sched2.policy.ledger.violations == 0
    kube.close_watches()


async def test_service_delete_releases_all_replicas():
    async def scenario(h):
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=2, max_replicas=2))
        await h.until(lambda: h.replica_admitted(0)
                      and h.replica_admitted(1), "2 replicas")
        booked = dict(h.sched.policy.ledger.ns_chips)
        await h.kube.delete("InferenceService", "svc", "user")
        await h.until(lambda: not h.sched.policy.ledger.allocations,
                      "every card released on delete")
        await h.mgr.wait_idle(timeout=20)
        return booked

    assert await run_both(scenario) == {"user": 8}


# ---- workload-class guards ---------------------------------------------------


async def test_the_culler_never_culls_serving_class():
    """Through the manager: the culler skips a serving-labeled Notebook,
    probes and all, while the InferenceService controller runs beside
    it; the same Notebook without the label is culled."""
    probes = []

    def culling():
        async def prober(url):
            probes.append(url)
            return []   # "no kernels" — reads as idle for a notebook

        return {"prober": prober, "options": {
            "enable_culling": True, "cull_idle_seconds": 0.0,
            "check_period_seconds": 0.05}}

    async def scenario(h):
        nbapi, i = h.m.nbapi, h.m.isvcapi
        probes.clear()
        stale = {nbapi.LAST_ACTIVITY_ANNOTATION:
                 h.m.objects.fmt_iso(time.time() - 9999)}
        served = notebook(h.m, h.pkg, "served-model")
        served["metadata"]["labels"] = {
            i.WORKLOAD_CLASS_LABEL: i.SERVING_CLASS}
        served["metadata"]["annotations"] = dict(stale)
        plain = notebook(h.m, h.pkg, "plain-nb")
        plain["metadata"]["annotations"] = dict(stale)
        await h.kube.create("Notebook", served)
        await h.kube.create("Notebook", plain)

        async def culled():
            return nbapi.STOP_ANNOTATION in await h.annotations(
                "plain-nb", "user")

        await h.wait_for(culled, "the plain notebook culled")
        await h.mgr.wait_idle(timeout=20)
        return (nbapi.STOP_ANNOTATION in await h.annotations(
                    "served-model", "user"),
                any("served-model" in url for url in probes))

    assert await run_both(scenario, culling=culling) == (False, False)


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
def test_victim_search_never_picks_serving_allocations(pkg):
    m = modules(pkg)
    acc, topo = SHAPES[pkg]["2x2"]
    policy = importlib.import_module(f"{pkg}.scheduler.policy")
    Allocation = importlib.import_module(f"{pkg}.scheduler.fleet").Allocation

    def queue(waiter_slices):
        q = policy.PolicyQueue(
            fleet=m.scheduler.Fleet.parse(fleet_of(pkg, "pool-a:2x2:2")),
            config=policy.PolicyConfig(idle_preempt_after_seconds=10.0))
        for key, prio, workload in ((("u", "svc#r0"), 100, "serving"),
                                    (("u", "nb"), 0, "notebook")):
            q.ledger.admit(Allocation(
                key=key, namespace="u", accelerator=acc, topology=topo,
                num_slices=1, chips=4, placements={"pool-a": 1},
                priority=prio, admitted_at=0.0, last_active_at=0.0,
                workload=workload))
        q.submit(policy.GangRequest(
            key=("u", "w"), namespace="u", accelerator=acc, topology=topo,
            num_slices=waiter_slices, chips=4 * waiter_slices, priority=200,
            submitted_at=0.0))
        return q.schedule(now=10_000.0)

    two = queue(2)
    assert not two.admitted
    assert ("u", "svc#r0") not in {p.key for p in two.preempted} | \
        {p.key for p in two.drains}
    one = queue(1)
    assert {p.key for p in one.preempted} == {("u", "nb")}
    assert [a.key for a in one.admitted] == [("u", "w")]


# ---- admission ------------------------------------------------------------------


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
async def test_webhook_rejects_over_quota_and_over_ceiling(pkg, monkeypatch):
    m = modules(pkg)
    monkeypatch.setenv("KFTPU_FLEET", fleet_of(pkg, "pool-a:2x2:2"))
    quota = "gpuQuota" if pkg == PORT else "tpuQuota"
    kube = m.fakekube.FakeKube()
    m.webhooks.register_all(kube)
    await kube.create("Profile", {
        "apiVersion": "kubeflow.org/v1", "kind": "Profile",
        "metadata": {"name": "user"},
        "spec": {"owner": {"kind": "User", "name": "user@example.com"},
                 quota: 8}})
    with pytest.raises(m.errors.Invalid, match=quota):
        await kube.create("InferenceService", isvc(m, pkg, shape="4x4"))
    with pytest.raises(m.errors.Invalid, match="scaling floor"):
        await kube.create("InferenceService", isvc(
            m, pkg, min_replicas=3, max_replicas=3))
    with pytest.raises(m.errors.Invalid, match="ever be scheduled"):
        await kube.create("InferenceService", isvc(m, pkg, shape="none"))
    # maxReplicas above the ceiling is fine: surplus replicas queue.
    await kube.create("InferenceService", isvc(
        m, pkg, "ok", min_replicas=1, max_replicas=8))
    # UPDATEs are never capacity-checked.
    await kube.patch("InferenceService", "ok",
                     {"metadata": {"annotations": {"x": "y"}}}, "user")
    if pkg == PORT:
        with pytest.raises(Invalid, match="one replica needs 16 GPUs"):
            await kube.create("InferenceService", isvc(m, pkg, shape="4x4"))


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
async def test_webhook_validates_scaling_shape(pkg):
    m = modules(pkg)
    kube = m.fakekube.FakeKube()
    m.webhooks.register_all(kube)
    bad = isvc(m, pkg)
    bad["spec"]["scaling"] = {"minReplicas": 2, "maxReplicas": 1}
    with pytest.raises(m.errors.Invalid, match="maxReplicas"):
        await kube.create("InferenceService", bad)
    bad2 = m.isvcapi.new("svc", "user")
    bad2["spec"]["template"]["spec"]["containers"] = []
    with pytest.raises(m.errors.Invalid, match="containers"):
        await kube.create("InferenceService", bad2)


async def test_a_spec_tpu_inference_service_is_refused(monkeypatch):
    m = modules(PORT)
    kube = m.fakekube.FakeKube()
    m.webhooks.register_all(kube)
    tpu = modules(REFERENCE).isvcapi.new("svc", "user", accelerator="v5e",
                                         topology="2x2")
    with pytest.raises(Invalid, match="spec.tpu is not supported"):
        await kube.create("InferenceService", tpu)
    bad = isvcapi.new("svc", "user", accelerator="v5e", topology="2x2")
    with pytest.raises(Invalid, match="invalid spec.gpu"):
        await kube.create("InferenceService", bad)
    # With the serving switch off the kind has no admission at all, as
    # in the reference.
    monkeypatch.setenv("KFTPU_SERVING", "off")
    off = m.fakekube.FakeKube()
    m.webhooks.register_all(off)
    await off.create("InferenceService", isvcapi.new("x", "user"))


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
def test_replica_key_roundtrip(pkg):
    i = modules(pkg).isvcapi
    key = i.replica_key("ns", "my-svc", 3)
    assert key == ("ns", "my-svc#r3")
    assert i.parse_replica_key(key) == ("my-svc", 3)
    assert i.parse_replica_key(("ns", "a-notebook")) is None
    assert i.replica_sts_name("svc", 1) == "svc-r1"
    assert i.replica_sts_name("svc", 1, slice_id=2, num_slices=4) == \
        "svc-r1-s2"


def test_the_api_defaults_as_the_reference_outside_the_accelerator():
    ref, port = modules(REFERENCE).isvcapi, modules(PORT).isvcapi
    for kw in ({}, {"min_replicas": 2, "max_replicas": 3, "target_rate": 4.0,
                    "scale_to_zero_after": 60.0,
                    "checkpoint_path": "/models/m"}):
        a = ref.new("svc", "user", accelerator="v5e", topology="2x2", **kw)
        b = port.new("svc", "user", accelerator=H100, topology="1x4", **kw)
        for obj in (a, b):
            del obj["spec"]["template"]["spec"]["containers"][0]["name"]
        ref.default(a)
        port.default(b)
        assert a["spec"].pop("tpu") == {"accelerator": "v5e",
                                        "topology": "2x2"}
        assert b["spec"].pop("gpu") == {"accelerator": H100,
                                        "topology": "1x4"}
        assert a == b
        assert b["spec"]["template"]["spec"]["containers"][0] == {
            "name": "svc", "image": "kubeflow-tpu/jax-serve:latest"}
    assert port.multi_slice_of(port.new("s", "u")) == \
        MultiSlice.parse(H100, "1x1", 1)
    assert port.model_rates({"serving.kubeflow.org/model-rate-a": "2.5",
                             "serving.kubeflow.org/model-rate-b": "junk"}) \
        == {"a": 2.5}


# ---- status --------------------------------------------------------------------


async def test_controller_folds_engine_annotations_into_status():
    async def scenario(h):
        i = h.m.isvcapi
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, min_replicas=1, max_replicas=2, target_rate=8.0))
        await h.until(lambda: h.replica_admitted(0), "replica admission")
        await h.kube.patch("InferenceService", "svc", {"metadata": {
            "annotations": {
                i.KV_BLOCKS_SHORT_ANNOTATION: "4",
                i.MODEL_SWAP_ANNOTATION: "chat-7b",
                i.MODEL_SWAP_WARM_ANNOTATION: "true",
                i.MODEL_RATE_ANNOTATION_PREFIX + "chat-7b": "2.5",
                i.MODEL_RATE_ANNOTATION_PREFIX + "code-3b": "1.5"}}},
            "user")

        async def folded():
            s = serving_status(await isvc_of(h))
            return "models" in s and s

        s = await h.wait_for(folded, "the engine annotations folded")
        status = (await isvc_of(h))["status"]
        block = status.get("gpu" if h.pkg == PORT else "tpu")
        return ({k: s[k] for k in ("kvPressure", "modelSwap", "models")},
                sorted(block))

    fold, block = await run_both(scenario)
    assert fold == {"kvPressure": {"blocksShort": 4},
                    "modelSwap": {"model": "chat-7b", "warm": True},
                    "models": {"chat-7b": 2.5, "code-3b": 1.5}}
    assert block == ["accelerator", "chipsPerReplica", "hostsPerReplica",
                     "topology"]


async def test_controller_burn_rate_wiring_and_kill_switch():
    async def scenario(h):
        slo = h.m.serving.slo
        assert slo.current() is h.mgr.slo
        rates = [h.serving._serving_burn_rate()]
        for _ in range(10):
            h.mgr.slo.observe("serving_latency", 60.0)
        burn = h.serving._serving_burn_rate()
        rates.append(burn is not None and burn > 1.0)
        h.serving.opts.slo_autoscale = False      # the kill switch
        rates.append(h.serving._serving_burn_rate())
        return rates

    assert await run_both(scenario) == [0.0, True, None]


# ---- children against the reference's ------------------------------------------


def _scrub(node):
    if isinstance(node, dict):
        return {k: _scrub(v) for k, v in node.items() if k not in VOLATILE}
    if isinstance(node, list):
        return [_scrub(v) for v in node]
    return node


def _accel_env(name: str) -> bool:
    return name.startswith(("TPU_", "JAX_", "MEGASCALE_", "PET_")) or name in (
        "KFTPU_ACCELERATOR", "KFTPU_SLICE_PEERS")


def _strip_accelerator(obj: dict) -> dict:
    obj = copy.deepcopy(obj)
    if obj["kind"] == "StatefulSet":
        template = obj["spec"]["template"]
        spec = template["spec"]
        spec.pop("nodeSelector", None)
        for ctr in spec["containers"]:
            ctr["env"] = [e for e in ctr.get("env", [])
                          if not _accel_env(e["name"])]
            for bucket in (ctr.get("resources") or {}).values():
                for res in ACCEL_RESOURCES:
                    bucket.pop(res, None)
        for key in ACCEL_ANNOTATIONS:
            template["metadata"]["annotations"][key] = "<accelerator>"
    if obj["kind"] == "Service" and obj["spec"].get("clusterIP") == "None":
        obj["spec"]["ports"] = [p for p in obj["spec"]["ports"]
                                if p.get("name") not in RENDEZVOUS_PORTS]
    return obj


@pytest.mark.parametrize("shape,slices", [("2x2", 1), ("4x4", 1), ("2x2", 2)])
async def test_replica_children_equal_the_reference_outside_the_accelerator(
        shape, slices):
    async def scenario(h):
        await h.kube.create("InferenceService", isvc(
            h.m, h.pkg, shape=shape, min_replicas=1, max_replicas=1,
            num_slices=slices, checkpoint_path="/models/svc"))
        await h.until(lambda: h.replica_admitted(0), "replica 0")
        await h.settle()
        return {kind: _scrub(await h.kube.list(kind, "user"))
                for kind in ("StatefulSet", "Service")}

    got = {}
    for pkg in (REFERENCE, PORT):
        h = await make_harness(
            pkg, fleet=fleet_of(pkg, f"pool-a:{shape}:{slices}"),
            scheduler=SCHEDULER, serving=SERVING)
        try:
            got[pkg] = await scenario(h)
            pods = await h.kube.list("Pod", "user")
            got[pkg + "-pods"] = {p["metadata"]["name"]: {
                e["name"]: e.get("value")
                for e in p["spec"]["containers"][0]["env"]} for p in pods}
        finally:
            await h.stop()
    for kind in ("StatefulSet", "Service"):
        assert [_strip_accelerator(o) for o in got[PORT][kind]] == \
            [_strip_accelerator(o) for o in got[REFERENCE][kind]], kind

    # The accelerator leaves the comparison took out, from gpu/topology.py.
    # The nodes' hostnames are the replica's own pods (the reference's
    # name pods no replica has: ROADMAP queue 3).
    acc, topo = SHAPES[PORT][shape]
    ms = MultiSlice.parse(acc, topo, slices)
    gpu = ms.slice
    names = [isvcapi.replica_sts_name("svc", 0, slice_id=j,
                                      num_slices=slices)
             for j in range(slices)]
    hostnames = ms.worker_hostnames("svc-r0", "svc-workers", "user")
    assert [s["metadata"]["name"] for s in got[PORT]["StatefulSet"]] == names
    for j, sts in enumerate(got[PORT]["StatefulSet"]):
        template = sts["spec"]["template"]
        main = template["spec"]["containers"][0]
        assert sts["spec"]["replicas"] == gpu.num_hosts
        assert template["spec"]["nodeSelector"] == gpu.node_selectors()
        assert main["resources"] == {"requests": gpu.resource_requests(),
                                     "limits": gpu.resource_requests()}
        assert main["resources"]["requests"][GPU_RESOURCE] == str(
            gpu.chips_per_host)
        annotations = template["metadata"]["annotations"]
        assert {k: annotations[k] for k in ACCEL_ANNOTATIONS} == {
            "tpu.kubeflow.org/accelerator": acc,
            "tpu.kubeflow.org/topology": topo}
        static = ms.worker_env(j, 0, hostnames)
        for key in ("TPU_WORKER_ID", "PET_NODE_RANK"):
            static.pop(key)
        assert {k: v for k, v in env_of(sts).items() if _accel_env(k)} \
            == static
        assert env_of(sts)["KFTPU_RESTORE_CHECKPOINT_PATH"] == "/models/svc"
    pods = got[PORT + "-pods"]
    assert sorted(pods) == sorted(f"{n}-{k}" for n in names
                                  for k in range(gpu.num_hosts))
    for name, env in pods.items():
        sts_name, _, ordinal = name.rpartition("-")
        j = names.index(sts_name)
        assert (env["TPU_WORKER_ID"], env["PET_NODE_RANK"]) == (
            ordinal, str(j * gpu.num_hosts + int(ordinal)))
        assert env["PET_MASTER_ADDR"] == (
            LOOPBACK_ADDR if ms.total_hosts == 1 else hostnames[0][0])
        assert env["TPU_WORKER_HOSTNAMES"].split(",") == [
            f"{sts_name}-{k}.svc-workers.user.svc.cluster.local"
            for k in range(gpu.num_hosts)]
    headless = [s for s in got[PORT]["Service"]
                if s["spec"].get("clusterIP") == "None"]
    ref_headless = [s for s in got[REFERENCE]["Service"]
                    if s["spec"].get("clusterIP") == "None"]
    if ms.total_hosts > 1:
        assert [s["spec"]["ports"] for s in headless] == [
            [{"name": "torch-rdzv", "port": MASTER_PORT, "protocol": "TCP"}]]
        assert [s["spec"]["ports"] for s in ref_headless] == [
            [{"name": "jax", "port": 8471, "protocol": "TCP"}]]
    else:
        assert headless == ref_headless == []
