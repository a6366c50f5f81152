"""The port's chaos harness (``kubeflow_tpu_torch/testing/chaos.py``) held
to the reference's: ``check_invariants`` of both packages on stacks built
from each with the fleet scheduler and a warm pod pool — a converged stack
first, then the same hand-made violations — and both packages'
shard-kill and poison-pill scenarios.

Shapes map as in tests/test_torch_scheduler_parity.py: v5e ``2x2`` →
H100 ``1x4`` (a slice keeps its card count).

Last, faults of the reference, fixed in the port: three kept its soak
from settling under load (a queued gang's scale-up wait written to its
status at millisecond precision, so every status write re-enqueued it:
a reconcile loop; a StatefulSet pod that a warm-pool claim adopted and
deleted never coming back in the kubelet simulator; and a pod whose
delete the simulator's watch missed never coming back either), and the
shard kill could strike before the shard ring had settled. The port's
soak also counts a commit that lands while its restore check waits for
the uploads."""

import asyncio
import importlib

import pytest

from torch_control import PORT, REFERENCE, clear_kftpu_env, make_harness

SHAPES = {REFERENCE: ("v5e", "2x2"), PORT: ("nvidia-h100-80gb", "1x4")}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


def chaos(pkg):
    return importlib.import_module(f"{pkg}.testing.chaos")


def _as_port(problems: list, pkg: str, names: dict) -> list:
    """A package's problems in the port's words: "TPU" read as "GPU",
    the shape and the warm pods' names read as the port's."""
    acc, topo = SHAPES[pkg]
    out = []
    for p in problems:
        for old, new in names.items():
            p = p.replace(old, new)
        out.append(p.replace("TPU", "GPU").replace(
            f"{acc}:{topo}", ":".join(SHAPES[PORT])))
    return out


async def _stack(pkg):
    acc, topo = SHAPES[pkg]
    scheduler = importlib.import_module(f"{pkg}.scheduler")
    warmpool = importlib.import_module(f"{pkg}.controllers.warmpool")
    Sched = getattr(scheduler, "GpuFleetScheduler", None) or \
        scheduler.TpuFleetScheduler
    held = {}

    def wire(kube, mgr):
        sched = Sched(kube, scheduler.SchedulerOptions(
            fleet_spec=f"a={acc}:{topo}:4"), registry=mgr.registry)
        wp = warmpool.WarmPoolManager(kube, warmpool.WarmPoolOptions(
            spec=f"ns/img:latest@{acc}:{topo}:1", replenish_seconds=0.05),
            registry=mgr.registry)
        held.update(sched=sched, wp=wp)
        return {"scheduler": sched, "warmpool": wp}

    h = await make_harness(pkg, wire=wire)
    h.sched, h.wp = held["sched"], held["wp"]
    return h


async def _invariant_trace(pkg) -> tuple[list, list]:
    """``check_invariants`` on a converged stack of ``pkg``, then on the
    same stack with five violations made by hand (the manager stopped,
    so nothing repairs them)."""
    m = chaos(pkg)
    acc, topo = SHAPES[pkg]
    h = await _stack(pkg)
    try:
        # A cold gang and a warm-eligible one that claims the pool's pod.
        await h.kube.create("Notebook", h.m.nbapi.new(
            "nb-0", "ns", accelerator=acc, topology=topo))
        await h.kube.create("Notebook", h.m.nbapi.new(
            "nb-1", "ns", image="img:latest", accelerator=acc,
            topology=topo))

        async def converged():
            nbs = [await h.kube.get("Notebook", n, "ns")
                   for n in ("nb-0", "nb-1")]
            ready = all(h.m.objects.deep_get(
                nb, "status", "readyReplicas", default=0) for nb in nbs)
            claimed = h.m.objects.annotations_of(nbs[1]).get(
                h.m.nbapi.WARM_CLAIMED_ANNOTATION)
            return ready and claimed and not await m.check_invariants(
                h.kube, h.mgr, h.sched, h.wp)

        await h.wait_for(converged, "converged", timeout=20.0)
        await h.settle()
        clean = await m.check_invariants(h.kube, h.mgr, h.sched, h.wp)
        h.wp.stop()
        await h.sim.stop()
        await h.mgr.stop()

        nb0 = await h.kube.get("Notebook", "nb-0", "ns")
        nb1 = await h.kube.get("Notebook", "nb-1", "ns")
        warm_pod = h.m.objects.annotations_of(nb1)[
            h.m.nbapi.WARM_CLAIMED_ANNOTATION]
        key = ("ns", "nb-0")
        # (1) a gang stamped both Admitted and Queued;
        assert key in h.sched.policy.ledger.allocations
        h.sched.policy.pending[key] = object()
        # (2) a duplicate slice StatefulSet and (3) an orphaned one;
        for name, uid in (("nb-0-dup", nb0["metadata"]["uid"]),
                          ("ghost", "no-such-uid")):
            await h.kube.create("StatefulSet", {
                "apiVersion": "apps/v1", "kind": "StatefulSet",
                "metadata": {"name": name, "namespace": "ns",
                             "ownerReferences": [{
                                 "apiVersion": "kubeflow.org/v1",
                                 "kind": "Notebook", "name": "gone",
                                 "uid": uid, "controller": True}]},
                "spec": {"replicas": 0}})
        # (4) a warm pod claimed by two notebooks;
        await h.kube.patch("Notebook", "nb-0", {"metadata": {"annotations": {
            h.m.nbapi.WARM_CLAIMED_ANNOTATION: warm_pod}}}, "ns")
        # (5) a drain left in flight.
        h.sched._draining[key] = object()
        broken = await m.check_invariants(h.kube, h.mgr, h.sched, h.wp)
        return clean, _as_port(broken, pkg, {warm_pod: "<warm-pod>"})
    finally:
        h.wp.stop()
        await h.stop()


def test_the_soak_keeps_the_references_bounds_and_rates():
    """Every field of ``SoakConfig`` but the two accelerator strings is
    the reference's, and those name the same shapes in cards."""
    import dataclasses

    ref, port = (dataclasses.asdict(chaos(pkg).SoakConfig())
                 for pkg in (REFERENCE, PORT))
    accel = ("fleet", "warm_pools")
    assert {k: v for k, v in port.items() if k not in accel} == \
        {k: v for k, v in ref.items() if k not in accel}
    for key in accel:
        assert ref[key].replace("v5e:4x4", "nvidia-h100-80gb:2x8").replace(
            "v5e:2x2", "nvidia-h100-80gb:1x4") == port[key]


def test_check_invariants_agree_on_a_converged_stack_and_on_violations():
    ref_clean, ref = asyncio.run(_invariant_trace(REFERENCE))
    port_clean, port = asyncio.run(_invariant_trace(PORT))
    assert ref_clean == [] and port_clean == []
    assert port == ref
    joined = "\n".join(port)
    for want in ("gangs both Admitted and Queued: [('ns', 'nb-0')]",
                 "non-terminal drains: [('ns', 'nb-0')]",
                 "duplicate/stale slice StatefulSet ns/nb-0-dup for "
                 "('ns', 'nb-0')",
                 "orphan StatefulSet ns/ghost: owner Notebook gone",
                 "pod ns/<warm-pod> claimed by two Notebooks: "
                 "['nb-0', 'nb-1']",
                 "Queued gang ('ns', 'nb-0') owns scaled-up StatefulSets"):
        assert want in joined, (want, port)


def test_shard_kill_scenario_passes_in_both_packages():
    outs = {pkg: asyncio.run(chaos(pkg).shard_kill_scenario(
        seed=0, replicas=3)) for pkg in (REFERENCE, PORT)}
    for pkg, out in outs.items():
        assert out["pass"], (pkg, out)
        assert out["dropped_keys"] == [], (pkg, out)
        assert out["ownership_disjoint"], (pkg, out)
    assert sorted(outs[PORT]) == sorted(outs[REFERENCE])
    # The namespaces, the victim and its shards come from crc32 of the
    # names alone: both packages kill the same replica.
    for k in ("namespaces", "notebooks", "victim_replica", "victim_shards",
              "post_kill_created", "pre_kill_ready"):
        assert outs[PORT][k] == outs[REFERENCE][k], k


def test_poison_scenario_gives_the_same_booleans_in_both_packages():
    outs = {pkg: asyncio.run(chaos(pkg).poison_scenario(seed=0))
            for pkg in (REFERENCE, PORT)}
    assert outs[PORT]["pass"] and outs[REFERENCE]["pass"]
    assert outs[PORT] == outs[REFERENCE]


async def _status_writes_while_waiting_for_scale_up() -> tuple:
    h = await make_harness(PORT, fleet="a=nvidia-h100-80gb:2x8:1", scheduler={
        "enable_elastic": True, "queued_requeue_seconds": 0.05,
        "scale_up_ttl_seconds": 30.0})
    try:
        await h.kube.create("Notebook", h.m.nbapi.new(
            "big", "ns", accelerator="nvidia-h100-80gb", topology="2x8",
            num_slices=3))

        async def waiting():
            nb = await h.kube.get("Notebook", "big", "ns")
            return h.m.objects.deep_get(nb, "status", "scheduler", "scaleUp")

        await h.wait_for(waiting, "the scale-up wait in the status")
        writes = []

        async def count():
            async for event, nb in h.kube.watch(
                    "Notebook", "ns", send_initial=False):
                if event == "MODIFIED" and nb["metadata"]["name"] == "big":
                    writes.append(nb["status"]["scheduler"]["scaleUp"])

        counter = asyncio.create_task(count())
        await asyncio.sleep(1.5)
        counter.cancel()
        await asyncio.gather(counter, return_exceptions=True)
        return writes, await waiting()
    finally:
        await h.stop()


def test_a_gang_waiting_for_scale_up_is_written_once_a_second():
    """The wait is whole seconds (what the JWA shows), so a queued gang's
    status changes once a second, not on every 0.05 s refresh."""
    writes, block = asyncio.run(_status_writes_while_waiting_for_scale_up())
    assert block["chips"] > 0
    assert isinstance(block["pendingSeconds"], int)
    assert len(writes) <= 3, writes


async def _pod_back_after_adoption() -> dict:
    from kubeflow_tpu_torch.runtime.objects import controller_owner

    h = await make_harness(PORT)
    try:
        sts = await h.kube.create("StatefulSet", {
            "apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": "slot", "namespace": "ns"},
            "spec": {"replicas": 1, "template": {"spec": {"containers": [
                {"name": "c", "image": "img:latest"}]}}}})

        async def pod():
            return await h.kube.get_or_none("Pod", "slot-0", "ns")

        await h.wait_for(pod, "the slot's pod")
        # A warm claim re-owns the pod into a notebook; the notebook's
        # stop deletes it while the slot's StatefulSet lives on.
        await h.kube.patch("Pod", "slot-0", {"metadata": {
            "ownerReferences": [controller_owner({
                "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
                "metadata": {"name": "nb", "uid": "nb-uid"}})]}}, "ns")
        await h.kube.delete("Pod", "slot-0", "ns")

        async def recreated():
            p = await pod()
            return p if p and p["metadata"]["ownerReferences"][0][
                "uid"] == sts["metadata"]["uid"] else None

        return await h.wait_for(recreated, "the slot's pod recreated",
                                timeout=5.0)
    finally:
        await h.stop()


def test_a_statefulset_pod_adopted_then_deleted_is_recreated():
    pod = asyncio.run(_pod_back_after_adoption())
    assert pod["metadata"]["ownerReferences"][0]["kind"] == "StatefulSet"


async def _pod_after_a_missed_delete(pkg) -> tuple:
    """A StatefulSet's pod deleted while the simulator's pod watch is not
    running (a watch gap: a re-watch replays what exists, never what
    went), then the workload reconciled again: (the pod before the
    delete, the pod after)."""
    fakekube = importlib.import_module(f"{pkg}.testing.fakekube")
    podsim = importlib.import_module(f"{pkg}.testing.podsim")
    kube = fakekube.FakeKube()
    sim = podsim.PodSimulator(kube)
    sim._running = True                  # reconcile by hand, no watches
    try:
        sts = await kube.create("StatefulSet", {
            "apiVersion": "apps/v1", "kind": "StatefulSet",
            "metadata": {"name": "slot", "namespace": "ns"},
            "spec": {"replicas": 1, "template": {"spec": {"containers": [
                {"name": "c", "image": "img:latest"}]}}}})
        await sim._reconcile_workload("StatefulSet", sts)
        while sim._pods_in_flight:       # the pod's start runs to its end
            await asyncio.sleep(0.01)
        before = await kube.get_or_none("Pod", "slot-0", "ns")
        await kube.delete("Pod", "slot-0", "ns")
        await sim._reconcile_workload("StatefulSet", sts)
        return before, await kube.get_or_none("Pod", "slot-0", "ns")
    finally:
        await sim.stop()


@pytest.mark.parametrize("pkg", [REFERENCE, PORT])
def test_a_pod_whose_delete_the_simulator_missed_is_recreated(pkg):
    """The fault that wedged a warm pool's slot without a pod for the
    soak's whole 30 s convergence (chip_smoke.py's ``chaos`` phase on the
    card, and 1 of 120 seed-0 soaks on the CPU under load)."""
    before, after = asyncio.run(_pod_after_a_missed_delete(pkg))
    assert before is not None
    if pkg == REFERENCE:
        assert after is None             # the reference's simulator's fault
    else:
        assert after is not None
        assert after["metadata"]["ownerReferences"][0]["name"] == "slot"


async def _restore_check_with_a_commit_in_its_wait() -> tuple:
    """The soak's restore check on a fabric whose step 1 the harness has
    recorded and whose step 2 was saved and not yet recorded (the commit
    poller has not ticked): what the check reports, and the step the
    fabric restored."""
    m = chaos(PORT)
    soak = m.ChaosSoak(m.SoakConfig(seed=0))
    key = ("team-0", "nb")
    fab = soak._fabric_for(key)
    soak._save(fab, key, 1)
    fab.wait()
    soak._committed_steps[key] = {1}
    soak._pending_commits[key] = [(soak._save(fab, key, 2), 2, None)]
    problems = await soak._check_restores()
    return problems, fab.last_restore["step"]


def test_the_restore_check_counts_a_commit_that_lands_in_its_wait():
    problems, restored = asyncio.run(
        _restore_check_with_a_commit_in_its_wait())
    assert restored == 2
    assert problems == []


def test_shard_kill_waits_for_a_late_replica_to_take_its_shard(monkeypatch):
    """A replica whose ring ticks late (a cold start, a starved loop)
    finds its preferred shard absorbed and claims it back, and the
    notebooks can converge before it holds it again. The port's scenario
    kills only once every replica holds its own slice, so the victim
    still has a shard to lose and every shard is owned after the kill."""
    import time

    from kubeflow_tpu_torch.runtime.sharding import ShardRing

    tick, stalled = ShardRing.tick, {}

    async def late_tick(self):
        # The victim (replica 2 of 3) skips its ticks for its first 1.5 s.
        if self.replica == 2:
            t0 = stalled.setdefault(id(self), time.monotonic())
            if time.monotonic() - t0 < 1.5:
                return
        await tick(self)

    monkeypatch.setattr(ShardRing, "tick", late_tick)
    out = asyncio.run(chaos(PORT).shard_kill_scenario(seed=0, replicas=3))
    assert out["victim_replica"] == 2
    assert out["victim_shards"] == [2], out
    assert out["all_shards_owned"] and out["pass"], out
