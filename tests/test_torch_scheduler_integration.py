"""The GPU fleet scheduler wired into the port's control plane, over the
fake apiserver, the admission chain, the notebook controller and the pod
simulator (``tests/torch_control.py``): gang queue → admit, priority
preemption to a checkpoint (drain, an SDK-shaped ack, park, re-admission
with the restore env), the ack-less victim's hard stop driven by the
scheduler's clock, spot reclaim, flex placement on the lender's nodes,
the webhook's fleet fast-fail, and the ``KFTPU_SCHEDULER=off`` switch.

No case sleeps against a grace or a TTL: the scheduler's ``_now`` is a
clock the test moves, and the controller is woken by an enqueue.
"""

import pytest

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.gpu.topology import (GKE_ACCELERATOR_LABEL,
                                             GPU_RESOURCE, LOOPBACK_ADDR)
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import annotations_of, deep_get
from kubeflow_tpu_torch.scheduler import (Fleet, GpuFleetScheduler,
                                          SchedulerOptions)
from kubeflow_tpu_torch.scheduler.elastic import (RECLAIM_TAINTS,
                                                  SPOT_RECLAIM_REASON)
from kubeflow_tpu_torch.scheduler.fleet import (GKE_NODEPOOL_LABEL,
                                                GKE_SPOT_LABEL)
from torch_control import clear_kftpu_env, make_harness

H100 = "nvidia-h100-80gb"


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


class Clock:
    """The scheduler's ``now``, moved by the test."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


async def _stack(fleet: str, clock: Clock | None = None, **options):
    holder = {}

    def wire(kube, mgr):
        sched = GpuFleetScheduler(
            kube, SchedulerOptions(queued_requeue_seconds=0.05, **options),
            fleet=Fleet.parse(fleet), registry=mgr.registry)
        if clock is not None:
            sched._now = clock
        holder["sched"] = sched
        return {"scheduler": sched}

    h = await make_harness(wire=wire)
    h.sched = holder["sched"]
    return h


def _gpu_nb(name, topology="1x8", *, priority=None, num_slices=1):
    nb = nbapi.new(name, "ns", accelerator=H100, topology=topology,
                   num_slices=num_slices)
    if priority:
        nb["metadata"].setdefault("annotations", {})[
            nbapi.PRIORITY_ANNOTATION] = priority
    return nb


async def _state(h, name):
    nb = await h.kube.get("Notebook", name, "ns")
    return deep_get(nb, "status", "scheduler", "state")


async def _sts(h, name):
    return await h.kube.get_or_none("StatefulSet", name, "ns")


def _main(sts):
    return sts["spec"]["template"]["spec"]["containers"][0]


async def _ack(h, name, path="/ckpt/train", step=3):
    """What the SDK's CheckpointGuard patches onto its CR after the
    drain's snapshot: the ack, echoing the request it answers."""
    ann = await h.annotations(name)
    await h.kube.patch("Notebook", name, {"metadata": {"annotations": {
        **migration.ack_patch(
            path, step, h.sched._now(),
            for_request=ann[nbapi.DRAIN_REQUESTED_ANNOTATION]),
        **migration.commit_patch(
            h.sched._now(),
            for_request=ann[nbapi.DRAIN_REQUESTED_ANNOTATION])}}}, "ns")


async def test_a_gang_queues_then_admits_when_the_cards_come_free():
    h = await _stack(f"a={H100}:1x8:1")
    try:
        await h.kube.create("Notebook", _gpu_nb("first"))
        await h.settle()
        assert await _state(h, "first") == "Admitted"
        sts = await _sts(h, "first")
        assert _main(sts)["resources"]["requests"] == {GPU_RESOURCE: "8"}
        assert nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION in \
            await h.annotations("first")

        await h.kube.create("Notebook", _gpu_nb("second"))
        await h.settle()
        nb = await h.kube.get("Notebook", "second", "ns")
        block = deep_get(nb, "status", "scheduler")
        assert block["state"] == "Queued" and block["position"] == 1
        assert block["waitingChips"] == 8
        assert block["reason"] == (
            f"waiting for 8 chips (1x {H100}:1x8)")
        cond = nb["status"]["conditions"][0]
        assert (cond["type"], cond["reason"], cond["message"]) == (
            "Queued", "GpuFleetScheduler", "position 1, waiting for 8 GPUs")
        assert await _sts(h, "second") is None
        events = [e["message"] for e in await h.kube.list("Event", "ns")
                  if e["reason"] in ("Queued", "Admitted")]
        assert any(m.startswith("Queued for GPU capacity (position 1)")
                   for m in events)

        await h.kube.delete("Notebook", "first", "ns")
        await h.wait_for(
            lambda: _is(h, "second", "Admitted"), "second admitted")
        await h.settle()
        assert await _sts(h, "second") is not None
        assert any(m.startswith("Admitted by the GPU fleet scheduler")
                   for m in [e["message"] for e in
                             await h.kube.list("Event", "ns")])
        assert h.sched.policy.ledger.ns_chips == {"ns": 8}
        h.sched.policy.ledger.assert_consistent()
    finally:
        await h.stop()


async def _is(h, name, state):
    return await _state(h, name) == state


async def test_priority_preemption_drains_parks_and_readmits_with_restore():
    h = await _stack(f"a={H100}:1x8:1", enable_migration=True,
                     drain_grace_seconds=600.0, commit_grace_seconds=600.0)
    try:
        await h.kube.create("Notebook", _gpu_nb("train", priority="low"))
        await h.settle()
        assert await _state(h, "train") == "Admitted"

        await h.kube.create("Notebook", _gpu_nb("urgent", priority="high"))
        await h.wait_for(
            lambda: _drain_reason(h, "train"), "drain requested on train")
        assert (await h.annotations("train"))[
            nbapi.DRAIN_REASON_ANNOTATION] == "preempt:priority"
        # The waiter's status lands at the end of the reconcile that
        # stamped the drain.
        await h.wait_for(lambda: _is(h, "urgent", "Queued"), "urgent queued")
        # The victim keeps its cards while it checkpoints.
        assert h.sched.policy.ledger.allocations[("ns", "train")].draining

        await _ack(h, "train", step=3)
        await h.wait_for(lambda: _is(h, "urgent", "Admitted"),
                         "urgent admitted after the ack")
        await h.settle()
        ann = await h.annotations("train")
        assert nbapi.STOP_ANNOTATION in ann
        assert ann[nbapi.CHECKPOINT_PATH_ANNOTATION] == "/ckpt/train"
        assert (await _sts(h, "train"))["spec"]["replicas"] == 0
        assert ("ns", "train") not in h.sched.policy.ledger.allocations
        assert _main(await _sts(h, "urgent"))["resources"]["requests"] == {
            GPU_RESOURCE: "8"}

        # The user restarts the victim: it queues behind the waiter, and
        # takes the node back once the waiter is gone.
        await h.kube.patch("Notebook", "train", {"metadata": {"annotations": {
            nbapi.STOP_ANNOTATION: None}}}, "ns")
        await h.wait_for(lambda: _is(h, "train", "Queued"), "train queued")
        await h.kube.delete("Notebook", "urgent", "ns")
        await h.wait_for(lambda: _is(h, "train", "Admitted"),
                         "train re-admitted")
        await h.settle()
        env = {e["name"]: e.get("value")
               for e in _main(await _sts(h, "train"))["env"]}
        assert env[migration.RESTORE_PATH_ENV] == "/ckpt/train"
        assert env[migration.RESTORE_STEP_ENV] == "3"
        pod_env = await h.pod_env("train-0")
        assert pod_env[migration.RESTORE_PATH_ENV] == "/ckpt/train"
        assert pod_env["PET_MASTER_ADDR"] == LOOPBACK_ADDR
        assert h.sched.m_drain_fallback.labels().value == 0
        assert h.sched.policy.ledger.violations == 0
        h.sched.policy.ledger.assert_consistent()
    finally:
        await h.stop()


async def _drain_reason(h, name):
    return (await h.annotations(name)).get(nbapi.DRAIN_REASON_ANNOTATION)


async def test_an_ackless_victim_is_hard_stopped_at_the_deadline():
    clock = Clock()
    h = await _stack(f"a={H100}:1x8:1", clock, enable_migration=True,
                     drain_grace_seconds=30.0)
    try:
        await h.kube.create("Notebook", _gpu_nb("mute", priority="low"))
        await h.settle()
        await h.kube.create("Notebook", _gpu_nb("urgent", priority="high"))
        await h.wait_for(lambda: _drain_reason(h, "mute"), "drain requested")
        await h.settle()
        # Inside the grace: nothing moves, however often it reconciles.
        clock.t += 29.0
        h.mgr.enqueue("notebook", ("ns", "mute"))
        await h.settle()
        assert await _state(h, "urgent") == "Queued"
        assert h.sched.m_drain_fallback.labels().value == 0
        # Past the deadline, the next reconcile stops it without a
        # checkpoint and the waiter takes the node.
        clock.t += 2.0
        h.mgr.enqueue("notebook", ("ns", "mute"))
        await h.wait_for(lambda: _is(h, "urgent", "Admitted"),
                         "urgent admitted after the hard stop")
        await h.settle()
        assert h.sched.m_drain_fallback.labels().value == 1
        ann = await h.annotations("mute")
        assert nbapi.STOP_ANNOTATION in ann
        assert nbapi.CHECKPOINT_PATH_ANNOTATION not in ann
        assert (await _sts(h, "mute"))["spec"]["replicas"] == 0
        h.sched.policy.ledger.assert_consistent()
    finally:
        await h.stop()


async def test_spot_reclaim_drains_requeues_and_readmits():
    h = await _stack(f"res={H100}:1x8:1,cheap={H100}:1x8:1:spot",
                     enable_migration=True, drain_grace_seconds=600.0,
                     commit_grace_seconds=600.0, enable_elastic=True,
                     fleet_refresh_seconds=0.05)
    try:
        await h.kube.create("Node", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "cheap-0", "labels": {
                GKE_NODEPOOL_LABEL: "cheap", GKE_SPOT_LABEL: "true",
                GKE_ACCELERATOR_LABEL: H100}}})
        for name in ("a", "b"):
            await h.kube.create("Notebook", _gpu_nb(name, priority="low"))
        await h.settle()
        ledger = h.sched.policy.ledger
        ledger.assert_consistent()
        victim = next(k for k, v in ledger.allocations.items()
                      if "cheap" in v.placements)
        priority = ledger.allocations[victim].priority
        await h.kube.patch("Node", "cheap-0", {"spec": {"taints": [
            {"key": RECLAIM_TAINTS[0], "effect": "NoSchedule"}]}})
        await h.wait_for(lambda: _drain_reason(h, victim[1]),
                         "reclaim drain requested")
        assert await _drain_reason(h, victim[1]) == SPOT_RECLAIM_REASON
        ledger.assert_consistent()
        await _ack(h, victim[1], path=f"/ckpt/{victim[1]}")
        await h.wait_for(lambda: _pending(h, victim), "victim re-queued")
        await h.settle()
        ledger.assert_consistent()
        assert h.sched.policy.pending[victim].priority == priority == -100
        assert "cheap" in ledger.unavailable
        nb = await h.kube.get("Notebook", victim[1], "ns")
        assert deep_get(nb, "status", "scheduler", "reclaimed") == \
            SPOT_RECLAIM_REASON
        assert nbapi.STOP_ANNOTATION not in annotations_of(nb)
        # The signal clears: the pool re-opens and the gang restores.
        await h.kube.patch("Node", "cheap-0", {"spec": {"taints": None}})
        await h.wait_for(lambda: _is(h, victim[1], "Admitted"),
                         "victim re-admitted")
        await h.settle()
        env = {e["name"]: e.get("value")
               for e in _main(await _sts(h, victim[1]))["env"]}
        assert env[migration.RESTORE_PATH_ENV] == f"/ckpt/{victim[1]}"
        assert h.sched.m_spot_reclaims.labels().value == 1
        assert ledger.violations == 0
        ledger.assert_consistent()
    finally:
        await h.stop()


async def _pending(h, key):
    return key in h.sched.policy.pending


async def test_a_flex_gang_runs_on_the_lender_pools_nodes():
    h = await _stack(f"pack={H100}:2x8:1", enable_elastic=True)
    try:
        await h.kube.create("Notebook", _gpu_nb("tiny", "1x1"))
        await h.settle()
        assert await _state(h, "tiny") == "Admitted"
        assert h.sched.policy.ledger.borrowed == {"pack": 1}
        assert (await h.annotations("tiny"))[
            nbapi.FLEX_POOL_ANNOTATION] == "pack"
        spec = (await _sts(h, "tiny"))["spec"]["template"]["spec"]
        assert spec["nodeSelector"] == {GKE_ACCELERATOR_LABEL: H100,
                                        GKE_NODEPOOL_LABEL: "pack"}
        assert spec["containers"][0]["resources"]["requests"] == {
            GPU_RESOURCE: "1"}
        assert h.sched.flex_node_selectors(("ns", "tiny")) == \
            spec["nodeSelector"]
        # A flex gang is one node: its rendezvous is its own loopback.
        assert (await h.pod_env("tiny-0"))["PET_MASTER_ADDR"] == LOOPBACK_ADDR
        # The whole node is booked: the 2x8 slice it broke sells nothing.
        await h.kube.create("Notebook", _gpu_nb("big", "2x8"))
        await h.settle()
        assert await _state(h, "big") == "Queued"
        h.sched.policy.ledger.assert_consistent()
    finally:
        await h.stop()


async def test_the_webhook_fast_fails_a_gang_the_fleet_can_never_hold(
        monkeypatch):
    monkeypatch.setenv("KFTPU_FLEET", f"a={H100}:1x8:1")
    monkeypatch.setenv("KFTPU_ELASTIC", "off")
    h = await make_harness()
    try:
        assert h.rec._scheduler.active
        with pytest.raises(Invalid, match=(
                f"can never be scheduled — no configured node pool hosts "
                f"{H100}:2x8 slices")):
            await h.kube.create("Notebook", _gpu_nb("big", "2x8"))
        with pytest.raises(Invalid, match="the fleet holds at most 1 "
                           f"{H100}:1x8 slice"):
            await h.kube.create("Notebook", _gpu_nb("two", num_slices=2))
        with pytest.raises(Invalid, match="reduce spec.gpu.numSlices"):
            await h.kube.create("Notebook", _gpu_nb("tiny", "1x1"))
        # With the elastic fleet on, a one-node gang that can borrow a
        # node of the pool passes the ceiling.
        monkeypatch.setenv("KFTPU_ELASTIC", "on")
        await h.kube.create("Notebook", _gpu_nb("tiny", "1x1"))
        assert await h.kube.get("Notebook", "tiny", "ns")
    finally:
        await h.stop()


async def test_scheduler_off_restores_the_pre_scheduler_gate(monkeypatch):
    monkeypatch.setenv("KFTPU_FLEET", f"a={H100}:1x8:1")
    monkeypatch.setenv("KFTPU_SCHEDULER", "off")
    h = await make_harness()
    try:
        assert h.rec._scheduler is None
        # Neither the webhook's ceiling nor a queue: both gangs spawn.
        for name, topology in (("one", "1x8"), ("two", "2x8")):
            await h.kube.create("Notebook", _gpu_nb(name, topology))
        await h.settle()
        for name in ("one", "two"):
            nb = await h.kube.get("Notebook", name, "ns")
            assert deep_get(nb, "status", "scheduler") is None
            assert (await _sts(h, name))["spec"]["replicas"] >= 1
    finally:
        await h.stop()


async def test_with_no_fleet_the_scheduler_makes_no_api_writes():
    """No KFTPU_FLEET: the scheduler the setup builds from the env is a
    pass-through, and a spawn makes the same kinds of API request (verb
    and kind) as one with no scheduler at all: no Event, no annotation
    patch and no read of a fleet source of its own."""
    counts = []
    for wire in (None, lambda kube, mgr: {"scheduler": None}):
        h = await make_harness(wire=wire)
        try:
            assert (h.rec._scheduler is None) == (wire is not None)
            await h.kube.create("Notebook", _gpu_nb("nb"))
            await h.settle()
            assert deep_get(await h.kube.get("Notebook", "nb", "ns"),
                            "status", "scheduler") is None
            counts.append({(e["verb"], e["kind"]) for e in h.kube.request_log})
        finally:
            await h.stop()
    assert counts[0] == counts[1]
