"""The port's warm pod pools (``kubeflow_tpu_torch/controllers/
warmpool.py``) on GPU nodes, over the fake apiserver with the GPU fleet
scheduler: the spec grammar, slot creation and the replenisher, the CAS
claim race, adoption (labels, owner, injected env), the cold fallback of
an empty pool, the warm reservation as the scheduler's first victim, and
the slot StatefulSet held to the reference's outside its accelerator
fields.
"""

import asyncio
import copy
import time

import pytest

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.controllers.warmpool import (
    WarmPoolConfigError,
    WarmPoolManager,
    WarmPoolOptions,
    WarmPoolSpec,
    parse_warm_pools,
)
from kubeflow_tpu_torch.gpu.topology import GKE_ACCELERATOR_LABEL, GPU_RESOURCE
from kubeflow_tpu_torch.runtime import timeline as timeline_mod
from kubeflow_tpu_torch.runtime.objects import annotations_of, deep_get, fmt_iso
from kubeflow_tpu_torch.scheduler import (GpuFleetScheduler,
                                          SchedulerOptions)
from torch_control import clear_kftpu_env, make_harness

H100 = "nvidia-h100-80gb"


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


# ---- the spec grammar ----------------------------------------------------------


def test_parse_warm_pools_gpu_grammar():
    pools = parse_warm_pools(
        f"img:v1@{H100}:1x1:3, team-a/registry.io/repo/img:v2@{H100}:1x8:1",
        default_namespace="kubeflow-tpu")
    assert pools[0] == WarmPoolSpec("kubeflow-tpu", "img:v1", H100, "1x1", 3)
    assert (pools[1].namespace, pools[1].image, pools[1].topology) == (
        "team-a", "registry.io/repo/img:v2", "1x8")
    assert [p.topology for p in parse_warm_pools(
        ",".join(f"i{n}@{H100}:1x{n}:1" for n in (1, 2, 4, 8)),
        default_namespace="x")] == ["1x1", "1x2", "1x4", "1x8"]
    assert parse_warm_pools("", default_namespace="x") == ()


@pytest.mark.parametrize("spec,match", [
    (f"img@{H100}:1x8", "want"),
    (f"img@{H100}:1x8:abc", "not an integer"),
    ("img@v5e:2x2:1", "unknown accelerator"),
    (f"img@{H100}:1x8:1,img@{H100}:1x8:2", "duplicate warm pool"),
    # A warm pod IS the slice: a shape of two nodes cannot pre-warm.
    (f"img@{H100}:2x8:1", "only single-node shapes can pre-warm"),
])
def test_parse_warm_pools_rejects_garbage(spec, match):
    with pytest.raises(WarmPoolConfigError, match=match):
        parse_warm_pools(spec, default_namespace="x")


# ---- the stack -----------------------------------------------------------------


async def _stack(fleet=f"a={H100}:1x8:6", warm=f"ns/img:latest@{H100}:1x8:2",
                 migration=False):
    holder = {}

    def wire(kube, mgr):
        sched = GpuFleetScheduler(
            kube, SchedulerOptions(fleet_spec=fleet,
                                   enable_migration=migration,
                                   drain_grace_seconds=600.0),
            registry=mgr.registry) if fleet else None
        wp = WarmPoolManager(kube, WarmPoolOptions(
            spec=warm, replenish_seconds=0.05), registry=mgr.registry)
        holder.update(sched=sched, wp=wp)
        return {"scheduler": sched, "warmpool": wp}

    h = await make_harness(wire=wire)
    h.sched, h.wp = holder["sched"], holder["wp"]
    return h


async def _stop(h):
    h.wp.stop()
    await h.stop()


async def _ready_count(h, count):
    info = await h.wp.debug_info()
    return bool(info["pools"]) and info["pools"][0]["ready"] >= count


async def _pool_ready(h, count):
    await h.wait_for(lambda: _ready_count(h, count), f"{count} warm pods")


async def _nb_ready(h, name):
    async def ready():
        nb = await h.kube.get("Notebook", name, "ns")
        return nb if deep_get(nb, "status", "readyReplicas", default=0) \
            else None
    return await h.wait_for(ready, f"{name} Ready", timeout=20.0)


def _warm_nb(name, image="img:latest", topology="1x8"):
    return nbapi.new(name, "ns", image=image, accelerator=H100,
                     topology=topology)


async def test_slots_are_created_and_the_replenisher_tops_the_pool_up():
    h = await _stack()
    try:
        await _pool_ready(h, 2)
        pool = h.wp.pools[0]
        slots = await h.kube.list("StatefulSet", "ns", label_selector={
            "matchLabels": {keys.TPU_WARM_POOL_LABEL: pool.slug}})
        assert sorted(s["metadata"]["name"] for s in slots) == [
            f"{pool.slug}-p0", f"{pool.slug}-p1"]
        warm = [a for a in h.sched.policy.ledger.allocations.values()
                if a.workload == "warmpool"]
        assert len(warm) == 2 and all(a.chips == 8 for a in warm)
        await h.kube.create("Notebook", _warm_nb("nb"))
        await _nb_ready(h, "nb")
        # The claim consumed one slot; the replenisher builds another.
        await _pool_ready(h, 2)
        info = await h.wp.debug_info()
        assert info["pools"][0]["slots"] == 2
        assert h.sched.policy.ledger.violations == 0
        h.sched.policy.ledger.assert_consistent()
    finally:
        await _stop(h)


async def test_a_claim_adopts_the_pod_into_the_notebook():
    h = await _stack()
    try:
        await _pool_ready(h, 2)
        await h.kube.create("Notebook", _warm_nb("nb"))
        await _nb_ready(h, "nb")
        await h.settle()
        nb = await h.kube.get("Notebook", "nb", "ns")
        ann = annotations_of(nb)
        pod_name = ann[nbapi.WARM_CLAIMED_ANNOTATION]
        # No slice StatefulSet: the adopted pod IS the slice.
        assert await h.kube.get_or_none("StatefulSet", "nb", "ns") is None
        pod = await h.kube.get("Pod", pod_name, "ns")
        labels = pod["metadata"]["labels"]
        assert labels[nbapi.NOTEBOOK_NAME_LABEL] == "nb"
        assert labels["statefulset"] == "nb"
        assert labels["statefulset.kubernetes.io/pod-name"] == "nb-0"
        assert [r["kind"] for r in pod["metadata"]["ownerReferences"]] == [
            "Notebook"]
        assert annotations_of(pod)[keys.TPU_WARM_CLAIM].startswith("ns/nb/")
        env = {e["name"]: e.get("value")
               for e in pod["spec"]["containers"][0]["env"]}
        assert env["NB_PREFIX"] == "/notebook/ns/nb"
        assert pod["spec"]["containers"][0]["resources"]["requests"] == {
            GPU_RESOURCE: "8"}
        states = [e["state"] for e in timeline_mod.decode(ann)]
        assert timeline_mod.CLAIMED in states
        assert states[-1] == timeline_mod.READY
        assert deep_get(nb, "status", "gpu", "warmPool", "claimed") is True
        # The claim turned the slot's reservation into the gang's own
        # admission: one allocation for the notebook, the replenished
        # slots beside it.
        allocs = h.sched.policy.ledger.allocations
        assert allocs[("ns", "nb")].workload == "notebook"
        h.sched.policy.ledger.assert_consistent()
    finally:
        await _stop(h)


async def test_the_cas_claim_has_one_winner():
    """Two claimers (two controller replicas' pool managers) race the
    CAS on one pod: exactly one reads its own value back; and two
    notebooks racing a one-pod pool never adopt the same pod."""
    h = await _stack(warm=f"ns/img:latest@{H100}:1x8:1")
    try:
        await _pool_ready(h, 1)
        pool = h.wp.pools[0]
        pod = (await h.wp._claimable_pods(pool))[0]["metadata"]["name"]
        rival = WarmPoolManager(h.kube, WarmPoolOptions(
            spec=f"ns/img:latest@{H100}:1x8:1"))
        wins = await asyncio.gather(
            h.wp._cas_claim(pool, pod, "ns/a/1"),
            rival._cas_claim(pool, pod, "ns/b/1"))
        assert sorted(wins) == [False, True]
        winner = annotations_of(await h.kube.get("Pod", pod, "ns"))[
            keys.TPU_WARM_CLAIM]
        assert winner == ("ns/a/1" if wins[0] else "ns/b/1")
        # Free the pod again and race two notebooks for it.
        await h.kube.patch("Pod", pod, {"metadata": {"annotations": {
            keys.TPU_WARM_CLAIM: None}}}, "ns")
        await asyncio.gather(h.kube.create("Notebook", _warm_nb("race-a")),
                             h.kube.create("Notebook", _warm_nb("race-b")))
        await _nb_ready(h, "race-a")
        await _nb_ready(h, "race-b")
        await h.settle()
        claimed = [annotations_of(await h.kube.get("Notebook", n, "ns"))
                   .get(nbapi.WARM_CLAIMED_ANNOTATION)
                   for n in ("race-a", "race-b")]
        pods = [p for p in claimed if p]
        assert pods and len(pods) == len(set(pods))
        assert h.sched.policy.ledger.violations == 0
    finally:
        await _stop(h)


async def test_an_empty_pool_falls_back_to_the_cold_path():
    """A matching pool with no warm pod left must not wedge a notebook:
    it starts cold in the same reconcile."""
    h = await _stack(fleet=f"a={H100}:1x8:2")
    try:
        # The pool fills the fleet's two nodes; two notebooks claim both
        # pods, and the pool cannot refill (no free node).
        await _pool_ready(h, 2)
        for name in ("eat-1", "eat-2"):
            await h.kube.create("Notebook", _warm_nb(name))
            await _nb_ready(h, name)
        # A third queues; a stop frees a node, and the third starts cold.
        await h.kube.create("Notebook", _warm_nb("third"))
        await h.kube.patch("Notebook", "eat-1", {"metadata": {"annotations": {
            nbapi.STOP_ANNOTATION: fmt_iso(time.time())}}}, "ns")
        nb = await _nb_ready(h, "third")
        assert annotations_of(nb).get(nbapi.WARM_CLAIMED_ANNOTATION) is None
        assert await h.kube.get_or_none("StatefulSet", "third", "ns")
        assert h.wp.m_exhausted.labels(pool=h.wp.pools[0].slug).value >= 1
        assert h.sched.policy.ledger.violations == 0
    finally:
        await _stop(h)


async def test_the_warm_reservation_is_the_first_victim():
    """Under pressure the scheduler frees a warm slot's cards first —
    at once, with no drain — before any real gang, even an idle one,
    with preempt-to-checkpoint on."""
    h = await _stack(fleet=f"a={H100}:1x8:3", warm=f"ns/img:latest@{H100}:1x8:1",
                     migration=True)
    try:
        await _pool_ready(h, 1)
        for name in ("real-1", "real-2"):
            await h.kube.create("Notebook", _warm_nb(name, image="other:1"))
            await _nb_ready(h, name)
        await h.kube.patch("Notebook", "real-1", {"metadata": {"annotations": {
            nbapi.LAST_ACTIVITY_ANNOTATION: fmt_iso(time.time() - 7200)}}},
            "ns")
        allocs = h.sched.policy.ledger.allocations
        real = {k for k, a in allocs.items() if a.workload == "notebook"}
        await h.kube.create("Notebook", _warm_nb("real-3", image="other:1"))
        await _nb_ready(h, "real-3")
        assert real <= set(allocs)
        assert not any(a.draining for a in allocs.values())
        assert h.wp.m_reclaimed.labels().value >= 1
        assert (await h.wp.debug_info())["pools"][0]["ready"] == 0
        scheduler = h.sched.policy.debug_info(time.time())
        assert not [a for a in scheduler["admitted"]
                    if a.get("workload") == "warmpool"]
        assert h.sched.policy.ledger.violations == 0
        h.sched.policy.ledger.assert_consistent()
    finally:
        await _stop(h)


def _accelerator_free(sts: dict, slug: str, pkg: str) -> dict:
    """A slot StatefulSet without its accelerator fields: the node
    selector, the accelerator resource, the accelerator and shape
    annotations' values, the warm shim's package and the pool slug."""
    sts = copy.deepcopy(sts)
    tmpl = sts["spec"]["template"]
    spec = tmpl["spec"]
    spec.pop("nodeSelector")
    ctr = spec["containers"][0]
    for bucket in ctr["resources"].values():
        bucket.pop(GPU_RESOURCE, None)
        bucket.pop("google.com/tpu", None)
    assert ctr["command"] == ["python", "-m", f"{pkg}.sdk", "--warm-idle"]
    ctr["command"][2] = "<package>.sdk"
    for key in ("tpu.kubeflow.org/accelerator", "tpu.kubeflow.org/topology"):
        tmpl["metadata"]["annotations"][key] = "<accelerator>"
    return _replace(sts, slug, "<slug>")


def _replace(node, old, new):
    if isinstance(node, dict):
        return {_replace(k, old, new): _replace(v, old, new)
                for k, v in node.items()}
    if isinstance(node, list):
        return [_replace(v, old, new) for v in node]
    return node.replace(old, new) if isinstance(node, str) else node


def test_the_slot_statefulset_is_the_references_outside_its_accelerator():
    from kubeflow_tpu.controllers import warmpool as jax_warmpool

    gpu_wp = WarmPoolManager(None, WarmPoolOptions(
        spec=f"ns/img:latest@{H100}:1x8:1"))
    tpu_wp = jax_warmpool.WarmPoolManager(None, jax_warmpool.WarmPoolOptions(
        spec="ns/img:latest@v5e:2x4:1"))
    gpu_pool, = gpu_wp.pools
    tpu_pool, = tpu_wp.pools
    got = gpu_wp._slot_statefulset(gpu_pool, f"{gpu_pool.slug}-p0")
    ref = tpu_wp._slot_statefulset(tpu_pool, f"{tpu_pool.slug}-p0")
    assert _accelerator_free(got, gpu_pool.slug, "kubeflow_tpu_torch") == \
        _accelerator_free(ref, tpu_pool.slug, "kubeflow_tpu")
    spec = got["spec"]["template"]["spec"]
    assert spec["nodeSelector"] == {GKE_ACCELERATOR_LABEL: H100}
    assert spec["containers"][0]["resources"] == {
        "requests": {GPU_RESOURCE: "8"}, "limits": {GPU_RESOURCE: "8"}}
    assert got["spec"]["template"]["metadata"]["annotations"] == {
        "tpu.kubeflow.org/accelerator": H100,
        "tpu.kubeflow.org/topology": "1x8"}
    assert gpu_pool.slug.startswith(f"warm-img-{H100}-18-")
