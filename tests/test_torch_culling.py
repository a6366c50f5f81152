"""The port's culler (``kubeflow_tpu_torch/controllers/culling.py``)
against the reference's (``kubeflow_tpu/controllers/culling.py``).

Every case of tests/test_culling.py, and the cull-drain paths, runs once
on each package: the same Notebook (a ``spec.tpu`` slice for the
reference, the ``spec.gpu`` slice of as many nodes for the port), the
same scripted prober and the same ``FakeClock``. The two cullers must
write the same annotations, return the same requeue, probe the same URLs
and record the same Event reasons; each case then holds the port's
result to the reference test's own expectations.
"""

import pytest

from kubeflow_tpu_torch.controllers.culling import _fold_activity
from torch_control import PORT, REFERENCE, clear_kftpu_env, make_harness, modules

# The reference's TPU shape → the GPU shape of as many nodes (and, for
# these shapes, as many accelerators).
SHAPES = {REFERENCE: {"2x2": ("v5e", "2x2"), "4x4": ("v5e", "4x4")},
          PORT: {"2x2": ("nvidia-h100-80gb", "1x4"),
                 "4x4": ("nvidia-h100-80gb", "2x8")}}
T0 = 1_000_000.0


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


class FakeClock:
    def __init__(self, t=T0):
        self.t = t

    def __call__(self):
        return self.t


def make_prober(responses):
    """responses: dict url-suffix → payload; records requested URLs."""
    calls = []

    async def prober(url):
        calls.append(url)
        for suffix, payload in responses.items():
            if url.endswith(suffix):
                return payload
        return None

    prober.calls = calls
    return prober


def kernels(m, state, ts):
    return [{"execution_state": state,
             "last_activity": m.objects.fmt_iso(ts)}]


def notebook(m, pkg, name="nb", shape=None, annotations=None):
    kw = {}
    if shape is not None:
        acc, topo = SHAPES[pkg][shape]
        kw = {"accelerator": acc, "topology": topo}
    nb = m.nbapi.new(name, "ns", **kw)
    if annotations:
        nb["metadata"]["annotations"] = dict(annotations)
    return nb


async def run_both(case):
    """Run ``case(m, pkg)`` on each package; assert the two results are
    equal and return the port's."""
    got = {}
    for pkg in (REFERENCE, PORT):
        got[pkg] = await case(modules(pkg), pkg)
    assert got[PORT] == got[REFERENCE]
    return got[PORT]


async def _state(m, kube, rec, result, name="nb"):
    nb = await kube.get("Notebook", name, "ns")
    events = await kube.list("Event", "ns")
    return {"requeue": None if result is None else result.requeue_after,
            "annotations": dict(nb["metadata"].get("annotations") or {}),
            "events": sorted(e.get("reason") for e in events),
            "probes": list(rec.prober.calls)}


# ---- the cases of tests/test_culling.py ---------------------------------------


async def test_fresh_idle_notebook_gets_activity_annotations():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        prober = make_prober({"kernels": kernels(m, "idle", clock.t - 50),
                              "terminals": []})
        rec = m.culling.CullingReconciler(
            kube, prober, m.culling.CullingOptions(), clock=clock)
        await kube.create("Notebook", notebook(m, pkg))
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    m = modules(PORT)
    assert got["requeue"] == 60.0
    anns = got["annotations"]
    assert anns[m.nbapi.LAST_ACTIVITY_ANNOTATION] == \
        m.objects.fmt_iso(T0 - 50)
    assert anns[m.nbapi.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION] == \
        m.objects.fmt_iso(T0)
    assert m.nbapi.STOP_ANNOTATION not in anns
    assert "http://nb.ns.svc.cluster.local/notebook/ns/nb/api/kernels" \
        in got["probes"]


async def test_auth_proxied_notebook_probed_on_node_0s_pod_ip():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        prober = make_prober({"kernels": kernels(m, "idle", clock.t - 50),
                              "terminals": []})
        rec = m.culling.CullingReconciler(
            kube, prober, m.culling.CullingOptions(), clock=clock)
        await kube.create("Notebook", notebook(m, pkg, annotations={
            m.controller.AUTH_PROXY_ANNOTATION: "true"}))
        # Pod IP not known yet: no probe, no decision — just requeue.
        before = await _state(m, kube, rec,
                              await rec.reconcile(("ns", "nb")))
        await kube.create("Pod", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "nb-0", "namespace": "ns"},
            "spec": {}, "status": {"podIP": "10.244.0.7"}})
        after = await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))
        return before, after

    before, after = await run_both(case)
    m = modules(PORT)
    assert before["requeue"] == 60.0 and before["probes"] == []
    assert after["probes"][0] == \
        "http://10.244.0.7:8888/notebook/ns/nb/api/kernels"
    assert after["annotations"][m.nbapi.LAST_ACTIVITY_ANNOTATION] == \
        m.objects.fmt_iso(T0 - 50)


async def test_busy_kernel_resets_idle_clock():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        prober = make_prober({"kernels": kernels(m, "busy", clock.t - 900),
                              "terminals": []})
        rec = m.culling.CullingReconciler(
            kube, prober, m.culling.CullingOptions(cull_idle_seconds=100),
            clock=clock)
        await kube.create("Notebook", notebook(m, pkg))
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    m = modules(PORT)
    # Busy now ⇒ last activity is "now", regardless of stale timestamps.
    assert got["annotations"][m.nbapi.LAST_ACTIVITY_ANNOTATION] == \
        m.objects.fmt_iso(T0)
    assert m.nbapi.STOP_ANNOTATION not in got["annotations"]


async def test_idle_past_threshold_sets_stop_annotation():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        rec = m.culling.CullingReconciler(
            kube, make_prober({"kernels": kernels(m, "idle", clock.t),
                               "terminals": []}),
            m.culling.CullingOptions(cull_idle_seconds=600), clock=clock)
        await kube.create("Notebook", notebook(m, pkg))
        await rec.reconcile(("ns", "nb"))  # seeds last-activity = now
        clock.t += 601
        rec.prober = make_prober({"kernels": [], "terminals": []})
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    m = modules(PORT)
    assert got["requeue"] is None  # parked: no more polling until restart
    assert m.nbapi.STOP_ANNOTATION in got["annotations"]
    assert "NotebookCulled" in got["events"]


async def test_unreachable_server_does_not_cull():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        rec = m.culling.CullingReconciler(
            kube, make_prober({}), m.culling.CullingOptions(
                cull_idle_seconds=1), clock=clock)
        await kube.create("Notebook", notebook(m, pkg, annotations={
            m.nbapi.LAST_ACTIVITY_ANNOTATION:
                m.objects.fmt_iso(clock.t - 10_000)}))
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    assert got["requeue"] == 60.0
    assert modules(PORT).nbapi.STOP_ANNOTATION not in got["annotations"]


async def test_stopped_notebook_is_skipped():
    async def case(m, pkg):
        kube = m.fakekube.FakeKube()
        rec = m.culling.CullingReconciler(
            kube, make_prober({"kernels": [], "terminals": []}),
            m.culling.CullingOptions(), clock=FakeClock())
        await kube.create("Notebook", notebook(m, pkg, annotations={
            m.nbapi.STOP_ANNOTATION: "t"}))
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    assert got["requeue"] is None and got["probes"] == []


FOLD_CASES = {
    "busy": ([{"execution_state": "busy",
               "last_activity": "2026-01-01T00:00:00Z"}],
             [{"last_activity": "2026-01-02T00:00:00Z"}]),
    "empty": ([], []),
    "garbage": (["garbage"], [{"last_activity": "not-a-time"}]),
    "idle_latest": ([{"execution_state": "idle",
                      "last_activity": "2026-01-03T00:00:00Z"},
                     {"execution_state": None}],
                    [{"last_activity": "2026-01-01T00:00:00Z"}]),
    "starting": ([{"execution_state": "starting"}], []),
}


@pytest.mark.parametrize("name", sorted(FOLD_CASES))
def test_fold_activity_semantics(name):
    kernels_in, terminals_in = FOLD_CASES[name]
    got = _fold_activity(kernels_in, terminals_in)
    assert got == modules(REFERENCE).culling._fold_activity(
        kernels_in, terminals_in)
    busy, ts = got
    if name == "busy":
        assert busy and ts is not None
    elif name in ("empty", "garbage"):
        assert not busy and ts is None   # malformed entries are ignored
    elif name == "idle_latest":
        assert not busy and ts == modules(PORT).objects.parse_iso(
            "2026-01-03T00:00:00Z")
    else:
        assert busy and ts is None


async def test_culled_slice_scales_to_zero_end_to_end():
    """Culler + notebook reconciler together: an idle two-node slice → all
    of its pods deleted, its accelerators added to the culled counter."""
    async def case(m, pkg):
        clock = FakeClock()
        h = await make_harness(pkg, culling={
            "prober": make_prober({"kernels": [], "terminals": []}),
            "options": {"cull_idle_seconds": 300}, "clock": clock})
        try:
            await h.kube.create("Notebook", notebook(m, pkg, "slice", "4x4"))
            await h.settle()
            assert await h.kube.get_or_none("Pod", "slice-1", "ns")
            clock.t += 10_000  # the idle clock was seeded on the first pass
            await h.culler.reconcile(("ns", "slice"))
            await h.settle()
            sts = await h.kube.get("StatefulSet", "slice", "ns")
            return {"replicas": sts["spec"]["replicas"],
                    "pods": [p["metadata"]["name"]
                             for p in await h.kube.list("Pod", "ns")],
                    "culled": h.culler.m_chips_culled.labels().value,
                    "stopped": m.nbapi.STOP_ANNOTATION
                    in await h.annotations("slice")}
        finally:
            await h.stop()

    got = await run_both(case)
    assert got == {"replicas": 0, "pods": [], "culled": 16.0,
                   "stopped": True}


# ---- the cull-drain paths -----------------------------------------------------


async def _drain_case(m, pkg, *, ack=False, busy_in_grace=False,
                      expire=False):
    """An idle accelerator notebook under ``drain_on_cull``: the culler
    requests a drain with reason ``cull``; then the SDK acks it, the
    kernel turns busy, or the grace runs out."""
    kube, clock = m.fakekube.FakeKube(), FakeClock()
    opts = m.culling.CullingOptions(cull_idle_seconds=600,
                                    drain_on_cull=True,
                                    drain_grace_seconds=120.0)
    rec = m.culling.CullingReconciler(
        kube, make_prober({"kernels": kernels(m, "idle", clock.t - 3600),
                           "terminals": []}), opts, clock=clock)
    await kube.create("Notebook", notebook(m, pkg, shape="2x2"))
    steps = [await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))]
    requested = steps[0]["annotations"].get(
        m.nbapi.DRAIN_REQUESTED_ANNOTATION)
    clock.t += 5
    if ack:
        await kube.patch("Notebook", "nb", {"metadata": {"annotations":
            m.migration.ack_patch("/ckpt/nb", 42, clock.t,
                                  for_request=requested)}}, "ns")
    if busy_in_grace:
        rec.prober = make_prober({"kernels": kernels(m, "busy", clock.t),
                                  "terminals": []})
    if expire:
        clock.t += 200
    steps.append(await _state(m, kube, rec, await rec.reconcile(("ns", "nb"))))
    return steps, rec.m_chips_culled.labels().value


async def test_cull_drain_acked_stops_with_the_checkpoint_step():
    async def case(m, pkg):
        return await _drain_case(m, pkg, ack=True)

    (first, last), _ = await run_both(case)
    nbapi = modules(PORT).nbapi
    assert first["requeue"] == 60.0
    assert first["annotations"][nbapi.DRAIN_REASON_ANNOTATION] == "cull"
    assert nbapi.LAST_ACTIVITY_ANNOTATION in first["annotations"]
    assert first["events"] == ["CullDrainRequested"]
    anns = last["annotations"]
    assert last["requeue"] is None and nbapi.STOP_ANNOTATION in anns
    assert nbapi.DRAIN_REQUESTED_ANNOTATION not in anns
    assert anns[nbapi.CHECKPOINT_PATH_ANNOTATION] == "/ckpt/nb"
    assert anns[nbapi.CHECKPOINT_STEP_ANNOTATION] == "42"
    assert last["events"] == ["CullDrainRequested", "NotebookCulled"]


async def test_cull_drain_grace_deadline_falls_back_to_a_plain_stop():
    async def case(m, pkg):
        return await _drain_case(m, pkg, expire=True)

    (_, last), _ = await run_both(case)
    nbapi = modules(PORT).nbapi
    assert nbapi.STOP_ANNOTATION in last["annotations"]
    assert nbapi.CHECKPOINT_STEP_ANNOTATION not in last["annotations"]
    assert last["events"] == ["CullDrainDeadlineExceeded",
                              "CullDrainRequested", "NotebookCulled"]


async def test_busy_kernel_in_the_grace_cancels_the_cull_drain():
    async def case(m, pkg):
        return await _drain_case(m, pkg, busy_in_grace=True)

    (_, last), _ = await run_both(case)
    m = modules(PORT)
    anns = last["annotations"]
    assert m.nbapi.STOP_ANNOTATION not in anns
    assert m.nbapi.DRAIN_REQUESTED_ANNOTATION not in anns
    assert anns[m.nbapi.LAST_ACTIVITY_ANNOTATION] == \
        m.objects.fmt_iso(T0 + 5)
    assert last["events"] == ["CullDrainCancelled", "CullDrainRequested"]


async def test_a_notebook_without_an_accelerator_is_stopped_without_a_drain():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        rec = m.culling.CullingReconciler(
            kube, make_prober({"kernels": kernels(m, "idle", clock.t - 3600),
                               "terminals": []}),
            m.culling.CullingOptions(cull_idle_seconds=600,
                                     drain_on_cull=True), clock=clock)
        await kube.create("Notebook", notebook(m, pkg))
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    nbapi = modules(PORT).nbapi
    assert nbapi.STOP_ANNOTATION in got["annotations"]
    assert nbapi.DRAIN_REQUESTED_ANNOTATION not in got["annotations"]


@pytest.mark.parametrize("recorded", [True, False],
                         ids=["stale_activity", "no_activity_record"])
async def test_the_admitted_at_floor(recorded):
    """A stale activity record is floored at the scheduler's admission
    stamp (a gang that queued for hours is not idle since before it
    ran); a notebook with no record does not inherit the admission time
    as activity, and takes the probe's instead."""
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        rec = m.culling.CullingReconciler(
            kube, make_prober({"kernels": kernels(m, "idle", clock.t - 7200),
                               "terminals": []}),
            m.culling.CullingOptions(cull_idle_seconds=600), clock=clock)
        anns = {m.nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION:
                m.objects.fmt_iso(clock.t - 60)}
        if recorded:
            anns[m.nbapi.LAST_ACTIVITY_ANNOTATION] = \
                m.objects.fmt_iso(clock.t - 7200)
        await kube.create("Notebook", notebook(m, pkg, shape="2x2",
                                               annotations=anns))
        return await _state(m, kube, rec, await rec.reconcile(("ns", "nb")))

    got = await run_both(case)
    m = modules(PORT)
    anns = got["annotations"]
    if recorded:
        assert m.nbapi.STOP_ANNOTATION not in anns
        assert anns[m.nbapi.LAST_ACTIVITY_ANNOTATION] == \
            m.objects.fmt_iso(T0 - 60)
    else:
        assert m.nbapi.STOP_ANNOTATION in anns


async def test_the_culler_never_probes_a_serving_class_notebook():
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        rec = m.culling.CullingReconciler(
            kube, make_prober({"kernels": [], "terminals": []}),
            m.culling.CullingOptions(cull_idle_seconds=0.0), clock=clock)
        out = []
        for name, serving in (("served", True), ("plain", False)):
            nb = notebook(m, pkg, name, "2x2", annotations={
                m.nbapi.LAST_ACTIVITY_ANNOTATION:
                    m.objects.fmt_iso(clock.t - 9999)})
            if serving:
                nb["metadata"]["labels"] = {
                    m.isvcapi.WORKLOAD_CLASS_LABEL: m.isvcapi.SERVING_CLASS}
            await kube.create("Notebook", nb)
            out.append(await _state(m, kube, rec, await rec.reconcile(
                ("ns", name)), name))
        return out

    served, plain = await run_both(case)
    nbapi = modules(PORT).nbapi
    assert served["requeue"] is None and served["probes"] == []
    assert nbapi.STOP_ANNOTATION not in served["annotations"]
    # The same shape without the label IS culled.
    assert nbapi.STOP_ANNOTATION in plain["annotations"]


@pytest.mark.parametrize("chips", [0, 4, 16])
async def test_the_culled_counter_sums_the_status_accelerators(chips):
    """The port's counter (``gpu_cards_idle_culled_total``) adds the
    notebook's ``status.gpu.chips`` where the reference's adds
    ``status.tpu.chips``."""
    async def case(m, pkg):
        kube, clock = m.fakekube.FakeKube(), FakeClock()
        rec = m.culling.CullingReconciler(
            kube, make_prober({"kernels": [], "terminals": []}),
            m.culling.CullingOptions(cull_idle_seconds=600), clock=clock,
            registry=m.metrics.Registry())
        await kube.create("Notebook", notebook(m, pkg, annotations={
            m.nbapi.LAST_ACTIVITY_ANNOTATION:
                m.objects.fmt_iso(clock.t - 3600)}))
        block = "gpu" if pkg == PORT else "tpu"
        await kube.patch("Notebook", "nb", {"status": {block: {
            "chips": chips}}}, "ns", subresource="status")
        await rec.reconcile(("ns", "nb"))
        return rec.m_chips_culled.labels().value

    assert await run_both(case) == float(chips)
    m = modules(PORT)
    reg = m.metrics.Registry()
    m.culling.CullingReconciler(m.fakekube.FakeKube(), make_prober({}),
                                registry=reg)
    assert "gpu_cards_idle_culled_total" in reg.expose()
    assert "tpu_chips" not in reg.expose()


async def test_the_managers_periodic_probes_stamp_the_idle_signal():
    """Through the manager: the culler's periodic probe stamps the idle
    signal with no hand-written annotation."""
    async def case(m, pkg):
        probes = []

        async def prober(url):
            probes.append(url)
            return []

        h = await make_harness(pkg, culling={
            "prober": prober,
            "options": {"cull_idle_seconds": 10 ** 6,
                        "check_period_seconds": 0.05}})
        try:
            await h.kube.create("Notebook", notebook(m, pkg))
            await h.wait_for(lambda: _probed_twice(probes), "two probes")
            anns = await h.annotations("nb")
            return sorted(k for k in anns if "activity" in k)
        finally:
            await h.stop()

    got = await run_both(case)
    nbapi = modules(PORT).nbapi
    assert got == sorted([nbapi.LAST_ACTIVITY_ANNOTATION,
                          nbapi.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION])


async def _probed_twice(probes):
    return sum(url.endswith("kernels") for url in probes) >= 2
