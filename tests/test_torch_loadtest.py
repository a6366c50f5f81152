"""The port's notebook load test (``kubeflow_tpu_torch/testing/
loadtest.py``): the leader-election cases of
tests/test_leaderelection_loadtest.py run again on the port, unchanged;
its two load-test cases written again on H100 ``1x4`` (the reference's
v5e ``2x2``, a slice of as many cards); and ``run_load_test`` of both
packages over their own stacks, which must give the same report fields
and the same failure strings."""

import asyncio
import importlib

import pytest

from kubeflow_tpu_torch.controllers.notebook import setup_notebook_controller
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.testing.fakekube import FakeKube
from kubeflow_tpu_torch.testing.loadtest import run_load_test
from kubeflow_tpu_torch.testing.podsim import PodSimulator
from kubeflow_tpu_torch.webhooks import register_all
from torch_control import (PORT, REFERENCE, clear_kftpu_env, make_harness,
                           ported, run_case)

REFERENCE_CASES = ported("test_leaderelection_loadtest.py")
# The two load-test cases name v5e 2x2: they are written again below.
CASES = ["test_leader_election_acquire_renew_release",
         "test_leader_election_single_winner_and_takeover"]
SHAPES = {REFERENCE: ("v5e", "2x2"), PORT: ("nvidia-h100-80gb", "1x4")}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


def test_every_reference_case_is_collected():
    names = sorted(k for k, v in REFERENCE_CASES.items()
                   if k.startswith("test_") and callable(v))
    assert names == sorted(CASES + [
        "test_event_mirroring_does_no_per_reconcile_lists",
        "test_load_test_spawns_and_reports_percentiles"])
    assert REFERENCE_CASES["run_load_test"] is run_load_test


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case):
    run_case(REFERENCE_CASES[case])


async def test_load_test_spawns_and_reports_percentiles():
    kube = FakeKube()
    register_all(kube)
    mgr = Manager(kube)
    setup_notebook_controller(mgr)
    sim = PodSimulator(kube)
    await mgr.start()
    await sim.start()
    try:
        report = await run_load_test(
            kube, count=20, accelerator="nvidia-h100-80gb", topology="1x4",
            timeout=30
        )
        assert report.ready == 20
        assert report.failures == []
        assert report.p50_ready_seconds is not None
        assert report.p95_ready_seconds >= report.p50_ready_seconds
        # Cleanup removed the CRs.
        assert await kube.list("Notebook", "loadtest") == []
    finally:
        await sim.stop()
        await mgr.stop()
        kube.close_watches()


async def test_event_mirroring_does_no_per_reconcile_lists():
    """_mirror_events reads the Event informer's watch cache, not a LIST
    of the namespace per reconcile: under load the controller's Event
    LISTs stay O(1) (informer sync), not O(reconciles)."""
    kube = FakeKube()
    register_all(kube)
    mgr = Manager(kube)
    setup_notebook_controller(mgr)
    sim = PodSimulator(kube)

    lists = {"Event": 0, "total": 0}
    orig_list = kube.list

    async def counting_list(kind, *args, **kw):
        lists["total"] += 1
        if kind == "Event":
            lists["Event"] += 1
        return await orig_list(kind, *args, **kw)

    kube.list = counting_list
    await mgr.start()
    await sim.start()
    try:
        report = await run_load_test(
            kube, count=30, accelerator="nvidia-h100-80gb", topology="1x4",
            timeout=30
        )
        assert report.ready == 30
        assert lists["Event"] <= 5, (
            f"{lists['Event']} Event LISTs — mirror is LIST-driven again?")
    finally:
        kube.list = orig_list
        await sim.stop()
        await mgr.stop()
        kube.close_watches()


def _loadtest(pkg):
    return importlib.import_module(f"{pkg}.testing.loadtest")


async def _spawn_report(pkg) -> tuple[dict, list]:
    acc, topo = SHAPES[pkg]
    h = await make_harness(pkg)
    try:
        report = await _loadtest(pkg).run_load_test(
            h.kube, count=20, accelerator=acc, topology=topo, timeout=30)
        return report.to_dict(), await h.kube.list("Notebook", "loadtest")
    finally:
        await h.stop()


async def _failure_strings(pkg) -> list:
    """No controller runs, so ``load-0`` never becomes Ready; ``load-1``
    is deleted while the test polls."""
    acc, topo = SHAPES[pkg]
    kube = importlib.import_module(f"{pkg}.testing.fakekube").FakeKube()
    importlib.import_module(f"{pkg}.webhooks").register_all(kube)

    async def delete_when_created():
        while await kube.get_or_none("Notebook", "load-1",
                                     "loadtest") is None:
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.1)
        await kube.delete("Notebook", "load-1", "loadtest")

    deleter = asyncio.create_task(delete_when_created())
    report = await _loadtest(pkg).run_load_test(
        kube, count=2, accelerator=acc, topology=topo, timeout=0.5)
    await deleter
    assert report.ready == 0
    assert report.p50_ready_seconds is None
    assert report.p95_ready_seconds is None
    return report.failures


def test_run_load_test_gives_the_reference_report_and_failures():
    ref, ref_left = asyncio.run(_spawn_report(REFERENCE))
    port, port_left = asyncio.run(_spawn_report(PORT))
    assert sorted(port) == sorted(ref) == [
        "failures", "notebooks", "p50_ready_seconds", "p95_ready_seconds",
        "ready", "wall_seconds"]
    for d in (ref, port):
        assert d["notebooks"] == d["ready"] == 20
        assert d["failures"] == []
        assert 0 < d["p50_ready_seconds"] <= d["p95_ready_seconds"] \
            <= d["wall_seconds"]
    assert ref_left == port_left == []

    failures = {pkg: asyncio.run(_failure_strings(pkg))
                for pkg in (REFERENCE, PORT)}
    assert failures[PORT] == failures[REFERENCE] == [
        "loadtest/load-1: disappeared",
        "loadtest/load-0: not ready within 0.5s"]
