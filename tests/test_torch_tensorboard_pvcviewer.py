"""The port's Tensorboard and PVCViewer controllers against the reference's:
every case of tests/test_tensorboard_pvcviewer.py runs again on
``kubeflow_tpu_torch``, and the same CRs given to both packages' control
planes (the fake apiserver, the admission chain, the manager with the two
controllers, the kubelet simulator) give the same children and status:
``pvc://`` with a subpath, ``gs://`` with the creds secret, ``s3://``, a
bare path, ``profilerPlugin``, Istio on and the ReadWriteOnce pin; and the
PVCViewer's defaults and children.
"""

import asyncio
import importlib
from dataclasses import asdict

import pytest

from torch_control import PORT, REFERENCE, ported, run_case

REFERENCE_CASES = ported("test_tensorboard_pvcviewer.py")
CASES = sorted(k for k, v in REFERENCE_CASES.items()
               if k.startswith("test_") and callable(v))


def test_every_reference_case_is_collected():
    assert len(CASES) == 6
    assert REFERENCE_CASES["FakeKube"].__module__ == \
        "kubeflow_tpu_torch.testing.fakekube"
    assert REFERENCE_CASES["setup_tensorboard_controller"].__module__ == \
        "kubeflow_tpu_torch.controllers.tensorboard"


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case):
    run_case(REFERENCE_CASES[case])


def _load(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


async def _plane(pkg: str, tb_opts: dict, pvc_opts: dict):
    fakekube, podsim = _load(pkg, "testing.fakekube"), _load(pkg, "testing.podsim")
    tb, pvc = _load(pkg, "controllers.tensorboard"), _load(pkg, "controllers.pvcviewer")
    kube = fakekube.FakeKube()
    _load(pkg, "webhooks").register_all(kube)
    mgr = _load(pkg, "runtime.manager").Manager(
        kube, registry=_load(pkg, "runtime.metrics").Registry())
    tb.setup_tensorboard_controller(mgr, tb.TensorboardOptions(**tb_opts))
    pvc.setup_pvcviewer_controller(mgr, pvc.PVCViewerOptions(**pvc_opts))
    sim = podsim.PodSimulator(kube)
    await mgr.start()
    await sim.start()
    return kube, mgr, sim


async def _settle(mgr) -> None:
    for _ in range(6):
        await mgr.wait_idle(timeout=20)
        await asyncio.sleep(0.02)


def _rendered(obj):
    """An object as its controller rendered it: no server-set metadata."""
    if obj is None:
        return None
    meta = obj["metadata"]
    return {"metadata": {
        "name": meta["name"], "namespace": meta.get("namespace"),
        "labels": meta.get("labels"), "annotations": meta.get("annotations"),
        "owners": [(o["kind"], o["name"], o.get("controller"))
                   for o in meta.get("ownerReferences", [])]},
        "spec": obj.get("spec")}


async def _claims(kube, rwo: bool) -> None:
    await kube.create("PersistentVolumeClaim", {
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": "logs", "namespace": "ns"},
        "spec": {"accessModes": ["ReadWriteOnce" if rwo else "ReadWriteMany"]}})
    if rwo:
        await kube.create("Pod", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "user-nb-0", "namespace": "ns"},
            "spec": {"nodeName": "node-7",
                     "containers": [{"name": "x", "image": "i"}],
                     "volumes": [{"name": "w", "persistentVolumeClaim": {
                         "claimName": "logs"}}]}})
        await kube.patch("Pod", "user-nb-0", {"status": {"phase": "Running"}},
                         "ns", subresource="status")


async def _tensorboard(pkg: str, logspath: str, profiler: bool, opts: dict,
                       rwo: bool) -> dict:
    tbapi = _load(pkg, "api.tensorboard")
    kube, mgr, sim = await _plane(pkg, opts, {})
    try:
        await _claims(kube, rwo)
        await kube.create("Tensorboard", tbapi.new("tb", "ns", logspath,
                                                   profiler=profiler))
        await _settle(mgr)
        return {
            "deployment": _rendered(await kube.get_or_none(
                "Deployment", "tb", "ns")),
            "service": _rendered(await kube.get_or_none("Service", "tb", "ns")),
            "virtual_service": _rendered(await kube.get_or_none(
                "VirtualService", "tensorboard-ns-tb", "ns")),
            "status": (await kube.get("Tensorboard", "tb", "ns")).get("status")}
    finally:
        await sim.stop()
        await mgr.stop()
        kube.close_watches()


TENSORBOARDS = {
    "pvc_subpath": ("pvc://logs/sub/dir", False, {}, False),
    "gcs_with_creds": ("gs://bkt/traces", False,
                       {"gcp_creds_secret": "user-gcp-sa"}, False),
    "s3": ("s3://bucket/x", False, {}, False),
    "bare_path": ("/local/path", False, {}, False),
    "profiler_plugin": ("pvc://logs/run1", True, {}, False),
    "istio": ("pvc://logs", True, {"use_istio": True,
                                   "cluster_domain": "corp.local"}, False),
    "rwo_pin": ("pvc://logs/run1", True, {}, True),
    "rwo_scheduling_off": ("pvc://logs", False,
                           {"rwo_pvc_scheduling": False}, True),
}


@pytest.mark.parametrize("case", sorted(TENSORBOARDS))
async def test_tensorboard_children_and_status_equal_the_reference(case):
    logspath, profiler, opts, rwo = TENSORBOARDS[case]
    port = await _tensorboard(PORT, logspath, profiler, opts, rwo)
    ref = await _tensorboard(REFERENCE, logspath, profiler, opts, rwo)
    assert port == ref
    assert port["deployment"] is not None and port["status"]["readyReplicas"] == 1
    assert (port["virtual_service"] is not None) == bool(opts.get("use_istio"))
    command = port["deployment"]["spec"]["template"]["spec"]["containers"][0][
        "command"]
    assert ("--reload_multifile=true" in command) == profiler


def test_the_tensorboard_image_stays_the_references_string(monkeypatch):
    monkeypatch.delenv("TENSORBOARD_IMAGE", raising=False)
    port = _load(PORT, "controllers.tensorboard").TensorboardOptions()
    ref = _load(REFERENCE, "controllers.tensorboard").TensorboardOptions()
    assert asdict(port) == asdict(ref)
    assert port.image == "tensorflow/tensorflow:latest"
    assert _load(PORT, "cmd.envconfig").tensorboard_options().image == \
        _load(REFERENCE, "cmd.envconfig").tensorboard_options().image


async def _viewer(pkg: str, viewer_update: dict, opts: dict, rwo: bool) -> dict:
    pvcapi = _load(pkg, "api.pvcviewer")
    kube, mgr, sim = await _plane(pkg, {}, opts)
    try:
        await _claims(kube, rwo)
        viewer = pvcapi.new("view", "ns", "logs", rwo_scheduling=rwo)
        viewer["spec"].update(viewer_update)
        await kube.create("PVCViewer", viewer)
        await _settle(mgr)
        stored = await kube.get("PVCViewer", "view", "ns")
        return {
            "spec": stored["spec"], "status": stored.get("status"),
            "deployment": _rendered(await kube.get_or_none(
                "Deployment", "view-pvcviewer", "ns")),
            "service": _rendered(await kube.get_or_none(
                "Service", "view-pvcviewer", "ns")),
            "virtual_service": _rendered(await kube.get_or_none(
                "VirtualService", "pvcviewer-ns-view", "ns"))}
    finally:
        await sim.stop()
        await mgr.stop()
        kube.close_watches()


VIEWERS = {
    "defaults": ({}, {}, False),
    "istio_with_networking": (
        {"networking": {"targetPort": 9090, "basePrefix": "/files",
                        "rewrite": "/", "timeout": "30s"}},
        {"use_istio": True}, False),
    "rwo_pin": ({}, {}, True),
    "own_pod_spec": ({"podSpec": {"containers": [{
        "name": "browser", "image": "example/browser:1",
        "volumeMounts": [{"name": "viewer-volume", "mountPath": "/srv"}]}]}},
        {"use_istio": True}, False),
}


@pytest.mark.parametrize("case", sorted(VIEWERS))
async def test_pvcviewer_defaults_children_and_status_equal_the_reference(case):
    update, opts, rwo = VIEWERS[case]
    port = await _viewer(PORT, update, opts, rwo)
    ref = await _viewer(REFERENCE, update, opts, rwo)
    assert port == ref
    assert port["status"]["ready"] is True
    volumes = port["spec"]["podSpec"]["volumes"]
    assert {"name": "viewer-volume",
            "persistentVolumeClaim": {"claimName": "logs"}} in volumes
    pinned = port["deployment"]["spec"]["template"]["spec"].get("affinity")
    assert (pinned is not None) == rwo
