"""The port's web-app backends against the reference's: every case of
tests/test_web_apps.py, tests/test_kfam_authz.py and
tests/test_frontend_contract.py that names no accelerator runs again on
``kubeflow_tpu_torch``; the accelerator cases are rewritten on
``spec.gpu``; and both packages, given the same input, agree:

- the same spawner form gives the same Notebook outside ``spec.tpu`` /
  ``spec.gpu`` (and the same claims);
- every ``process_status`` / ``process_serving_status`` case gives the
  reference's phase and its message with "TPU" read as "GPU";
- ``gpu_options()`` is the ``ACCELERATORS`` table, in the keys of the
  reference's ``tpu_options()``;
- a form that posts ``tpu`` is refused, naming ``gpu``.
"""

import copy
import importlib
import time

import pytest

from torch_control import PORT, REFERENCE, ported, run_case

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.gpu.topology import ACCELERATORS, GpuSlice
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get
from kubeflow_tpu_torch.web.jupyter import create_app as create_jwa

GPU = "nvidia-h100-80gb"
MODULES = {name: ported(name) for name in (
    "test_web_apps.py", "test_kfam_authz.py", "test_frontend_contract.py")}
# The reference's cases that name the accelerator: rewritten below.
ACCELERATOR_CASES = {
    "test_jwa_full_lifecycle", "test_jwa_csrf_and_tpu_catalog",
    "test_jwa_num_slices_rejects_bool_and_float",
    "test_status_state_machine_pure", "test_status_elastic_fleet_messages",
    "test_status_waiting_longer_than_expected"}
CASES = sorted(
    (module, name) for module, namespace in MODULES.items()
    for name, fn in namespace.items()
    if name.startswith("test_") and callable(fn)
    and name not in ACCELERATOR_CASES)
WEB = MODULES["test_web_apps.py"]


def test_every_reference_case_is_collected():
    assert len(CASES) == 16
    assert {name for module, name in CASES
            if module == "test_web_apps.py"} | ACCELERATOR_CASES == {
        name for name in WEB if name.startswith("test_")}
    assert WEB["create_jwa"].__module__ == "kubeflow_tpu_torch.web.jupyter.app"
    assert MODULES["test_frontend_contract.py"]["WEB"].parts[-2:] == (
        "kubeflow_tpu_torch", "web")


@pytest.mark.parametrize("module,case", CASES)
def test_reference_case_on_the_port(module, case, monkeypatch):
    run_case(MODULES[module][case], monkeypatch=monkeypatch)


# ---- the accelerator cases, on spec.gpu --------------------------------------


async def test_jwa_full_lifecycle_on_a_gpu_node():
    """The reference's lifecycle with a whole H100 node (1x8) picked in
    the form: the row reports 8 cards on one node, Running."""
    h = await WEB["WebHarness"]().start()
    try:
        jwa = await h.client(create_jwa(h.kube))
        resp = await jwa.get("/api/namespaces/team/notebooks")
        assert resp.status == 401

        headers = await WEB["csrf"](jwa, "/api/config")
        resp = await jwa.post("/api/namespaces/team/notebooks", json={
            "name": "my-nb", "gpu": {"accelerator": GPU, "topology": "1x8"},
            "environment": {"NCCL_DEBUG": "INFO"}}, headers=headers)
        assert resp.status == 200, await resp.text()
        await h.settle()

        stored = await h.kube.get("Notebook", "my-nb", "team")
        assert stored["spec"]["gpu"] == {"accelerator": GPU, "topology": "1x8"}
        assert "tpu" not in stored["spec"]
        sel = deep_get(stored, "metadata", "annotations",
                       nbapi.IMAGE_SELECTION_ANNOTATION)
        assert sel and ":" in sel
        pvc = await h.kube.get("PersistentVolumeClaim", "my-nb-workspace",
                               "team")
        assert deep_get(pvc, "spec", "resources", "requests",
                        "storage") == "5Gi"

        resp = await jwa.get("/api/namespaces/team/notebooks", headers=headers)
        nb = (await resp.json())["notebooks"][0]
        assert nb["name"] == "my-nb" and nb["cpu"] == "0.5"
        assert nb["status"] == {"phase": "ready", "message": "Running"}
        assert nb["gpu"] == {"accelerator": GPU, "topology": "1x8"}
        assert nb["gpuStatus"] == {
            "hosts": 1, "readyHosts": 1, "chips": 8, "slices": 1}
        assert "tpu" not in nb and "tpuStatus" not in nb

        resp = await jwa.get("/api/namespaces/team/notebooks/my-nb/pod",
                             headers=headers)
        pod = (await resp.json())["pod"]
        assert pod["metadata"]["name"] == "my-nb-0"
        assert pod["spec"]["containers"][0]["resources"]["limits"][
            "nvidia.com/gpu"] == "8"

        for stopped, phase in ((True, "stopped"), (False, "ready")):
            resp = await jwa.patch("/api/namespaces/team/notebooks/my-nb",
                                   json={"stopped": stopped}, headers=headers)
            assert resp.status == 200
            await h.settle()
            resp = await jwa.get("/api/namespaces/team/notebooks",
                                 headers=headers)
            assert (await resp.json())["notebooks"][0]["status"][
                "phase"] == phase

        resp = await jwa.delete("/api/namespaces/team/notebooks/my-nb",
                                headers=headers)
        assert resp.status == 200
        await h.settle()
        assert await h.kube.get_or_none("Notebook", "my-nb", "team") is None
        assert await h.kube.get_or_none("StatefulSet", "my-nb", "team") is None
    finally:
        await h.stop()


async def test_jwa_csrf_and_gpu_catalog():
    h = await WEB["WebHarness"]().start()
    try:
        jwa = await h.client(create_jwa(h.kube))
        resp = await jwa.post("/api/namespaces/ns/notebooks",
                              json={"name": "x"}, headers=WEB["USER"])
        assert resp.status == 403

        headers = await WEB["csrf"](jwa, "/api/config")
        resp = await jwa.get("/api/gpus", headers=headers)
        gpus = (await resp.json())["gpus"]
        h100 = next(t for t in gpus if t["accelerator"] == GPU)
        assert {"topology": "2x8", "chips": 16, "hosts": 2,
                "multiHost": True} in h100["topologies"]
        assert {"topology": "1x1", "chips": 1, "hosts": 1,
                "multiHost": False} in h100["topologies"]
        resp = await jwa.get("/api/tpus", headers=headers)
        assert resp.status == 404
        resp = await jwa.get("/api/config", headers=headers)
        config = (await resp.json())["config"]
        assert config["gpus"]["options"] == gpus and "tpus" not in config
    finally:
        await h.stop()


def test_jwa_num_slices_rejects_bool_and_float():
    """True == 1 and 1.0 == 1 in Python: the form rejects them before any
    default-membership test could admit them as one slice."""
    from kubeflow_tpu_torch.web.jupyter.form import _gpu_from_form

    config = {"gpus": {"readOnly": False}}
    for bad in (True, False, 1.0, 2.9, [2]):
        with pytest.raises(Invalid):
            _gpu_from_form(config, {"gpu": {
                "accelerator": GPU, "topology": "2x8", "numSlices": bad}})
    ok = _gpu_from_form(config, {"gpu": {
        "accelerator": GPU, "topology": "2x8", "numSlices": "2"}})
    assert ok["numSlices"] == 2
    one = _gpu_from_form(config, {"gpu": {
        "accelerator": GPU, "topology": "2x8", "numSlices": 1}})
    assert "numSlices" not in one
    queued = _gpu_from_form(config, {"gpu": {
        "accelerator": GPU, "topology": "1x8", "queuedProvisioning": True}})
    assert queued == {"accelerator": GPU, "topology": "1x8",
                      "queuedProvisioning": True}
    with pytest.raises(Invalid):
        _gpu_from_form(config, {"gpu": {
            "accelerator": GPU, "queuedProvisioning": "yes"}})
    # readOnly: the admin's slice, whatever the form posts.
    pinned = {"gpus": {"readOnly": True,
                       "value": {"accelerator": GPU, "topology": "1x1"}}}
    assert _gpu_from_form(pinned, {"gpu": {
        "accelerator": GPU, "topology": "1x8"}}) == {
        "accelerator": GPU, "topology": "1x1"}


def test_status_messages_on_gpu():
    """The reference's status assertions, on status.gpu: hosts from
    ``status.gpu.hosts``, "GPU" where it says "TPU", counts unchanged."""
    from kubeflow_tpu_torch.web.common.status import (
        Status, filter_events, process_status)

    nb = nbapi.new("x", "ns")
    nb["metadata"]["creationTimestamp"] = "2020-01-01T00:00:00Z"
    assert process_status(nb).phase == "warning"
    nb["status"] = {"readyReplicas": 1, "gpu": {"hosts": 1}}
    assert process_status(nb) == Status("ready", "Running")
    nb["status"] = {"readyReplicas": 1, "gpu": {"hosts": 4}}
    s = process_status(nb)
    assert s.phase == "waiting"
    assert s.message == "Waiting for GPU workers (1/4 ready)"
    nb["status"] = {"readyReplicas": 4, "gpu": {"hosts": 4}}
    assert process_status(nb).message == "Running (4/4 GPU workers)"
    nb["status"] = {"scheduler": {"state": "Queued", "position": 3,
                                  "waitingChips": 32}}
    assert process_status(nb).message == \
        "Queued for GPU capacity (position 3, waiting for 32 chips)"
    nb["status"] = {"gpu": {"capacityPending": True}}
    assert process_status(nb).message == \
        "Waiting for GPU capacity (queued ProvisioningRequest)"
    nb["status"] = {"readyReplicas": 0, "scheduler": {
        "state": "Preempted", "reason": "priority"}}
    assert process_status(nb) == Status(
        "stopped", "Preempted by the GPU fleet scheduler (priority); "
        "restart the server to re-queue")
    stale = [{"type": "Warning", "message": "old incarnation crashed",
              "lastTimestamp": "2019-12-31T23:59:00Z"}]
    assert filter_events(nb, stale) == []


# ---- parity: the same input to both packages ---------------------------------


def _status_mod(pkg: str):
    return importlib.import_module(f"{pkg}.web.common.status")


NOW = 1_800_000_000.0  # the clock both packages read in the status cases


def _timeline(kind: str, age: float) -> dict:
    timeline = importlib.import_module(f"{PORT}.runtime.timeline")
    entries: list = []
    timeline.append(entries, kind, at=NOW - age)
    return {timeline.TIMELINE_ANNOTATION: timeline.encode(entries)}


def _spot(step=700):
    mig = {"state": "Running", "checkpointedAt": "t"}
    if step is not None:
        mig["checkpointStep"] = step
    return {"scheduler": {"state": "Queued", "position": 2,
                          "waitingChips": 16, "reclaimed": "spot-reclaim"},
            "migration": mig}


# (annotations, status, events) in the reference's shape: the accelerator
# leaves under status.tpu; the port's copy moves them to status.gpu.
NOTEBOOK_STATUSES = {
    "no_status_old": ({}, None, None),
    "stopped": ({nbapi.STOP_ANNOTATION: "t"}, None, None),
    "stopping": ({nbapi.STOP_ANNOTATION: "t"}, {"readyReplicas": 1}, None),
    "ready_one_host": ({}, {"readyReplicas": 1, "tpu": {"hosts": 1}}, None),
    "ready_four_hosts": ({}, {"readyReplicas": 4, "tpu": {"hosts": 4}}, None),
    "partial_slice": ({}, {"readyReplicas": 1, "tpu": {"hosts": 4}}, None),
    "crash_loop": ({}, {"readyReplicas": 0, "containerState": {"waiting": {
        "reason": "CrashLoopBackOff", "message": "boom"}}}, None),
    "pod_initializing": ({}, {"containerState": {"waiting": {
        "reason": "PodInitializing"}}}, None),
    "condition_reason": ({}, {"conditions": [
        {"type": "Ready", "reason": "Unschedulable", "message": "0/3"}]},
        None),
    "warning_event": ({}, {}, [{"type": "Warning",
                                "message": "0/3 nodes available",
                                "lastTimestamp": "2026-01-01T00:00:00Z"}]),
    "stale_event": ({}, {}, [{"type": "Warning", "message": "old crash",
                              "lastTimestamp": "2019-12-31T23:59:00Z"}]),
    "quarantined": ({}, {"readyReplicas": 1, "tpu": {"hosts": 1},
                         "conditions": [{"type": "Degraded", "status": "True",
                                         "reason": "ReconcileQuarantined"}]},
                    None),
    "released": ({}, {"readyReplicas": 1, "tpu": {"hosts": 1}, "conditions": [
        {"type": "Degraded", "status": "False"},
        {"type": "Degraded", "status": "True"}]}, None),
    "spot_reclaimed": ({}, _spot(), None),
    "spot_reclaimed_no_step": ({}, _spot(None), None),
    "defrag_requeued": ({}, {"scheduler": {
        "state": "Queued", "position": 1, "reclaimed": "defrag"}}, None),
    "scale_up": ({}, {"scheduler": {
        "state": "Queued", "position": 1, "waitingChips": 48,
        "scaleUp": {"chips": 48, "pendingSeconds": 12.4}}}, None),
    "queued": ({}, {"scheduler": {"state": "Queued", "position": 3,
                                  "waitingChips": 32}}, None),
    "queued_breach": (_timeline("Queued", 120.0), {"scheduler": {
        "state": "Queued", "position": 2, "waitingChips": 16,
        "reason": "waiting for 16 chips"}}, None),
    "queued_breach_no_reason": (_timeline("Queued", 120.0), {"scheduler": {
        "state": "Queued", "position": 2, "waitingChips": 16}}, None),
    "queued_inside_objective": (_timeline("Queued", 5.0), {"scheduler": {
        "state": "Queued", "position": 2, "waitingChips": 16}}, None),
    "partial_breach": (_timeline("Admitted", 300.0), {
        "readyReplicas": 1, "tpu": {"hosts": 4}}, None),
    "draining_defrag": ({}, {"scheduler": {"state": "Draining",
                                           "reason": "defrag"}}, None),
    "draining_spot": ({}, {"scheduler": {"state": "Draining",
                                         "reason": "spot-reclaim"}}, None),
    "draining_priority": ({}, {"scheduler": {"state": "Draining",
                                             "reason": "priority"}}, None),
    "preempted": ({}, {"readyReplicas": 0, "scheduler": {
        "state": "Preempted", "reason": "priority"}, "migration": {
        "checkpointStep": 40, "checkpointedAt": "t"}}, None),
    "capacity_pending": ({}, {"tpu": {"capacityPending": True}}, None),
    "warm_claimed": ({}, {"readyReplicas": 0, "tpu": {
        "hosts": 1, "warmPool": {"claimed": True, "claimedInSec": 0.25}}},
        None),
    "warm_replenishing": ({}, {"readyReplicas": 0, "tpu": {
        "hosts": 1, "warmPool": {"replenishing": {"ready": 1, "size": 3}}}},
        None),
    "parked": ({nbapi.STOP_ANNOTATION: "t"}, {"readyReplicas": 0,
                                               "migration": {
        "state": "Parked", "checkpointStep": 9}}, None),
    "parked_dirty": ({nbapi.STOP_ANNOTATION: "t"}, {"readyReplicas": 0,
                                                     "migration": {
        "state": "Parked", "commitDirty": True}}, None),
    "parked_uploading": ({nbapi.STOP_ANNOTATION: "t"}, {
        "readyReplicas": 0, "migration": {
            "state": "Parked", "checkpointStep": 9,
            "uploadProgress": "3/8"}}, None),
    "restoring": ({}, {"readyReplicas": 1, "tpu": {"hosts": 2}, "migration": {
        "state": "Restoring", "checkpointStep": 9,
        "restoreTier": "staging"}}, None),
    "maintenance": ({nbapi.MAINTENANCE_ANNOTATION: "node-3"}, {
        "readyReplicas": 1, "tpu": {"hosts": 1}}, None),
    "update_pending": ({nbapi.UPDATE_PENDING_ANNOTATION: "true"}, {
        "readyReplicas": 1, "tpu": {"hosts": 1}}, None),
    "training": ({}, {"readyReplicas": 2, "tpu": {"hosts": 2, "telemetry": {
        "step": 120, "mfu": 0.41, "family": "burnin"}}}, None),
    "training_stale": ({}, {"readyReplicas": 1, "tpu": {"hosts": 1,
                                                        "telemetry": {
        "step": 120, "stale": True}}}, None),
}


def _gpu_leaves(obj):
    """The reference-shaped object on the port's API: every ``tpu`` key
    under ``spec`` / ``status`` renamed ``gpu``."""
    obj = copy.deepcopy(obj)
    for part in ("spec", "status"):
        block = obj.get(part)
        if isinstance(block, dict) and "tpu" in block:
            block["gpu"] = block.pop("tpu")
    return obj


@pytest.mark.parametrize("case", sorted(NOTEBOOK_STATUSES))
def test_process_status_reads_as_the_reference_with_gpu(case, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    annotations, status, events = NOTEBOOK_STATUSES[case]
    nb = nbapi.new("slow", "team")
    nb["metadata"]["creationTimestamp"] = "2020-01-01T00:00:00Z"
    nb["metadata"]["annotations"] = dict(annotations)
    if status is not None:
        nb["status"] = status
    ref = _status_mod(REFERENCE).process_status(nb, events)
    port = _status_mod(PORT).process_status(_gpu_leaves(nb), events)
    assert port.phase == ref.phase
    assert port.message == ref.message.replace("TPU", "GPU")
    assert "TPU" not in port.message


def test_the_slo_knob_moves_both_thresholds(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: NOW)
    annotations, status, _ = NOTEBOOK_STATUSES["queued_breach"]
    nb = nbapi.new("slow", "team")
    nb["metadata"]["annotations"] = dict(annotations)
    nb["status"] = status
    for knob, phase in (("600", "waiting"), ("60:0.999", "warning")):
        monkeypatch.setenv("KFTPU_SLO_NOTEBOOK_TIME_TO_READY", knob)
        ref = _status_mod(REFERENCE).process_status(nb)
        port = _status_mod(PORT).process_status(_gpu_leaves(nb))
        assert ref.phase == port.phase == phase
        assert port.message == ref.message.replace("TPU", "GPU")


SERVING_STATUSES = {
    "degraded": {"conditions": [{"type": "Degraded", "status": "True"}]},
    "parked": {"serving": {"state": "Parked",
                           "parkedCheckpoint": {"step": 7}}},
    "parked_no_step": {"serving": {"state": "Parked",
                                   "parkedCheckpoint": {"path": "x"}}},
    "parked_bare": {"serving": {"state": "Parked"}},
    "parking": {"serving": {"state": "Parking"}},
    "swap_warm": {"serving": {"state": "Ready",
                              "modelSwap": {"model": "alt", "warm": True}}},
    "swap_cold": {"serving": {"state": "Ready",
                              "modelSwap": {"model": "alt"}}},
    "kv_pressure": {"serving": {"state": "Ready",
                                "kvPressure": {"blocksShort": 3}}},
    "queued": {"serving": {"state": "Queued", "queuedReplicas": 2}},
    "scaling": {"readyReplicas": 1, "serving": {
        "state": "Scaling", "desiredReplicas": 3, "queuedReplicas": 1}},
    "scaling_unqueued": {"serving": {"state": "Scaling",
                                     "desiredReplicas": 2}},
    "ready": {"readyReplicas": 2, "serving": {"state": "Ready",
                                              "admittedReplicas": 2}},
    "unknown_old": {},
}


@pytest.mark.parametrize("case", sorted(SERVING_STATUSES))
def test_process_serving_status_reads_as_the_reference_with_gpu(case):
    isvc = {"apiVersion": "serving.kubeflow.org/v1", "kind":
            "InferenceService", "metadata": {
                "name": "svc", "namespace": "user",
                "creationTimestamp": "2020-01-01T00:00:00Z"},
            "spec": {"tpu": {"accelerator": "v5e", "topology": "2x2"}},
            "status": SERVING_STATUSES[case]}
    ref = _status_mod(REFERENCE).process_serving_status(isvc)
    port = _status_mod(PORT).process_serving_status(_gpu_leaves(isvc))
    assert port.phase == ref.phase
    assert port.message == ref.message.replace("TPU", "GPU")


def _form(pkg: str):
    return importlib.import_module(f"{pkg}.web.jupyter.form")


def _config(pkg: str):
    return importlib.import_module(f"{pkg}.web.jupyter.spawner_config")


FORMS = {
    "defaults": {"name": "nb"},
    "custom_image_env": {"name": "nb", "customImage": " img:v2 ", "cpu": "2",
                         "memory": "4Gi", "environment": {"A": 1}},
    "group_one": {"name": "code", "serverType": "group-one"},
    "group_two": {"name": "rs", "serverType": "group-two",
                  "image": "kubeflow-tpu/rstudio-tidyverse:latest"},
    "volumes": {"name": "nb", "workspaceVolume": {"mount": "/w", "newPvc": {
        "metadata": {"name": "{notebook-name}-ws"}, "spec": {
            "accessModes": ["ReadWriteMany"]}}},
        "dataVolumes": [{"existingSource": {"persistentVolumeClaim": {
            "claimName": "data"}}}, {}], "shm": False},
    "configurations": {"name": "nb", "configurations": ["add-gcp-secret"],
                       "labels": {"team": "a"}},
    "digest_image": {"name": "nb", "customImage": "img@sha256:abc"},
}
SLICES = {"one_card": ({"accelerator": "v5e", "topology": "1x1"},
                       {"accelerator": GPU, "topology": "1x1"}),
          "multi_slice": ({"accelerator": "v5e", "topology": "4x4",
                           "numSlices": 2, "queuedProvisioning": True},
                          {"accelerator": GPU, "topology": "2x8",
                           "numSlices": 2, "queuedProvisioning": True}),
          "none": (None, None)}


@pytest.mark.parametrize("slice_", sorted(SLICES))
@pytest.mark.parametrize("form", sorted(FORMS))
def test_the_same_form_gives_the_same_notebook(form, slice_):
    tpu, gpu = SLICES[slice_]
    ref_body, port_body = dict(FORMS[form]), dict(FORMS[form])
    if tpu is not None:
        ref_body["tpu"], port_body["gpu"] = tpu, gpu
    ref_nb, ref_pvcs = _form(REFERENCE).notebook_from_form(
        _config(REFERENCE).load_config(), ref_body, "team", "a@example.com")
    port_nb, port_pvcs = _form(PORT).notebook_from_form(
        _config(PORT).load_config(), port_body, "team", "a@example.com")
    assert port_nb["spec"].pop("gpu", None) == gpu
    assert ref_nb["spec"].pop("tpu", None) == tpu
    assert port_nb == ref_nb
    assert port_pvcs == ref_pvcs


def test_the_toleration_group_is_the_gpu_taint():
    config = _config(PORT).load_config()
    (group,) = config["tolerationGroup"]["options"]
    assert group["groupKey"] == "gpu-reserved"
    nb, _ = _form(PORT).notebook_from_form(
        config, {"name": "nb", "tolerationGroup": "gpu-reserved"}, "t", "u")
    assert nb["spec"]["template"]["spec"]["tolerations"] == [
        {"key": "nvidia.com/gpu", "operator": "Exists",
         "effect": "NoSchedule"}]
    with pytest.raises(Invalid):
        _form(PORT).notebook_from_form(
            config, {"name": "nb", "tolerationGroup": "tpu-reserved"}, "t",
            "u")


def test_gpu_options_are_the_accelerator_table():
    options = _config(PORT).gpu_options()
    reference = _config(REFERENCE).tpu_options()
    assert [o["accelerator"] for o in options] == list(ACCELERATORS)
    assert {tuple(o) for o in options} == {tuple(o) for o in reference}
    for option in options:
        acc = ACCELERATORS[option["accelerator"]]
        assert option["gkeAccelerator"] == acc.name
        assert option["hbmGiBPerChip"] == acc.hbm_gib_per_gpu == 80
        assert [t["topology"] for t in option["topologies"]] == list(
            acc.topologies)
        for t in option["topologies"]:
            s = GpuSlice.parse(acc.name, t["topology"], strict=True)
            assert t == {"topology": t["topology"], "chips": s.num_chips,
                         "hosts": s.num_hosts, "multiHost": s.multi_host}
            nodes, per_node = map(int, t["topology"].split("x"))
            assert t["chips"] == nodes * per_node and t["hosts"] == nodes
    h100 = next(o for o in options if o["accelerator"] == GPU)
    assert h100["topologies"][0]["topology"] == "1x1"
    assert h100["topologies"][-1] == {"topology": "64x8", "chips": 512,
                                      "hosts": 64, "multiHost": True}


@pytest.mark.parametrize("tpu", [
    {"accelerator": "v5e", "topology": "2x2"}, "v5e", [1]])
def test_a_form_that_posts_tpu_is_refused(tpu):
    config = _config(PORT).load_config()
    with pytest.raises(Invalid) as err:
        _form(PORT).notebook_from_form(config, {"name": "nb", "tpu": tpu},
                                       "t", "u")
    assert "gpu" in err.value.message and "tpu" in err.value.message
    # "none" is the picker's empty choice, in either key.
    nb, _ = _form(PORT).notebook_from_form(
        config, {"name": "nb", "tpu": "none", "gpu": "none"}, "t", "u")
    assert "gpu" not in nb["spec"] and "tpu" not in nb["spec"]


async def test_the_jwa_refuses_a_tpu_form_with_422():
    h = await WEB["WebHarness"]().start()
    try:
        jwa = await h.client(create_jwa(h.kube))
        headers = await WEB["csrf"](jwa, "/api/config")
        resp = await jwa.post("/api/namespaces/team/notebooks", json={
            "name": "old", "tpu": {"accelerator": "v5e", "topology": "2x4"}},
            headers=headers)
        body = await resp.json()
        assert resp.status == 422 and body["success"] is False
        assert "gpu" in body["log"]
        assert await h.kube.get_or_none("Notebook", "old", "team") is None
        assert await h.kube.list("PersistentVolumeClaim", "team") == []
    finally:
        await h.stop()
