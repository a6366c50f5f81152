"""The port's admission webhook server (``webhooks/server.py``) and its
JSONPatch engine against the reference's: the cases of
tests/test_webhook_server.py with no accelerator in them run again with
their imports pointed at ``kubeflow_tpu_torch`` (the JSONPatch round trips,
the image catalog, the admission metric, both TLS rotation cases, with
``openssl`` as they use it); the accelerator cases run on the GPU env
(``TPU_WORKER_ID``, ``PET_NODE_RANK`` = ``slice_id * nodes + ordinal``);
and the same AdmissionReviews and ConversionReviews sent to both packages'
apps give the same responses, outside the accelerator env and keys.
"""

import base64
import copy
import importlib
import json

import pytest
from aiohttp.test_utils import TestClient, TestServer

from torch_control import PORT, REFERENCE, ported, run_case

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.testing.fakekube import FakeKube
from kubeflow_tpu_torch.webhooks.jsonpatch import apply
from kubeflow_tpu_torch.webhooks.server import create_webhook_app

REFERENCE_CASES = ported("test_webhook_server.py")
# The reference's cases that name a TPU (its annotations and env) are
# rewritten below on the GPU env; these run as they are.
CASES = ("test_jsonpatch_roundtrips",
         "test_admission_server_resolves_image_catalog",
         "test_admission_server_metrics",
         "test_tls_cert_rotation_without_restart",
         "test_cert_rotation_retries_after_mid_rotation_failure")
GPU = "nvidia-h100-80gb"


def test_every_reference_case_is_collected():
    every = sorted(k for k, v in REFERENCE_CASES.items()
                   if k.startswith("test_") and callable(v))
    assert set(CASES) <= set(every) and len(every) == len(CASES) + 3
    assert REFERENCE_CASES["create_webhook_app"].__module__ == \
        "kubeflow_tpu_torch.webhooks.server"


@pytest.mark.parametrize("case", CASES)
def test_reference_case_on_the_port(case, tmp_path):
    run_case(REFERENCE_CASES[case], tmp_path=tmp_path)


admission_review = REFERENCE_CASES["admission_review"]
decode_patch = REFERENCE_CASES["decode_patch"]


async def _client(app) -> TestClient:
    client = TestClient(TestServer(app))
    await client.start_server()
    return client


def _gpu_pod(name: str, topology: str, **annotations) -> dict:
    return {
        "kind": "Pod",
        "metadata": {"name": name, "labels": {"notebook-name": "nb"},
                     "annotations": {keys.TPU_ACCELERATOR: GPU,
                                     keys.TPU_TOPOLOGY: topology,
                                     **annotations}},
        "spec": {"containers": [{"name": "nb", "env": []}]},
    }


async def _patched_env(client, path: str, pod: dict) -> dict:
    resp = await client.post(path, json=admission_review(pod, namespace="ns"))
    body = await resp.json()
    assert body["response"]["allowed"] is True
    patched = apply({**pod, "metadata": {**pod["metadata"], "namespace": "ns"}},
                    decode_patch(body))
    return patched, {e["name"]: e["value"]
                     for e in patched["spec"]["containers"][0]["env"]}


async def test_admission_server_injects_poddefault_and_gpu_env():
    kube = FakeKube()
    await kube.create("PodDefault", {
        "metadata": {"name": "proxy", "namespace": "ns", "resourceVersion": "1"},
        "spec": {"selector": {"matchLabels": {"notebook-name": "nb"}},
                 "env": [{"name": "HTTPS_PROXY",
                          "value": "http://proxy:3128"}]}})
    client = await _client(create_webhook_app(kube))
    try:
        patched, env = await _patched_env(client, "/apply-poddefault",
                                          _gpu_pod("nb-1", "2x8"))
        assert env["HTTPS_PROXY"] == "http://proxy:3128"   # PodDefault applied
        assert env["TPU_WORKER_ID"] == "1"                 # ordinal from the name
        assert env["PET_NODE_RANK"] == "1"
        assert "JAX_PROCESS_ID" not in env
        assert ("poddefault.admission.kubeflow.org/poddefault-proxy"
                in patched["metadata"]["annotations"])
    finally:
        await client.close()


async def test_admission_server_rejects_conflicts_and_bad_specs():
    kube = FakeKube()
    await kube.create("PodDefault", {
        "metadata": {"name": "clash", "namespace": "ns"},
        "spec": {"selector": {}, "env": [{"name": "A", "value": "pd-value"}]}})
    client = await _client(create_webhook_app(kube))
    try:
        pod = {"kind": "Pod", "metadata": {"name": "p", "namespace": "ns"},
               "spec": {"containers": [{"name": "c", "env": [
                   {"name": "A", "value": "mine"}]}]}}
        resp = await client.post("/apply-poddefault", json=admission_review(pod))
        body = await resp.json()
        assert body["response"]["allowed"] is False
        assert "conflict" in body["response"]["status"]["message"].lower()

        nb = {"kind": "Notebook", "metadata": {"name": "n", "namespace": "ns"},
              "spec": {"gpu": {"accelerator": "nope", "topology": "1x8"},
                       "template": {"spec": {"containers": [{"image": "i"}]}}}}
        resp = await client.post("/mutate-notebooks", json=admission_review(nb))
        assert (await resp.json())["response"]["allowed"] is False

        # A TPU block is refused on GPU nodes, naming spec.gpu.
        tpu = copy.deepcopy(nb)
        tpu["spec"]["tpu"] = tpu["spec"].pop("gpu")
        tpu["spec"]["tpu"].update(accelerator="v5e", topology="2x2")
        resp = await client.post("/mutate-notebooks", json=admission_review(tpu))
        body = await resp.json()
        assert body["response"]["allowed"] is False
        assert "spec.gpu" in body["response"]["status"]["message"]

        nb["spec"]["gpu"] = {"accelerator": GPU, "topology": "1x8"}
        resp = await client.post("/mutate-notebooks", json=admission_review(nb))
        body = await resp.json()
        assert body["response"]["allowed"] is True
        patched = apply(nb, decode_patch(body))
        # Defaulter named container[0] after the notebook.
        assert patched["spec"]["template"]["spec"]["containers"][0]["name"] == "n"
    finally:
        await client.close()


async def test_admission_server_multislice_global_rank_on_the_wire():
    """The wire path computes the multislice rank: PET_NODE_RANK =
    slice_id * nodes_per_slice + ordinal, TPU_WORKER_ID stays per slice."""
    client = await _client(create_webhook_app(FakeKube()))
    try:
        pod = _gpu_pod("nb-s1-1", "2x8", **{keys.TPU_SLICE_ID: "1",
                                            keys.TPU_NUM_SLICES: "2"})
        _, env = await _patched_env(client, "/mutate-pods", pod)
        assert env["TPU_WORKER_ID"] == "1"
        assert env["PET_NODE_RANK"] == "3"
    finally:
        await client.close()


async def test_the_notebook_route_holds_the_card_quota():
    """Capacity fast-fail on the wire: a gang over the Profile's
    ``gpuQuota`` is denied at CREATE."""
    from kubeflow_tpu_torch.api import profile as profileapi

    kube = FakeKube()
    await kube.create("Profile", profileapi.new("ns", "a@example.com",
                                                gpu_quota=8))
    client = await _client(create_webhook_app(kube))
    try:
        for topology, allowed in (("1x8", True), ("2x8", False)):
            nb = nbapi.new("nb", "ns", accelerator=GPU, topology=topology)
            resp = await client.post("/mutate-notebooks",
                                     json=admission_review(nb))
            body = (await resp.json())["response"]
            assert body["allowed"] is allowed, body
        assert "spec.gpuQuota" in body["status"]["message"]
    finally:
        await client.close()


# ---- parity: both packages' apps, the same reviews --------------------------

# The port's names for the reference's accelerator env and keys.
ENV_NAMES = {"PET_NODE_RANK": "JAX_PROCESS_ID"}


def _objects(pkg: str) -> dict:
    def load(name):
        return importlib.import_module(f"{pkg}.{name}")

    nb, pvc, tb = load("api.notebook"), load("api.pvcviewer"), load("api.tensorboard")
    profile = load("api.profile")
    # Two hosts, two nodes.
    accelerator = {"accelerator": "v5e", "topology": "4x4"} if pkg == REFERENCE \
        else {"accelerator": GPU, "topology": "2x8"}
    no_container = {"apiVersion": nb.API_VERSION, "kind": "Notebook",
                    "metadata": {"name": "Bad_Name!", "namespace": "ns"},
                    "spec": {"template": {"spec": {"containers": []}}}}
    old = nb.new("old", "ns")
    old["apiVersion"] = "kubeflow.org/v1beta1"
    old_profile = profile.new("team", "a@example.com")
    old_profile["apiVersion"] = "kubeflow.org/v1beta1"
    pod = {"kind": "Pod", "metadata": {
        "name": "nb-1", "labels": {"notebook-name": "nb"},
        "annotations": {keys.TPU_ACCELERATOR: accelerator["accelerator"],
                        keys.TPU_TOPOLOGY: accelerator["topology"]}},
        "spec": {"containers": [{"name": "nb", "env": []}, {"name": "side"}]}}
    multislice = copy.deepcopy(pod)
    multislice["metadata"]["name"] = "nb-s1-1"
    multislice["metadata"]["annotations"].update({
        keys.TPU_SLICE_ID: "1", keys.TPU_NUM_SLICES: "2"})
    plain_pod = {"kind": "Pod", "metadata": {
        "name": "web-0", "labels": {"notebook-name": "nb"}},
        "spec": {"containers": [{"name": "c", "env": [
            {"name": "B", "value": "mine"}]}]}}
    return {
        "reviews": [
            ("/apply-poddefault", pod), ("/mutate-pods", multislice),
            ("/apply-poddefault", plain_pod),
            ("/mutate-notebooks", nb.new("cpu", "ns")),
            ("/mutate-notebooks", no_container),
            ("/mutate-pvcviewers", pvc.new("view", "ns", "data")),
            ("/mutate-pvcviewers", {"kind": "PVCViewer", "metadata": {
                "name": "nopvc", "namespace": "ns"}, "spec": {}}),
            ("/validate-tensorboards", tb.new("tb", "ns", "pvc://logs/run1",
                                              profiler=True)),
            ("/validate-tensorboards", tb.new("tb", "ns", "")),
            ("/validate-tensorboards", tb.new("tb", "ns", "pvc://")),
            ("/validate-profiles", profile.new("team", "a@example.com")),
            ("/validate-profiles", {"kind": "Profile",
                                    "metadata": {"name": "team"}, "spec": {}}),
            ("/validate-poddefaults", {"kind": "PodDefault", "metadata": {
                "name": "pd", "namespace": "ns"}, "spec": {
                "selector": {"matchLabels": {"a": "b"}}, "desc": "d"}}),
            ("/validate-poddefaults", {"kind": "PodDefault", "metadata": {
                "name": "pd", "namespace": "ns"}, "spec": {}}),
        ],
        "conversions": [
            ([old], "kubeflow.org/v1"), ([old_profile], "kubeflow.org/v1"),
            ([{"apiVersion": "kubeflow.org/v1alpha1", "kind": "PodDefault",
               "metadata": {"name": "pd"}}], "kubeflow.org/v1"),
        ],
        "accelerator_notebook": nb.new("acc", "ns", **accelerator),
    }


def _unaccelerated(patch: list) -> list:
    """A patch with the port's env names read as the reference's."""
    text = json.dumps(patch)
    for port_name, ref_name in ENV_NAMES.items():
        text = text.replace(f'"{port_name}"', f'"{ref_name}"')
    return json.loads(text)


async def _answers(pkg: str) -> dict:
    fakekube = importlib.import_module(f"{pkg}.testing.fakekube")
    server = importlib.import_module(f"{pkg}.webhooks.server")
    metrics = importlib.import_module(f"{pkg}.runtime.metrics")
    kube = fakekube.FakeKube()
    await kube.create("PodDefault", {
        "metadata": {"name": "proxy", "namespace": "ns"},
        "spec": {"selector": {"matchLabels": {"notebook-name": "nb"}},
                 "env": [{"name": "HTTPS_PROXY", "value": "http://p:3128"}],
                 "volumes": [{"name": "cache", "emptyDir": {}}],
                 "volumeMounts": [{"name": "cache", "mountPath": "/cache"}]}})
    objects = _objects(pkg)
    client = await _client(server.create_webhook_app(
        kube, registry=metrics.Registry()))
    out: dict = {"reviews": [], "conversions": []}
    try:
        for i, (path, obj) in enumerate(objects["reviews"]):
            resp = await client.post(path, json=admission_review(
                obj, uid=f"u{i}", namespace="ns"))
            body = await resp.json()
            response = dict(body["response"])
            response["patch"] = _unaccelerated(decode_patch(body)) \
                if response.get("patch") else None
            out["reviews"].append((path, resp.status, body["apiVersion"],
                                   response))
        for i, (objs, desired) in enumerate(objects["conversions"]):
            resp = await client.post("/convert", json={
                "apiVersion": "apiextensions.k8s.io/v1",
                "kind": "ConversionReview",
                "request": {"uid": f"c{i}", "desiredAPIVersion": desired,
                            "objects": objs}})
            out["conversions"].append((resp.status, await resp.json()))
        resp = await client.post("/mutate-notebooks", json=admission_review(
            objects["accelerator_notebook"], uid="acc", namespace="ns"))
        out["accelerator_notebook_allowed"] = (await resp.json())["response"][
            "allowed"]
        resp = await client.get("/metrics")
        out["metrics"] = sorted(
            line for line in (await resp.text()).splitlines()
            if line.startswith("webhook_admission_total"))
    finally:
        await client.close()
    return out


async def test_both_apps_answer_the_same_reviews_the_same():
    port, ref = await _answers(PORT), await _answers(REFERENCE)
    assert [r[:2] for r in port["reviews"]] == [r[:2] for r in ref["reviews"]]
    for got, want in zip(port["reviews"], ref["reviews"]):
        assert got == want, got[0]
    assert port["conversions"] == ref["conversions"]
    assert port["metrics"] == ref["metrics"]
    assert port["accelerator_notebook_allowed"] is \
        ref["accelerator_notebook_allowed"] is True
    # The accelerator pods' env on the wire: the per-node ordinal and the
    # job-wide rank under the port's names.
    for i, rank in ((0, "1"), (1, "3")):
        env = [op["value"] for op in port["reviews"][i][3]["patch"]
               if op["path"] == "/spec/containers/0/env/-"]
        assert {"name": "JAX_PROCESS_ID", "value": rank} in env
    denied = [r for r in port["reviews"] if not r[3]["allowed"]]
    assert len(denied) == 6


async def test_the_port_app_names_its_gpu_env_on_the_wire():
    """The one difference the parity test maps away: the port's pod route
    injects PET_NODE_RANK where the reference injects JAX_PROCESS_ID."""
    client = await _client(create_webhook_app(FakeKube()))
    try:
        pod = _gpu_pod("nb-2", "4x8")   # four nodes, the third
        resp = await client.post("/mutate-pods",
                                 json=admission_review(pod, namespace="ns"))
        patch = json.loads(base64.b64decode(
            (await resp.json())["response"]["patch"]))
        names = {e["name"] for op in patch for e in (
            op["value"] if isinstance(op["value"], list) else [op["value"]])}
        assert names == {"TPU_WORKER_ID", "PET_NODE_RANK"}
    finally:
        await client.close()


async def test_neither_app_serves_an_inference_service_route():
    """The reference's wire server has no InferenceService route (its
    quota and ceiling run only in the in-process chain); the port mirrors
    it, route for route."""
    for pkg in (PORT, REFERENCE):
        server = importlib.import_module(f"{pkg}.webhooks.server")
        fakekube = importlib.import_module(f"{pkg}.testing.fakekube")
        app = server.create_webhook_app(fakekube.FakeKube())
        routes = sorted((r.method, r.resource.canonical)
                        for r in app.router.routes())
        if pkg == PORT:
            port_routes = routes
        client = await _client(app)
        try:
            resp = await client.post("/mutate-inferenceservices", json={})
            assert resp.status == 404
        finally:
            await client.close()
    assert port_routes == routes
    assert not any("inference" in path for _, path in routes)
