"""The port's profile controller (``kubeflow_tpu_torch/controllers/
profile.py``) on ``spec.gpuQuota``: the five cases of
tests/test_profile_controller.py — namespace, RBAC and quota; the quota
removed with its spec; the Workload Identity plugin and the finalizer's
revoke; the Istio AuthorizationPolicy; the hot-reloaded namespace labels
— each also run on the reference with ``spec.tpuQuota``, and every child
compared: they are equal outside the quota's accelerator key
(``requests.nvidia.com/gpu`` for ``requests.google.com/tpu``).
"""

import asyncio
import copy
import importlib

import pytest

from kubeflow_tpu_torch.controllers.profile import (
    DEFAULT_EDITOR,
    DEFAULT_VIEWER,
    PROFILE_FINALIZER,
)
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta
from torch_control import PORT, REFERENCE, clear_kftpu_env

GPU_KEY = "requests.nvidia.com/gpu"
TPU_KEY = "requests.google.com/tpu"
CHILDREN = (("Namespace", None), ("ServiceAccount", DEFAULT_EDITOR),
            ("ServiceAccount", DEFAULT_VIEWER), ("RoleBinding", DEFAULT_EDITOR),
            ("RoleBinding", DEFAULT_VIEWER), ("RoleBinding", "namespaceAdmin"),
            ("ResourceQuota", "kf-resource-quota"),
            ("AuthorizationPolicy", "ns-owner-access-istio"))
VOLATILE = ("uid", "creationTimestamp", "resourceVersion", "lastProbeTime",
            "lastTransitionTime", "managedFields", "generation")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    clear_kftpu_env(monkeypatch)


class Stack:
    """The fake apiserver, the admission chain and a manager running the
    profile controller, from one package."""

    def __init__(self, pkg: str, **opts):
        def load(name):
            return importlib.import_module(f"{pkg}.{name}")

        self.api = load("api.profile")
        self.kube = load("testing.fakekube").FakeKube()
        load("webhooks").register_all(self.kube)
        self.mgr = load("runtime.manager").Manager(
            self.kube, registry=load("runtime.metrics").Registry())
        profile = load("controllers.profile")
        self.rec = profile.setup_profile_controller(
            self.mgr, profile.ProfileOptions(**opts))
        self.quota_arg = "gpu_quota" if pkg == PORT else "tpu_quota"

    def new(self, name, owner, quota=None, **kw):
        if quota is not None:
            kw[self.quota_arg] = quota
        return self.api.new(name, owner, **kw)

    async def __aenter__(self):
        await self.mgr.start()
        return self

    async def __aexit__(self, *exc):
        await self.mgr.stop()
        self.kube.close_watches()

    async def settle(self):
        for _ in range(5):
            await self.mgr.wait_idle()
            await asyncio.sleep(0.02)

    async def children(self, ns: str) -> dict:
        out = {}
        for kind, name in CHILDREN:
            obj = await self.kube.get_or_none(kind, name or ns,
                                              None if name is None else ns)
            out[(kind, name)] = _scrub(obj)
        profile = await self.kube.get_or_none("Profile", ns)
        out["status"] = _scrub(deep_get(profile or {}, "status"))
        out["finalizers"] = get_meta(profile or {}).get("finalizers")
        return out


def _scrub(node):
    if isinstance(node, dict):
        return {k: _scrub(v) for k, v in node.items() if k not in VOLATILE}
    if isinstance(node, list):
        return [_scrub(v) for v in node]
    return node


def _outside_quota_key(children: dict, key: str) -> dict:
    children = copy.deepcopy(children)
    quota = children[("ResourceQuota", "kf-resource-quota")]
    if quota is not None:
        quota["spec"]["hard"].pop(key, None)
    return children


async def _both(case, **opts) -> tuple:
    """Run one case on each package; return (port's, reference's)."""
    out = []
    for pkg in (PORT, REFERENCE):
        async with Stack(pkg, **opts) as s:
            out.append(await case(s))
    return tuple(out)


async def test_profile_materialises_namespace_rbac_and_quota():
    async def case(s):
        await s.kube.create("Profile", s.new(
            "alice", "alice@example.com", quota=16,
            resource_quota={"hard": {"requests.cpu": "8"}}))
        await s.settle()
        return await s.children("alice")

    got, ref = await _both(case)
    ns = got[("Namespace", None)]
    assert get_meta(ns)["labels"]["istio-injection"] == "enabled"
    assert get_meta(ns)["annotations"]["owner"] == "alice@example.com"
    assert got[("ServiceAccount", DEFAULT_EDITOR)] is not None
    assert got[("ServiceAccount", DEFAULT_VIEWER)] is not None
    assert got[("RoleBinding", DEFAULT_EDITOR)]["roleRef"]["name"] == \
        "kubeflow-edit"
    assert got[("RoleBinding", "namespaceAdmin")]["subjects"][0]["name"] \
        == "alice@example.com"
    assert got[("ResourceQuota", "kf-resource-quota")]["spec"]["hard"] == {
        "requests.cpu": "8", GPU_KEY: "16"}
    assert ref[("ResourceQuota", "kf-resource-quota")]["spec"]["hard"][
        TPU_KEY] == "16"
    assert got["status"]["conditions"][0]["type"] == "Successful"
    assert _outside_quota_key(got, GPU_KEY) == _outside_quota_key(ref, TPU_KEY)


async def test_quota_removed_when_spec_cleared():
    async def case(s):
        await s.kube.create("Profile", s.new("bob", "bob@x.com", quota=8))
        await s.settle()
        before = await s.children("bob")
        profile = await s.kube.get("Profile", "bob")
        profile["spec"].pop("gpuQuota" if s.quota_arg == "gpu_quota"
                            else "tpuQuota")
        await s.kube.update("Profile", profile)
        await s.settle()
        return before, await s.children("bob")

    (got_before, got_after), (ref_before, ref_after) = await _both(case)
    assert got_before[("ResourceQuota", "kf-resource-quota")]["spec"][
        "hard"] == {GPU_KEY: "8"}
    assert got_after[("ResourceQuota", "kf-resource-quota")] is None
    assert _outside_quota_key(got_before, GPU_KEY) == \
        _outside_quota_key(ref_before, TPU_KEY)
    assert got_after == ref_after


async def test_workload_identity_plugin_and_finalizer_revoke():
    gsa = "carol@proj.iam.gserviceaccount.com"

    async def case(s):
        await s.kube.create("Profile", s.new(
            "carol", "carol@x.com", quota=4, plugins=[{
                "kind": "WorkloadIdentity",
                "spec": {"gcpServiceAccount": gsa}}]))
        await s.settle()
        before = await s.children("carol")
        # Deleting the profile revokes the binding before the namespace
        # goes.
        await s.kube.delete("Profile", "carol")
        await s.settle()
        return before, await s.children("carol")

    (got, got_after), (ref, ref_after) = await _both(case)
    assert PROFILE_FINALIZER in got["finalizers"]
    assert get_meta(got[("ServiceAccount", DEFAULT_EDITOR)])["annotations"][
        "iam.gke.io/gcp-service-account"] == gsa
    assert all(v is None for k, v in got_after.items() if k != "finalizers")
    assert _outside_quota_key(got, GPU_KEY) == _outside_quota_key(ref, TPU_KEY)
    assert got_after == ref_after


async def test_istio_authorization_policy():
    async def case(s):
        await s.kube.create("Profile", s.new("dave", "dave@x.com", quota=8))
        await s.settle()
        return await s.children("dave")

    got, ref = await _both(case, use_istio=True)
    rules = deep_get(got[("AuthorizationPolicy", "ns-owner-access-istio")],
                     "spec", "rules")
    assert any(r.get("when", [{}])[0].get("values") == ["dave@x.com"]
               for r in rules)
    # The culler's probe path stays reachable.
    assert any(deep_get(r, "to", default=[{}])[0].get("operation", {})
               .get("paths") == ["*/api/kernels"] for r in rules)
    assert _outside_quota_key(got, GPU_KEY) == _outside_quota_key(ref, TPU_KEY)


async def test_namespace_labels_file_hot_reload(tmp_path):
    """The mounted labels file replaces the static labels, and an edit
    converges without a controller restart (the file watcher
    re-enqueues every Profile)."""
    labels_file = tmp_path / "labels.yaml"
    labels_file.write_text("istio-injection: enabled\ntier: bronze\n")
    async with Stack(PORT, namespace_labels_file=str(labels_file)) as s:
        await s.kube.create("Profile", s.new("team", "a@example.com",
                                             quota=8))
        await s.settle()
        ns = await s.kube.get("Namespace", "team")
        assert get_meta(ns)["labels"] == {"istio-injection": "enabled",
                                          "tier": "bronze"}
        labels_file.write_text("istio-injection: enabled\ntier: gold\n")
        for _ in range(40):  # the polling fallback looks every 2 s
            await asyncio.sleep(0.2)
            await s.mgr.wait_idle()
            ns = await s.kube.get("Namespace", "team")
            if get_meta(ns)["labels"].get("tier") == "gold":
                break
        assert get_meta(ns)["labels"]["tier"] == "gold"
        quota = await s.kube.get("ResourceQuota", "kf-resource-quota", "team")
        assert quota["spec"]["hard"] == {GPU_KEY: "8"}
