#!/usr/bin/env python3
"""Conformance runner: 20 checks, one JSON line each + a summary line.

The port of ``conformance/run.py`` onto the port's control plane: the
same checks under the same names and in the same order, a multi-node
slice as an ``nvidia-h100-80gb`` gang of two nodes (``2x8``) where the
reference's is a v5e ``4x4``. Hermetic by default (in-process fake
cluster + controllers); ``--live`` targets the in-cluster apiserver or
``kubectl proxy`` on 127.0.0.1:8001 (``runtime.httpclient.HttpKube``)
instead and skips the checks that need the simulator (pod Ready states,
fault injection).

The pipeline-parallel step runs the pipelined dp x pp x tp train step in
a world of 8 processes (data 2 x stage 2 x model 2, the mesh the
reference forms from 8 devices) on the card: over NCCL, one process a
card, with 8 cards, else over gloo with every process on the card(s).
``--device cpu`` runs it on the CPU over gloo; with no card and no
``--device cpu`` the check fails naming the missing card, it never falls
back to the CPU.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import sys
import time

import torch

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.api import pvcviewer as pvcapi
from kubeflow_tpu_torch.api import tensorboard as tbapi
from kubeflow_tpu_torch.api.keys import API_V1BETA1
from kubeflow_tpu_torch.controllers.culling import (CullingOptions,
                                                    setup_culling_controller)
from kubeflow_tpu_torch.controllers.notebook import setup_notebook_controller
from kubeflow_tpu_torch.controllers.profile import setup_profile_controller
from kubeflow_tpu_torch.controllers.pvcviewer import setup_pvcviewer_controller
from kubeflow_tpu_torch.controllers.tensorboard import (
    setup_tensorboard_controller)
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta
from kubeflow_tpu_torch.runtime.scheme import DEFAULT_SCHEME

NS = "conformance"
# A two-node gang (gpu/topology.ACCELERATORS): the reference's v5e 4x4.
GPU = "nvidia-h100-80gb"
SLICE = "2x8"

# The reference's pipeline-parallel check: its config at the default
# attention, 2 token rows a data shard, and the (data, stage, model) mesh
# it forms from 8 devices.
PP_CONFIG = dict(vocab=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                 seq_len=12, n_micro=2)
PP_MESH = (2, 2, 2)
PP_WORLD = math.prod(PP_MESH)
PP_ROWS = 2
PP_SEED = 0
PP_TIMEOUT = 600.0


class Skip(Exception):
    """Check not applicable in this mode (e.g. needs the pod simulator)."""


def _env(pod: dict) -> dict:
    return {e["name"]: e.get("value")
            for e in deep_get(pod, "spec", "containers")[0]["env"]}


def pp_world(device: str | None) -> tuple:
    """``(device, backend, cuda)`` of the pipeline-parallel step's world:
    the CPU over gloo only when ``device`` is "cpu"; else the card, over
    NCCL with a card for each process, over gloo with the processes
    sharing the card(s) otherwise. No card raises."""
    if device == "cpu":
        return "cpu", "gloo", False
    if not torch.cuda.is_available():
        raise RuntimeError(
            "the pipeline-parallel step needs a CUDA card and "
            "torch.cuda.is_available() is false; pass --device cpu to run "
            "it on the CPU")
    backend = "nccl" if torch.cuda.device_count() >= PP_WORLD else "gloo"
    return "cuda", backend, True


def pp_step_rank(rank: int, device: str, params: dict | None = None,
                 config: dict = PP_CONFIG) -> dict:
    """One process of the pipeline-parallel step at ``config``: its shard
    of the seeded params (or of ``params``, an unsharded f32 tree) and its
    data shard of the all-zero tokens, one SGD step; the global loss."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.models import pipelined
    from kubeflow_tpu_torch.models.tree import map_params

    cfg = pipelined.PipelinedConfig(**config)
    _, n_stages, n_model = PP_MESH
    mesh = pipelined.make_pp_mesh(n_stages, n_model, device_type=device)
    dev = torch.device(device)  # "cuda": the card launch.run_world set
    tree = (pipelined.init_params(cfg, seed=PP_SEED, device=dev)
            if params is None else map_params(lambda t: t.to(dev), params))
    tree = pipelined.shard_params(tree, mesh, cfg)
    tokens = torch.zeros((PP_ROWS, cfg.seq_len), dtype=torch.long,
                         device=dev)
    _, loss = pipelined.make_train_step(cfg, mesh)(tree, tokens)
    return {"loss": float(loss), "backend": dist.get_backend(),
            "device": loss.device.type}


def pipeline_parallel_step(device: str | None, params: dict | None = None,
                           config: dict = PP_CONFIG) -> dict:
    """The step in its world (:func:`pp_world`): each rank's loss
    (:func:`pp_step_rank`), and the world's ``world``, ``backend`` and
    ``device``."""
    from kubeflow_tpu_torch.parallel import launch

    device, backend, cuda = pp_world(device)
    ranks = launch.run_world(pp_step_rank, PP_WORLD, device, params, config,
                             backend=backend, cuda=cuda, timeout=PP_TIMEOUT)
    ran_on = {r["device"] for r in ranks}
    if ran_on != {device}:
        raise RuntimeError(f"the step ran on {ran_on}, not {device}")
    return {"world": PP_WORLD, "backend": backend, "device": device,
            "losses": [r["loss"] for r in ranks]}


class Conformance:
    def __init__(self, kube, mgr=None, sim=None, culler=None, clock=None,
                 device: str | None = None):
        self.kube = kube
        self.mgr = mgr
        self.sim = sim
        self.culler = culler
        self.clock = clock
        self.device = device
        self.results: list[dict] = []

    async def settle(self):
        if self.mgr is None:
            await asyncio.sleep(2.0)
            return
        for _ in range(10):
            await self.mgr.wait_idle(timeout=30)
            await asyncio.sleep(0.02)

    async def check(self, name, fn):
        """Run one check and print its line; a check may return a dict of
        fields for its line."""
        start = time.perf_counter()
        try:
            extra = await fn()
            result = {"check": name, "pass": True, **(extra or {})}
        except Skip as e:
            result = {"check": name, "pass": True, "skipped": str(e) or "skipped"}
        except Exception as e:  # noqa: BLE001 — report, don't abort the suite
            result = {"check": name, "pass": False, "error": f"{type(e).__name__}: {e}"}
        result["seconds"] = round(time.perf_counter() - start, 3)
        self.results.append(result)
        print(json.dumps(result), flush=True)

    # ---- checks ---------------------------------------------------------------

    async def check_crds(self):
        for kind in ("Notebook", "Profile", "PodDefault", "Tensorboard", "PVCViewer"):
            DEFAULT_SCHEME.by_kind(kind)

    async def check_notebook_lifecycle(self):
        await self.kube.create("Notebook", nbapi.new("conf-nb", NS))
        await self.settle()
        if self.sim is not None:  # pod Ready needs the kubelet (simulator)
            nb = await self.kube.get("Notebook", "conf-nb", NS)
            assert deep_get(nb, "status", "readyReplicas") == 1, "not Ready"
        else:
            assert await self.kube.get_or_none("StatefulSet", "conf-nb", NS), (
                "StatefulSet not created")
        await self.kube.patch(
            "Notebook", "conf-nb",
            {"metadata": {"annotations": {nbapi.STOP_ANNOTATION: "t"}}}, NS)
        await self.settle()
        sts = await self.kube.get("StatefulSet", "conf-nb", NS)
        assert deep_get(sts, "spec", "replicas") == 0, "stop did not park"
        await self.kube.patch(
            "Notebook", "conf-nb",
            {"metadata": {"annotations": {nbapi.STOP_ANNOTATION: None}}}, NS)
        await self.settle()
        await self.kube.delete("Notebook", "conf-nb", NS)
        await self.settle()
        assert await self.kube.get_or_none("StatefulSet", "conf-nb", NS) is None, (
            "cascade delete failed")

    async def check_multi_host_slice(self):
        await self.kube.create(
            "Notebook", nbapi.new("conf-slice", NS, accelerator=GPU, topology=SLICE))
        await self.settle()
        sts = await self.kube.get("StatefulSet", "conf-slice", NS)
        assert deep_get(sts, "spec", "replicas") == 2
        headless = await self.kube.get("Service", "conf-slice-workers", NS)
        assert deep_get(headless, "spec", "clusterIP") == "None"
        ids, ranks = set(), set()
        for i in range(2):
            pod = await self.kube.get_or_none("Pod", f"conf-slice-{i}", NS)
            if pod:
                env = _env(pod)
                ids.add(env.get("TPU_WORKER_ID"))
                ranks.add(env.get("PET_NODE_RANK"))
                assert "conf-slice-workers" in env["TPU_WORKER_HOSTNAMES"]
        if self.sim is not None:
            assert ids == {"0", "1"}, f"worker ids {ids}"
            assert ranks == {"0", "1"}, f"node ranks {ranks}"

    async def check_multislice(self):
        """spec.gpu.numSlices fans out one StatefulSet per slice with the
        slices' env and the global process space wired."""
        await self.kube.create(
            "Notebook",
            nbapi.new("conf-ms", NS, accelerator=GPU, topology=SLICE,
                      num_slices=2))
        await self.settle()
        for j in range(2):
            sts = await self.kube.get("StatefulSet", f"conf-ms-s{j}", NS)
            assert deep_get(sts, "spec", "replicas") == 2
            assert deep_get(sts, "spec", "serviceName") == "conf-ms-workers"
        headless = await self.kube.get("Service", "conf-ms-workers", NS)
        assert deep_get(headless, "spec", "selector") == {
            "notebook-name": "conf-ms"}
        if self.sim is not None:
            env = _env(await self.kube.get("Pod", "conf-ms-s1-1", NS))
            assert env.get("MEGASCALE_SLICE_ID") == "1"
            assert env.get("MEGASCALE_NUM_SLICES") == "2"
            assert env.get("PET_NODE_RANK") == "3"  # slice·nodes + ordinal
            assert env.get("PET_NNODES") == "4"
        await self.kube.delete("Notebook", "conf-ms", NS)

    async def check_poddefault(self):
        await self.kube.create(
            "PodDefault",
            {"metadata": {"name": "conf-pd", "namespace": NS},
             "spec": {"selector": {"matchLabels": {"notebook-name": "conf-pd-nb"}},
                      "env": [{"name": "CONF", "value": "1"}]}})
        await self.kube.create("Notebook", nbapi.new("conf-pd-nb", NS))
        await self.settle()
        if self.sim is not None:
            env = _env(await self.kube.get("Pod", "conf-pd-nb-0", NS))
            assert env.get("CONF") == "1", "PodDefault not injected"
        try:
            await self.kube.create(
                "PodDefault",
                {"metadata": {"name": "bad", "namespace": NS}, "spec": {}})
            raise AssertionError("selector-less PodDefault accepted")
        except Invalid:
            pass

    async def check_profile(self):
        await self.kube.create(
            "Profile", profileapi.new("conf-tenant", "conf@example.com", gpu_quota=8))
        await self.settle()
        assert await self.kube.get_or_none("Namespace", "conf-tenant")
        quota = await self.kube.get("ResourceQuota", "kf-resource-quota", "conf-tenant")
        assert quota["spec"]["hard"]["requests.nvidia.com/gpu"] == "8"
        for sa in ("default-editor", "default-viewer"):
            assert await self.kube.get_or_none("ServiceAccount", sa, "conf-tenant")

    async def check_tensorboard_pvcviewer(self):
        await self.kube.create("Tensorboard", tbapi.new("conf-tb", NS, "gs://b/l"))
        await self.kube.create(
            "PersistentVolumeClaim",
            {"metadata": {"name": "conf-data", "namespace": NS},
             "spec": {"accessModes": ["ReadWriteMany"]}})
        await self.kube.create("PVCViewer", pvcapi.new("conf-view", NS, "conf-data"))
        await self.settle()
        assert await self.kube.get_or_none("Deployment", "conf-tb", NS)
        assert await self.kube.get_or_none("Deployment", "conf-view-pvcviewer", NS)
        if self.sim is not None:
            tb = await self.kube.get("Tensorboard", "conf-tb", NS)
            assert deep_get(tb, "status", "readyReplicas") == 1

    async def check_culling(self):
        if self.culler is None:
            raise Skip("needs the in-process culler + fake clock")
        await self.kube.create("Notebook", nbapi.new("conf-cull", NS))
        await self.settle()
        await self.culler.reconcile((NS, "conf-cull"))  # seeds idle clock
        self.clock.offset += 10_000
        await self.culler.reconcile((NS, "conf-cull"))
        await self.settle()
        sts = await self.kube.get("StatefulSet", "conf-cull", NS)
        assert deep_get(sts, "spec", "replicas") == 0, "idle notebook not parked"

    async def check_slice_restart(self):
        if self.sim is None:
            raise Skip("needs the simulator's fault injection")
        crashed = {"done": False}

        def injector(pod):
            if get_meta(pod)["name"] == "conf-frag-1" and not crashed["done"]:
                crashed["done"] = True
                return "crash"
            return None

        self.sim.failure_injector = injector
        await self.kube.create(
            "Notebook", nbapi.new("conf-frag", NS, accelerator=GPU, topology=SLICE))
        await self.settle()
        await self.settle()
        events = await self.kube.list("Event", NS)
        assert any(e.get("reason") == "SliceRestart" for e in events)
        self.sim.failure_injector = None

    async def check_preemption_recovery(self):
        """A spot-preempted worker (DisruptionTarget condition) triggers a
        slice-atomic restart classified SlicePreempted, and the
        replacement gang converges back to Ready."""
        if self.sim is None:
            raise Skip("needs the simulator's fault injection")
        hit = {"done": False}

        def injector(pod):
            if get_meta(pod)["name"] == "conf-spot-1" and not hit["done"]:
                hit["done"] = True
                return "disrupt"
            return None

        self.sim.failure_injector = injector
        await self.kube.create(
            "Notebook",
            nbapi.new("conf-spot", NS, accelerator=GPU, topology=SLICE))
        await self.settle()
        await self.settle()
        events = await self.kube.list("Event", NS)
        assert any(
            e.get("reason") == "SlicePreempted" for e in events), (
            sorted({e.get("reason") for e in events}))
        nb = await self.kube.get("Notebook", "conf-spot", NS)
        assert deep_get(nb, "status", "readyReplicas") == 2, (
            "replacement slice did not converge")
        self.sim.failure_injector = None

    async def check_queued_provisioning(self):
        """spec.gpu.queuedProvisioning gates the gang on a GKE
        ProvisioningRequest: no StatefulSet until Provisioned=True, then
        the pods consume the reservation."""
        if self.sim is None:
            # Live mode: patching the PR status would impersonate (and
            # race) the real autoscaler, and the CRD may not exist.
            raise Skip("needs the simulated autoscaler")
        await self.kube.create(
            "Notebook",
            nbapi.new("conf-queued", NS, accelerator=GPU, topology=SLICE,
                      queued=True))
        await self.settle()
        assert await self.kube.get_or_none(
            "StatefulSet", "conf-queued", NS) is None, (
            "gang created before capacity was provisioned")
        pr = await self.kube.get(
            "ProvisioningRequest", "conf-queued-capacity", NS)
        assert deep_get(pr, "spec", "podSets")[0]["count"] == 2
        await self.kube.patch(
            "ProvisioningRequest", "conf-queued-capacity",
            {"status": {"conditions": [
                {"type": "Provisioned", "status": "True"}]}},
            NS, subresource="status")
        await self.settle()
        sts = await self.kube.get("StatefulSet", "conf-queued", NS)
        anns = deep_get(sts, "spec", "template", "metadata", "annotations")
        assert anns.get(
            "cluster-autoscaler.kubernetes.io/consume-provisioning-request"
        ) == "conf-queued-capacity"
        if self.sim is not None:
            nb = await self.kube.get("Notebook", "conf-queued", NS)
            assert deep_get(nb, "status", "readyReplicas") == 2

    async def check_maintenance_mirror(self):
        """A maintenance taint on a worker's node mirrors onto the CR
        (annotation + Warning event + checkpoint message) and clears with
        the taint."""
        if self.sim is None:
            raise Skip("needs the simulator (taints placed by the test)")
        from kubeflow_tpu_torch.controllers.notebook import (
            DEFAULT_MAINTENANCE_TAINTS)

        await self.kube.create("Node", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "conf-gpu-node"}, "spec": {}})
        await self.kube.create(
            "Notebook",
            nbapi.new("conf-maint", NS, accelerator=GPU, topology=SLICE))
        await self.settle()
        await self.kube.patch(
            "Pod", "conf-maint-0",
            {"spec": {"nodeName": "conf-gpu-node"}}, NS)
        await self.kube.patch(
            "Node", "conf-gpu-node",
            {"spec": {"taints": [
                {"key": DEFAULT_MAINTENANCE_TAINTS[0],
                 "effect": "NoSchedule"}]}})
        await self.settle()
        nb = await self.kube.get("Notebook", "conf-maint", NS)
        anns = get_meta(nb).get("annotations") or {}
        assert anns.get(nbapi.MAINTENANCE_ANNOTATION) == "conf-gpu-node", anns
        events = await self.kube.list("Event", NS)
        assert any(e.get("reason") == "MaintenancePending" for e in events)
        await self.kube.patch(
            "Node", "conf-gpu-node", {"spec": {"taints": []}})
        await self.settle()
        nb = await self.kube.get("Notebook", "conf-maint", NS)
        assert not (get_meta(nb).get("annotations") or {}).get(
            nbapi.MAINTENANCE_ANNOTATION)

    async def check_version_conversion(self):
        """Old served apiVersions reconcile like v1."""
        if self.sim is None:
            # Live clusters route old versions through the CRD conversion
            # webhook (and HttpKube always posts the storage version); the
            # in-process rewrite this asserts is hermetic-only.
            raise Skip("hermetic-only: live conversion goes via the webhook")
        nb = nbapi.new("conf-beta", NS)
        nb["apiVersion"] = API_V1BETA1
        await self.kube.create("Notebook", nb)
        await self.settle()
        stored = await self.kube.get("Notebook", "conf-beta", NS)
        assert stored["apiVersion"] == nbapi.STORAGE_API_VERSION, (
            f"not normalized: {stored['apiVersion']}")
        assert await self.kube.get_or_none("StatefulSet", "conf-beta", NS), (
            "v1beta1 CR did not reconcile")

    async def check_event_hygiene(self):
        """Events predating the CR are invisible to the status machine."""
        from kubeflow_tpu_torch.web.common.status import (filter_events,
                                                          process_status)

        nb = nbapi.new("conf-ev", NS)
        nb["metadata"]["creationTimestamp"] = "2026-01-02T00:00:00Z"
        stale = [{"type": "Warning", "message": "old crash",
                  "lastTimestamp": "2026-01-01T00:00:00Z"}]
        assert filter_events(nb, stale) == []
        assert "old crash" not in process_status(nb, stale).message

    async def check_contributor_authz(self):
        """KFAM binding grants access through SAR; strangers are denied."""
        if self.mgr is None:
            raise Skip("live clusters bring their own RBAC")
        from kubeflow_tpu_torch.testing.rbac import register_sar_evaluator
        from kubeflow_tpu_torch.web.common.auth import SarAuthorizer
        from kubeflow_tpu_torch.web.dashboard.kfam import InProcessKfam

        register_sar_evaluator(self.kube)
        await self.kube.create(
            "Profile", profileapi.new("conf-authz", "owner@example.com"))
        await self.settle()
        kfam = InProcessKfam(self.kube)
        await kfam.add_contributor(
            "owner@example.com", "conf-authz", "friend@example.com")
        authz = SarAuthorizer(self.kube)
        assert await authz.check(
            "friend@example.com", "list", "Notebook", "conf-authz")
        assert not await authz.check(
            "stranger@example.com", "list", "Notebook", "conf-authz")
        await kfam.remove_contributor(
            "owner@example.com", "conf-authz", "friend@example.com")
        assert not await authz.check(
            "friend@example.com", "list", "Notebook", "conf-authz")

    async def check_profile_v1beta1(self):
        """Profile served at v1beta1 normalizes to storage v1."""
        if self.sim is None:
            raise Skip("hermetic-only: live conversion goes via the webhook")
        p = profileapi.new("conf-beta", "beta@example.com")
        p["apiVersion"] = API_V1BETA1
        await self.kube.create("Profile", p)
        await self.settle()
        stored = await self.kube.get("Profile", "conf-beta")
        assert stored["apiVersion"] == profileapi.STORAGE_API_VERSION, (
            stored["apiVersion"])
        back = profileapi.convert(stored, API_V1BETA1)
        assert back["apiVersion"] == API_V1BETA1
        await self.kube.delete("Profile", "conf-beta")

    async def check_image_catalog(self):
        """The spawner's image selection pins from the catalog ConfigMap at
        admission (odh ImageStream resolution, rebuilt k8s-native)."""
        from kubeflow_tpu_torch.runtime.deployment import controller_namespace

        ns = controller_namespace()
        if await self.kube.get_or_none("ConfigMap", "notebook-images", ns):
            raise Skip("cluster already has a notebook-images catalog; "
                       "not overwriting the admin's")
        await self.kube.create("ConfigMap", {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "notebook-images", "namespace": ns},
            "data": {"images.yaml":
                     "conf/jax:\n  latest: conf.io/jax@sha256:c0ffee\n"},
        })
        try:
            nb = nbapi.new("conf-cat", NS, image="conf/jax:latest")
            get_meta(nb).setdefault("annotations", {})[
                nbapi.IMAGE_SELECTION_ANNOTATION] = "conf/jax:latest"
            await self.kube.create("Notebook", nb)
            stored = await self.kube.get("Notebook", "conf-cat", NS)
            image = deep_get(stored, "spec", "template", "spec",
                             "containers")[0]["image"]
            assert image == "conf.io/jax@sha256:c0ffee", image
            await self.kube.delete("Notebook", "conf-cat", NS)
        finally:
            await self.kube.delete("ConfigMap", "notebook-images", ns)

    async def check_pipeline_rbac(self):
        """A pipelines Role in the namespace earns the notebook's SA an
        owned RoleBinding (odh notebook_rbac.go analogue)."""
        created_role = await self.kube.get_or_none(
            "Role", "pipeline-user-access", NS) is None
        if created_role:
            await self.kube.create("Role", {
                "apiVersion": "rbac.authorization.k8s.io/v1", "kind": "Role",
                "metadata": {"name": "pipeline-user-access", "namespace": NS},
                "rules": [],
            })
        try:
            await self.kube.create("Notebook", nbapi.new("conf-rbac", NS))
            await self.settle()
            rb = await self.kube.get_or_none(
                "RoleBinding", "pipelines-pipeline-user-access-conf-rbac", NS)
            assert rb is not None, "pipeline RoleBinding not created"
            assert rb["subjects"][0]["kind"] == "ServiceAccount"
            await self.kube.delete("Notebook", "conf-rbac", NS)
        finally:
            if created_role:
                await self.kube.delete("Role", "pipeline-user-access", NS)

    async def check_pipeline_parallel_step(self):
        """The dp×pp×tp train step runs across the 8 ranks of a world on
        the card (:func:`pipeline_parallel_step`), with a finite loss; its
        line names the world, its backend and its device."""
        # to_thread: the world takes seconds to start; it must not block
        # this event loop (--live mode shares it with HTTP watches).
        ran = await asyncio.to_thread(pipeline_parallel_step, self.device)
        assert all(math.isfinite(loss) for loss in ran["losses"]), (
            f"non-finite pipelined loss {ran['losses']}")
        return {key: ran[key] for key in ("world", "backend", "device")}

    async def check_sidecar_isolation(self):
        """A sidecar crash must NOT trigger the slice-atomic restart."""
        if self.sim is None:
            raise Skip("needs the simulator's fault injection")
        from kubeflow_tpu_torch.controllers.notebook import AUTH_PROXY_ANNOTATION

        def injector(pod):
            if get_meta(pod)["name"] == "conf-side-1":
                return "crash:auth-proxy"
            return None

        self.sim.failure_injector = injector
        nb = nbapi.new("conf-side", NS, accelerator=GPU, topology=SLICE)
        nb["metadata"].setdefault("annotations", {})[
            AUTH_PROXY_ANNOTATION] = "true"
        await self.kube.create("Notebook", nb)
        await self.settle()
        await self.settle()
        events = await self.kube.list("Event", NS)
        slice_restarts = [
            e for e in events
            if e.get("reason") == "SliceRestart"
            and "conf-side" in str(e.get("involvedObject", {}).get("name"))
        ]
        assert not slice_restarts, "sidecar crash restarted the slice"
        self.sim.failure_injector = None


async def run(live: bool, device: str | None = None) -> int:
    if live:
        from kubeflow_tpu_torch.runtime.deployment import controller_namespace
        from kubeflow_tpu_torch.runtime.errors import AlreadyExists
        from kubeflow_tpu_torch.runtime.httpclient import HttpKube

        kube = HttpKube()
        # The checks' working namespace AND the controller namespace (the
        # image-catalog check writes its ConfigMap there) must exist on a
        # real cluster. Only AlreadyExists is benign — a 403/5xx here
        # would otherwise cascade into twenty misleading 404s.
        for ns_name in (NS, controller_namespace()):
            try:
                await kube.create("Namespace", {
                    "apiVersion": "v1", "kind": "Namespace",
                    "metadata": {"name": ns_name}})
            except AlreadyExists:
                pass
        conf = Conformance(kube, device=device)
    else:
        from kubeflow_tpu_torch.controllers.notebook import NotebookOptions
        from kubeflow_tpu_torch.testing.fakekube import FakeKube
        from kubeflow_tpu_torch.testing.podsim import PodSimulator
        from kubeflow_tpu_torch.webhooks.register import register_all

        kube = FakeKube()
        register_all(kube)
        mgr = Manager(kube)
        # auth_proxy_image on so the sidecar-isolation check exercises a
        # really-injected sidecar, not a no-op.
        setup_notebook_controller(
            mgr, NotebookOptions(auth_proxy_image="authproxy:conformance")
        )

        class OffsetClock:
            def __init__(self):
                self.offset = 0.0

            def __call__(self):
                return time.time() + self.offset

        clock = OffsetClock()

        async def idle_prober(_url):
            return []

        culler = setup_culling_controller(
            mgr, idle_prober, CullingOptions(cull_idle_seconds=300,
                                             enable_culling=True),
            clock=clock)
        setup_profile_controller(mgr)
        setup_tensorboard_controller(mgr)
        setup_pvcviewer_controller(mgr)
        sim = PodSimulator(kube)
        await mgr.start()
        await sim.start()
        conf = Conformance(kube, mgr, sim, culler, clock, device=device)

    await conf.check("crds-registered", conf.check_crds)
    await conf.check("notebook-lifecycle", conf.check_notebook_lifecycle)
    await conf.check("multi-host-slice", conf.check_multi_host_slice)
    await conf.check("multislice-megascale", conf.check_multislice)
    await conf.check("poddefault-injection", conf.check_poddefault)
    await conf.check("profile-tenancy", conf.check_profile)
    await conf.check("tensorboard-pvcviewer", conf.check_tensorboard_pvcviewer)
    await conf.check("culling", conf.check_culling)
    await conf.check("slice-atomic-restart", conf.check_slice_restart)
    await conf.check("preemption-recovery", conf.check_preemption_recovery)
    await conf.check("queued-provisioning", conf.check_queued_provisioning)
    await conf.check("maintenance-mirror", conf.check_maintenance_mirror)
    await conf.check("version-conversion", conf.check_version_conversion)
    await conf.check("event-hygiene", conf.check_event_hygiene)
    await conf.check("contributor-authz", conf.check_contributor_authz)
    await conf.check("sidecar-restart-isolation", conf.check_sidecar_isolation)
    await conf.check("profile-v1beta1", conf.check_profile_v1beta1)
    await conf.check("image-catalog-pinning", conf.check_image_catalog)
    await conf.check("pipeline-rbac", conf.check_pipeline_rbac)
    await conf.check("pipeline-parallel-step", conf.check_pipeline_parallel_step)

    passed = sum(1 for r in conf.results if r["pass"])
    print(json.dumps({"summary": f"{passed}/{len(conf.results)} checks passed"}))

    if conf.mgr is not None:
        await conf.sim.stop()
        await conf.mgr.stop()
        conf.kube.close_watches()
    else:
        await conf.kube.close()
    return 0 if passed == len(conf.results) else 1


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--live", action="store_true")
    parser.add_argument("--device", choices=("cuda", "cpu"), default=None,
                        help="where the pipeline-parallel step runs "
                             "(default: the card)")
    args = parser.parse_args()
    sys.exit(asyncio.run(run(args.live, args.device)))


if __name__ == "__main__":
    main()
