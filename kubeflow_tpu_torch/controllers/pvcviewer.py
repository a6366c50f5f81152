"""PVCViewer reconciler: CR → filebrowser Deployment + Service (+ VS);
the port of ``kubeflow_tpu/controllers/pvcviewer.py``.

Reference: ``pvcviewer-controller/controllers/pvcviewer_controller.go``
(:96-146) with the file-based defaulting webhook folded into
``api.pvcviewer.default`` (pvcviewer_webhook.go:33-60) and RWO
co-scheduling like the tensorboard controller.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from kubeflow_tpu_torch.api import pvcviewer as pvcapi
from kubeflow_tpu_torch.controllers.common import (
    POD_PVC_INDEX,
    index_pod_by_pvc,
    rwo_affinity,
)
from kubeflow_tpu_torch.runtime.apply import (
    ApplyCache,
    Stage,
    apply_set,
    informer_reader,
)
from kubeflow_tpu_torch.runtime.manager import Controller, Manager, Result
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    deepcopy,
    get_meta,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.runtime.tracing import span

log = logging.getLogger(__name__)


@dataclass
class PVCViewerOptions:
    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"
    cluster_domain: str = "cluster.local"


class PVCViewerReconciler:
    def __init__(self, kube, options: PVCViewerOptions | None = None):
        self.kube = kube
        self.opts = options or PVCViewerOptions()
        # Wired by setup_pvcviewer_controller; bare-reconciler tests run
        # with the apiserver fallbacks.
        self._pod_informer = None
        self._child_informers: dict[str, object] = {}
        self._reader = informer_reader(self._child_informers)
        self._apply_cache = ApplyCache()

    async def reconcile(self, key) -> Result | None:
        ns, name = key
        with span("cache_read"):
            viewer = await self.kube.get_or_none("PVCViewer", name, ns)
        if viewer is None or get_meta(viewer).get("deletionTimestamp"):
            return None
        pvcapi.default(viewer)  # idempotent; covers CRs that bypassed admission

        with span("build_children"):
            deployment = await self.generate_deployment(viewer)
            children = [deployment, self.generate_service(viewer)]
            if self.opts.use_istio:
                children.append(self.generate_virtual_service(viewer))
        with span("apply"):
            # Independent children — one stage, applied concurrently
            # (latency hiding).
            outcomes = await apply_set(
                self.kube, [Stage("children", children)],
                cache=self._apply_cache, reader=self._reader, owner=viewer,
            )
        live_deployment = next(
            (row.result for row in outcomes[0]
             if isinstance(row.child, dict)
             and row.child.get("kind") == "Deployment"), None)
        with span("status"):
            await self._update_status(viewer, live_deployment)
        return None

    async def generate_deployment(self, viewer: dict) -> dict:
        name, ns = name_of(viewer), namespace_of(viewer)
        pod_spec = deepcopy(deep_get(viewer, "spec", "podSpec", default={}))
        if deep_get(viewer, "spec", "rwoScheduling"):
            affinity = await rwo_affinity(
                self.kube, ns, deep_get(viewer, "spec", "pvc"),
                pod_informer=self._pod_informer,
            )
            if affinity:
                pod_spec["affinity"] = affinity
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": f"{name}-pvcviewer", "namespace": ns},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"pvcviewer": name}},
                "template": {
                    "metadata": {"labels": {"pvcviewer": name}},
                    "spec": pod_spec,
                },
            },
        }

    def generate_service(self, viewer: dict) -> dict:
        name, ns = name_of(viewer), namespace_of(viewer)
        target = deep_get(
            viewer, "spec", "networking", "targetPort",
            default=pvcapi.DEFAULT_TARGET_PORT,
        )
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"{name}-pvcviewer", "namespace": ns},
            "spec": {
                "type": "ClusterIP",
                "selector": {"pvcviewer": name},
                "ports": [
                    {"name": "http", "port": 80, "targetPort": target,
                     "protocol": "TCP"}
                ],
            },
        }

    def url_of(self, viewer: dict) -> str:
        name, ns = name_of(viewer), namespace_of(viewer)
        base = deep_get(
            viewer, "spec", "networking", "basePrefix",
            default=pvcapi.DEFAULT_BASE_PREFIX,
        )
        return f"{base}/{ns}/{name}/"

    def generate_virtual_service(self, viewer: dict) -> dict:
        name, ns = name_of(viewer), namespace_of(viewer)
        prefix = self.url_of(viewer)
        rewrite = deep_get(viewer, "spec", "networking", "rewrite", default=prefix)
        http = {
            "match": [{"uri": {"prefix": prefix}}],
            "rewrite": {"uri": rewrite},
            "route": [
                {
                    "destination": {
                        "host": f"{name}-pvcviewer.{ns}.svc."
                        f"{self.opts.cluster_domain}",
                        "port": {"number": 80},
                    }
                }
            ],
        }
        timeout = deep_get(viewer, "spec", "networking", "timeout")
        if timeout:
            http["timeout"] = timeout
        return {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"pvcviewer-{ns}-{name}", "namespace": ns},
            "spec": {
                "hosts": [self.opts.istio_host],
                "gateways": [self.opts.istio_gateway],
                "http": [http],
            },
        }

    async def _update_status(self, viewer: dict, deployment: dict | None) -> None:
        name, ns = name_of(viewer), namespace_of(viewer)
        ready = deep_get(deployment or {}, "status", "readyReplicas", default=0) or 0
        replicas = deep_get(deployment or {}, "spec", "replicas", default=1)
        status = {
            "ready": bool(ready) and ready == replicas,
            "conditions": deep_get(deployment or {}, "status", "conditions",
                                   default=[]),
        }
        if self.opts.use_istio:
            status["url"] = self.url_of(viewer)
        if deep_get(viewer, "status") != status:
            await self.kube.patch(
                "PVCViewer", name, {"status": status}, ns, subresource="status"
            )


def setup_pvcviewer_controller(
    mgr: Manager, options: PVCViewerOptions | None = None
) -> PVCViewerReconciler:
    rec = PVCViewerReconciler(mgr.kube, options)
    owned = ["Deployment", "Service"] + (
        ["VirtualService"] if rec.opts.use_istio else [])
    mgr.add_controller(
        Controller(
            name="pvcviewer",
            kind="PVCViewer",
            reconcile=rec.reconcile,
            owns=owned,
        )
    )
    # update(), not rebind: rec._reader closed over this dict in __init__.
    rec._child_informers.update({k: mgr.informer_for(k) for k in owned})
    rec._pod_informer = mgr.informer_for("Pod")
    rec._pod_informer.add_indexer(POD_PVC_INDEX, index_pod_by_pvc)
    return rec
