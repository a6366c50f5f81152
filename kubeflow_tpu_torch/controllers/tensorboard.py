"""Tensorboard reconciler: CR → Deployment + Service (+ VirtualService);
the port of ``kubeflow_tpu/controllers/tensorboard.py``.

Reference: ``tensorboard-controller/controllers/tensorboard_controller.go``:

- ``Reconcile`` (:67-157), ``generateDeployment`` (:167-299) with gs://
  creds mount (:232-247), scheme parsing (:380-410), RWO-PVC co-scheduling
  via node affinity with the pod currently mounting the claim (:428-471,
  gated by ``RWO_PVC_SCHEDULING``), image from env (:172), Service 80→6006,
  VirtualService ``/tensorboard/<ns>/<name>/`` with 300 s timeout (:370).

``spec.profilerPlugin`` starts TensorBoard with the profile plugin over
the logdir that ``sdk.trace`` / ``sdk.capture_profile`` write their
``torch.profiler`` traces (``*.pt.trace.json``) into. The default image
stays the reference's ``tensorflow/tensorflow:latest``, whose profile
plugin reads ``xplane.pb`` files: what its capture button records from a
notebook that runs ``sdk.start_profiler_server`` (the card's kernels
included); browsing the torch traces needs an image with the PyTorch
profiler plugin, set through ``TENSORBOARD_IMAGE``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

from kubeflow_tpu_torch.api import tensorboard as tbapi
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
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.manager import Controller, Manager, Result, Watch
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    get_meta,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.runtime.tracing import span

log = logging.getLogger(__name__)

TB_PORT = 6006


@dataclass
class TensorboardOptions:
    image: str = "tensorflow/tensorflow:latest"      # TENSORBOARD_IMAGE
    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"
    cluster_domain: str = "cluster.local"
    rwo_pvc_scheduling: bool = True                   # RWO_PVC_SCHEDULING
    gcp_creds_secret: str | None = None               # mounted for gs:// when set


class TensorboardReconciler:
    def __init__(self, kube, options: TensorboardOptions | None = None):
        self.kube = kube
        self.opts = options or TensorboardOptions()
        # Wired by setup_tensorboard_controller; bare-reconciler tests run
        # with the apiserver fallbacks.
        self._pod_informer = None
        self._child_informers: dict[str, object] = {}
        self._reader = informer_reader(self._child_informers)
        self._apply_cache = ApplyCache()

    async def reconcile(self, key) -> Result | None:
        ns, name = key
        with span("cache_read"):
            tb = await self.kube.get_or_none("Tensorboard", name, ns)
        if tb is None or get_meta(tb).get("deletionTimestamp"):
            return None
        with span("build_children"):
            try:
                deployment = await self.generate_deployment(tb)
            except Invalid as e:
                log.warning("tensorboard %s/%s: %s", ns, name, e)
                return None
            children = [deployment, self.generate_service(tb)] + (
                [self.generate_virtual_service(tb)]
                if self.opts.use_istio else []
            )
        with span("apply"):
            # Deployment / Service / VirtualService are independent —
            # one stage, all children overlap (latency hiding).
            outcomes = await apply_set(
                self.kube, [Stage("children", children)],
                cache=self._apply_cache, reader=self._reader, owner=tb,
            )
        live_deployment = next(
            (row.result for row in outcomes[0]
             if isinstance(row.child, dict)
             and row.child.get("kind") == "Deployment"), None)
        with span("status"):
            await self._update_status(tb, live_deployment)
        return None

    async def generate_deployment(self, tb: dict) -> dict:
        name, ns = name_of(tb), namespace_of(tb)
        logspath = str(deep_get(tb, "spec", "logspath", default=""))
        scheme, claim, logdir = tbapi.parse_logspath(logspath)

        command = [
            "/usr/local/bin/tensorboard",
            f"--logdir={logdir}",
            "--bind_all",
            f"--port={TB_PORT}",
        ]
        if deep_get(tb, "spec", "profilerPlugin"):
            # Profiler traces land as training runs; poll the logdir.
            command.append("--reload_multifile=true")

        container: dict = {
            "name": "tensorboard",
            "image": self.opts.image,
            "command": command,
            "ports": [{"containerPort": TB_PORT, "name": "http", "protocol": "TCP"}],
        }
        volumes: list[dict] = []
        pod_spec: dict = {"containers": [container], "volumes": volumes}

        if scheme == tbapi.SCHEME_PVC:
            volumes.append(
                {"name": "logs", "persistentVolumeClaim": {"claimName": claim}}
            )
            container["volumeMounts"] = [
                {"name": "logs", "mountPath": "/tensorboard_logs", "readOnly": True}
            ]
            if self.opts.rwo_pvc_scheduling:
                affinity = await rwo_affinity(
                    self.kube, ns, claim, pod_informer=self._pod_informer)
                if affinity:
                    pod_spec["affinity"] = affinity
        elif scheme == tbapi.SCHEME_GCS and self.opts.gcp_creds_secret:
            # Reference mounts user-gcp-sa creds (:232-247); on GKE prefer
            # Workload Identity (profile plugin) — secret is the fallback.
            volumes.append(
                {
                    "name": "gcp-creds",
                    "secret": {"secretName": self.opts.gcp_creds_secret},
                }
            )
            container["volumeMounts"] = [
                {"name": "gcp-creds", "mountPath": "/secret/gcp", "readOnly": True}
            ]
            container["env"] = [
                {
                    "name": "GOOGLE_APPLICATION_CREDENTIALS",
                    "value": "/secret/gcp/user-gcp-sa.json",
                }
            ]

        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": pod_spec,
                },
            },
        }

    def generate_service(self, tb: dict) -> dict:
        name, ns = name_of(tb), namespace_of(tb)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "type": "ClusterIP",
                "selector": {"app": name},
                "ports": [
                    {"name": "http", "port": 80, "targetPort": TB_PORT,
                     "protocol": "TCP"}
                ],
            },
        }

    def generate_virtual_service(self, tb: dict) -> dict:
        name, ns = name_of(tb), namespace_of(tb)
        prefix = f"/tensorboard/{ns}/{name}/"
        return {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"tensorboard-{ns}-{name}", "namespace": ns},
            "spec": {
                "hosts": [self.opts.istio_host],
                "gateways": [self.opts.istio_gateway],
                "http": [
                    {
                        "match": [{"uri": {"prefix": prefix}}],
                        "rewrite": {"uri": "/"},
                        "route": [
                            {
                                "destination": {
                                    "host": f"{name}.{ns}.svc."
                                    f"{self.opts.cluster_domain}",
                                    "port": {"number": 80},
                                }
                            }
                        ],
                        "timeout": "300s",
                    }
                ],
            },
        }

    async def _update_status(self, tb: dict, deployment: dict | None) -> None:
        name, ns = name_of(tb), namespace_of(tb)
        ready = deep_get(deployment or {}, "status", "readyReplicas", default=0) or 0
        conditions = deep_get(deployment or {}, "status", "conditions", default=[])
        status = {
            "readyReplicas": ready,
            "conditions": [
                {"deploymentState": c.get("type", "")} for c in conditions
            ] or ([{"deploymentState": "Available"}] if ready else []),
        }
        if deep_get(tb, "status") != status:
            await self.kube.patch(
                "Tensorboard", name, {"status": status}, ns, subresource="status"
            )


def setup_tensorboard_controller(
    mgr: Manager, options: TensorboardOptions | None = None
) -> TensorboardReconciler:
    rec = TensorboardReconciler(mgr.kube, options)
    owned = ["Deployment", "Service"] + (
        ["VirtualService"] if rec.opts.use_istio else [])
    mgr.add_controller(
        Controller(
            name="tensorboard",
            kind="Tensorboard",
            reconcile=rec.reconcile,
            owns=owned,
        )
    )
    # update(), not rebind: rec._reader closed over this dict in __init__.
    rec._child_informers.update({k: mgr.informer_for(k) for k in owned})
    if rec.opts.rwo_pvc_scheduling:
        rec._pod_informer = mgr.informer_for("Pod")
        rec._pod_informer.add_indexer(POD_PVC_INDEX, index_pod_by_pvc)
    return rec
