"""Notebook reconciler: Notebook CR → StatefulSet + Services (+ VirtualService).

Reference behavior being matched (``notebook-controller/controllers/
notebook_controller.go``):

- ``Reconcile`` (:90-272): create/patch StatefulSet, Service, VirtualService;
  mirror pod status into the CR; re-emit pod events onto the CR.
- ``generateStatefulSet`` (:408-484): stop-annotation → replicas 0 (:410-412),
  ``NB_PREFIX`` env (:392-406), fsGroup 100 (:471-482), ``notebook-name``
  label (:430).
- ``generateService`` (:486-513): ClusterIP, port 80 → named port
  ``http-<name>``.
- ``generateVirtualService`` (:519-619): `/notebook/<ns>/<name>/` prefix with
  optional rewrite/headers from annotations.

GPU nodes (the port of ``kubeflow_tpu/controllers/notebook.py``, whose
TPU-native redesign this keeps; only the accelerator layer differs):

- ``spec.gpu`` resolves through :class:`kubeflow_tpu_torch.gpu.topology.GpuSlice`;
  the StatefulSet gets ``replicas = num_hosts`` (one worker pod per GPU
  node), ``podManagementPolicy: Parallel`` (slice workers must start
  together), the GKE accelerator node selector, and ``nvidia.com/gpu``
  card requests.
- A **headless Service** (``<name>-workers``) gives every node a stable DNS
  name for ``PET_MASTER_ADDR`` (node 0, the ``torch.distributed``
  rendezvous on ``gpu.topology.MASTER_PORT``) and ``TPU_WORKER_HOSTNAMES``.
  ``publishNotReadyAddresses: true`` so bootstrap DNS resolves before
  readiness.
- Slice-wide static env (``GpuSlice.worker_env`` / ``MultiSlice.worker_env``)
  goes into the pod template; the *per-node* ``TPU_WORKER_ID`` /
  ``PET_NODE_RANK`` is injected at pod admission from the pod ordinal (see
  ``kubeflow_tpu_torch.webhooks.gpu``) because a StatefulSet template
  cannot vary env per ordinal.
- **Slice-atomic restart**: a multi-node slice is an all-or-nothing unit —
  an NCCL world cannot take back a restarted rank, so the reconciler
  deletes *all* worker pods when any of them enters a terminal failure
  state and lets the StatefulSet rebuild the slice.
- The capacity stage asks the GPU fleet scheduler
  (:mod:`kubeflow_tpu_torch.scheduler`) for gang admission, and a
  single-node gang may be placed on a warm pod
  (:mod:`kubeflow_tpu_torch.controllers.warmpool`); both are wired in
  :func:`setup_notebook_controller` as the reference wires them.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.controllers.common import bounded_name
from kubeflow_tpu_torch.runtime.apply import (
    ApplyCache,
    Stage,
    apply_set,
    informer_reader,
    overlap,
    reconcile_child,
    state_hash,
)
from kubeflow_tpu_torch.runtime.errors import ApiError, Conflict, Invalid, NotFound
from kubeflow_tpu_torch.runtime.events import EventRecorder
from kubeflow_tpu_torch.runtime.informer import (
    NAMESPACE_INDEX,
    OWNER_INDEX,
    index_by_label,
    index_by_namespace,
)
from kubeflow_tpu_torch.runtime.manager import (
    Controller,
    Manager,
    Result,
    Watch,
    soonest,
)
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import (
    annotations_of,
    deep_get,
    fmt_iso,
    get_meta,
    name_of,
    namespace_of,
    now_iso,
    parse_iso,
    set_controller_owner,
    uid_of,
)
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime import timeline as timeline_mod
from kubeflow_tpu_torch.runtime.tracing import current_trace_id, span
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.telemetry import publisher as telemetry_pub
from kubeflow_tpu_torch.gpu.topology import MASTER_PORT, NODE_RANK_ENV, GpuSlice

log = logging.getLogger(__name__)

TPU_ACCELERATOR_ANNOTATION = nbapi.TPU_ACCELERATOR_ANNOTATION
TPU_TOPOLOGY_ANNOTATION = nbapi.TPU_TOPOLOGY_ANNOTATION

# The name of node 0's torch.distributed rendezvous port (torchrun's
# default --master-port) on the container and the headless Service.
RENDEZVOUS_PORT_NAME = "torch-rdzv"

STS_LABEL = "statefulset"  # reference labels pods with statefulset=<name> (:429)
POD_NAME_LABEL = "statefulset.kubernetes.io/pod-name"  # set by the STS controller

# Secondary-index names on the shared informers (runtime/informer.py
# AddIndexers semantics). Every per-reconcile child lookup goes through one
# of these instead of a kube.list() or a cache scan — the control plane
# stays O(changes) as the cluster grows.
NB_POD_INDEX = "notebook-name"      # Pod informer, by notebook-name label
POD_NODE_INDEX = "node"             # Pod informer, by spec.nodeName
EVENT_POD_INDEX = "involved-pod"    # Event informer, by involved Pod


def index_pod_by_node(pod: dict) -> list:
    node = deep_get(pod, "spec", "nodeName")
    return [node] if node else []


def index_event_by_involved_pod(event: dict) -> list:
    involved = event.get("involvedObject") or {}
    if involved.get("kind") != "Pod" or not involved.get("name"):
        return []
    return [(namespace_of(event), involved["name"])]


# Impending-maintenance surfacing: nodes hosting GPU workers get this taint
# from GKE graceful node termination ahead of a maintenance event; the
# controller mirrors it onto the CR (api/notebook.py MAINTENANCE_ANNOTATION,
# a comma-joined sorted node list) so the UI and in-notebook tooling can
# checkpoint before the slice goes down.
MAINTENANCE_ANNOTATION = nbapi.MAINTENANCE_ANNOTATION
DEFAULT_MAINTENANCE_TAINTS = ("cloud.google.com/impending-node-termination",)

# Queued provisioning (spec.gpu.queuedProvisioning): the slice's capacity
# is reserved through a GKE ProvisioningRequest before any worker pod
# exists; once Provisioned, the pods consume the reservation via the
# cluster-autoscaler annotation. Names: <notebook>-capacity for both the
# request and its PodTemplate.
PROVISIONING_CLASS = "queued-provisioning.gke.io"
CONSUME_PR_ANNOTATION = (
    "cluster-autoscaler.kubernetes.io/consume-provisioning-request")
PR_CLASS_ANNOTATION = (
    "cluster-autoscaler.kubernetes.io/provisioning-class-name")


def capacity_name(notebook_name: str) -> str:
    """The one place the PR/PodTemplate/consume-annotation name contract
    lives — three consumers must agree or the pods reference a request
    that doesn't exist."""
    return bounded_name(f"{notebook_name}-capacity")


@dataclass
class NotebookOptions:
    """The reference's env-var sprawl (USE_ISTIO, ISTIO_GATEWAY, CLUSTER_DOMAIN,
    ADD_FSGROUP — notebook_controller.go:213,475,537-560) as one typed block.
    The odh-controller features fold in here too (SURVEY.md §2.1):
    NetworkPolicies (notebook_network.go), trusted-CA aggregation
    (notebook_controller.go:253-353), auth-proxy sidecar (notebook_oauth.go)."""

    use_istio: bool = False
    istio_gateway: str = "kubeflow/kubeflow-gateway"
    istio_host: str = "*"
    cluster_domain: str = "cluster.local"
    add_fsgroup: bool = True
    fsgroup: int = 100
    workers_service_suffix: str = "-workers"
    default_serving_port: int = nbapi.DEFAULT_CONTAINER_PORT
    # NetworkPolicy per notebook: HTTP only from gateway namespaces; slice
    # workers may talk to each other (DCN bootstrap).
    create_network_policies: bool = False
    gateway_namespaces: tuple = ("istio-system", "kubeflow-tpu")
    # Trusted-CA bundle: ConfigMap <trusted_ca_configmap> in
    # <controller_namespace> is mirrored into the notebook namespace and
    # mounted into every container.
    trusted_ca_configmap: str | None = None
    controller_namespace: str = "kubeflow-tpu"
    ca_bundle_mount_path: str = "/etc/pki/tls/certs/custom-ca-bundle.crt"
    # Auth-proxy sidecar (odh oauth-proxy equivalent) for meshless clusters:
    # injected when the notebook has the inject-auth-proxy annotation.
    auth_proxy_image: str | None = None
    auth_proxy_port: int = 3000
    # Pipeline-access RBAC (odh's ReconcileRoleBindings, notebook_rbac.go:
    # 36-154): when a Role with this name exists in the notebook namespace
    # (created by a pipelines deployment), bind the notebook's
    # ServiceAccount to it so in-notebook pipeline clients (elyra-style)
    # can submit runs. None disables the probe entirely.
    pipeline_access_role: str | None = "pipeline-user-access"

    # Taint keys that mean "this node is about to go down for maintenance"
    # (GKE graceful node termination for GPU maintenance events).
    # Empty disables the maintenance-pending mirror.
    maintenance_taints: tuple[str, ...] = DEFAULT_MAINTENANCE_TAINTS

    # Queued provisioning support (spec.gpu.queuedProvisioning). Disable
    # on clusters without the autoscaling.x-k8s.io ProvisioningRequest
    # CRD — the watch would otherwise relist-404 forever. When disabled,
    # a queued spec runs as if unqueued.
    enable_queued_provisioning: bool = True

    # Workqueue event-coalescing window (seconds): a multi-host slice
    # coming up emits one status event per worker pod within milliseconds;
    # the window folds the burst into one reconcile. Small enough to be
    # invisible in ready-latency percentiles. 0 disables.
    coalesce_window: float = 0.005

    # Preempt-to-checkpoint (kubeflow_tpu/migration): drives the
    # annotation-driven suspend/resume flow, the restore-hint pod env,
    # and the status.migration block. Safe on by default — all three are
    # no-ops until a drain/checkpoint annotation exists. The scheduler's
    # own drain path has its own switch (SchedulerOptions/KFTPU_MIGRATION).
    enable_migration: bool = True
    drain_grace_seconds: float = migration.DEFAULT_DRAIN_GRACE_SECONDS


AUTH_PROXY_ANNOTATION = keys.NOTEBOOK_INJECT_AUTH_PROXY
CA_BUNDLE_CONFIGMAP = "kubeflow-tpu-ca-bundle"
CA_BUNDLE_KEY = "ca-bundle.crt"

# Slice-restart backoff state (annotations so damping survives controller
# restarts) + schedule: attempt N waits base·2^(N-1) seconds, capped.
SLICE_RESTART_ATTEMPTS_ANNOTATION = keys.NOTEBOOK_SLICE_RESTART_ATTEMPTS
SLICE_RESTART_AT_ANNOTATION = keys.NOTEBOOK_SLICE_RESTART_AT
SLICE_RESTART_BASE_SECONDS = 10.0
SLICE_RESTART_MAX_SECONDS = 300.0


class NotebookReconciler:
    def __init__(
        self,
        kube,
        options: NotebookOptions | None = None,
        *,
        registry: Registry | None = None,
    ):
        self.kube = kube
        self.opts = options or NotebookOptions()
        self.recorder = EventRecorder(kube, "notebook-controller",
                                      registry=registry)
        # Fleet scheduler (kubeflow_tpu/scheduler): the cluster-level gang
        # arbiter the capacity stage consults before any slice StatefulSet
        # exists. None (bare-reconciler tests, KFTPU_SCHEDULER=off) or an
        # inactive scheduler (no fleet configured) means admission passes
        # through — the pre-scheduler behavior. Set by
        # setup_notebook_controller.
        self._scheduler = None
        # Warm pod pools (controllers/warmpool.py): the claim
        # gate adopts a pre-warmed pod for eligible notebooks instead of
        # creating slice StatefulSets. None (no KFTPU_WARM_POOLS) keeps
        # the cold path byte-for-byte.
        self._warmpool = None
        # (ns, name) → {pod-event-name: count} — events already mirrored, so
        # each reconcile re-emits only NEW occurrences (a plain list-driven
        # re-emit would bump the mirrored count once per reconcile, turning
        # it into a reconcile-frequency counter).
        self._mirrored: dict[tuple, dict[str, int]] = {}
        # ns → (role exists, checked-at); see _namespace_has_role. The
        # generation counter closes the TOCTOU between an in-flight probe
        # and the Role watch busting the cache: a probe only writes its
        # result back if no Role event landed while it was awaiting.
        self._role_probe_cache: dict[str, tuple[bool, float]] = {}
        self._role_probe_gen: dict[str, int] = {}
        self._role_probe_ttl = 60.0
        # Wall clock for the slice-restart backoff; tests inject a fake.
        self._now = time.time
        # Informer handles (set by setup_notebook_controller): mirror and
        # status reads come from the watch-driven caches, not LISTs/GETs
        # per reconcile. None (bare-reconciler unit tests) falls back to
        # direct apiserver reads.
        self._event_informer = None
        self._sts_informer = None
        self._node_informer = None
        self._nb_informer = None
        self._pr_informer = None
        self._pod_informer = None
        # Durable lifecycle timeline recorder (runtime/timeline.py) —
        # the manager's, shared across controllers; None in bare
        # reconciler tests. This reconciler is the SINGLE timeline
        # writer per notebook key (the workqueue serializes reconciles
        # per key), so every layer's transition lands through
        # _update_status exactly once.
        self._timeline = None
        # kind → informer for owned children: reconcile_child reads the
        # live object from the watch cache instead of a per-child GET.
        # (Populated by setup_notebook_controller; the reader reads the
        # dict live.)
        self._child_informers: dict[str, object] = {}
        self._reader = informer_reader(self._child_informers)
        # Write elision: last-applied hashes for children (apply.py) and a
        # per-key last-written status hash, so a reconcile whose desired
        # state is unchanged issues ZERO PATCH/PUT calls.
        self._apply_cache = ApplyCache()
        # (ns, name) → (computed-status hash, stored-status hash); see
        # _update_status for why the pair (not either hash alone) is the
        # elision key.
        self._last_status: dict[tuple, tuple[str, str]] = {}
        # Per-notebook gauge contributions, aggregated incrementally:
        # recomputing the namespace rollup from the informer cache cost
        # O(notebooks-in-ns) per reconcile — O(N²) across a namespace
        # coming up (the scale bench's biggest remaining scan).
        self._gauge_contrib: dict[tuple, tuple[int, int]] = {}
        self._ns_totals: dict[str | None, list[int]] = {}
        # Training telemetry fold: latest decoded annotation
        # entry per key (the /debug/telemetry data source) and the last
        # publish seq fed downstream — the SLO engine, the Prometheus
        # mirror, and the scheduler's efficiency ledger each consume one
        # observation per publish, not one per reconcile.
        self._telemetry: dict[tuple, dict] = {}
        self._telemetry_seq: dict[tuple, int] = {}
        registry = registry or global_registry
        # Metric names match the reference (pkg/metrics/metrics.go:14-62) so
        # dashboards/alerts carry over.
        self.m_create = registry.counter(
            "notebook_create_total", "Total times of creating notebooks"
        )
        self.m_running = registry.gauge(
            "notebook_running", "Running notebooks in the cluster", ["namespace"]
        )
        self.m_chips = registry.gauge(
            "notebook_gpus_requested",
            "GPUs requested by non-stopped notebooks", ["namespace"],
        )
        self.m_status_elided = registry.counter(
            "notebook_status_writes_elided_total",
            "Status reconciles skipped because nothing changed",
        )

    # ---- reconcile --------------------------------------------------------------

    async def reconcile(self, key) -> Result | None:
        namespace, name = key
        # Phase spans: every section below lands in the reconcile's trace
        # tree (manager opens the root + queue_wait), so /debug/traces
        # shows which phase ate the time when a Notebook sticks.
        with span("cache_read"):
            nb = await self.kube.get_or_none("Notebook", name, namespace)
        if nb is None or get_meta(nb).get("deletionTimestamp"):
            self._mirrored.pop((namespace, name), None)
            self._last_status.pop((namespace, name), None)
            self._telemetry.pop((namespace, name), None)
            self._telemetry_seq.pop((namespace, name), None)
            if self._timeline is not None:
                self._timeline.forget((namespace, name))
            # The namespace's running/chip gauges must drop the deleted
            # notebook's contribution now, not at the next unrelated
            # reconcile in this namespace.
            self._set_gauge_contribution(namespace, name, 0, 0)
            if self._scheduler is not None:
                # Admission handle dies with the CR: its chips go back to
                # the fleet and the scheduler re-arbitrates immediately.
                await self._scheduler.release((namespace, name))
            return None  # children die by ownerReference cascade

        try:
            ms = nbapi.multi_slice_of(nb)
        except Invalid as e:
            await self.recorder.event(nb, "Warning", "InvalidSpec", str(e))
            return None
        gpu = ms.slice if ms else None

        # User-facing suspend/resume rides the same drain protocol as
        # scheduler preemption (kubeflow_tpu/migration). Runs before the
        # children phase: a suspend that just acked must park THIS
        # reconcile's StatefulSets, and a resume must un-park before the
        # scheduler gate re-arbitrates. Patches annotations only; the
        # resulting watch event drives the follow-up reconcile.
        suspend_requeue = await self._check_suspend(nb, ms)

        with span("apply"):
            capacity_pending, capacity_requeue, admission, warm = \
                await self._apply_children(nb, ms, gpu)

        with span("status"):
            pods = await self._worker_pods(nb)  # one lookup, shared by the tail
            # The tail's three sections are independent reads over the
            # same pod set (slice health, node taints, event mirror) —
            # against a real apiserver each is its own RTT chain, so
            # overlap them; the status write waits for all three (the
            # restart path's annotation patches must land first).
            requeue, _, _ = await overlap(
                self._restart_broken_slice(nb, ms, pods),
                self._check_maintenance(nb, pods),
                self._mirror_events(nb, pods),
            )
            await self._update_status(nb, ms, capacity_pending=capacity_pending,
                                      admission=admission, pods=pods,
                                      warm=warm)
        if capacity_pending:
            return capacity_requeue
        if admission is not None and admission.state == "Draining" \
                and admission.requeue_after:
            # A draining victim must reconcile again by the grace
            # deadline even if the SDK never acks — the scheduler's
            # hard-stop fallback fires on that pass.
            return _soonest(Result(requeue_after=admission.requeue_after),
                            requeue)
        # Soonest wins: a pending suspend drain's grace deadline must not
        # be deferred behind a longer periodic requeue from the status
        # tail (or vice versa).
        return _soonest(requeue, suspend_requeue)

    async def _apply_children(
        self, nb: dict, ms, gpu
    ) -> tuple[bool, Result | None, object | None, dict | None]:
        """The child-object phase of reconcile as a dependency DAG
        (latency hiding): capacity gate → [all slice
        StatefulSets] → [Service, headless Service, VirtualService,
        NetworkPolicy, RBAC, slice GC]. Stage-mates overlap; each stage
        waits for the previous one, so against a real apiserver the wall
        time is the critical-path RTT depth, not the child count.
        Returns (capacity_pending, capacity_requeue, admission, warm)."""
        # Stage "capacity", part 1: cluster-level gang arbitration
        # (kubeflow_tpu/scheduler). The fleet scheduler is the single
        # admission point between the CR and its slice StatefulSets —
        # while the gang is Queued, nothing downstream runs: no slice
        # may exist and GKE capacity must not be reserved for a gang
        # that lost the arbitration. In-process (no RTT), so it runs
        # before — not overlapped with — the provisioning gate.
        admission = await self._scheduler_gate(nb, ms)
        if admission is not None and admission.state == "Queued":
            # Queued ⇒ no StatefulSet AND no GKE reservation. A PR left
            # behind on any path that still lands here would double-book
            # the physical slice while the chips belong to another gang —
            # drop it (informer-checked: a no-op for the common
            # never-admitted queued gang).
            if self.opts.enable_queued_provisioning and ms \
                    and nbapi.queued_provisioning(nb):
                await self._release_capacity(nb)
            # Same contract for slices: a gang that slipped through the
            # scheduler's pre-activation pass-through window (fresh
            # restart, dynamic fleet source still loading, possibly a
            # partial DAG apply under API faults) can own live
            # StatefulSets by the time arbitration lands Queued — scale
            # them to 0; their chips belong to whoever wins.
            await self._park_queued_slices(nb)
            requeue = Result(requeue_after=(
                self._scheduler.options.queued_requeue_seconds))
            return True, requeue, admission, None
        # Warm-pool claim gate: an admitted (or pass-through)
        # eligible notebook adopts a pre-warmed pod INSTEAD of creating
        # slice StatefulSets — the whole pod+runtime start collapses to
        # a re-label. An empty pool (state "warming") falls through to
        # the cold path transparently.
        warm = await self._warm_claim_gate(nb, ms)
        claimed = warm is not None and warm.get("state") == "claimed"
        if claimed:
            # The adopted pod IS the slice: no ProvisioningRequest (its
            # capacity already exists under the running pod) and no
            # slice StatefulSets.
            capacity_pending, capacity_provisioned, capacity_requeue = \
                False, True, None
        else:
            # Stage "capacity", part 2: the queued-provisioning gate and
            # the CA-bundle mirror are independent round-trip chains —
            # overlap them. The gate's verdict shapes the slices stage,
            # so it stays control flow rather than an apply_set child.
            with span("apply_stage", stage="capacity"):
                (capacity_pending, capacity_provisioned,
                 capacity_requeue), _ = \
                    await overlap(
                        self._capacity_gate(nb, ms),
                        self._mirror_ca_bundle(nb)
                        if self.opts.trusted_ca_configmap else None,
                    )

        # One StatefulSet per slice (placement is per-slice; the data-center
        # network joins them — gpu/topology.py MultiSlice). Single-slice keeps the bare
        # name, zero churn for the common case.
        num_sts = 0 if (capacity_pending or claimed) \
            else (ms.num_slices if ms else 1)
        # Creation events ride the NEXT stage, off the gang's critical
        # path: awaiting each best-effort emission inside its slice child
        # would re-serialize an N-slice cold create on the (deliberately
        # narrow) event lane.
        created_slices: list[str] = []
        try:
            await self._apply_children_stages(
                nb, ms, gpu, num_sts, capacity_provisioned, created_slices)
        except Exception:
            # A stage error skips the services stage — which now carries
            # the creation events. Slices that DID create must still
            # announce themselves (the pre-DAG code emitted each event
            # right after its create); the retry reconcile sees them as
            # pre-existing and would stay silent forever.
            if created_slices:
                try:
                    await self._emit_created_events(nb, created_slices)
                except Exception:
                    # Best-effort by contract: keep the real (stage)
                    # error, but the drop must land in the counter.
                    self.recorder.count_drop()
            raise
        return capacity_pending, capacity_requeue, admission, warm

    async def _scheduler_gate(self, nb: dict, ms):
        """Consult the GPU fleet scheduler (the ``schedule``/``admit``/
        ``preempt`` spans live inside it). Returns the current
        :class:`~kubeflow_tpu_torch.scheduler.runtime.Admission`, or None when
        no scheduler is wired / no fleet is configured / the notebook is
        CPU-only — all of which mean "admit unconditionally".

        A stopped notebook (user stop, culling, or a preemption's stop
        annotation) releases its admission handle here; the normal apply
        path still runs afterwards so the gang actually parks (replicas
        0 everywhere). A gang whose StatefulSets are already live —
        controller restart, scheduler turned on over a running fleet —
        is re-seated (reclaimed), never re-queued."""
        sched = self._scheduler
        if sched is None:
            return None
        key = (namespace_of(nb), name_of(nb))
        if ms is None:
            # Edited from TPU to CPU while Queued/Admitted (the webhook
            # allows spec edits on queued gangs): the gang no longer
            # exists, so drop its queue entry / allocation — otherwise
            # the stale entry holds (or later takes) fleet chips and, if
            # starved, blocks backfill forever. CPU notebooks carry no
            # scheduler status, so the verdict is discarded.
            await sched.release(key, nb)
            return None
        if nbapi.is_stopped(nb):
            return await sched.release(key, nb)
        # Liveness probed unconditionally (not just once the fleet is
        # active) because admission() itself can activate a lazily-
        # discovered fleet — and must then reclaim, not queue, a gang
        # that is already running. A live ProvisioningRequest counts as
        # running for the same reason: it is created only AFTER admission
        # and deleted on park, so across a controller restart it is the
        # proof of admission for a gang still waiting on GKE capacity
        # (no StatefulSet yet) — re-queueing that gang would hand its
        # ledger chips to another while the GKE reservation double-books
        # the physical slice.
        return await sched.admission(
            nb, ms, running=(await self._gang_running(nb, ms)
                             or await self._holds_reservation(nb)))

    async def _park_queued_slices(self, nb: dict) -> None:
        """Scale a Queued gang's leftover slice StatefulSets to zero
        (see the caller for how a Queued gang can own any). Informer
        owner-index first; zero work for the common no-STS queued gang.
        A stale cache at worst defers the park one STS event — the
        queued requeue re-runs this every pass."""
        name, ns = name_of(nb), namespace_of(nb)
        if (self._sts_informer is not None
                and self._sts_informer.has_indexer(OWNER_INDEX)):
            owned = self._sts_informer.by_index(OWNER_INDEX, uid_of(nb))
        else:
            try:
                owned = await self.kube.list(
                    "StatefulSet", ns,
                    label_selector={
                        "matchLabels": {nbapi.NOTEBOOK_NAME_LABEL: name}},
                )
            except ApiError as exc:
                log.debug("queued-slice park LIST for %s/%s failed "
                          "(retried on the queued requeue): %s",
                          ns, name, exc)
                return
        for sts in owned:
            if (deep_get(sts, "spec", "replicas") or 0) > 0:
                try:
                    await self.kube.patch(
                        "StatefulSet", name_of(sts),
                        {"spec": {"replicas": 0}}, ns)
                except (NotFound, ApiError) as exc:
                    log.debug("queued-slice scale-to-0 of %s failed "
                              "(retried on the queued requeue): %s",
                              name_of(sts), exc)

    async def _holds_reservation(self, nb: dict) -> bool:
        """Does this notebook hold a live GKE ProvisioningRequest?
        Informer-checked, so the common no-PR case costs nothing."""
        if not (self.opts.enable_queued_provisioning
                and nbapi.queued_provisioning(nb)):
            return False
        name, ns = name_of(nb), namespace_of(nb)
        cap_name = capacity_name(name)
        if self._pr_informer is not None:
            return self._pr_informer.get(cap_name, ns) is not None
        return await self.kube.get_or_none(
            "ProvisioningRequest", cap_name, ns) is not None

    async def _gang_running(self, nb: dict, ms) -> bool:
        """Is this notebook's gang actively running (slice-0 StatefulSet
        live with replicas > 0)? Informer-cached; shared by the
        scheduler gate (reclaim-vs-queue) and the provisioning gate
        (hold-vs-pass on an unprovisioned request)."""
        sts0 = ms.slice_sts_name(name_of(nb), 0)
        existing = await self._live_sts(sts0, namespace_of(nb))
        return existing is not None and (
            deep_get(existing, "spec", "replicas") or 0) > 0

    async def _check_suspend(self, nb: dict, ms) -> Result | None:
        """Annotation-driven suspend/resume over the drain protocol
        (kubeflow_tpu/migration). Suspend = the SUSPEND annotation
        appears: request a drain (reason ``suspend``), wait for the
        in-pod SDK's checkpoint ack (bounded by the drain grace), then
        park via the stop annotation — so "suspend" is "stop, but my
        training state survives". Resume = the annotation is removed:
        a parked suspend un-parks (the scheduler re-arbitrates and the
        restore hint rides the pod env); a still-draining suspend is
        cancelled. CPU notebooks (no slice, nothing to checkpoint) and
        migration-off park immediately — the pre-migration stop."""
        annotations = annotations_of(nb)
        suspended = nbapi.SUSPEND_ANNOTATION in annotations
        stopped = nbapi.is_stopped(nb)
        reason = migration.drain_reason(annotations)
        ns, name = namespace_of(nb), name_of(nb)
        now = self._now()

        async def patch(anns: dict) -> None:
            await self.kube.patch(
                "Notebook", name, {"metadata": {"annotations": anns}}, ns)

        if suspended and not stopped:
            if not (self.opts.enable_migration and ms
                    and await self._gang_running(nb, ms)):
                # Nothing to checkpoint: CPU notebook, migration off, or
                # a gang with no running pods (queued, provisioning,
                # parked mid-restart) — park immediately; waiting out
                # the drain grace would only delay the stop and emit a
                # spurious deadline warning.
                await patch({nbapi.STOP_ANNOTATION: fmt_iso(now)})
                await self.recorder.event(
                    nb, "Normal", "Suspended", "Suspended (no checkpoint)")
                return None
            requested = migration.drain_requested_at(annotations)
            if requested is None:
                await patch(migration.request_drain_patch("suspend", now))
                await self.recorder.event(
                    nb, "Normal", "SuspendRequested",
                    "Suspend requested; checkpointing before parking "
                    f"(grace {self.opts.drain_grace_seconds:.0f}s)")
                return Result(requeue_after=self.opts.drain_grace_seconds
                              + 0.1)
            if reason != "suspend":
                return None  # a preemption drain owns the marks; its
                             # park satisfies the suspend too
            deadline = requested + self.opts.drain_grace_seconds
            # The park keeps DRAIN_REASON="suspend" as the durable "how
            # it parked" marker — resume (annotation removed while
            # stopped) and derive_state's Parked gate key off it; the
            # request/progress marks clear.
            park_clear = migration.clear_drain_patch(keep_reason=True)
            if migration.drain_acked(annotations):
                await patch({nbapi.STOP_ANNOTATION: fmt_iso(now),
                             **park_clear})
                step = migration.checkpoint_step(annotations)
                await self.recorder.event(
                    nb, "Normal", "Suspended",
                    "Suspended"
                    + (f" (checkpoint @ step {step})"
                       if step is not None else " (checkpoint committed)"))
                return None
            if now >= deadline:
                await patch({nbapi.STOP_ANNOTATION: fmt_iso(now),
                             **park_clear})
                await self.recorder.event(
                    nb, "Warning", "SuspendDeadlineExceeded",
                    f"No checkpoint ack within "
                    f"{self.opts.drain_grace_seconds:.0f}s; suspended "
                    "without a fresh checkpoint")
                return None
            return Result(requeue_after=max(0.1, deadline - now + 0.05))

        if not suspended and reason == "suspend":
            if stopped:
                # Resume: un-park; the scheduler gate re-arbitrates and
                # generate_statefulset stamps the restore hint.
                await patch({nbapi.STOP_ANNOTATION: None,
                             **migration.clear_drain_patch()})
                hint = migration.restore_hint(annotations)
                await self.recorder.event(
                    nb, "Normal", "Resuming",
                    "Resuming"
                    + (f" from checkpoint {hint[0]}"
                       + (f" @ step {hint[1]}"
                          if hint[1] is not None else "")
                       if hint else " (no checkpoint recorded)"))
            else:
                # Suspend cancelled mid-drain: drop the request so the
                # SDK stops checkpointing for a park that isn't coming.
                await patch(migration.clear_drain_patch())
            return None
        if (not stopped and reason and reason != "suspend"
                and migration.drain_requested_at(annotations) is None):
            # Parked-marker hygiene without a scheduler: a cull/preempt
            # park keeps its drain-reason so derive_state can tell a
            # checkpointed park from a plain stop. The fleet scheduler
            # clears it on re-admission; on scheduler-less clusters this
            # is the restart path that does — otherwise a later plain
            # stop would present as "Suspended (checkpoint @ step N)".
            await patch({nbapi.DRAIN_REASON_ANNOTATION: None})
        return None

    async def _warm_claim_gate(self, nb: dict, ms) -> dict | None:
        """Warm pod pools (controllers/warmpool.py): adopt a pre-warmed
        pod for this notebook instead of paying the cold pod + runtime
        start. Returns the warm verdict for status/timeline:
        ``{"state": "claimed", "pod": ...}`` (skip slice StatefulSets —
        the adopted pod IS the slice), ``{"state": "warming", ...}`` (a
        matching pool exists but is EMPTY: the cold path proceeds while
        the pool replenishes, and the miss is surfaced), or None (no
        pool / ineligible / already running cold). Claims route through
        the manager's CAS claim protocol EXCLUSIVELY — enforced by the
        ``warm-pool-contract`` analysis pass."""
        wp = self._warmpool
        annotations = annotations_of(nb)
        claimed_name = annotations.get(nbapi.WARM_CLAIMED_ANNOTATION)
        stopped = nbapi.is_stopped(nb)
        ns, name = namespace_of(nb), name_of(nb)
        clear = {nbapi.WARM_CLAIMED_ANNOTATION: None,
                 nbapi.WARM_CLAIMED_AT_ANNOTATION: None,
                 nbapi.WARM_CLAIMED_IN_ANNOTATION: None}
        if claimed_name:
            pod = await self._claimed_pod(nb, claimed_name)
            adopted = pod is not None and (
                get_meta(pod).get("labels") or {}).get(
                    nbapi.NOTEBOOK_NAME_LABEL) == name
            if stopped or wp is None or ms is None:
                # Park (or the subsystem turned off, or the notebook was
                # edited TPU→CPU): the adopted pod dies with the stop —
                # a restart claims fresh or goes cold; a stale claim
                # must not wedge either path. Only an ADOPTED pod is ours
                # to delete: a stale intent (hand-off never completed)
                # names a pod that is still pool property — or by now
                # another notebook's — so it is cleared without touching
                # the pod.
                if adopted:
                    try:
                        await self.kube.delete("Pod", claimed_name, ns)
                    except (NotFound, ApiError) as exc:
                        log.debug("adopted-pod delete %s on stop failed "
                                  "(GC owner cascade also covers it): "
                                  "%s", claimed_name, exc)
                await self.kube.patch(
                    "Notebook", name,
                    {"metadata": {"annotations": clear}}, ns)
                return None
            if not adopted:
                # Intent without a completed hand-off (a fault landed
                # between the CR stamp and the pod patch): the pod — if
                # it even exists — is still POOL property; clear the
                # stale intent and go cold without touching it.
                await self.kube.patch(
                    "Notebook", name,
                    {"metadata": {"annotations": clear}}, ns)
                return None
            # Broken-pod check against the POD's own container name —
            # an adopted warm pod keeps the pool template's container
            # ("warm"), not the CR's; checking the CR name would let a
            # crashlooping claimed pod wedge readiness forever.
            pod_main = (deep_get(pod, "spec", "containers",
                                 default=[{}]) or [{}])[0].get("name") \
                or _main_container_name(nb)
            if _worker_is_broken(pod, pod_main):
                # Claimed pod broken: transparent cold fallback — THIS
                # reconcile already creates the slice StatefulSets.
                try:
                    await self.kube.delete("Pod", claimed_name, ns)
                except (NotFound, ApiError) as exc:
                    log.debug("broken claimed-pod delete %s failed "
                              "(cold fallback proceeds regardless): %s",
                              claimed_name, exc)
                await self.kube.patch(
                    "Notebook", name,
                    {"metadata": {"annotations": clear}}, ns)
                await self.recorder.event(
                    nb, "Warning", "WarmClaimLost",
                    f"Warm-claimed pod {claimed_name} is broken; "
                    "falling back to the cold start path")
                return None
            return {"state": "claimed", "pod": pod}
        if wp is None or stopped or ms is None \
                or wp.pool_for(nb, ms) is None:
            return None
        if await self._gang_running(nb, ms):
            # Already live on the cold path (restart, scheduler reclaim):
            # claiming now would double-provision the slice.
            return None
        since = self._episode_start(nb)
        pod = await wp.claim(nb, ms, since=since)
        if pod is not None:
            await self.recorder.event(
                nb, "Normal", "WarmClaimed",
                f"Claimed warm pod {name_of(pod)} from the warm pool; "
                "skipping the cold StatefulSet start")
            return {"state": "claimed", "pod": pod,
                    "claimed_in": round(max(0.0, self._now() - since), 3)}
        return {"state": "warming",
                "replenishing": await wp.replenishing_status(nb, ms)}

    async def _claimed_pod(self, nb: dict, pod_name: str) -> dict | None:
        ns = namespace_of(nb)
        if self._pod_informer is not None:
            pod = self._pod_informer.get(pod_name, ns)
            if pod is not None:
                return pod
        return await self.kube.get_or_none("Pod", pod_name, ns)

    def _episode_start(self, nb: dict) -> float:
        """When this startup episode began — the timeline's episode
        boundary (survives re-queues and restarts), falling back to the
        CR's creation time. Feeds the "claimed in Xs" attribution."""
        annotations = annotations_of(nb)
        if self._timeline is not None:
            entries = self._timeline.entries(
                (namespace_of(nb), name_of(nb)), annotations=annotations)
        else:
            entries = timeline_mod.decode(annotations)
        start = timeline_mod.episode_start(entries)
        if start is not None:
            return start["at"]
        created = get_meta(nb).get("creationTimestamp")
        ts = parse_iso(created) if created else None
        return ts if ts is not None else self._now()

    async def _apply_children_stages(
        self, nb: dict, ms, gpu, num_sts: int, capacity_provisioned: bool,
        created_slices: list[str],
    ) -> None:
        await apply_set(
            self.kube,
            [
                Stage("slices", [
                    self._apply_slice_sts(nb, ms, gpu, slice_id,
                                          capacity_provisioned,
                                          created_slices)
                    for slice_id in range(num_sts)
                ]),
                Stage("services", [
                    self._emit_created_events(nb, created_slices),
                    self.generate_service(nb, multi=ms),
                    (self.generate_headless_service(nb, multi=ms)
                     if (gpu and gpu.multi_host) or (ms and ms.multi)
                     else None),
                    (self.generate_virtual_service(nb)
                     if self.opts.use_istio else None),
                    (self.generate_network_policy(nb, gpu)
                     if self.opts.create_network_policies else None),
                    self._ensure_pipeline_rbac(nb),
                    # Covers scale-in (numSlices 4→2) AND the multi→single
                    # transition (numSlices 2→1 renames the STS to the
                    # bare name; the stale -s* StatefulSets must not keep
                    # burning chips). After the slices stage so a rename
                    # creates before it deletes.
                    self._gc_extra_slices(nb, ms) if ms else None,
                ]),
            ],
            cache=self._apply_cache, reader=self._reader, owner=nb,
        )

    async def _capacity_gate(self, nb: dict, ms) -> tuple[bool, bool,
                                                          Result | None]:
        """Queued provisioning: reserve the whole slice's capacity through
        a ProvisioningRequest BEFORE creating any worker — a partially
        scheduled gang on a scarce topology burns quota and wedges
        (every node must land together for the rendezvous). Until
        Provisioned, no StatefulSet exists; the Services are still created
        so DNS is ready the moment pods land. Returns (capacity_pending,
        capacity_provisioned, capacity_requeue)."""
        if not (ms and nbapi.queued_provisioning(nb)
                and self.opts.enable_queued_provisioning):
            return False, True, None
        if nbapi.is_stopped(nb):
            # Parked: the reservation is one-shot — its capacity was
            # consumed (or expired) when the gang went away. Delete the
            # request so a restart queues for FRESH capacity instead of
            # sailing past the gate on a spent Provisioned=True.
            await self._release_capacity(nb)
            return False, True, None
        provisioned, capacity_requeue = await self._ensure_capacity(nb, ms)
        if provisioned:
            return False, True, None
        # The gate holds unless the gang is ACTIVELY running (flag
        # flipped on mid-flight, or the PR deleted from under a live
        # slice — freezing those would block spec drift and flip status
        # to a false capacity wait). A parked STS (replicas 0,
        # reservation released on park) still gates: restart queues for
        # fresh capacity.
        return (not await self._gang_running(nb, ms)), False, \
            capacity_requeue

    async def _apply_slice_sts(
        self, nb: dict, ms, gpu, slice_id: int, capacity_provisioned: bool,
        created_sink: list[str],
    ) -> bool:
        """Build + apply one slice's StatefulSet (an apply_set child —
        slices overlap each other inside the ``slices`` stage). Newly
        created names land in ``created_sink``; their events are emitted
        by the next stage (:meth:`_emit_created_events`)."""
        with span("build_children", kind="StatefulSet", slice=slice_id):
            sts = self.generate_statefulset(
                nb, gpu, multi=ms, slice_id=slice_id,
                capacity_provisioned=capacity_provisioned)
        if self._scheduler is not None:
            flex = self._scheduler.flex_node_selectors(
                (namespace_of(nb), name_of(nb)))
            if flex:
                # Flex (borrowed-host) placement: the workers must land
                # on the HOST pool's nodes — the gang's own shape labels
                # select nothing (that's why it borrowed). Chip request
                # stays the gang's own (sub-host allocation).
                selectors = sts["spec"]["template"]["spec"].setdefault(
                    "nodeSelector", {})
                selectors.update(flex)
        if self.opts.enable_migration:
            await self._stabilize_restore_env(nb, sts)
        if not capacity_provisioned:
            # Sticky consume annotation: when the request is (or has
            # become) unprovisioned over a LIVE gang — e.g. the PR was
            # deleted from under it and recreated — keep whatever the
            # running StatefulSet already carries. Stripping it would
            # diff the template and rolling-restart a healthy slice.
            await self._preserve_consume_annotation(nb, sts)
        created = await self._ensure(nb, sts)
        if created:
            self.m_create.inc()
            created_sink.append(name_of(sts))
        return created

    async def _emit_created_events(self, nb: dict, names: list[str]) -> None:
        """Emit CreatedStatefulSet for every slice the previous stage
        created — concurrently, and overlapping the services stage, so a
        wide cold create never serializes on the event lane's width.
        Consumes ``names``: the rescue emitter in ``_apply_children``
        runs this again when a stage error skipped the services stage,
        and a services-stage SIBLING failure (first-error semantics let
        this child complete first) must not double-emit."""
        if not names:
            return
        batch, names[:] = list(names), []
        await overlap(*(
            self.recorder.event(
                nb, "Normal", "CreatedStatefulSet",
                f"Created StatefulSet {n}")
            for n in batch
        ))

    async def _live_sts(self, name: str, ns: str) -> dict | None:
        """Informer-cached StatefulSet read with apiserver fallback. The
        controller owns StatefulSets, so the informer is always running
        under the manager (a 64-slice notebook would otherwise pay 64
        serialized GETs per reconcile); staleness self-corrects on the
        next STS event."""
        if self._sts_informer is not None:
            return self._sts_informer.get(name, ns)
        return await self.kube.get_or_none("StatefulSet", name, ns)

    async def _stabilize_restore_env(self, nb: dict, sts: dict) -> None:
        """Restore-hint env may only change across a park boundary. For a
        LIVE gang (replicas > 0) the freshly generated template keeps
        exactly the restore env the running pods already have — present
        or absent, with the live values: the hint is moot while the gang
        runs, and adding/updating it (first ack of a drain, a cancelled
        suspend after its ack, an ack→park race) would diff the template
        and rolling-restart pods that nothing intends to disturb. A
        parked or not-yet-created StatefulSet takes the desired hint
        as-is — it rides the same update as the scale-up."""
        live = await self._live_sts(name_of(sts), namespace_of(nb))
        if live is None or not (deep_get(live, "spec", "replicas") or 0):
            return
        restore_keys = (migration.RESTORE_PATH_ENV, migration.RESTORE_STEP_ENV)
        live_env = (deep_get(live, "spec", "template", "spec", "containers",
                             default=[{}]) or [{}])[0].get("env") or []
        live_restore = [dict(e) for e in live_env
                        if e.get("name") in restore_keys]
        main = sts["spec"]["template"]["spec"]["containers"][0]
        env = [e for e in main.get("env", [])
               if e.get("name") not in restore_keys]
        env.extend(live_restore)
        main["env"] = env

    async def _preserve_consume_annotation(self, nb: dict, sts: dict) -> None:
        """Copy the live StatefulSet's consume-provisioning-request
        annotations onto the freshly generated template when the request
        is not (currently) Provisioned. Two cases meet here:

        - PR deleted/recreated under a live consuming gang → the live
          template has the annotation; keeping it avoids a spurious
          rolling restart, and the recreated request reuses the same name.
        - Mid-flight flip (flag turned on over a running gang on a
          cluster without the admission webhook) → the live template has
          no annotation; generating none means no rollout until the
          request actually provisions (an unprovisioned consume reference
          would park replacement pods behind the autoscaler)."""
        live = await self._live_sts(name_of(sts), namespace_of(nb))
        live_anns = deep_get(live, "spec", "template", "metadata",
                             "annotations", default={}) or {}
        if CONSUME_PR_ANNOTATION not in live_anns:
            return
        meta = sts["spec"]["template"].setdefault("metadata", {})
        anns = meta.setdefault("annotations", {})
        anns[CONSUME_PR_ANNOTATION] = live_anns[CONSUME_PR_ANNOTATION]
        if PR_CLASS_ANNOTATION in live_anns:
            anns[PR_CLASS_ANNOTATION] = live_anns[PR_CLASS_ANNOTATION]

    async def _ensure_capacity(self, nb: dict, ms) -> tuple[bool, Result | None]:
        """Reserve the slice's capacity via a GKE ProvisioningRequest
        (queued-provisioning.gke.io). Creates an owned PodTemplate (one
        worker's pod shape — chips + node selectors drive what capacity
        the autoscaler must find) and a ProvisioningRequest asking for
        ``total_hosts`` of them, then reads its conditions:

        - ``Provisioned=True`` → (True, None): create the StatefulSets;
          their pods consume the reservation via CONSUME_PR_ANNOTATION.
        - ``Failed=True`` → Warning event, long requeue (capacity class
          rejected the request; flapping on it would spam the
          autoscaler).
        - otherwise → short requeue while the request queues.

        Both objects are owner-referenced, so they die with the notebook.
        A notebook that turns the flag off keeps its stale request until
        deletion — harmless (Provisioned reservations expire server-side)
        and cheaper than probing for it every reconcile."""
        name, ns = name_of(nb), namespace_of(nb)
        cap_name = capacity_name(name)
        # Steady state: the PR informer already saw Provisioned=True —
        # zero API calls and no throwaway template generation for the
        # rest of the notebook's life.
        cached = (self._pr_informer.get(cap_name, ns)
                  if self._pr_informer is not None else None)
        if cached is not None and any(
            c.get("type") == "Provisioned" and c.get("status") == "True"
            for c in deep_get(cached, "status", "conditions", default=[]) or []
        ):
            return True, None
        # The PR's capacity template must not self-reference the request:
        # the autoscaler matches on shape (resources/selectors), and a
        # consume annotation inside the template it provisions against is
        # at best noise, at worst a circular reference.
        sts = self.generate_statefulset(nb, ms.slice, multi=ms, slice_id=0,
                                        capacity_provisioned=False)
        template = deep_get(sts, "spec", "template", default={})
        pod_template = {
            "apiVersion": "v1",
            "kind": "PodTemplate",
            "metadata": {"name": cap_name, "namespace": ns,
                         "labels": {nbapi.NOTEBOOK_NAME_LABEL: name}},
            "template": template,
        }
        await self._ensure(nb, pod_template)
        pr = {
            "apiVersion": "autoscaling.x-k8s.io/v1beta1",
            "kind": "ProvisioningRequest",
            "metadata": {"name": cap_name, "namespace": ns,
                         "labels": {nbapi.NOTEBOOK_NAME_LABEL: name}},
            "spec": {
                "provisioningClassName": PROVISIONING_CLASS,
                "podSets": [{
                    "podTemplateRef": {"name": cap_name},
                    "count": ms.total_hosts,
                }],
            },
        }
        created = await self._ensure(nb, pr)
        if created:
            await self.recorder.event(
                nb, "Normal", "CapacityRequested",
                f"Created ProvisioningRequest {cap_name} for "
                f"{ms.total_hosts} GPU node(s); workers start once "
                "capacity is provisioned",
            )
        live = await self.kube.get_or_none("ProvisioningRequest", cap_name, ns)
        conditions = deep_get(live, "status", "conditions", default=[]) or []
        by_type = {c.get("type"): c for c in conditions}
        if (by_type.get("Provisioned") or {}).get("status") == "True":
            return True, None
        failed = by_type.get("Failed") or {}
        if failed.get("status") == "True":
            await self.recorder.event(
                nb, "Warning", "CapacityFailed",
                f"ProvisioningRequest {cap_name} failed: "
                f"{failed.get('reason', '')} {failed.get('message', '')}",
            )
            return False, Result(requeue_after=300.0)
        return False, Result(requeue_after=15.0)

    async def _release_capacity(self, nb: dict) -> None:
        """Drop a parked notebook's ProvisioningRequest (informer-checked,
        so steady-state parked notebooks cost nothing). The PodTemplate
        stays — it's inert and the next queue-up reuses the name."""
        name, ns = name_of(nb), namespace_of(nb)
        cap_name = capacity_name(name)
        cached = (self._pr_informer.get(cap_name, ns)
                  if self._pr_informer is not None
                  else await self.kube.get_or_none(
                      "ProvisioningRequest", cap_name, ns))
        if cached is None:
            return
        # Evict from the informer cache regardless of how the delete
        # goes (already-gone, transient apiserver error, success): a
        # restart reconcile can land before the watch task processes the
        # DELETE, and _ensure_capacity's fast path would trust the stale
        # Provisioned=True — sailing past the very gate this release
        # exists to re-arm. If the PR actually still exists, the watch
        # repopulates the cache.
        try:
            await self.kube.delete("ProvisioningRequest", cap_name, ns)
        except NotFound:
            return
        finally:
            if self._pr_informer is not None:
                self._pr_informer.evict(cap_name, ns)
        await self.recorder.event(
            nb, "Normal", "CapacityReleased",
            f"Deleted ProvisioningRequest {cap_name}: the reservation is "
            "one-shot; restarting will queue for fresh capacity",
        )

    async def _ensure_pipeline_rbac(self, nb: dict) -> None:
        """odh notebook_rbac.go:36-154 analogue: if the pipelines Role
        exists in the notebook's namespace, bind the notebook's
        ServiceAccount (pod spec's serviceAccountName, else the profile's
        default-editor) to it via an owned RoleBinding. Skipped silently
        when no pipelines deployment put the Role there."""
        role_name = self.opts.pipeline_access_role
        if not role_name:
            return
        name, ns = name_of(nb), namespace_of(nb)
        if not await self._namespace_has_role(ns, role_name):
            return
        sa = deep_get(nb, "spec", "template", "spec", "serviceAccountName") \
            or "default-editor"
        binding = {
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "RoleBinding",
            "metadata": {
                # roleRef is immutable on a real apiserver, so the binding
                # name derives from the role (apply.py's documented
                # copy_rolebinding_fields invariant): a role-name config
                # change creates a fresh binding; the stale one is
                # garbage-collected with the notebook.
                "name": bounded_name(f"pipelines-{role_name}-{name}"),
                "namespace": ns,
                "labels": {nbapi.NOTEBOOK_NAME_LABEL: name},
            },
            "subjects": [
                {"kind": "ServiceAccount", "name": sa, "namespace": ns}
            ],
            "roleRef": {
                "apiGroup": "rbac.authorization.k8s.io",
                "kind": "Role",
                "name": role_name,
            },
        }
        await self._ensure(nb, binding)

    async def _namespace_has_role(self, ns: str, role_name: str) -> bool:
        """Role-existence probe with a short negative/positive cache — one
        extra GET per notebook reconcile would otherwise hit the apiserver
        on every pod-status event cluster-wide."""
        now = time.monotonic()
        cached = self._role_probe_cache.get(ns)
        if cached and now - cached[1] < self._role_probe_ttl:
            return cached[0]
        gen = self._role_probe_gen.get(ns, 0)
        exists = await self.kube.get_or_none("Role", role_name, ns) is not None
        if self._role_probe_gen.get(ns, 0) == gen:
            self._role_probe_cache[ns] = (exists, now)
        return exists

    async def _ensure(self, nb: dict, desired: dict) -> bool:
        """reconcile_child with ownership; returns True when newly created."""
        set_controller_owner(desired, nb)
        _, created = await reconcile_child(
            self.kube, desired,
            cache=self._apply_cache, reader=self._reader,
        )
        return created

    # ---- object generation ------------------------------------------------------

    def generate_statefulset(
        self, nb: dict, gpu: GpuSlice | None, *, multi=None, slice_id: int = 0,
        capacity_provisioned: bool = True,
    ) -> dict:
        """Reference: generateStatefulSet (notebook_controller.go:408-484).

        ``multi``/``slice_id``: in multislice mode each slice gets its own
        StatefulSet (``<name>-s<j>``) with slice-static MEGASCALE_* and
        node-count env; they all share the notebook's headless Service for
        DNS.

        ``capacity_provisioned``: whether the notebook's ProvisioningRequest
        (if any) is known Provisioned. The consume-provisioning-request
        annotation is only stamped when True — a rolling update whose
        replacement pods reference an *unprovisioned* request would park
        them behind the autoscaler (the mid-flight-flip case: the flag
        turned on over an already-running gang). Once the request
        provisions, the next reconcile rolls the consume annotation on."""
        name, ns = name_of(nb), namespace_of(nb)
        sts_name = multi.slice_sts_name(name, slice_id) if multi else name
        replicas = 0 if nbapi.is_stopped(nb) else (gpu.num_hosts if gpu else 1)

        pod_spec = deep_get(nb, "spec", "template", "spec", default={})
        pod_spec = {**pod_spec}  # shallow copy; containers replaced below
        containers = [dict(c) for c in pod_spec.get("containers", [])]
        if not containers:
            containers = [{"name": name, "image": "kubeflow-tpu/jupyter-jax:latest"}]
        main = containers[0]
        main.setdefault("name", name)
        main.setdefault(
            "ports",
            [{"containerPort": self.opts.default_serving_port, "name": "notebook-port",
              "protocol": "TCP"}],
        )
        self._set_prefix_env(main, ns, name)
        if self.opts.enable_migration:
            self._set_restore_env(main, nb)

        template_annotations: dict[str, str] = {}
        template_labels: dict[str, str] = {
            STS_LABEL: sts_name,
            nbapi.NOTEBOOK_NAME_LABEL: name,
            "app": name,
        }
        if gpu:
            self._apply_gpu(
                main, pod_spec, template_annotations, template_labels, nb, gpu,
                multi=multi, slice_id=slice_id,
            )
            if (nbapi.queued_provisioning(nb)
                    and self.opts.enable_queued_provisioning
                    and capacity_provisioned):
                # Consume the capacity _ensure_capacity reserved instead
                # of triggering fresh (and possibly partial) scale-up.
                # Gated on the SAME flag as the reconcile gate: with the
                # feature off no request exists, and a consume annotation
                # for a nonexistent request parks the pods forever (the
                # autoscaler won't scale up for them).
                template_annotations[CONSUME_PR_ANNOTATION] = \
                    capacity_name(name)
                template_annotations[PR_CLASS_ANNOTATION] = PROVISIONING_CLASS
        containers[0] = main
        pod_spec["containers"] = containers

        if self.opts.add_fsgroup:
            sc = dict(pod_spec.get("securityContext") or {})
            sc.setdefault("fsGroup", self.opts.fsgroup)
            pod_spec["securityContext"] = sc

        if self.opts.trusted_ca_configmap:
            self._mount_ca_bundle(pod_spec, containers)

        annotations = get_meta(nb).get("annotations") or {}
        if (
            self.opts.auth_proxy_image
            and annotations.get(AUTH_PROXY_ANNOTATION) == "true"
        ):
            containers.append(self._auth_proxy_container(name, ns))

        sts = {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {"name": sts_name, "namespace": ns,
                         "labels": {nbapi.NOTEBOOK_NAME_LABEL: name}},
            "spec": {
                "replicas": replicas,
                # All slices share the notebook's headless Service: every
                # worker of every slice resolves under one DNS zone.
                "serviceName": name + self.opts.workers_service_suffix,
                "selector": {"matchLabels": {STS_LABEL: sts_name}},
                # Slice workers must come up together: sequential (OrderedReady)
                # start would serialise the rendezvous across nodes.
                "podManagementPolicy": "Parallel",
                "template": {
                    "metadata": {
                        "labels": template_labels,
                        "annotations": template_annotations,
                    },
                    "spec": pod_spec,
                },
            },
        }
        return sts

    def _set_restore_env(self, container: dict, nb: dict) -> None:
        """Stamp the migration restore hint (checkpoint path + step) into
        the worker env so in-pod code — sdk.CheckpointManager users, or
        anything reading KFTPU_RESTORE_* — resumes where the drain left
        off. User-provided values win (a notebook that manages its own
        restore keeps doing so). The hint only changes when the SDK
        commits a checkpoint, which is immediately followed by a park —
        so a live gang's template stays stable between drains."""
        hint = migration.restore_hint(annotations_of(nb))
        if hint is None:
            return
        path, step = hint
        env = [dict(e) for e in container.get("env", [])]
        have = {e.get("name") for e in env}
        if migration.RESTORE_PATH_ENV not in have:
            env.append({"name": migration.RESTORE_PATH_ENV, "value": path})
        if step is not None and migration.RESTORE_STEP_ENV not in have:
            env.append({"name": migration.RESTORE_STEP_ENV,
                        "value": str(step)})
        container["env"] = env

    def _set_prefix_env(self, container: dict, ns: str, name: str) -> None:
        """NB_PREFIX tells the server its URL base (notebook_controller.go:392-406)."""
        env = [dict(e) for e in container.get("env", [])]
        prefix = f"/notebook/{ns}/{name}"
        for e in env:
            if e.get("name") == nbapi.PREFIX_ENV_VAR:
                e["value"] = prefix
                break
        else:
            env.append({"name": nbapi.PREFIX_ENV_VAR, "value": prefix})
        container["env"] = env

    def _apply_gpu(
        self,
        main: dict,
        pod_spec: dict,
        template_annotations: dict,
        template_labels: dict,
        nb: dict,
        gpu: GpuSlice,
        *,
        multi=None,
        slice_id: int = 0,
    ) -> None:
        """Wire the slice: selector, card requests, slice-static env, webhook
        annotations. Per-node env (TPU_WORKER_ID, PET_NODE_RANK) is the pod
        webhook's job. In multislice mode the MEGASCALE_* env and the node
        count over every slice are slice-static, so they bake into this
        slice's template here."""
        name, ns = name_of(nb), namespace_of(nb)
        selectors = dict(pod_spec.get("nodeSelector") or {})
        selectors.update(gpu.node_selectors())
        pod_spec["nodeSelector"] = selectors

        resources = dict(main.get("resources") or {})
        for kind in ("requests", "limits"):
            bucket = dict(resources.get(kind) or {})
            bucket.update(gpu.resource_requests())
            resources[kind] = bucket
        main["resources"] = resources

        headless = name + self.opts.workers_service_suffix
        if multi and multi.multi:
            all_hostnames = multi.worker_hostnames(
                name, headless, ns, self.opts.cluster_domain
            )
            static_env = multi.worker_env(slice_id, 0, all_hostnames)
            template_annotations[nbapi.TPU_SLICE_ID_ANNOTATION] = str(slice_id)
            template_annotations[nbapi.TPU_NUM_SLICES_ANNOTATION] = str(
                multi.num_slices)
        else:
            hostnames = gpu.worker_hostnames(
                name, headless, ns, self.opts.cluster_domain
            )
            static_env = gpu.worker_env(0, hostnames)
        # Per-node keys are the webhook's job; don't bake node 0's values
        # into every pod of a multi-node slice.
        for per_worker in ("TPU_WORKER_ID", NODE_RANK_ENV):
            static_env.pop(per_worker, None)
        env = [dict(e) for e in main.get("env", [])]
        have = {e.get("name") for e in env}
        for k, v in static_env.items():
            if k not in have:
                env.append({"name": k, "value": v})
        # Downward-API fallback for the per-node keys: the STS controller
        # (≥1.28) stamps the ordinal on the pod-index label, so even if the
        # admission webhook is unavailable the nodes still get correct
        # ranks and the slice can form its world (the webhook, when up,
        # overrides these with plain values). In multislice mode the global
        # PET_NODE_RANK = sliceId·nodes + ordinal can NOT come from the
        # pod index — only the webhook computes it; a wrong rank would
        # silently collide process ranks, so none is better than wrong.
        fallback_keys = (
            ("TPU_WORKER_ID",) if multi and multi.multi
            else ("TPU_WORKER_ID", NODE_RANK_ENV)
        )
        for per_worker in fallback_keys:
            if per_worker not in have:
                env.append({
                    "name": per_worker,
                    "valueFrom": {"fieldRef": {
                        "fieldPath":
                            "metadata.labels['apps.kubernetes.io/pod-index']"
                    }},
                })
        main["env"] = env

        ports = list(main.get("ports", []))
        if not any(p.get("containerPort") == MASTER_PORT for p in ports):
            ports.append(
                {"containerPort": MASTER_PORT, "name": RENDEZVOUS_PORT_NAME,
                 "protocol": "TCP"}
            )
        main["ports"] = ports

        template_annotations[TPU_ACCELERATOR_ANNOTATION] = gpu.accelerator.name
        template_annotations[TPU_TOPOLOGY_ANNOTATION] = gpu.topology_str
        # Label (not annotation) so the per-worker env webhook registration
        # can scope a failurePolicy:Fail entry with an objectSelector —
        # admission must hard-fail for slice pods, stay best-effort for the
        # convenience PodDefault path (manifests/base/webhook.yaml).
        template_labels[nbapi.TPU_SLICE_LABEL] = "true"

    def _mount_ca_bundle(self, pod_spec: dict, containers: list[dict]) -> None:
        """Mount the mirrored CA ConfigMap into every container (reference:
        CheckAndMountCACertBundle, notebook_webhook.go:371-417)."""
        volumes = list(pod_spec.get("volumes") or [])
        if not any(v.get("name") == "trusted-ca" for v in volumes):
            volumes.append(
                {
                    "name": "trusted-ca",
                    "configMap": {
                        "name": CA_BUNDLE_CONFIGMAP,
                        "items": [
                            {"key": CA_BUNDLE_KEY, "path": CA_BUNDLE_KEY}
                        ],
                    },
                }
            )
        pod_spec["volumes"] = volumes
        for ctr in containers:
            mounts = list(ctr.get("volumeMounts") or [])
            if not any(m.get("name") == "trusted-ca" for m in mounts):
                mounts.append(
                    {
                        "name": "trusted-ca",
                        "mountPath": self.opts.ca_bundle_mount_path,
                        "subPath": CA_BUNDLE_KEY,
                        "readOnly": True,
                    }
                )
            ctr["volumeMounts"] = mounts

    async def _mirror_ca_bundle(self, nb: dict) -> None:
        """Copy the controller-namespace CA ConfigMap into the notebook's
        namespace (reference aggregates odh-trusted-ca-bundle,
        notebook_controller.go:253-353)."""
        source = await self.kube.get_or_none(
            "ConfigMap",
            self.opts.trusted_ca_configmap,
            self.opts.controller_namespace,
        )
        if source is None:
            return
        mirror = {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {
                "name": CA_BUNDLE_CONFIGMAP,
                "namespace": namespace_of(nb),
            },
            "data": {
                CA_BUNDLE_KEY: (source.get("data") or {}).get(CA_BUNDLE_KEY, "")
                or "\n".join((source.get("data") or {}).values()),
            },
        }
        await reconcile_child(self.kube, mirror, copier=_copy_configmap_data)

    def _auth_proxy_container(self, name: str, ns: str) -> dict:
        """Auth sidecar for meshless clusters (reference oauth-proxy,
        notebook_oauth.go:49-300): proxies the serving port and enforces
        the gateway's identity header."""
        return {
            "name": "auth-proxy",
            "image": self.opts.auth_proxy_image,
            "args": [
                f"--upstream=http://localhost:{self.opts.default_serving_port}",
                f"--http-address=0.0.0.0:{self.opts.auth_proxy_port}",
                f"--prefix=/notebook/{ns}/{name}/",
            ],
            "ports": [
                {"containerPort": self.opts.auth_proxy_port, "name": "auth-proxy",
                 "protocol": "TCP"}
            ],
            "resources": {
                "requests": {"cpu": "100m", "memory": "64Mi"},
                "limits": {"cpu": "100m", "memory": "64Mi"},
            },
        }

    def generate_network_policy(self, nb: dict, gpu: GpuSlice | None) -> dict:
        """Per-notebook NetworkPolicy (reference ReconcileAllNetworkPolicies,
        notebook_network.go:42-211: controller-namespace-only ingress).
        Slice addition: the nodes of a multi-node slice must reach each
        other for the torch.distributed rendezvous and NCCL, so
        intra-slice traffic is allowed."""
        name, ns = name_of(nb), namespace_of(nb)
        ingress: list[dict] = [
            {
                "from": [
                    {
                        "namespaceSelector": {
                            "matchLabels": {"kubernetes.io/metadata.name": gw}
                        }
                    }
                    for gw in self.opts.gateway_namespaces
                ],
                "ports": [
                    {"port": self._serving_target_port(nb), "protocol": "TCP"}
                ],
            }
        ]
        if gpu and gpu.multi_host:
            ingress.append(
                {
                    "from": [
                        {
                            "podSelector": {
                                "matchLabels": {nbapi.NOTEBOOK_NAME_LABEL: name}
                            }
                        }
                    ]
                }
            )
        return {
            "apiVersion": "networking.k8s.io/v1",
            "kind": "NetworkPolicy",
            "metadata": {"name": f"notebook-{name}", "namespace": ns},
            "spec": {
                "podSelector": {
                    "matchLabels": {nbapi.NOTEBOOK_NAME_LABEL: name}
                },
                "policyTypes": ["Ingress"],
                "ingress": ingress,
            },
        }

    def _serving_target_port(self, nb: dict) -> int:
        annotations = get_meta(nb).get("annotations") or {}
        if (
            self.opts.auth_proxy_image
            and annotations.get(AUTH_PROXY_ANNOTATION) == "true"
        ):
            return self.opts.auth_proxy_port
        return self.opts.default_serving_port

    def generate_service(self, nb: dict, multi=None) -> dict:
        """HTTP entrypoint. Reference: generateService (:486-513) — port 80 →
        named port ``http-<name>``. Multi-host twist: route to worker 0 only
        (the Jupyter server runs on worker 0; other workers are compute
        peers), via the stable STS pod-name label. In multislice mode the
        server pod is slice 0's worker 0 (``<name>-s0-0``)."""
        name, ns = name_of(nb), namespace_of(nb)
        sts0 = multi.slice_sts_name(name, 0) if multi else name
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns},
            "spec": {
                "type": "ClusterIP",
                "selector": {STS_LABEL: sts0, POD_NAME_LABEL: f"{sts0}-0"},
                "ports": [
                    {
                        "name": f"http-{name}"[:63],
                        "port": nbapi.SERVICE_PORT,
                        "targetPort": self._serving_target_port(nb),
                        "protocol": "TCP",
                    }
                ],
            },
        }

    def generate_headless_service(self, nb: dict, multi=None) -> dict:
        """Node discovery for multi-node slices — the DNS backing
        ``PET_MASTER_ADDR`` and ``TPU_WORKER_HOSTNAMES``, on the rendezvous
        port. In multislice mode one headless Service spans every slice's
        pods (selected by the notebook-name label), so cross-slice peers
        resolve too."""
        name, ns = name_of(nb), namespace_of(nb)
        selector = (
            {nbapi.NOTEBOOK_NAME_LABEL: name} if multi and multi.multi
            else {STS_LABEL: name}
        )
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name + self.opts.workers_service_suffix,
                         "namespace": ns},
            "spec": {
                "clusterIP": "None",
                "publishNotReadyAddresses": True,
                "selector": selector,
                "ports": [
                    {"name": RENDEZVOUS_PORT_NAME, "port": MASTER_PORT,
                     "protocol": "TCP"}
                ],
            },
        }

    def generate_virtual_service(self, nb: dict) -> dict:
        """Reference: generateVirtualService (:519-619) — URL contract
        ``/notebook/<ns>/<name>/``, honoring the rewrite/header annotations
        the vscode-like and rstudio-like images rely on."""
        name, ns = name_of(nb), namespace_of(nb)
        annotations = get_meta(nb).get("annotations") or {}
        prefix = f"/notebook/{ns}/{name}/"
        http: dict = {
            "match": [{"uri": {"prefix": prefix}}],
            "route": [
                {
                    "destination": {
                        "host": f"{name}.{ns}.svc.{self.opts.cluster_domain}",
                        "port": {"number": nbapi.SERVICE_PORT},
                    }
                }
            ],
            "timeout": "300s",
        }
        rewrite = annotations.get(nbapi.ANNOTATION_REWRITE_URI)
        if rewrite:
            http["rewrite"] = {"uri": rewrite}
        headers = annotations.get(nbapi.ANNOTATION_HEADERS_REQUEST_SET)
        if headers:
            import json

            try:
                http["headers"] = {"request": {"set": json.loads(headers)}}
            except ValueError:
                log.warning("notebook %s/%s: bad %s annotation", ns, name,
                            nbapi.ANNOTATION_HEADERS_REQUEST_SET)
        return {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"notebook-{ns}-{name}", "namespace": ns},
            "spec": {
                "hosts": [self.opts.istio_host],
                "gateways": [self.opts.istio_gateway],
                "http": [http],
            },
        }

    async def _gc_extra_slices(self, nb: dict, ms) -> None:
        """Delete slice StatefulSets beyond the current numSlices (scale-in:
        numSlices 4 → 2 must not leave s2/s3 running and burning chips).
        Owned children come from the StatefulSet informer's owner index
        (Manager auto-registers it for every ``owns=`` kind) — a stale
        cache at worst defers the GC to the next STS event; the apiserver
        LIST remains only as the bare-reconciler (no manager) fallback."""
        name, ns = name_of(nb), namespace_of(nb)
        expected = {ms.slice_sts_name(name, j) for j in range(ms.num_slices)}
        if (self._sts_informer is not None
                and self._sts_informer.has_indexer(OWNER_INDEX)):
            owned = self._sts_informer.by_index(OWNER_INDEX, uid_of(nb))
        else:
            try:
                owned = await self.kube.list(
                    "StatefulSet", ns,
                    label_selector={
                        "matchLabels": {nbapi.NOTEBOOK_NAME_LABEL: name}},
                )
            except ApiError as exc:
                log.debug("slice-GC LIST for %s/%s failed (retried "
                          "next reconcile): %s", ns, name, exc)
                return
        for sts in owned:
            if name_of(sts) not in expected:
                try:
                    await self.kube.delete("StatefulSet", name_of(sts), ns)
                except NotFound:
                    pass

    # ---- failure semantics ------------------------------------------------------

    async def _worker_pods(self, nb: dict) -> list[dict]:
        """This notebook's worker pods, from the Pod informer's label index
        — O(workers), not O(cluster pods), and zero apiserver LISTs in the
        steady state. The returned dicts are the informer's cached objects:
        read-only by contract. Bare-reconciler tests (no manager) fall
        back to the apiserver LIST."""
        if (self._pod_informer is not None
                and self._pod_informer.has_indexer(NB_POD_INDEX)):
            return self._pod_informer.by_index(
                NB_POD_INDEX, (namespace_of(nb), name_of(nb)))
        return await self.kube.list(
            "Pod",
            namespace_of(nb),
            label_selector={"matchLabels": {nbapi.NOTEBOOK_NAME_LABEL: name_of(nb)}},
        )

    async def _restart_broken_slice(
        self, nb: dict, ms, pods: list[dict] | None = None
    ) -> Result | None:
        """All-or-nothing slice recovery (the hard part the reference never
        faced with single-pod notebooks, SURVEY.md §7.5): one dead worker
        breaks the whole NCCL world, so every worker restarts together. In
        multislice mode this spans every slice — all nodes are one
        torch.distributed job, so a broken slice stalls them all.

        Restarts back off exponentially (attempt counter + last-restart
        timestamp persisted as CR annotations, so the damping survives a
        controller restart): a main container that crashes at startup
        would otherwise produce a hot delete→recreate→crash loop. The
        counter resets once every worker reports Ready — a slice that was
        stable and then faults gets a fresh budget. Protocol style after
        the reference's retry/backoff lock removal
        (odh notebook_controller.go:117-145)."""
        gpu = ms.slice if ms else None
        gang = (gpu and gpu.multi_host) or (ms and ms.multi)
        if not gang or nbapi.is_stopped(nb):
            return None
        total_hosts = ms.total_hosts
        ns, name = namespace_of(nb), name_of(nb)
        if pods is None:
            pods = await self._worker_pods(nb)
        main_name = _main_container_name(nb)
        # A disrupted-but-still-running worker (spot preemption, node
        # drain) dooms the slice just as surely as a crashed one: restart
        # all workers now so the replacement gang schedules together
        # instead of limping until the kubelet finishes the eviction.
        disrupted = {
            name_of(p): reason for p in pods
            if (reason := _pod_disruption(p)) is not None
        }
        broken = [
            p for p in pods
            if name_of(p) in disrupted or _worker_is_broken(p, main_name)
        ]
        annotations = annotations_of(nb)
        try:  # annotations are user-writable; garbage must not wedge reconcile
            attempts = int(annotations.get(SLICE_RESTART_ATTEMPTS_ANNOTATION) or 0)
        except ValueError:
            attempts = 0

        if not broken:
            all_ready = len(pods) == total_hosts and all(
                any(c.get("type") == "Ready" and c.get("status") == "True"
                    for c in deep_get(p, "status", "conditions", default=[]))
                for p in pods
            )
            if attempts and all_ready:
                await self.kube.patch(
                    "Notebook", name,
                    {"metadata": {"annotations": {
                        SLICE_RESTART_ATTEMPTS_ANNOTATION: None,
                        SLICE_RESTART_AT_ANNOTATION: None,
                    }}}, ns)
            return None

        if attempts:
            delay = min(
                SLICE_RESTART_BASE_SECONDS * (2 ** (attempts - 1)),
                SLICE_RESTART_MAX_SECONDS,
            )
            try:
                last = float(annotations.get(SLICE_RESTART_AT_ANNOTATION) or 0.0)
            except ValueError:
                last = 0.0
            remaining = delay - (self._now() - last)
            if remaining > 0:
                return Result(requeue_after=remaining)

        names = ", ".join(sorted(name_of(p) for p in broken))
        if disrupted:
            why = ", ".join(
                f"{n} ({r})" for n, r in sorted(disrupted.items()))
            detail = f"Worker(s) {why} disrupted"
            # Don't let a concurrent crash hide behind the preemption:
            # name the workers that failed on their own too.
            crashed = sorted(
                name_of(p) for p in broken if name_of(p) not in disrupted)
            if crashed:
                detail += f"; worker(s) {', '.join(crashed)} failed"
            reason = "SlicePreempted"
        else:
            reason, detail = "SliceRestart", f"Worker(s) {names} failed"
        await self.recorder.event(
            nb,
            "Warning",
            reason,
            f"{detail}; restarting all {total_hosts} workers "
            f"(GPU slices restart atomically; attempt {attempts + 1})",
        )
        await self.kube.patch(
            "Notebook", name,
            {"metadata": {"annotations": {
                SLICE_RESTART_ATTEMPTS_ANNOTATION: str(attempts + 1),
                SLICE_RESTART_AT_ANNOTATION: repr(self._now()),
            }}}, ns)
        for p in pods:
            try:
                await self.kube.delete("Pod", name_of(p), namespace_of(p))
            except NotFound:
                pass
        return None

    async def _check_maintenance(
        self, nb: dict, pods: list[dict] | None = None
    ) -> None:
        """Mirror impending node maintenance onto the CR. GPU nodes get a
        taint (NotebookOptions.maintenance_taints; GKE graceful node
        termination) ahead of a maintenance event — the one advance
        warning a slice gets before it goes down. The controller stamps
        the affected node list into MAINTENANCE_ANNOTATION and emits a
        Warning event, so the UI (and in-notebook tooling watching its
        own CR) can checkpoint to the workspace PVC / GCS while the
        workers are still up. No reference counterpart: single-pod CUDA
        notebooks never had a gang to lose (SURVEY.md §7.5 failure
        semantics)."""
        if not self.opts.maintenance_taints:
            return
        if pods is None:
            pods = await self._worker_pods(nb)
        node_names = {deep_get(p, "spec", "nodeName") for p in pods}
        node_names.discard(None)
        if not node_names:
            # No scheduled workers right now (slice restarting, stopped,
            # or pods still Pending) — hold the last-known state rather
            # than emitting a false MaintenanceCleared while the taint
            # may still be there; the next reconcile with placed pods
            # recomputes it.
            return
        if self._node_informer is not None:
            nodes = self._node_informer.items()
        else:  # bare-reconciler unit tests without a manager
            nodes = await self.kube.list("Node")
        pending = sorted(
            name_of(n) for n in nodes
            if name_of(n) in node_names and any(
                t.get("key") in self.opts.maintenance_taints
                for t in deep_get(n, "spec", "taints", default=[])
            )
        )
        current = annotations_of(nb).get(MAINTENANCE_ANNOTATION)
        want = ",".join(pending) if pending else None
        if want == current:
            return
        await self.kube.patch(
            "Notebook", name_of(nb),
            {"metadata": {"annotations": {MAINTENANCE_ANNOTATION: want}}},
            namespace_of(nb),
        )
        if want:
            await self.recorder.event(
                nb, "Warning", "MaintenancePending",
                f"Node(s) {want} hosting this notebook's GPU workers are "
                "scheduled for maintenance; checkpoint now — the slice "
                "restarts when they go down",
            )
        else:
            await self.recorder.event(
                nb, "Normal", "MaintenanceCleared",
                "Impending-maintenance taints cleared from all worker nodes",
            )

    # ---- status ----------------------------------------------------------------

    async def _mirror_events(
        self, nb: dict, worker_pods: list[dict] | None = None
    ) -> None:
        """Re-emit worker pod events onto the CR so the UI can surface them
        (reference: notebook_controller.go:94-123 event mapping — that
        design is watch-driven, and so is this one: the manager's Event
        informer feeds both the reconcile queue and this cache, so status
        churn costs zero apiserver LISTs per reconcile)."""
        ns, name = namespace_of(nb), name_of(nb)
        if worker_pods is None:
            worker_pods = await self._worker_pods(nb)
        pods = {name_of(p) for p in worker_pods}
        if (self._event_informer is not None
                and self._event_informer.has_indexer(EVENT_POD_INDEX)):
            # O(workers) index lookups instead of scanning every Event in
            # the cache per reconcile.
            events = []
            for pod_name in pods:
                events.extend(self._event_informer.by_index(
                    EVENT_POD_INDEX, (ns, pod_name)))
        elif self._event_informer is not None:
            events = [e for e in self._event_informer.items()
                      if namespace_of(e) == ns]
        else:
            try:
                events = await self.kube.list("Event", ns)
            except ApiError as exc:
                log.debug("event-mirror LIST for %s/%s failed (mirror "
                          "catches up next reconcile): %s", ns, name,
                          exc)
                return
        seen = self._mirrored.setdefault((ns, name), {})
        for ev in events:
            involved = ev.get("involvedObject") or {}
            if involved.get("kind") != "Pod" or involved.get("name") not in pods:
                continue
            ev_name, count = name_of(ev), ev.get("count", 1)
            if seen.get(ev_name) == count:
                continue
            seen[ev_name] = count
            await self.recorder.event(
                nb,
                ev.get("type", "Normal"),
                ev.get("reason", ""),
                f"[pod {involved['name']}] {ev.get('message', '')}",
            )

    async def _update_status(self, nb: dict, ms, *,
                             capacity_pending: bool = False,
                             admission=None, pods: list[dict] | None = None,
                             warm: dict | None = None) -> None:
        """Mirror STS/pod state into the CR (reference :228-349): readyReplicas,
        containerState of worker 0's server container, condition history.
        Multislice: readyReplicas sums across every slice's StatefulSet.
        ``capacity_pending``: queued provisioning hasn't delivered yet —
        surfaced via status.gpu so the UI can say why nothing runs.
        ``admission``: the fleet scheduler's verdict — surfaced as
        ``status.scheduler`` (queue position, waiting chips, preemption
        reason) plus a Queued/Admitted/Preempted condition on each
        transition, which is what JWA's status machine and kubectl
        watchers key off."""
        gpu = ms.slice if ms else None
        ns, name = namespace_of(nb), name_of(nb)
        # Informer cache first: a 64-slice notebook would otherwise pay
        # 64 apiserver GETs per reconcile. The controller owns
        # StatefulSets, so this informer is always running under the
        # manager; staleness self-corrects on the next STS event. The
        # bare-reconciler fallback GETs (per-slice STS + worker-0 pod)
        # are independent reads — overlap them so even the cold path is
        # one RTT deep, not num_slices + 1.
        warm_state = (warm or {}).get("state")
        claimed = warm_state == "claimed"
        pod0_name = f"{ms.slice_sts_name(name, 0) if ms else name}-0"
        if claimed:
            # Warm-claimed notebooks own no StatefulSet — the adopted
            # pod IS the slice; readiness and container state come from
            # it directly (it keeps its warm-pool NAME, so the
            # <sts0>-0 lookup below would miss it).
            if pods is None:
                pods = await self._worker_pods(nb)
            ready = sum(
                1 for p in pods
                if any(c.get("type") == "Ready"
                       and c.get("status") == "True"
                       for c in deep_get(p, "status", "conditions",
                                         default=[])))
            pod0 = (warm or {}).get("pod") or (pods[0] if pods else None)
        else:
            *stss, pod0 = await overlap(
                *[self._live_sts(
                    ms.slice_sts_name(name, j) if ms else name, ns)
                  for j in range(ms.num_slices if ms else 1)],
                (None if self._pod_informer is not None
                 else self.kube.get_or_none("Pod", pod0_name, ns)),
            )
            ready = sum(
                deep_get(sts or {}, "status", "readyReplicas", default=0)
                or 0 for sts in stss)

        container_state: dict = {}
        # Watch cache first (staleness self-corrects on the pod's next
        # event, which re-enqueues this notebook anyway).
        if self._pod_informer is not None and not claimed:
            pod0 = self._pod_informer.get(pod0_name, ns)
        if pod0:
            main_name = _main_container_name(nb)
            statuses = deep_get(pod0, "status", "containerStatuses", default=[])
            for cs in statuses:
                if cs.get("name") == main_name:
                    container_state = cs.get("state", {}) or {}
                    break
            else:
                if statuses:
                    container_state = statuses[0].get("state", {}) or {}

        want_hosts = 0 if nbapi.is_stopped(nb) else (
            ms.total_hosts if ms else 1)
        conditions = list(deep_get(nb, "status", "conditions", default=[]))
        # Quarantine self-heal: reaching the status phase proves this key
        # is reconciling again (a quarantined key never runs), so any
        # Degraded=True the manager stamped flips to False here — the one
        # writer that cannot race the quarantine, because a reconcile that
        # is still failing dies before this line.
        conditions = [
            {**c, "status": "False"}
            if c.get("type") == "Degraded" and c.get("status") == "True"
            else c
            for c in conditions
        ]
        # Scheduler transitions and container transitions interleave in
        # one history, so each family dedups against ITS most recent
        # entry — comparing against the list head would re-insert an
        # unchanged container condition after every scheduler insert
        # (and on every reconcile thereafter), churning real history
        # out of the 8-entry cap.
        prev_head = conditions[0].get("type") if conditions else None
        prev_container = next(
            (c.get("type") for c in conditions
             if c.get("type") in _CONTAINER_CONDITION_TYPES), None)
        sched_status = _scheduler_status_block(admission)
        prev_sched_state = deep_get(nb, "status", "scheduler", "state")
        if (sched_status is not None
                and sched_status["state"] != prev_sched_state
                and prev_head != sched_status["state"]):
            conditions.insert(0, _scheduler_condition(sched_status))
        new_cond = _condition_from_state(container_state)
        if new_cond and new_cond["type"] != prev_container:
            conditions.insert(0, new_cond)
        # Migration lifecycle (kubeflow_tpu/migration): the block mirrors
        # the drain/checkpoint annotations; a NEW committed checkpoint
        # (checkpointedAt changed) earns one `Checkpointed` condition —
        # its own dedup family, keyed on the recorded ack time, so
        # neither scheduler nor container churn re-inserts it.
        mig_status = (_migration_status_block(nb, ready=ready,
                                              want_hosts=want_hosts)
                      if self.opts.enable_migration else None)
        prev_ckpt = deep_get(nb, "status", "migration", "checkpointedAt")
        if (mig_status is not None and mig_status.get("checkpointedAt")
                and mig_status["checkpointedAt"] != prev_ckpt):
            conditions.insert(0, _checkpointed_condition(mig_status))
        conditions = conditions[:8]

        # Warm-pool surface (JWA contract, web/common/status.py): claimed
        # carries the pod + the claim latency ("Starting from warm pool
        # (claimed in Xs)"); warming carries the pool's replenish
        # progress ("Warming pool replenishing (k/n ready)"). Same
        # merge-patch discipline as capacityPending.
        warm_block: dict | None = None
        if claimed:
            warm_block = {"claimed": True}
            wpod = (warm or {}).get("pod")
            if wpod is not None:
                warm_block["pod"] = name_of(wpod)
            claimed_in = (warm or {}).get("claimed_in")
            if claimed_in is None:
                claimed_in = annotations_of(nb).get(
                    nbapi.WARM_CLAIMED_IN_ANNOTATION)
            try:
                warm_block["claimedInSec"] = float(claimed_in)
            except (TypeError, ValueError):
                pass
        elif warm_state == "warming" and (warm or {}).get("replenishing"):
            warm_block = {"replenishing": warm["replenishing"]}
        telemetry_block = self._fold_telemetry(nb, (ns, name))
        status = {
            "readyReplicas": ready,
            "containerState": container_state,
            "conditions": conditions,
            # Accelerator extras (not in the reference): slice rollup for the
            # UI, the reference's status.tpu leaves under status.gpu.
            "gpu": {
                "hosts": want_hosts,
                "readyHosts": ready,
                "chips": ms.num_chips if ms else 0,
                "slices": ms.num_slices if ms else 0,
                # Merge-patch semantics: flag present → True; flag stale
                # on the live object → explicit None deletes it; neither
                # → omit (no churn).
                **({"capacityPending": True} if capacity_pending else
                   ({"capacityPending": None}
                    if deep_get(nb, "status", "gpu", "capacityPending")
                    else {})),
                **({"warmPool": warm_block} if warm_block is not None else
                   ({"warmPool": None}
                    if deep_get(nb, "status", "gpu", "warmPool") is not None
                    else {})),
                **({"telemetry": telemetry_block}
                   if telemetry_block is not None else
                   ({"telemetry": None}
                    if deep_get(nb, "status", "gpu", "telemetry") is not None
                    else {})),
            },
        }
        # Same merge-patch discipline as capacityPending: present → set;
        # stale on the live object → explicit None deletes it; neither →
        # omit (no churn for CPU-only / scheduler-off notebooks).
        if sched_status is not None:
            status["scheduler"] = sched_status
        elif deep_get(nb, "status", "scheduler") is not None:
            status["scheduler"] = None
        if mig_status is not None:
            status["migration"] = mig_status
        elif deep_get(nb, "status", "migration") is not None:
            status["migration"] = None
        # Write elision. Two gates:
        # - live status equals the computed one (covers the cold start —
        #   controller restart with an already-converged CR);
        # - per-key last-written hash PAIR: (computed-status hash, hash of
        #   the status the apiserver actually stored for it). The computed
        #   side alone is not enough — merge-patch delete markers
        #   (capacityPending: None) make computed != stored forever, which
        #   would hot-loop the patch; the stored side keeps external drift
        #   repairable — a status someone else rewrote hashes differently
        #   from what we recorded, so the pair misses and we re-patch.
        h = state_hash(status)
        key = (ns, name)
        live_status = deep_get(nb, "status")
        if (live_status == status
                or self._last_status.get(key) == (h, state_hash(live_status))):
            self.m_status_elided.inc()
        else:
            try:
                stored = await self.kube.patch(
                    "Notebook", name, {"status": status}, ns, subresource="status"
                )
                self._last_status[key] = (h, state_hash(stored.get("status")))
            except Conflict:
                # A conflicting status write means this reconcile ran on a
                # stale read — re-raise so the workqueue retries with a
                # fresh one. Swallowing (the old behavior, exposed by the
                # conflict-storm test) left the CR's status stale until
                # the next unrelated event.
                raise
            except ApiError as exc:
                # Non-conflict write failures stay best-effort (the 409
                # path above re-raises): status refreshes on the next
                # event, and failing the whole reconcile for a status
                # tail write would churn healthy children.
                log.debug("status write for %s/%s failed: %s", ns, name,
                          exc)
        stopped = nbapi.is_stopped(nb)
        self._set_gauge_contribution(
            ns, name,
            # Parked: not running even while old pods drain, and its chip
            # demand is released.
            running=1 if (not stopped and ready and ready >= want_hosts)
            else 0,
            chips=0 if stopped else (ms.num_chips if ms else 0),
        )
        await self._record_timeline(nb, ms, sched_status, mig_status,
                                    ready=ready, want_hosts=want_hosts,
                                    warm=warm_state or "")

    async def _record_timeline(self, nb: dict, ms, sched_status,
                               mig_status, *, ready: int,
                               want_hosts: int, warm: str = "") -> None:
        """Fold this reconcile's derived state into the durable lifecycle
        timeline (runtime/timeline.py) and, on a NEW Ready transition,
        score the startup episode against the time-to-ready SLO. One
        record per reconcile; a no-transition call costs a dict lookup."""
        if self._timeline is None:
            return
        sched = sched_status or {}
        mig = mig_status or {}
        state = timeline_mod.derive_lifecycle(
            sched_state=sched.get("state"),
            mig_state=mig.get("state"),
            stopped=nbapi.is_stopped(nb),
            ready=ready, want_hosts=want_hosts,
            reclaimed=sched.get("reclaimed", ""),
            warm=warm)
        reason = (sched.get("reclaimed") or sched.get("reason")
                  or mig.get("reason") or "")
        shape = (f"{ms.num_slices}x{ms.slice.accelerator.name}:"
                 f"{ms.slice.topology_str}" if ms else "")
        key = (namespace_of(nb), name_of(nb))
        if warm == "claimed" and state == timeline_mod.READY:
            # The claim is its own transition: a warm pod is
            # often Ready within the claiming reconcile, which would
            # otherwise journal straight to Ready — and the episode
            # could no longer attribute warm vs cold starts. Record
            # Claimed first; dedup in record() keeps later reconciles
            # from repeating it.
            prior = self._timeline.entries(
                key, annotations=annotations_of(nb))
            if not prior or prior[-1]["state"] not in (
                    timeline_mod.CLAIMED, timeline_mod.READY):
                await self._timeline.record(
                    key, timeline_mod.CLAIMED, at=self._now(),
                    reason="warm-pool", trace_id=current_trace_id(),
                    shape=shape, annotations=annotations_of(nb))
        entries = await self._timeline.record(
            key, state, at=self._now(), reason=reason,
            trace_id=current_trace_id(), shape=shape,
            annotations=annotations_of(nb))
        if entries is not None and state == timeline_mod.READY:
            ttr = timeline_mod.time_to_ready(entries)
            if ttr is not None:
                slo.observe("notebook_time_to_ready", ttr, key=key,
                            trace_id=current_trace_id())

    def _fold_telemetry(self, nb: dict, key: tuple) -> dict | None:
        """Decode the SDK's telemetry annotation into the
        ``status.gpu.telemetry`` block and fan the window out — once per
        publish seq — to the SLO engine (``training_step``), the
        manager's Prometheus mirror, and the scheduler's efficiency
        ledger. Returns None (delete the block) when the annotation is
        absent or corrupt; a STALE entry keeps the block with
        ``stale: true`` so JWA can degrade its message rather than
        silently showing week-old MFU as live."""
        entry = telemetry_pub.decode(annotations_of(nb))
        if entry is None:
            self._telemetry.pop(key, None)
            return None
        now = self._now()
        stale = telemetry_pub.is_stale(entry, now)
        self._telemetry[key] = entry
        if not stale and entry["seq"] > self._telemetry_seq.get(key, 0):
            self._telemetry_seq[key] = entry["seq"]
            step_sec = entry.get("step_sec")
            if step_sec is not None:
                slo.observe("training_step", float(step_sec), key=key,
                            trace_id=current_trace_id())
            telemetry_pub.publish_metrics(entry)
            if self._scheduler is not None:
                self._scheduler.note_telemetry(
                    key, entry.get("family") or "unknown",
                    entry.get("mfu"))
        block = {
            "family": entry.get("family") or "unknown",
            "step": entry.get("step", 0),
            "at": entry.get("at"),
            "seq": entry.get("seq"),
        }
        for wire, status_key in (("mfu", "mfu"), ("step_sec", "stepSec"),
                                 ("overlap", "overlap"),
                                 ("tok_s", "tokensPerSec"),
                                 ("compile_sec", "compileSec"),
                                 ("hbm", "hbmBytes"), ("basis", "basis")):
            if entry.get(wire) is not None:
                block[status_key] = entry[wire]
        if stale:
            block["stale"] = True
        return block

    def telemetry_debug_info(self) -> dict:
        """The ``/debug/telemetry`` payload: every notebook's latest
        decoded telemetry entry with live staleness."""
        now = self._now()
        return {
            "stale_after_seconds": telemetry_pub.stale_after_seconds(),
            "notebooks": {
                f"{ns}/{name}": {
                    **entry,
                    "stale": telemetry_pub.is_stale(entry, now),
                    "age_sec": round(now - float(entry.get("at", 0.0)), 1),
                }
                for (ns, name), entry in sorted(self._telemetry.items())
            },
        }

    def _set_gauge_contribution(
        self, ns: str | None, name: str, running: int, chips: int
    ) -> None:
        """Fold one notebook's (running, chips) contribution into the
        per-namespace gauges, incrementally — the previous recompute from
        the informer cache was O(notebooks-in-ns) per reconcile, an O(N²)
        scan across a namespace coming up. Set-per-notebook would be
        wrong the moment a namespace holds two notebooks; per-key deltas
        against a running total are both O(1) and aggregate-correct."""
        old = self._gauge_contrib.get((ns, name), (0, 0))
        if (running, chips) == old:
            return
        if (running, chips) == (0, 0):
            self._gauge_contrib.pop((ns, name), None)
        else:
            self._gauge_contrib[(ns, name)] = (running, chips)
        totals = self._ns_totals.setdefault(ns, [0, 0])
        totals[0] += running - old[0]
        totals[1] += chips - old[1]
        self.m_running.labels(namespace=ns or "").set(totals[0])
        self.m_chips.labels(namespace=ns or "").set(totals[1])


_soonest = soonest  # shared helper (runtime/manager.py), old local name


def _main_container_name(nb: dict) -> str:
    """Name of the GPU worker (server) container — containers[0] of the CR's
    PodSpec by the reference contract, falling back to the CR name."""
    containers = deep_get(nb, "spec", "template", "spec", "containers", default=[])
    return (containers[0].get("name") if containers else None) or name_of(nb)


def _pod_disruption(pod: dict) -> str | None:
    """Classify a worker that is going away through no fault of its own:
    kubelet/scheduler/taint-manager set a ``DisruptionTarget`` condition
    (reason PreemptionByScheduler, DeletionByTaintManager,
    EvictionByEvictionAPI, TerminationByKubelet) on such pods. This is the
    upstream, vendor-neutral signal, so spot-GPU preemptions on GKE and
    plain node drains classify identically. Returns the reason, or None."""
    for c in deep_get(pod, "status", "conditions", default=[]):
        if c.get("type") == "DisruptionTarget" and c.get("status") == "True":
            return c.get("reason") or "Disrupted"
    return None


def _worker_is_broken(pod: dict, main_container: str) -> bool:
    """A worker whose GPU container died — even once, even if kubelet already
    restarted it in place — has broken the slice's NCCL world: the
    restarted process cannot rejoin (a world's ranks are fixed when its
    communicators form), so the
    healthy-looking peers are wedged. With restartPolicy Always the pod
    rarely shows phase=Failed or a current terminated state; the durable
    signals are restartCount > 0, a lastState.terminated, or
    CrashLoopBackOff. Slice-atomic deletion resets restartCount to 0 on the
    replacement pods, so this self-clears.

    Scoped to the *main* (GPU worker) container only: a sidecar restart
    (auth-proxy OOM, say) does not break the NCCL world, and counting it
    would wedge the slice in a permanent restart loop — the main
    container's statuses never clear the sidecar's restartCount."""
    if deep_get(pod, "status", "phase") == "Failed":
        return True
    for cs in deep_get(pod, "status", "containerStatuses", default=[]):
        if cs.get("name") != main_container:
            continue
        if cs.get("restartCount", 0) > 0:
            return True
        if deep_get(cs, "state", "terminated", "exitCode") not in (None, 0):
            return True
        if deep_get(cs, "lastState", "terminated") is not None:
            return True
        if deep_get(cs, "state", "waiting", "reason") in (
            "CrashLoopBackOff", "Error",
        ):
            return True
    return False


def _copy_configmap_data(desired: dict, live: dict) -> bool:
    if live.get("data") != desired.get("data"):
        live["data"] = desired.get("data", {})
        return True
    return False


def _scheduler_status_block(admission) -> dict | None:
    """Admission verdict → the ``status.scheduler`` block. The shape is
    the JWA contract (web/common/status.py): Queued carries position +
    waitingChips + reason — plus, elastic, the reclaim marker ("this
    gang is re-queued because its spot capacity was revoked / it is
    migrating pools") and any pending scale-up intent for its shape;
    Preempted/Draining carry the reason, Admitted is bare."""
    if admission is None:
        return None
    block: dict = {"state": admission.state}
    if admission.state == "Queued":
        block["position"] = admission.position
        block["waitingChips"] = admission.waiting_chips
        block["reason"] = admission.reason
        if getattr(admission, "reclaimed", ""):
            block["reclaimed"] = admission.reclaimed
        if getattr(admission, "scale_up_chips", 0):
            # Whole seconds, as the JWA shows the wait: a finer value
            # would change on every refresh of a queued gang, and each
            # status write's watch event would re-enqueue it at once.
            block["scaleUp"] = {
                "chips": admission.scale_up_chips,
                "pendingSeconds": round(admission.scale_up_pending_sec),
            }
    elif admission.state in ("Preempted", "Draining") and admission.reason:
        block["reason"] = admission.reason
    return block


def _migration_status_block(nb: dict, *, ready: int,
                            want_hosts: int) -> dict | None:
    """Drain/checkpoint annotations → the ``status.migration`` block
    (JWA contract: "Checkpointing before preemption…", "Suspended
    (checkpoint @ step N)", "Restoring from checkpoint"). None for the
    common untouched notebook, so steady-state status stays byte-
    identical to pre-migration."""
    annotations = annotations_of(nb)
    state = migration.derive_state(
        annotations, stopped=nbapi.is_stopped(nb),
        ready_hosts=ready, want_hosts=want_hosts)
    hint = migration.restore_hint(annotations)
    if (state == migration.RUNNING and hint is None
            and migration.drain_requested_at(annotations) is None):
        return None
    block: dict = {"state": state}
    if hint is not None:
        block["checkpointPath"] = hint[0]
        if hint[1] is not None:
            block["checkpointStep"] = hint[1]
    checkpointed = annotations.get(nbapi.CHECKPOINTED_AT_ANNOTATION)
    if checkpointed:
        block["checkpointedAt"] = checkpointed
    # Checkpoint fabric: the ack only promises a host-side
    # snapshot — surface the durable-commit trio so JWA can distinguish
    # "uploading (k/N chunks)" from committed, and flag a park whose
    # upload never landed.
    committed = annotations.get(nbapi.CHECKPOINT_COMMITTED_AT_ANNOTATION)
    if committed:
        block["committedAt"] = committed
    if migration.commit_dirty(annotations):
        block["commitDirty"] = True
    progress = migration.upload_progress(annotations)
    if progress is not None:
        block["uploadProgress"] = f"{progress[0]}/{progress[1]}"
    tier = migration.restore_tier(annotations)
    if tier:
        block["restoreTier"] = tier
    reason = migration.drain_reason(annotations)
    if reason:
        block["reason"] = reason
    return block


def _checkpointed_condition(mig_status: dict) -> dict:
    step = mig_status.get("checkpointStep")
    path = mig_status.get("checkpointPath", "")
    return {
        "type": "Checkpointed",
        "status": "True",
        "lastProbeTime": now_iso(),
        "reason": "Migration",
        "message": "checkpoint"
        + (f" @ step {step}" if step is not None else "")
        + (f" committed to {path}" if path else " committed"),
    }


def _scheduler_condition(sched_status: dict) -> dict:
    """One condition per scheduler-state transition
    (Queued → Admitted → Preempted), so the lifecycle is auditable from
    the CR alone (docs/multi-host.md lifecycle diagram)."""
    state = sched_status["state"]
    if state == "Queued":
        message = (f"position {sched_status.get('position', 0)}, waiting "
                   f"for {sched_status.get('waitingChips', 0)} GPUs")
    elif state == "Preempted":
        message = (f"preempted ({sched_status.get('reason', 'reclaimed')}); "
                   "restart to re-queue")
    elif state == "Draining":
        message = (f"checkpointing before preemption "
                   f"({sched_status.get('reason', 'reclaimed')})")
    else:
        message = "admitted by the GPU fleet scheduler"
    return {
        "type": state,
        "status": "True",
        "lastProbeTime": now_iso(),
        "reason": "GpuFleetScheduler",
        "message": message,
    }


# The condition types _condition_from_state emits — the dedup in
# _update_status scans for the most recent one of these.
_CONTAINER_CONDITION_TYPES = frozenset({"Running", "Waiting", "Terminated"})


def _condition_from_state(state: dict) -> dict | None:
    """ContainerState → NotebookCondition (Running|Waiting|Terminated),
    reference notebook_types.go:46-63 + status mirroring."""
    now = now_iso()
    if "running" in state:
        return {"type": "Running", "status": "True", "lastProbeTime": now}
    if "waiting" in state:
        w = state["waiting"] or {}
        return {
            "type": "Waiting",
            "status": "True",
            "lastProbeTime": now,
            "reason": w.get("reason", ""),
            "message": w.get("message", ""),
        }
    if "terminated" in state:
        t = state["terminated"] or {}
        return {
            "type": "Terminated",
            "status": "True",
            "lastProbeTime": now,
            "reason": t.get("reason", ""),
            "message": t.get("message", ""),
        }
    return None


def provisioning_request_to_notebook(pr: dict) -> list[tuple]:
    """Map ProvisioningRequest events (Provisioned/Failed condition
    flips) back to the waiting Notebook via the notebook-name label."""
    name = (get_meta(pr).get("labels") or {}).get(nbapi.NOTEBOOK_NAME_LABEL)
    if not name:
        return []
    return [(namespace_of(pr), name)]


def pod_to_notebook(pod: dict) -> list[tuple]:
    """Map pod events to their Notebook (reference SetupWithManager watch by
    ``notebook-name`` label, notebook_controller.go:739-787)."""
    name = (get_meta(pod).get("labels") or {}).get(nbapi.NOTEBOOK_NAME_LABEL)
    if not name:
        return []
    return [(namespace_of(pod), name)]


def event_to_notebook(event: dict) -> list[tuple]:
    """Map pod Events to Notebooks by the pod-name → notebook-name convention
    (reference :685-700 strips the trailing ordinal)."""
    involved = event.get("involvedObject") or {}
    if involved.get("kind") != "Pod":
        return []
    pod_name = involved.get("name", "")
    base, _, ordinal = pod_name.rpartition("-")
    if not base or not ordinal.isdigit():
        return []
    return [(event.get("metadata", {}).get("namespace"), base)]


_SCHEDULER_FROM_ENV = object()  # sentinel: build from KFTPU_* env vars
_WARMPOOL_FROM_ENV = object()   # sentinel: build from KFTPU_WARM_POOLS


def setup_notebook_controller(
    mgr: Manager, options: NotebookOptions | None = None,
    *, scheduler=_SCHEDULER_FROM_ENV, warmpool=_WARMPOOL_FROM_ENV,
) -> NotebookReconciler:
    """Wire the reconciler onto the manager. Without arguments the fleet
    scheduler and the warm pod pools come from ``KFTPU_*`` (with no fleet
    configured, admission passes through; with no ``KFTPU_WARM_POOLS``,
    every notebook takes the cold path); ``None`` wires neither."""
    rec = NotebookReconciler(mgr.kube, options, registry=mgr.registry)
    # Durable lifecycle timelines + SLO feeds (runtime/{timeline,slo}.py)
    # ride the manager's shared recorder/engine.
    rec._timeline = getattr(mgr, "timeline", None)
    # /debug/telemetry data source: the reconciler's per-notebook fold of
    # the telemetry annotation.
    mgr.telemetry = rec.telemetry_debug_info
    if scheduler is _SCHEDULER_FROM_ENV:
        # KFTPU_SCHEDULER=off is the kill switch: the capacity stage then
        # runs exactly the pre-scheduler gate. On (default), the
        # scheduler stays a transparent pass-through until a fleet is
        # configured (KFTPU_FLEET / ConfigMap / node inference).
        from kubeflow_tpu_torch.scheduler import scheduler_enabled

        if scheduler_enabled():
            from kubeflow_tpu_torch.cmd.envconfig import scheduler_options
            from kubeflow_tpu_torch.scheduler import GpuFleetScheduler

            scheduler = GpuFleetScheduler(
                mgr.kube, scheduler_options(), registry=mgr.registry)
        else:
            scheduler = None
    rec._scheduler = scheduler
    if warmpool is _WARMPOOL_FROM_ENV:
        # Warm pod pools: no KFTPU_WARM_POOLS spec (and no ConfigMap
        # source) means no manager at all — the claim gate is a None
        # check and the cold path is byte-for-byte untouched.
        from kubeflow_tpu_torch.cmd.envconfig import warm_pool_options
        from kubeflow_tpu_torch.controllers.warmpool import WarmPoolManager

        wp_opts = warm_pool_options()
        warmpool = (WarmPoolManager(mgr.kube, wp_opts,
                                    registry=mgr.registry)
                    if wp_opts.enabled else None)
    rec._warmpool = warmpool
    if warmpool is not None:
        # One card ledger: every warm slot holds a scheduler reservation
        # (the first preemption victim), and the scheduler's teardown
        # callback routes cannibalized slots back to the replenisher.
        warmpool.scheduler = rec._scheduler
        if rec._scheduler is not None:
            rec._scheduler.on_warm_reclaimed(warmpool.note_reclaimed)
        mgr.warmpool = warmpool
        mgr.add_background(warmpool.run_replenisher)
    owned_kinds = ["StatefulSet", "Service"] + (
        ["VirtualService"] if rec.opts.use_istio else [])
    mgr.add_controller(
        Controller(
            name="notebook",
            kind="Notebook",
            reconcile=rec.reconcile,
            owns=owned_kinds,
            watches=[
                Watch("Pod", pod_to_notebook),
                Watch("Event", event_to_notebook),
            ] + ([Watch("ProvisioningRequest",
                        provisioning_request_to_notebook)]
                 if rec.opts.enable_queued_provisioning else []),
            coalesce_window=rec.opts.coalesce_window,
        )
    )
    # _mirror_events and _update_status read the watch caches the Watch /
    # owns wiring above already maintains — watch streams instead of a
    # namespace-wide Event LIST + per-slice StatefulSet GETs per reconcile
    # (reference notebook_controller.go:739-787 is watch-driven the same
    # way). The indexers registered here turn every remaining cache scan
    # into an O(1) lookup (client-go AddIndexers; ``owner`` on owned kinds
    # comes from Manager.add_controller).
    rec._event_informer = mgr.informer_for("Event")
    rec._event_informer.add_indexer(EVENT_POD_INDEX, index_event_by_involved_pod)
    rec._sts_informer = mgr.informer_for("StatefulSet")
    rec._nb_informer = mgr.informer_for("Notebook")
    rec._nb_informer.add_indexer(NAMESPACE_INDEX, index_by_namespace)
    if rec._scheduler is not None:
        # A freshly admitted (or preempted) gang reconciles NOW — the
        # queued requeue_after is only the safety net. The Notebook
        # informer saves the scheduler a GET when it events a peer.
        rec._scheduler.on_admitted(lambda key: mgr.enqueue("notebook", key))
        rec._scheduler._nb_informer = rec._nb_informer
        if getattr(rec._scheduler.options, "fleet_spec", "") == "auto":
            rec._scheduler._node_informer = mgr.informer_for("Node")
        if getattr(rec._scheduler.options, "enable_elastic", False):
            # Elastic fleet: spot pools are reclaim-aware — the
            # revocation signal is a Node taint, so the scheduler needs
            # node events even for env/ConfigMap fleets (the auto
            # informer above only exists for label inference). The
            # informer handle also lets a lazily-activated fleet
            # re-scan cached nodes for signals its handler dropped
            # pre-activation.
            rec._scheduler._node_informer = mgr.informer_for("Node")
            sched_ref = rec._scheduler

            def spot_node_handler(event: str, node: dict) -> None:
                if event == "DELETED":
                    sched_ref.note_node_gone(node)
                else:
                    sched_ref.note_node_event(node)

            mgr.informer_for("Node").add_handler(spot_node_handler)
        mgr.scheduler = rec._scheduler
    rec._pod_informer = mgr.informer_for("Pod")
    rec._pod_informer.add_indexer(
        NB_POD_INDEX, index_by_label(nbapi.NOTEBOOK_NAME_LABEL))
    # update(), not rebind: rec._reader closed over this dict in __init__.
    rec._child_informers.update(
        {k: mgr.informer_for(k) for k in owned_kinds})
    if rec.opts.enable_queued_provisioning:
        rec._pr_informer = mgr.informer_for("ProvisioningRequest")
        rec._child_informers["ProvisioningRequest"] = rec._pr_informer
    if rec.opts.maintenance_taints:
        # Maintenance taints land on Nodes, not on anything the Notebook
        # owns — watch Nodes and re-enqueue the notebooks whose workers
        # run there (resolved from the Pod informer cache, zero LISTs).
        # Nodes churn constantly (status heartbeats, label updates), so
        # the handler keys on the *maintenance-taint set* changing — every
        # other Node event is dropped without touching the Pod cache.
        rec._node_informer = mgr.informer_for("Node")
        pod_informer = rec._pod_informer
        pod_informer.add_indexer(POD_NODE_INDEX, index_pod_by_node)
        watched = frozenset(rec.opts.maintenance_taints)
        last_taints: dict[str, frozenset] = {}

        def node_handler(event: str, node: dict) -> None:
            node_name = name_of(node)
            if event == "DELETED":
                now = frozenset()
                last_taints.pop(node_name, None)
            else:
                now = watched & {
                    t.get("key")
                    for t in deep_get(node, "spec", "taints", default=[])
                }
                if last_taints.get(node_name, frozenset()) == now:
                    return
                last_taints[node_name] = now
            # Node-indexed lookup: only this node's pods, not a scan of
            # every pod in the cluster per taint flip.
            for pod in pod_informer.by_index(POD_NODE_INDEX, node_name):
                for key in pod_to_notebook(pod):
                    mgr.enqueue("notebook", key)

        rec._node_informer.add_handler(node_handler)
    if rec.opts.pipeline_access_role:
        # A pipelines Role appearing AFTER notebooks exist must still get
        # bindings (the probe cache alone would leave idle notebooks
        # unbound until some unrelated event): watch Roles, bust the probe
        # cache, and re-enqueue that namespace's notebooks from the
        # informer cache.
        nb_informer = mgr.informer_for("Notebook")

        def role_handler(_event: str, role: dict) -> None:
            if name_of(role) != rec.opts.pipeline_access_role:
                return
            ns = namespace_of(role)
            rec._role_probe_gen[ns] = rec._role_probe_gen.get(ns, 0) + 1
            rec._role_probe_cache.pop(ns, None)
            # Namespace index (registered above): only this namespace's
            # notebooks re-enqueue, without walking the whole cache.
            for nb in nb_informer.by_index(NAMESPACE_INDEX, ns):
                mgr.enqueue("notebook", (ns, name_of(nb)))

        mgr.informer_for("Role").add_handler(role_handler)
    return rec
