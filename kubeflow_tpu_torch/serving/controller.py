"""InferenceService reconciler: CR → per-replica GPU slice StatefulSets
+ a Service, scaled by the pure autoscaler against the shared card
ledger. The port of ``kubeflow_tpu/serving/controller.py``.

The serving workload class end to end:

- each **replica** is a whole slice gang admitted through the SAME
  :class:`~kubeflow_tpu_torch.scheduler.runtime.GpuFleetScheduler` as
  every notebook (``serving_admission`` — one ledger, one fair order; a
  queued serving replica preempts *idle notebooks* through the existing
  drain protocol via its serving-class priority, default "high");
- replica count follows :mod:`kubeflow_tpu_torch.serving.autoscaler` over
  the observed-rate/inflight/last-request annotations the gateway stamps;
- **scale-to-zero parks, never bare-stops**: the controller requests a
  checkpoint (``park-requested``), the engine acks with the committed
  path/step, and only then do replicas scale to zero — replica 0's
  StatefulSet is kept at 0 replicas as the **parked warm standby**. The
  grace deadline (`park_grace_seconds`) is the ack-less fallback, the
  same cards-never-hostage contract as the notebook drain.
- **scale-from-zero warm-restores**: the first burst re-admits replica
  0 through the ledger and scales the parked StatefulSet back up with
  the parked checkpoint stamped into the pod env
  (``KFTPU_RESTORE_*``) — the engine restores weights instead of
  cold-initializing.

The accelerator block is ``spec.gpu`` (``status.gpu`` with the
reference's leaf names): each replica's pods request
``nvidia.com/gpu``, carry the slice-static env of ``gpu/topology.py``
(``PET_*``, ``KFTPU_ACCELERATOR``) and the annotations and slice label
the per-node webhook (``webhooks/gpu.py``) keys on to compute
``TPU_WORKER_ID`` / ``PET_NODE_RANK``; the headless Service of a
multi-node replica serves torchrun's rendezvous port.
"""

from __future__ import annotations

import logging
import re
import time
from dataclasses import dataclass
from typing import Callable

from kubeflow_tpu_torch.api import inferenceservice as isvcapi
from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.controllers.notebook import RENDEZVOUS_PORT_NAME
from kubeflow_tpu_torch.gpu.topology import MASTER_PORT, NODE_RANK_ENV
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime.apply import ApplyCache, informer_reader, reconcile_child
from kubeflow_tpu_torch.runtime.errors import ApiError, Invalid, NotFound
from kubeflow_tpu_torch.runtime.events import EventRecorder
from kubeflow_tpu_torch.runtime.informer import OWNER_INDEX
from kubeflow_tpu_torch.runtime.manager import Controller, Manager, Result, soonest
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
from kubeflow_tpu_torch.runtime.tracing import span
from kubeflow_tpu_torch.serving.autoscaler import (
    AutoscalerState,
    Signals,
    config_from_spec,
    desired_replicas,
)

log = logging.getLogger(__name__)

STS_LABEL = keys.SERVING_REPLICA_STS_LABEL
WORKERS_SERVICE_SUFFIX = "-workers"

# Replica index from a replica StatefulSet name (`<svc>-r<i>[-s<j>]`).
_REPLICA_STS_RE = re.compile(r"-r(\d+)(?:-s\d+)?$")


@dataclass
class ServingOptions:
    """Env contract (cmd/envconfig.py serving_options). The DATACLASS
    default is off — bare construction keeps the notebook-only control
    plane byte-for-byte; production gets ``enabled`` from
    ``KFTPU_SERVING`` (default on)."""

    enabled: bool = False
    cluster_domain: str = "cluster.local"
    controller_namespace: str = "kubeflow-tpu"
    serving_port: int = isvcapi.DEFAULT_CONTAINER_PORT
    # Serving-class fleet priority (overridable per CR via the
    # serving.kubeflow.org/priority annotation): "high" — an always-on
    # service outranks interactive notebooks, so a serving burst drains
    # idle notebooks through the existing preemption path.
    priority: int = 100
    # Autoscale cadence: the safety-net requeue; load-annotation watch
    # events drive reconciles sooner.
    autoscale_period_seconds: float = 5.0
    # Park drain grace: how long scale-to-zero waits for the engine's
    # checkpoint ack before parking without a fresh checkpoint.
    park_grace_seconds: float = migration.DEFAULT_DRAIN_GRACE_SECONDS
    # Operator-level defaults for spec.scaling knobs the CR leaves unset.
    default_target_rate: float = 8.0
    default_idle_window: float = 300.0
    default_stabilization: float = 60.0
    # SLO-driven autoscaling: feed the serving_latency
    # burn rate into the autoscaler when the SLO engine is installed
    # and enabled. Kill switch: off restores the raw rate/concurrency
    # policy byte-for-byte (KFTPU_SERVING_SLO_AUTOSCALE).
    slo_autoscale: bool = True


class InferenceServiceReconciler:
    def __init__(
        self,
        kube,
        options: ServingOptions | None = None,
        *,
        registry: Registry | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.kube = kube
        self.opts = options or ServingOptions()
        self.clock = clock
        self.recorder = EventRecorder(kube, "inferenceservice-controller",
                                      registry=registry)
        # The shared fleet scheduler (set by setup_serving_controller).
        # None — bare-reconciler tests, KFTPU_SCHEDULER=off, or no fleet
        # — means every replica admits unconditionally.
        self._scheduler = None
        self._sts_informer = None
        self._child_informers: dict[str, object] = {}
        self._reader = informer_reader(self._child_informers)
        self._apply_cache = ApplyCache()
        # key → AutoscalerState (the scale-down stabilization window).
        self._states: dict[tuple, AutoscalerState] = {}
        # key → last status dict we wrote (write elision; conditions
        # excluded — see _update_status).
        self._last_status: dict[tuple, dict] = {}
        # key → highest replica count ever materialised (scale-down GC
        # + delete-time release walk this).
        self._high_water: dict[tuple, int] = {}
        registry = registry or global_registry
        self.m_desired = registry.gauge(
            "inference_replicas_desired",
            "Replicas the autoscaler wants per InferenceService",
            ["service"])
        self.m_admitted = registry.gauge(
            "inference_replicas_admitted",
            "Replicas holding fleet admission per InferenceService",
            ["service"])
        self.m_scale_events = registry.counter(
            "inference_scale_events_total",
            "Autoscaler scale events", ["direction"])  # up|down|zero
        self.m_parks = registry.counter(
            "inference_parks_total",
            "Scale-to-zero parks (warm standby retained)")
        self.m_warm_restores = registry.counter(
            "inference_warm_restores_total",
            "Scale-from-zero restores from a parked warm standby")
        self.m_scale_from_zero = registry.histogram(
            "inference_scale_from_zero_seconds",
            "Park → first replica admitted again")

    # ---- reconcile --------------------------------------------------------------

    async def reconcile(self, key) -> Result | None:
        ns, name = key
        with span("cache_read"):
            isvc = await self.kube.get_or_none("InferenceService", name, ns)
        if isvc is None or get_meta(isvc).get("deletionTimestamp"):
            await self._release_all(key)
            self._states.pop(tuple(key), None)
            self._high_water.pop(tuple(key), None)
            self._last_status.pop(tuple(key), None)
            self.m_desired.labels(service=f"{ns}/{name}").set(0)
            self.m_admitted.labels(service=f"{ns}/{name}").set(0)
            return None  # children die by ownerReference cascade
        try:
            ms = isvcapi.multi_slice_of(isvc)
        except Invalid as e:
            await self._event(isvc, "Warning", "InvalidSpec", str(e))
            return None

        now = self.clock()
        annotations = annotations_of(isvc)
        skey = (ns, name)
        cfg = config_from_spec(
            isvcapi.scaling_of(isvc),
            default_target_rate=self.opts.default_target_rate,
            default_idle_window=self.opts.default_idle_window,
            default_stabilization=self.opts.default_stabilization)
        rate = _safe_float(annotations.get(
            isvcapi.OBSERVED_RATE_ANNOTATION))
        per_model = isvcapi.model_rates(annotations)
        if per_model:
            # The multiplexing breakdown is also a load signal: a
            # gateway that only stamps per-model rates still scales the
            # service (and a stale aggregate never UNDER-counts it).
            rate = max(rate, sum(per_model.values()))
        signals = Signals(
            rate=rate,
            inflight=_safe_float(annotations.get(
                isvcapi.OBSERVED_INFLIGHT_ANNOTATION)),
            last_request_at=parse_iso(annotations.get(
                isvcapi.LAST_REQUEST_AT_ANNOTATION) or ""),
            burn_rate=self._serving_burn_rate())
        state = self._states.get(skey)
        if state is None:
            created = parse_iso(
                get_meta(isvc).get("creationTimestamp") or "")
            state = self._states[skey] = AutoscalerState(
                created_at=created if created is not None else now)

        current = self._current_replicas(isvc)
        parked = isvcapi.PARKED_AT_ANNOTATION in annotations
        with span("autoscale", service=f"{ns}/{name}", current=current,
                  rate=signals.rate, inflight=signals.inflight):
            decision = desired_replicas(cfg, signals, current, now, state)
        desired = decision.replicas
        self.m_desired.labels(service=f"{ns}/{name}").set(desired)

        requeue = Result(requeue_after=self.opts.autoscale_period_seconds)
        park_requeue: Result | None = None
        admitted = queued = 0
        if desired == 0:
            if current > 0 or isvcapi.PARK_REQUESTED_ANNOTATION \
                    in annotations:
                # Scale-to-zero NEVER bare-stops: the park drain asks
                # the engine for a committed checkpoint first; the
                # grace deadline is the ack-less fallback.
                park_requeue = await self._drain_to_park(
                    isvc, ms, now, annotations)
            elif not parked and (self._high_water.get(skey, 0) > 0
                                 or self._booked_high(skey) > 0):
                # Already at zero without a park mark (e.g. restart):
                # make sure nothing still holds cards.
                await self._release_from(skey, 0)
        else:
            if parked or isvcapi.PARK_REQUESTED_ANNOTATION in annotations:
                await self._cancel_park(isvc, ns, name, parked=parked,
                                        now=now)
            admitted, queued = await self._scale_to(
                isvc, ms, desired, now, parked=parked)
        self.m_admitted.labels(service=f"{ns}/{name}").set(admitted)

        with span("apply_stage", stage="services"):
            await self._ensure(isvc, self._generate_service(isvc))
            if ms is not None and (ms.slice.multi_host or ms.multi):
                await self._ensure(
                    isvc, self._generate_headless_service(isvc))

        with span("status"):
            await self._update_status(
                isvc, ms, desired=desired, admitted=admitted,
                queued=queued, decision=decision, parked=parked)
        return soonest(requeue, park_requeue)

    def _serving_burn_rate(self) -> float | None:
        """The serving_latency error-budget burn rate from the process
        SLO engine's fast window, or None when SLO-driven autoscaling
        is off (kill switch) or no enabled engine is installed — None
        keeps the autoscaler byte-for-byte the raw-signal policy."""
        if not self.opts.slo_autoscale:
            return None
        engine = slo.current()
        if engine is None or not engine.enabled:
            return None
        try:
            # The engine's own clock, not ours: observations were
            # stamped on it, and the two can differ under test clocks.
            return engine.burn_rate("serving_latency", "5m")
        except KeyError:
            return None

    # ---- scale up / steady -------------------------------------------------------

    async def _scale_to(self, isvc: dict, ms, desired: int,
                        now: float, *, parked: bool = False,
                        ) -> tuple[int, int]:
        """Bid ``desired`` replicas against the card ledger and
        materialise the admitted ones. Returns (admitted, queued)."""
        ns, name = namespace_of(isvc), name_of(isvc)
        skey = (ns, name)
        annotations = annotations_of(isvc)
        priority = self.opts.priority
        raw = annotations.get(isvcapi.PRIORITY_ANNOTATION)
        if raw:
            from kubeflow_tpu_torch.scheduler import parse_priority

            priority = parse_priority(raw)
        restore = isvcapi.parked_checkpoint(annotations)
        admitted = queued = 0
        for i in range(desired):
            rkey = isvcapi.replica_key(ns, name, i)
            running = self._replica_running(isvc, ms, i)
            admission = None
            if self._scheduler is not None and ms is not None:
                admission = await self._scheduler.serving_admission(
                    rkey, ms, namespace=ns, priority=priority,
                    running=running,
                    flex_pool=annotations.get(
                        f"{isvcapi.FLEX_POOL_ANNOTATION_PREFIX}{i}"))
            if admission is None or admission.admitted:
                admitted += 1
                # ``parked`` is the CR state THIS reconcile read — not a
                # live StatefulSet count, which lags the informer and
                # would double-fire the warm branch (and its metric) on
                # the follow-up reconcile _cancel_park's patch triggers.
                warm = parked and i == 0 and restore is not None
                if warm:
                    # Scale-from-zero through the parked standby: the
                    # kept StatefulSet scales back up with the parked
                    # checkpoint as its restore hint — a weight restore,
                    # not a cold model init.
                    with span("warm_restore", service=f"{ns}/{name}",
                              checkpoint=restore[0]):
                        self.m_warm_restores.inc()
                        parked_at = parse_iso(annotations.get(
                            isvcapi.PARKED_AT_ANNOTATION) or "")
                        if parked_at is not None:
                            self.m_scale_from_zero.observe(
                                max(0.0, now - parked_at))
                        await self._apply_replica(isvc, ms, i,
                                                  restore=restore)
                        # The park is consumed NOW — clearing parked-at
                        # any earlier (e.g. while the replica still
                        # queues for cards) would skip this branch and
                        # its metrics on the follow-up reconcile.
                        try:
                            await self.kube.patch(
                                "InferenceService", name,
                                {"metadata": {"annotations": {
                                    isvcapi.PARKED_AT_ANNOTATION: None,
                                }}}, ns)
                        except ApiError as exc:
                            log.debug("parked-at clear for %s/%s after "
                                      "warm restore failed (re-cleared "
                                      "next pass): %s", ns, name, exc)
                        await self._event(
                            isvc, "Normal", "WarmRestored",
                            f"Scale-from-zero: replica 0 restoring from "
                            f"parked checkpoint {restore[0]}"
                            + (f" @ step {restore[1]}"
                               if restore[1] is not None else ""))
                else:
                    await self._apply_replica(isvc, ms, i, restore=restore)
            else:
                queued += 1
                if not running:
                    await self._park_replica_sts(isvc, ms, i,
                                                 delete=False)
        if parked and admitted > 0 and restore is None:
            # A checkpoint-less park (grace fallback) coming back up:
            # there is no warm branch to consume the parked-at mark, so
            # clear it here — a stale mark would skew the NEXT cycle's
            # scale-from-zero histogram.
            try:
                await self.kube.patch(
                    "InferenceService", name,
                    {"metadata": {"annotations": {
                        isvcapi.PARKED_AT_ANNOTATION: None}}}, ns)
            except ApiError as exc:
                log.debug("stale parked-at clear for %s/%s failed "
                          "(re-cleared next pass): %s", ns, name, exc)
        await self._sync_flex_markers(isvc, desired)
        recorded = self._high_water.get(skey, 0)
        if desired > recorded and recorded:
            self.m_scale_events.labels(direction="up").inc()
        elif desired < recorded:
            self.m_scale_events.labels(direction="down").inc()
        # GC/release against CLUSTER truth, not just the in-memory
        # high-water: a controller restart forgets the old replica
        # count, and replicas above the first post-restart desired would
        # otherwise keep their StatefulSets (and pods) forever while the
        # fresh ledger resells their cards.
        prev_high = max(recorded, self._observed_high(isvc))
        if desired < prev_high:
            await self._release_from(skey, desired, high=prev_high)
            await self._gc_replicas(isvc, ms, desired, prev_high)
        # kftpu: ignore[await-race] _scale_to runs only from this service's own reconcile (per-key workqueue serialization); skey entries race no one
        self._high_water[skey] = desired
        return admitted, queued

    async def _apply_replica(self, isvc: dict, ms, replica: int,
                             *, restore=None) -> None:
        for slice_id in range(ms.num_slices if ms else 1):
            with span("build_children", kind="StatefulSet",
                      replica=replica, slice=slice_id):
                sts = self.generate_statefulset(
                    isvc, ms, replica, slice_id=slice_id, restore=restore)
            if self._scheduler is not None:
                flex = self._scheduler.flex_node_selectors(
                    isvcapi.replica_key(namespace_of(isvc),
                                        name_of(isvc), replica))
                if flex:
                    sts["spec"]["template"]["spec"].setdefault(
                        "nodeSelector", {}).update(flex)
            await self._ensure(isvc, sts)

    def _replica_running(self, isvc: dict, ms, replica: int) -> bool:
        sts = self._live_sts(isvc, ms, replica)
        return sts is not None and (
            deep_get(sts, "spec", "replicas") or 0) > 0

    def _live_sts(self, isvc: dict, ms, replica: int,
                  slice_id: int = 0) -> dict | None:
        name = isvcapi.replica_sts_name(
            name_of(isvc), replica, slice_id=slice_id,
            num_slices=ms.num_slices if ms else 1)
        if self._sts_informer is not None:
            return self._sts_informer.get(name, namespace_of(isvc))
        return None

    def _current_replicas(self, isvc: dict) -> int:
        """Replicas with a live (replicas > 0) slice-0 StatefulSet —
        derived from the cluster, not in-memory state, so a controller
        restart sees the truth."""
        count = 0
        ms = None
        try:
            ms = isvcapi.multi_slice_of(isvc)
        except Invalid:
            pass
        for i in range(isvcapi.max_replicas(isvc)):
            if self._replica_running(isvc, ms, i):
                count += 1
        return count

    # ---- scale-to-zero: park drain ----------------------------------------------

    async def _drain_to_park(self, isvc: dict, ms, now: float,
                             annotations: dict) -> Result | None:
        """The ONE path that takes a service to zero replicas. Request a
        checkpoint, wait for the engine's ack (the parked-checkpoint
        annotations) bounded by ``park_grace_seconds``, then park: every
        replica StatefulSet scales to 0, replica 0's object is KEPT as
        the warm standby, and the fleet cards release. Never a bare
        stop: this is the only way serving replicas reach zero."""
        ns, name = namespace_of(isvc), name_of(isvc)
        requested = parse_iso(
            annotations.get(isvcapi.PARK_REQUESTED_ANNOTATION) or "")
        if requested is None:
            try:
                await self.kube.patch(
                    "InferenceService", name,
                    {"metadata": {"annotations": {
                        isvcapi.PARK_REQUESTED_ANNOTATION: fmt_iso(now)}}},
                    ns)
            except ApiError:
                return Result(
                    requeue_after=self.opts.autoscale_period_seconds)
            await self._event(
                isvc, "Normal", "ParkRequested",
                f"Idle past the scale-to-zero window; checkpointing "
                f"before parking (grace "
                f"{self.opts.park_grace_seconds:.0f}s)")
            return Result(requeue_after=min(
                self.opts.autoscale_period_seconds,
                self.opts.park_grace_seconds + 0.1))
        acked = isvcapi.park_acked(annotations)
        if not acked and now < requested + self.opts.park_grace_seconds:
            return Result(requeue_after=max(
                0.1, requested + self.opts.park_grace_seconds - now + 0.05))
        await self._park_all(isvc, ms, now, acked=acked)
        return None

    async def _park_all(self, isvc: dict, ms, now: float, *,
                        acked: bool) -> None:
        """Execute the park: replicas → 0 (replica 0's StatefulSet kept
        as the warm standby, higher replicas deleted), cards released,
        park stamped durable."""
        ns, name = namespace_of(isvc), name_of(isvc)
        skey = (ns, name)
        high = max(self._high_water.get(skey, 0),
                   isvcapi.max_replicas(isvc),
                   self._observed_high(isvc))
        with span("park", service=f"{ns}/{name}", acked=acked):
            for i in range(high):
                await self._park_replica_sts(isvc, ms, i, delete=(i > 0))
            await self._release_from(skey, 0)
            # Everything is released: the next scale-from-zero is an
            # up-from-nothing, not a scale-down from the old count.
            # kftpu: ignore[await-race] _park_all runs only from this service's own reconcile (per-key workqueue serialization)
            self._high_water[skey] = 0
            self.m_parks.inc()
            self.m_scale_events.labels(direction="zero").inc()
            try:
                await self.kube.patch(
                    "InferenceService", name,
                    {"metadata": {"annotations": {
                        isvcapi.PARK_REQUESTED_ANNOTATION: None,
                        isvcapi.PARKED_AT_ANNOTATION: fmt_iso(now)}}}, ns)
            except ApiError as exc:
                # the replicas are parked; re-stamp next pass
                log.debug("park stamp for %s/%s failed: %s", ns, name,
                          exc)
        step = isvcapi.parked_checkpoint(annotations_of(isvc))
        await self._event(
            isvc, "Normal", "Parked",
            "Scaled to zero; replica 0 kept as a parked warm standby"
            + (f" (checkpoint @ step {step[1]})"
               if acked and step and step[1] is not None
               else ("" if acked else " (no checkpoint ack within grace)")))

    async def _park_replica_sts(self, isvc: dict, ms, replica: int, *,
                                delete: bool) -> None:
        ns = namespace_of(isvc)
        for slice_id in range(ms.num_slices if ms else 1):
            sts_name = isvcapi.replica_sts_name(
                name_of(isvc), replica, slice_id=slice_id,
                num_slices=ms.num_slices if ms else 1)
            try:
                if delete:
                    await self.kube.delete("StatefulSet", sts_name, ns)
                else:
                    live = self._live_sts(isvc, ms, replica, slice_id)
                    if live is not None and (
                            deep_get(live, "spec", "replicas") or 0) > 0:
                        await self.kube.patch(
                            "StatefulSet", sts_name,
                            {"spec": {"replicas": 0}}, ns)
            except (NotFound, ApiError) as exc:
                log.debug("replica park of %s failed (re-parked next "
                          "pass): %s", sts_name, exc)

    async def _cancel_park(self, isvc: dict, ns: str, name: str, *,
                           parked: bool, now: float) -> None:
        """Demand returned: withdraw a pending park REQUEST. The
        parked-at mark (and the checkpoint annotations — the
        warm-restore hint) survive until the warm restore actually
        runs: a scale-from-zero that must first queue for cards would
        otherwise lose its park state before the restore, and the
        warm-restore metrics/event would silently skip in exactly the
        contended case operators watch them for."""
        if isvcapi.PARK_REQUESTED_ANNOTATION not in annotations_of(isvc):
            return
        try:
            await self.kube.patch(
                "InferenceService", name,
                {"metadata": {"annotations": {
                    isvcapi.PARK_REQUESTED_ANNOTATION: None}}}, ns)
        except ApiError as exc:
            log.debug("park-request withdrawal for %s/%s failed "
                      "(re-tried while demand holds): %s", ns, name, exc)

    # ---- releases / GC -----------------------------------------------------------

    def _observed_high(self, isvc: dict) -> int:
        """Highest replica index (+1) with a live StatefulSet or a
        booking in the shared scheduler — the restart-safe floor for
        GC/release decisions (the in-memory high-water dies with the
        process)."""
        high = 0
        if self._sts_informer is not None \
                and self._sts_informer.has_indexer(OWNER_INDEX):
            for sts in self._sts_informer.by_index(OWNER_INDEX,
                                                   uid_of(isvc)):
                m = _REPLICA_STS_RE.search(name_of(sts) or "")
                if m:
                    high = max(high, int(m.group(1)) + 1)
        return max(high, self._booked_high(
            (namespace_of(isvc), name_of(isvc))))

    def _booked_high(self, skey: tuple) -> int:
        """Highest replica index (+1) this service still holds (or
        queues) in the shared scheduler."""
        if self._scheduler is None:
            return 0
        high = 0
        policy = self._scheduler.policy
        for k in [*policy.ledger.allocations, *policy.pending]:
            parsed = isvcapi.parse_replica_key(tuple(k))
            if parsed is not None and k[0] == skey[0] \
                    and parsed[0] == skey[1]:
                high = max(high, parsed[1] + 1)
        return high

    async def _release_from(self, skey: tuple, keep: int, *,
                            high: int | None = None) -> None:
        """Release fleet admission for replicas >= ``keep``."""
        if self._scheduler is None:
            return
        bound = max(self._high_water.get(skey, 0), high or 0,
                    self._booked_high(skey))
        for i in range(keep, bound):
            await self._scheduler.serving_release(
                isvcapi.replica_key(skey[0], skey[1], i))

    async def _release_all(self, key: tuple) -> None:
        skey = tuple(key)
        await self._release_from(skey, 0)

    async def _sync_flex_markers(self, isvc: dict, desired: int) -> None:
        """Persist each replica's borrow pool on the CR (or clear it) so
        a controller restart re-seats flex replicas as BORROWS — the
        serving analogue of the notebook FLEX_POOL_ANNOTATION stamp."""
        if self._scheduler is None:
            return
        ns, name = namespace_of(isvc), name_of(isvc)
        ann = annotations_of(isvc)
        patch: dict = {}
        for i in range(max(desired, self._observed_high(isvc))):
            key = f"{isvcapi.FLEX_POOL_ANNOTATION_PREFIX}{i}"
            alloc = self._scheduler.policy.ledger.allocations.get(
                isvcapi.replica_key(ns, name, i))
            pool = (next(iter(alloc.borrow))
                    if alloc is not None and alloc.borrowed else None)
            if ann.get(key) != pool:
                patch[key] = pool
        if patch:
            try:
                await self.kube.patch(
                    "InferenceService", name,
                    {"metadata": {"annotations": patch}}, ns)
            except ApiError as exc:
                # best-effort durable marker; re-synced next pass
                log.debug("flex-marker sync for %s failed: %s", name,
                          exc)

    async def _gc_replicas(self, isvc: dict, ms, desired: int,
                           prev_high: int) -> None:
        """Delete StatefulSets of replicas above the new desired count
        (scale-down above zero; the park path owns the zero case)."""
        for i in range(max(desired, 1), prev_high):
            await self._park_replica_sts(isvc, ms, i, delete=True)

    # ---- object generation -------------------------------------------------------

    def generate_statefulset(self, isvc: dict, ms, replica: int, *,
                             slice_id: int = 0, restore=None) -> dict:
        """One replica-slice StatefulSet. Mirrors the notebook slice
        generator's GPU wiring (selectors, card requests, slice-static
        env, webhook annotations) with serving labels and the parked
        checkpoint (or spec.model.checkpointPath) as the restore env."""
        name, ns = name_of(isvc), namespace_of(isvc)
        num_slices = ms.num_slices if ms else 1
        sts_name = isvcapi.replica_sts_name(
            name, replica, slice_id=slice_id, num_slices=num_slices)
        gpu = ms.slice if ms else None
        replicas = gpu.num_hosts if gpu else 1

        pod_spec = {**isvcapi.pod_spec_of(isvc)}
        containers = [dict(c) for c in pod_spec.get("containers", [])]
        if not containers:
            containers = [{"name": name,
                           "image": "kubeflow-tpu/jax-serve:latest"}]
        main = containers[0]
        main.setdefault("name", name)
        main.setdefault("ports", [
            {"containerPort": self.opts.serving_port, "name": "serve",
             "protocol": "TCP"}])

        template_annotations: dict = {}
        template_labels: dict = {
            STS_LABEL: sts_name,
            isvcapi.SERVICE_LABEL: name,
            isvcapi.WORKLOAD_CLASS_LABEL: isvcapi.SERVING_CLASS,
            "app": name,
        }
        if gpu:
            self._apply_gpu(main, pod_spec, template_annotations,
                            template_labels, isvc, ms, replica, slice_id)
        self._set_restore_env(main, isvc, restore)
        containers[0] = main
        pod_spec["containers"] = containers

        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": sts_name, "namespace": ns,
                "labels": {
                    isvcapi.SERVICE_LABEL: name,
                    isvcapi.WORKLOAD_CLASS_LABEL: isvcapi.SERVING_CLASS,
                },
            },
            "spec": {
                "replicas": replicas,
                "serviceName": name + WORKERS_SERVICE_SUFFIX,
                "selector": {"matchLabels": {STS_LABEL: sts_name}},
                # Slice nodes bootstrap their world together, exactly
                # like a notebook slice.
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

    def _apply_gpu(self, main: dict, pod_spec: dict,
                   template_annotations: dict, template_labels: dict,
                   isvc: dict, ms, replica: int, slice_id: int) -> None:
        """Wire one replica slice: selector, card requests, slice-static
        env, the per-node webhook's annotations and label (the notebook
        controller's ``_apply_gpu`` without its downward-API fallback
        and container port, as the reference's serving wiring has
        neither). The nodes' hostnames are the replica's own pods,
        ``<name>-r<i>[-s<j>]-<ordinal>``: the reference names
        ``<name>[-s<j>]-<ordinal>``, pods no replica has, so a multi-node
        replica's rendezvous would never resolve."""
        from kubeflow_tpu_torch.api import notebook as nbapi

        name, ns = name_of(isvc), namespace_of(isvc)
        gpu = ms.slice
        selectors = dict(pod_spec.get("nodeSelector") or {})
        selectors.update(gpu.node_selectors())
        pod_spec["nodeSelector"] = selectors
        resources = dict(main.get("resources") or {})
        for kind in ("requests", "limits"):
            bucket = dict(resources.get(kind) or {})
            bucket.update(gpu.resource_requests())
            resources[kind] = bucket
        main["resources"] = resources

        headless = name + WORKERS_SERVICE_SUFFIX
        base = isvcapi.replica_sts_name(name, replica)
        if ms.multi:
            hostnames = ms.worker_hostnames(
                base, headless, ns, self.opts.cluster_domain)
            static_env = ms.worker_env(slice_id, 0, hostnames)
            template_annotations[nbapi.TPU_SLICE_ID_ANNOTATION] = \
                str(slice_id)
            template_annotations[nbapi.TPU_NUM_SLICES_ANNOTATION] = \
                str(ms.num_slices)
        else:
            hostnames = gpu.worker_hostnames(
                base, headless, ns, self.opts.cluster_domain)
            static_env = gpu.worker_env(0, hostnames)
        for per_worker in ("TPU_WORKER_ID", NODE_RANK_ENV):
            static_env.pop(per_worker, None)
        env = [dict(e) for e in main.get("env", [])]
        have = {e.get("name") for e in env}
        for k, v in static_env.items():
            if k not in have:
                env.append({"name": k, "value": v})
        main["env"] = env
        # Same per-node env contract as notebook slices: the pod
        # webhook computes TPU_WORKER_ID / PET_NODE_RANK at admission,
        # keyed on the slice label + annotations below.
        template_annotations[nbapi.TPU_ACCELERATOR_ANNOTATION] = \
            gpu.accelerator.name
        template_annotations[nbapi.TPU_TOPOLOGY_ANNOTATION] = \
            gpu.topology_str
        template_labels[nbapi.TPU_SLICE_LABEL] = "true"

    def _set_restore_env(self, container: dict, isvc: dict,
                         restore) -> None:
        """Weights source for the engine: the parked warm-standby
        checkpoint when one exists, else the model's declared
        checkpointPath (the cold source of truth)."""
        if restore is None:
            path = deep_get(isvc, "spec", "model", "checkpointPath")
            restore = (path, None) if path else None
        if restore is None:
            return
        path, step = restore
        env = [dict(e) for e in container.get("env", [])]
        have = {e.get("name") for e in env}
        if migration.RESTORE_PATH_ENV not in have:
            env.append({"name": migration.RESTORE_PATH_ENV, "value": path})
        if step is not None and migration.RESTORE_STEP_ENV not in have:
            env.append({"name": migration.RESTORE_STEP_ENV,
                        "value": str(step)})
        container["env"] = env

    def _generate_service(self, isvc: dict) -> dict:
        name, ns = name_of(isvc), namespace_of(isvc)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name, "namespace": ns,
                "labels": {isvcapi.SERVICE_LABEL: name},
            },
            "spec": {
                # All replicas behind one name: the Service load-balances
                # across every replica's workers.
                "selector": {isvcapi.SERVICE_LABEL: name},
                "ports": [{
                    "name": "http", "port": isvcapi.SERVICE_PORT,
                    "targetPort": self.opts.serving_port,
                    "protocol": "TCP",
                }],
            },
        }

    def _generate_headless_service(self, isvc: dict) -> dict:
        name, ns = name_of(isvc), namespace_of(isvc)
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": name + WORKERS_SERVICE_SUFFIX, "namespace": ns,
                "labels": {isvcapi.SERVICE_LABEL: name},
            },
            "spec": {
                "clusterIP": "None",
                "selector": {isvcapi.SERVICE_LABEL: name},
                "ports": [{"name": RENDEZVOUS_PORT_NAME,
                           "port": MASTER_PORT, "protocol": "TCP"}],
            },
        }

    # ---- status ------------------------------------------------------------------

    async def _update_status(self, isvc: dict, ms, *, desired: int,
                             admitted: int, queued: int, decision,
                             parked: bool) -> None:
        ns, name = namespace_of(isvc), name_of(isvc)
        ready = 0
        if self._sts_informer is not None \
                and self._sts_informer.has_indexer(OWNER_INDEX):
            owned = self._sts_informer.by_index(OWNER_INDEX, uid_of(isvc))
            ready = sum(deep_get(s, "status", "readyReplicas", default=0)
                        or 0 for s in owned)
        want_hosts = (ms.slice.num_hosts * ms.num_slices
                      if ms else 1) * max(admitted, 0)
        state = ("Parked" if parked and desired == 0
                 else "Parking" if desired == 0
                 else "Queued" if admitted == 0 and queued > 0
                 else "Scaling" if ready < want_hosts or queued > 0
                 else "Ready")
        status = {
            "replicas": desired,
            "readyReplicas": ready,
            "serving": {
                "state": state,
                "desiredReplicas": desired,
                "admittedReplicas": admitted,
                "queuedReplicas": queued,
                "reason": decision.reason,
            },
        }
        if ms is not None:
            status["gpu"] = {
                "chipsPerReplica": ms.num_chips,
                "hostsPerReplica": ms.slice.num_hosts * ms.num_slices,
                "accelerator": ms.slice.accelerator.name,
                "topology": ms.slice.topology_str,
            }
        ckpt = isvcapi.parked_checkpoint(annotations_of(isvc))
        if ckpt is not None:
            status["serving"]["parkedCheckpoint"] = {
                "path": ckpt[0],
                **({"step": ckpt[1]} if ckpt[1] is not None else {}),
            }
        # Engine data-plane surfaces, folded from the
        # gateway-stamped annotations so the JWA reads one place: the
        # KV-cache shortfall behind the head of the queue, an in-flight
        # model swap (warm standby vs cold load), and the per-model
        # load breakdown of a multiplexing replica.
        ann = annotations_of(isvc)
        short = int(_safe_float(ann.get(
            isvcapi.KV_BLOCKS_SHORT_ANNOTATION)))
        if short > 0:
            status["serving"]["kvPressure"] = {"blocksShort": short}
        swapping = (ann.get(isvcapi.MODEL_SWAP_ANNOTATION) or "").strip()
        if swapping:
            warm_raw = (ann.get(isvcapi.MODEL_SWAP_WARM_ANNOTATION)
                        or "").strip().lower()
            status["serving"]["modelSwap"] = {
                "model": swapping,
                "warm": warm_raw in ("1", "true", "yes", "on"),
            }
        per_model = isvcapi.model_rates(ann)
        if per_model:
            status["serving"]["models"] = {
                m: round(r, 3) for m, r in sorted(per_model.items())}
        # A successful reconcile clears a manager-stamped quarantine
        # verdict (runtime/manager.py Degraded condition) — without the
        # flip, a released quarantine would show "Reconciliation
        # suspended" in the UI forever (the notebook reconciler does
        # the same).
        conditions = deep_get(isvc, "status", "conditions",
                              default=[]) or []
        flipped = None
        for c in conditions:
            if c.get("type") == "Degraded":
                if c.get("status") == "True":
                    flipped = [{**c, "status": "False",
                                "reason": "Recovered",
                                "lastProbeTime": now_iso()}] + [
                        x for x in conditions if x is not c][:7]
                break
        if flipped is not None:
            status["conditions"] = flipped
        # Write elision against what WE last wrote (conditions aside):
        # other writers add fields this controller doesn't compute, so
        # comparing against the whole live status would defeat the
        # no-op guard and PATCH every autoscale pass forever.
        skey = (ns, name)
        if flipped is None and self._last_status.get(skey) == status:
            return
        try:
            await self.kube.patch(
                "InferenceService", name, {"status": status}, ns,
                subresource="status")
            # kftpu: ignore[await-race] per-service dedup cache written only from this key's own reconcile; worst case is one redundant status write
            self._last_status[skey] = {
                k: v for k, v in status.items() if k != "conditions"}
        except (NotFound, ApiError) as exc:
            log.debug("serving status write for %s failed (refreshed "
                      "next reconcile): %s", skey, exc)

    # ---- plumbing ----------------------------------------------------------------

    async def _ensure(self, isvc: dict, desired: dict) -> bool:
        set_controller_owner(desired, isvc)
        _, created = await reconcile_child(
            self.kube, desired,
            cache=self._apply_cache, reader=self._reader)
        return created

    async def _event(self, isvc: dict, type_: str, reason: str,
                     message: str) -> None:
        try:
            await self.recorder.event(isvc, type_, reason, message)
        except Exception:
            # Events are best-effort BY CONTRACT; the recorder only
            # counts API-level swallows, so count this one ourselves.
            self.recorder.count_drop()


def _safe_float(raw) -> float:
    try:
        value = float(raw) if raw is not None else 0.0
    except (TypeError, ValueError):
        return 0.0
    return max(0.0, value)


def setup_serving_controller(
    mgr: Manager, options: ServingOptions | None = None, *,
    scheduler=None,
) -> InferenceServiceReconciler:
    """Wire the serving workload class onto a manager. ``scheduler`` is
    the SHARED GpuFleetScheduler (the one the notebook controller
    consults) — one ledger for both workload classes; None means every
    replica admits unconditionally (KFTPU_SCHEDULER=off / no fleet)."""
    rec = InferenceServiceReconciler(mgr.kube, options,
                                     registry=mgr.registry)
    rec._scheduler = scheduler
    mgr.add_controller(
        Controller(
            name="inferenceservice",
            kind="InferenceService",
            reconcile=rec.reconcile,
            owns=["StatefulSet", "Service"],
        )
    )
    rec._sts_informer = mgr.informer_for("StatefulSet")
    rec._child_informers.update({
        "StatefulSet": mgr.informer_for("StatefulSet"),
        "Service": mgr.informer_for("Service"),
    })
    if scheduler is not None:
        # A replica admitted (or reclaimed) out of band reconciles its
        # service NOW; replica keys map back to the owning CR.
        def _requeue(rkey: tuple) -> None:
            parsed = isvcapi.parse_replica_key(tuple(rkey))
            if parsed is not None:
                mgr.enqueue("inferenceservice", (rkey[0], parsed[0]))

        scheduler.on_serving_admitted(_requeue)
    return rec
