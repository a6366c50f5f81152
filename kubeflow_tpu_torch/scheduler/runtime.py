"""Async runtime of the GPU fleet scheduler: the port of
``kubeflow_tpu/scheduler/runtime.py`` in GPU units (its "chips" are
cards, its "hosts" nodes).

The single admission point between a Notebook CR and its slice
StatefulSets: the notebook controller's capacity stage calls
:meth:`GpuFleetScheduler.admission` before creating any slice, and
:meth:`GpuFleetScheduler.release` on stop/delete. The pure policy core
(:mod:`kubeflow_tpu_torch.scheduler.policy`) makes every decision; this layer
adds what the cluster needs around it:

- fleet discovery (env spec, ConfigMap, or Node-label inference);
- preemption actuation — victims are stop-annotated (the notebook
  reconciler parks the whole gang, never a slice subset) and the
  preemption is recorded so their status can say why;
- transition side effects: ``Queued``/``Admitted``/``Preempted`` Events,
  the admitted-at annotation culling's idle clock needs, and re-enqueues
  so a freshly admitted notebook reconciles immediately;
- observability: ``schedule``/``admit``/``preempt`` tracing phases,
  Prometheus gauges/counters/histogram, and the ``/debug/scheduler``
  payload.

With no fleet configured the scheduler is a transparent no-op (every
admission passes through, zero API writes) — exactly today's behavior,
which is also what the ``KFTPU_SCHEDULER=off`` kill switch restores.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field, replace

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api import inferenceservice as isvcapi
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.errors import ApiError, NotFound
from kubeflow_tpu_torch.runtime.events import EventRecorder
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import (
    annotations_of,
    deep_get,
    fmt_iso,
    name_of,
    namespace_of,
    parse_iso,
)
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime.tracing import current_trace_id, span
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.scheduler import elastic
from kubeflow_tpu_torch.scheduler.fleet import Allocation, Fleet
from kubeflow_tpu_torch.scheduler.policy import (
    GangRequest,
    PolicyConfig,
    PolicyQueue,
    Preemption,
)
from kubeflow_tpu_torch.gpu.topology import GpuSlice, TopologyError

log = logging.getLogger(__name__)

# Priority classes from a CR annotation; plain integers are accepted too.
PRIORITY_ANNOTATION = nbapi.PRIORITY_ANNOTATION
PRIORITY_CLASSES = {"low": -100, "normal": 0, "high": 100, "critical": 200}

# Warm-pool slot reservations sit below every user priority
# class: the reserve exists to be cannibalized, and the tier -1 victim
# ordering in policy._find_victims makes the intent structural, not just
# a number.
WARM_POOL_PRIORITY = -1000

FLEET_CONFIGMAP_KEY = "fleet"
_CONFIGMAP_RETRY_SECONDS = 30.0


async def load_fleet_from_configmap(kube, name: str,
                                    namespace: str) -> Fleet | None:
    """The ONE reader of the fleet ConfigMap — shared by the scheduler's
    ``_ensure_fleet`` and the webhook's can-never-fit ceiling
    (webhooks/notebook.py), so the spec key and the bad-spec tolerance
    cannot drift apart between the two admission layers. Returns None
    when the ConfigMap/key is absent or the spec is malformed (a broken
    spec must not block admissions or wedge the scheduler); callers own
    their caching/retry policy."""
    cm = await kube.get_or_none("ConfigMap", name, namespace)
    spec = ((cm or {}).get("data") or {}).get(FLEET_CONFIGMAP_KEY) or ""
    if not spec.strip():
        return None
    try:
        return Fleet.parse(spec)
    except Exception:
        log.exception("bad fleet spec in ConfigMap %s/%s", namespace, name)
        return None


def parse_priority(value: str | None) -> int:
    if not value:
        return 0
    v = value.strip().lower()
    if v in PRIORITY_CLASSES:
        return PRIORITY_CLASSES[v]
    try:
        return int(v)
    except ValueError:
        return 0


@dataclass(frozen=True)
class Admission:
    """What the capacity stage gets back."""

    state: str                 # "Admitted" | "Queued" | "Preempted" | "Draining"
    position: int = 0
    reason: str = ""
    waiting_chips: int = 0
    # Draining only: how soon the controller must reconcile again so the
    # grace deadline fires even if the SDK never acks.
    requeue_after: float = 0.0
    # Queued only, elastic: why this gang is BACK in the queue
    # ("spot-reclaim" after its capacity was revoked, "defrag" after a
    # migration park) — JWA keys its message off it.
    reclaimed: str = ""
    # Queued only, elastic: a pool-scale-up intent is pending for this
    # gang's shape (chips asked for, and how long the ask has waited).
    scale_up_chips: int = 0
    scale_up_pending_sec: float = -1.0

    @property
    def admitted(self) -> bool:
        return self.state == "Admitted"


@dataclass
class _Drain:
    """In-memory side of one in-flight drain (the durable side lives in
    the victim's annotations — migration/protocol.py)."""

    reason: str                # "idle" | "priority" | "spot-reclaim" | "defrag"
    for_key: tuple             # beneficiary waiting on the chips
    chips: int
    requested_at: float
    deadline: float
    # The drain-reason annotation value (the protocol's finalizer
    # contract): "preempt:<reason>" for scheduler preemption,
    # "spot-reclaim"/"defrag" for the elastic paths.
    annotation: str = ""
    # Elastic drains: once parked, un-park and re-queue the victim with
    # its aging credit instead of waiting for a user restart.
    requeue: bool = False


@dataclass
class _CommitWait:
    """Post-park commit watch (checkpoint fabric): the drain
    acked at snapshot and the chips are already free, but the restore
    guarantee is only hard-released when the background upload durably
    commits — or the commit grace expires and the park is marked
    commit-dirty (the drain then counts as a fallback, not a clean
    drain)."""

    reason: str
    requested_at: float        # drain request — the commit SLI's t0
    deadline: float            # requested_at-anchored commit grace


@dataclass
class SchedulerOptions:
    """Env contract (cmd/envconfig.py scheduler_options)."""

    # "" → no explicit fleet; "auto" → infer from Node labels; otherwise a
    # Fleet.parse spec ("a3=nvidia-h100-80gb:2x8:2,...").
    fleet_spec: str = ""
    # ConfigMap (controller namespace) with the same spec under
    # data["fleet"]; tried when fleet_spec is empty. None disables.
    fleet_configmap: str | None = None
    controller_namespace: str = "kubeflow-tpu"
    weights: dict = field(default_factory=dict)   # namespace → weight
    aging_seconds: float = 300.0
    aging_max_boost: int = 4
    starvation_reserve_seconds: float = 900.0
    enable_preemption: bool = True
    idle_preempt_after_seconds: float = 1800.0
    # Requeue cadence for queued notebooks — a safety net; admissions
    # re-enqueue the winner immediately.
    queued_requeue_seconds: float = 10.0
    # Preempt-to-checkpoint (kubeflow_tpu_torch/migration): preemption requests
    # a drain and only frees the ledger once the victim acks a committed
    # checkpoint (or the grace deadline fires — chips are never held
    # hostage). The DATACLASS default is off so bare construction keeps
    # the pre-migration immediate-stop semantics byte-for-byte; the
    # production env wiring (cmd/envconfig.py, KFTPU_MIGRATION, default
    # on) is what turns it on.
    enable_migration: bool = False
    drain_grace_seconds: float = migration.DEFAULT_DRAIN_GRACE_SECONDS
    # Checkpoint fabric: how long after the snapshot ack the
    # background upload may run before the park is marked commit-dirty
    # and the drain counted as a fallback (KFTPU_COMMIT_GRACE; defaults
    # to the drain grace via cmd/envconfig.py).
    commit_grace_seconds: float = migration.DEFAULT_DRAIN_GRACE_SECONDS
    # Elastic fleet (kubeflow_tpu_torch/scheduler/elastic.py): scale-up
    # intents, flex (host-borrowing) placement, spot reclaim, defrag.
    # The DATACLASS default is off — bare construction keeps the
    # pre-elastic semantics byte-for-byte; production gets it from KFTPU_ELASTIC
    # (default on) via cmd/envconfig.py.
    enable_elastic: bool = False
    scale_up_ttl_seconds: float = elastic.DEFAULT_SCALE_UP_TTL_SECONDS
    # Defrag rides under enable_elastic; KFTPU_DEFRAG=off clears it.
    enable_defrag: bool = True
    defrag_interval_seconds: float = \
        elastic.DEFAULT_DEFRAG_INTERVAL_SECONDS
    defrag_idle_seconds: float = elastic.DEFAULT_DEFRAG_IDLE_SECONDS
    defrag_max_moves: int = elastic.DEFAULT_DEFRAG_MAX_MOVES
    # Dynamic fleet sources (ConfigMap / node inference) re-read on this
    # throttle; also paces how quickly a granted scale-up is noticed.
    fleet_refresh_seconds: float = _CONFIGMAP_RETRY_SECONDS


class GpuFleetScheduler:
    def __init__(
        self,
        kube,
        options: SchedulerOptions | None = None,
        *,
        fleet: Fleet | None = None,
        registry: Registry | None = None,
    ):
        self.kube = kube
        self.options = options or SchedulerOptions()
        self.recorder = EventRecorder(kube, "gpu-fleet-scheduler",
                                      registry=registry)
        if fleet is None and self.options.fleet_spec and \
                self.options.fleet_spec != "auto":
            fleet = Fleet.parse(self.options.fleet_spec)  # fail fast
        self.policy = PolicyQueue(
            fleet=fleet or Fleet(),
            config=PolicyConfig(
                aging_seconds=self.options.aging_seconds,
                aging_max_boost=self.options.aging_max_boost,
                starvation_reserve_seconds=(
                    self.options.starvation_reserve_seconds),
                enable_preemption=self.options.enable_preemption,
                idle_preempt_after_seconds=(
                    self.options.idle_preempt_after_seconds),
                deferred_preemption=self.options.enable_migration,
            ),
        )
        self._now = time.time
        self._node_informer = None          # set by setup wiring
        self._nb_informer = None
        self._ring = None                   # set by attach_ring (sharded)
        self._enqueue_cbs: list = []
        # Serving workload class (kubeflow_tpu_torch/serving): replica gang
        # keys admitted through serving_admission(). Their side effects
        # differ from notebooks' — no CR annotation stamps (the key
        # names no Notebook), no drain protocol (the engine's parked
        # checkpoint is the state), and re-enqueues route to the
        # serving controller's callbacks, never the notebook workqueue
        # (a notebook reconcile of a nonexistent key would RELEASE the
        # serving allocation). Empty — and every path below byte-
        # identical to the pre-serving scheduler — until a serving
        # controller registers.
        self._serving_keys: set = set()
        self._serving_cbs: list = []
        # Warm pod pools (controllers/warmpool.py): slot
        # reservation keys admitted through warm_reserve(). Their chips
        # are a low-priority reclaimable reserve — the FIRST preemption
        # victims, released instantly (nothing to checkpoint), with the
        # teardown routed to the pool manager's async callbacks instead
        # of any Notebook CR patch (no CR exists under these keys).
        self._warmpool_keys: set = set()
        self._warm_cbs: list = []
        # key → "Queued"|"Admitted" (last surfaced state, for transition
        # events); key → preemption reason for stopped victims; key →
        # reason for victims whose stop patch FAILED and must be retried
        # on their next reconcile (the ledger already re-assigned their
        # chips — without the retry the victim would run forever).
        self._state: dict[tuple, str] = {}
        self._preempted: dict[tuple, str] = {}
        self._stop_pending: dict[tuple, str] = {}
        # key → in-flight drain (preempt-to-checkpoint): the victim still
        # holds its chips while it checkpoints; finalized on ack or when
        # the grace deadline fires.
        self._draining: dict[tuple, _Drain] = {}
        self._commit_waits: dict[tuple, _CommitWait] = {}
        self._fleet_next_try = 0.0
        # Debounce for full arbitration passes (see Admission below).
        self._last_pass_gen = -1
        self._last_pass_at = float("-inf")
        self._gauge_ns: set = set()
        self._gauge_pools: set = set()
        # ---- elastic fleet state (None/"empty" with elastic off) ----
        # Pending scale-up intents (pure book; the CR mirror + metrics
        # live here in the runtime).
        self._intent_book = (
            elastic.IntentBook(self.options.scale_up_ttl_seconds)
            if self.options.enable_elastic else None)
        self._elastic_cfg = elastic.ElasticConfig(
            scale_up_ttl_seconds=self.options.scale_up_ttl_seconds,
            enable_defrag=self.options.enable_defrag,
            defrag_interval_seconds=self.options.defrag_interval_seconds,
            defrag_idle_seconds=self.options.defrag_idle_seconds,
            defrag_max_moves=self.options.defrag_max_moves,
        )
        self._last_defrag_at = float("-inf")
        self._defrag_moves = 0
        # Debounce for the elastic post-pass (intents/eviction are
        # O(queue) scans — same rationale as the arbitration debounce).
        self._last_elastic_gen = -1
        self._last_elastic_at = float("-inf")
        # Serializes the elastic post-pass: IntentBook.sync computes an
        # IntentSync delta and the CR mirror then applies it over many
        # await round trips — two reconcile workers interleaving there
        # could apply STALE deltas (one task creating a ProvisioningRequest
        # the other's sync just withdrew → an orphan CR only the throttled
        # janitor ever collects). The await-race pass tracks acquisition
        # through the call graph.
        self._elastic_lock = asyncio.Lock()
        # pool name → {"since": t, "nodes": set}: in-progress spot
        # reclaims. While an entry exists the pool is marked unavailable
        # in the ledger (sells nothing); the entry clears when the
        # signaling nodes recover/disappear AND every resident gang has
        # drained out.
        self._spot_reclaims: dict[str, dict] = {}
        # key → (reason, park stop-stamp): elastic drains that
        # auto-requeue after the park — release() un-parks them, and the
        # recorded stamp (a nonce'd stop value) lets it tell the
        # scheduler's own park from a user's racing stop. Alongside:
        # key → reason, the surviving "why am I queued again" marker JWA
        # reads until re-admission.
        self._auto_resume: dict[tuple, tuple] = {}
        self._reclaim_verdict: dict[tuple, str] = {}
        # key → submitted_at credit carried across a reclaim/defrag
        # re-queue (seniority from the gang's original admission — a
        # reclaimed gang must not age from zero behind newcomers).
        self._requeue_credit: dict[tuple, float] = {}
        registry = registry or global_registry
        self.m_queue_depth = registry.gauge(
            "gpu_scheduler_queue_depth",
            "Gangs waiting for GPU fleet admission")
        self.m_admitted_ns = registry.gauge(
            "gpu_scheduler_admitted_chips",
            "GPUs admitted by the fleet scheduler", ["namespace"])
        self.m_admitted_pool = registry.gauge(
            "gpu_scheduler_pool_admitted_chips",
            "GPUs admitted per node pool", ["pool"])
        self.m_preemptions = registry.counter(
            "gpu_scheduler_preemptions_total",
            "Gangs preempted to reclaim GPUs", ["reason"])
        self.m_wait = registry.histogram(
            "gpu_scheduler_admission_wait_seconds",
            "Queue wait from submission to admission")
        self.m_drain = registry.histogram(
            "gpu_scheduler_drain_seconds",
            "Drain request to checkpoint-ack round trip")
        self.m_drain_fallback = registry.counter(
            "gpu_scheduler_drain_fallback_total",
            "Drains that hit the grace deadline and hard-stopped "
            "without a checkpoint")
        self.m_draining = registry.gauge(
            "gpu_scheduler_draining_gangs",
            "Gangs currently checkpointing before preemption")
        self.m_scale_up = registry.gauge(
            "gpu_scheduler_scale_up_intents",
            "Pool scale-up intents currently pending")
        self.m_scale_up_events = registry.counter(
            "gpu_scheduler_scale_up_events_total",
            "Scale-up intent lifecycle events",
            ["event"])  # created | renewed | granted | moot | denied
        self.m_spot_reclaims = registry.counter(
            "gpu_scheduler_spot_reclaims_total",
            "Gangs drained off revoked spot capacity")
        self.m_defrag = registry.counter(
            "gpu_scheduler_defrag_moves_total",
            "Gangs migrated off pack-breaking pools by the defragmenter")
        self.m_borrowed = registry.gauge(
            "gpu_scheduler_borrowed_hosts",
            "Nodes borrowed from foreign-shape pools (flex placement)",
            ["pool"])
        self._gauge_borrow_pools: set = set()

    # ---- wiring -----------------------------------------------------------------

    def on_admitted(self, cb) -> None:
        """Register a re-enqueue callback: cb((namespace, name))."""
        self._enqueue_cbs.append(cb)

    def on_serving_admitted(self, cb) -> None:
        """Register the serving controller's re-enqueue callback:
        cb(replica_key) — called with the (namespace, "<svc>#r<i>")
        replica key whenever a serving replica's admission state may
        have changed (admitted, or its capacity reclaimed)."""
        self._serving_cbs.append(cb)

    def attach_ring(self, ring) -> None:
        """Arbiter election for sharded active-active deployments
        (runtime/sharding.py): the chip ledger stays GLOBALLY consistent
        by running arbitration only on the replica holding the arbiter
        shard (shard 0). A scheduler attached to a non-arbiter ring is
        dormant — ``_ensure_fleet`` refuses to activate, so its whole
        surface is transparent pass-through and none of its background
        sweeps (drains, spot reclaims, elastic intents) can fight the
        real arbiter's. In-process harnesses (bench, chaos) give every
        replica's controllers the ARBITER's scheduler instance — the
        per-shard workqueues feeding one elected arbiter; on arbiter
        failover a fresh scheduler rebuilds its ledger from the API via
        the ``running=True`` re-seat path, exactly the controller-restart
        semantics the chaos soak already exercises."""
        self._ring = ring

    @property
    def arbiter(self) -> bool:
        """True when this replica may arbitrate (unsharded, or holding
        the arbiter shard)."""
        return self._ring is None or self._ring.is_arbiter

    def _enqueue(self, key: tuple) -> None:
        cbs = (self._serving_cbs if key in self._serving_keys
               else self._enqueue_cbs)
        for cb in cbs:
            try:
                cb(key)
            except Exception:
                log.exception("scheduler enqueue callback failed for %s", key)

    @property
    def active(self) -> bool:
        """True once a fleet is known — until then every admission passes
        through untouched."""
        return bool(self.policy.fleet.pools)

    async def _ensure_fleet(self) -> bool:
        """Discover — and for dynamic sources keep refreshing — the fleet.

        An explicit ``KFTPU_FLEET`` spec is immutable for the process's
        lifetime (env can't change under a running controller), so it is
        read once. The ConfigMap and ``auto`` (Node-label) sources are
        *dynamic*: operators grow/shrink them live, and the webhook's
        fast-fail ceiling re-reads the same ConfigMap on a short TTL —
        so both are re-read here on the same ``_CONFIGMAP_RETRY_SECONDS``
        throttle even after activation, or the admission ceiling and the
        scheduler's ledger would diverge until a controller restart. The
        throttle also bounds the auto path's cost while no GPU pool
        exists yet (no per-reconcile full-cluster Node list). A
        transiently EMPTY dynamic fleet is ignored: node pools come and
        go, and turning the scheduler transparent mid-flight would drop
        the queue; ``KFTPU_SCHEDULER=off`` is the deliberate off switch.
        On a shrink, pools already over capacity simply stop fitting new
        gangs and drain as holders release."""
        if not self.arbiter:
            # Dormant standby: no fleet, so every admission passes
            # through untouched and no sweep mutates shared state. The
            # moment the ring hands this replica the arbiter shard, the
            # next admission activates it here.
            return False
        opts = self.options
        dynamic = opts.fleet_spec == "auto" or (
            not opts.fleet_spec and opts.fleet_configmap)
        if self.active and not dynamic:
            return True
        now = self._now()
        if now < self._fleet_next_try:
            return self.active
        refresh = self.options.fleet_refresh_seconds
        if self._intent_book is not None and self._intent_book.intents:
            # A scale-up ask is out: poll the fleet source faster so
            # granted capacity admits promptly, not a full throttle
            # interval later.
            refresh = min(refresh, max(refresh / 6.0, 1.0))
        self._fleet_next_try = now + refresh
        fleet = None
        if opts.fleet_spec == "auto":
            if self._node_informer is not None:
                nodes = self._node_informer.items()
            else:
                try:
                    nodes = await self.kube.list("Node")
                except ApiError:
                    nodes = []
            fleet = Fleet.from_nodes(nodes)
        elif not opts.fleet_spec and opts.fleet_configmap:
            fleet = await load_fleet_from_configmap(
                self.kube, opts.fleet_configmap, opts.controller_namespace)
        if fleet is not None and fleet.pools \
                and fleet != self.policy.fleet:
            was_active = self.active
            # Re-seats live allocations onto the new pools (renamed pool
            # = same hardware under a new name must not be double-sold)
            # and bumps gen, so the next admission runs a full
            # arbitration pass over the new capacity.
            self.policy.rebind_fleet(fleet)
            log.info("GPU fleet scheduler %s: %d pool(s), %d GPUs",
                     "fleet updated" if was_active else "active",
                     len(fleet.pools), fleet.total_chips)
            # Every known notebook re-arbitrates NOW: gangs whose last
            # reconcile ran during the pre-activation pass-through
            # window (fresh restart, dynamic source still loading) are
            # in neither book and may hold chips the new ledger is
            # about to sell — waiting for their next organic event
            # leaves that double-booking window open indefinitely.
            if self._nb_informer is not None:
                for nb in self._nb_informer.items():
                    self._enqueue((namespace_of(nb), name_of(nb)))
            # Same for reclaim signals: a revocation taint dispatched by
            # the Node informer's initial sync BEFORE the fleet loaded
            # mapped onto no pool and was dropped — and a healthy watch
            # never re-delivers it. Re-scan the cached nodes against the
            # fleet that now exists.
            if self._intent_book is not None \
                    and self._node_informer is not None:
                for node in self._node_informer.items():
                    self.note_node_event(node)
        return self.active

    # ---- request construction ---------------------------------------------------

    def _request_of(self, nb: dict, ms, now: float) -> GangRequest:
        ns = namespace_of(nb)
        annotations = annotations_of(nb)
        return GangRequest(
            key=(ns, name_of(nb)),
            namespace=ns or "",
            accelerator=ms.slice.accelerator.name,
            topology=ms.slice.topology_str,
            num_slices=ms.num_slices,
            chips=ms.num_chips,
            priority=parse_priority(annotations.get(PRIORITY_ANNOTATION)),
            weight=float(self.options.weights.get(ns, 1.0)),
            submitted_at=now,
            # A Notebook labeled workload-class=serving (a serving pod
            # deployed through the notebook CR) gets the same victim
            # protection as a real InferenceService replica: no Jupyter
            # activity probe means the idle heuristic would misread it.
            workload=("serving" if isvcapi.is_serving_class(nb)
                      else "notebook"),
        )

    @staticmethod
    def _last_active(nb: dict) -> float | None:
        """Culling's idle signal for preemption ranking. None — and
        therefore never idle — unless the culler has actually probed the
        server (LAST_ACTIVITY annotation present): on clusters running
        without culling nothing refreshes activity, and treating
        'no probe data' as 'idle since admission' would mark every busy
        gang preemptible ``idle_preempt_after`` seconds into its run.
        When probe data exists it is floored by the scheduler's own
        admitted-at stamp, so a gang that waited hours in the queue is
        not 'idle since before it ran'."""
        annotations = annotations_of(nb)
        last = parse_iso(
            annotations.get(nbapi.LAST_ACTIVITY_ANNOTATION) or "")
        if last is None:
            return None
        admitted = parse_iso(
            annotations.get(nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION) or "")
        return max(last, admitted) if admitted is not None else last

    # ---- admission / release ----------------------------------------------------

    async def admission(self, nb: dict, ms, *,
                        running: bool = False) -> Admission | None:
        """Arbitrate one notebook's gang. Returns None while no fleet is
        known (transparent pass-through), otherwise the current admission
        state. ``running=True`` re-seats a gang whose StatefulSets are
        already live (controller restart) instead of queueing it."""
        if not await self._ensure_fleet():
            return None
        now = self._now()
        key = (namespace_of(nb), name_of(nb))
        if key in self._stop_pending:
            # This gang was preempted but its stop patch failed: the
            # ledger already gave its chips away, so retry the stop
            # rather than re-admit/reclaim a gang that must park.
            return await self._retry_stop(key, now)
        # Drains whose victims never reconcile (SDK wedged, pod gone)
        # must still hit their grace deadline — every admission pass
        # sweeps them. The CURRENT key is handled inline below with the
        # live CR this reconcile already holds.
        await self._sweep_drains(now, skip=key)
        # Spot revocations signaled since the last pass start their
        # drains here — including the CURRENT key's (no skip: the
        # drain-progress branch right below then handles it inline).
        await self._sweep_spot_reclaims(now)
        if key in self._draining:
            return await self._drain_progress(key, nb, now)
        result = None
        with span("schedule", key=f"{key[0]}/{key[1]}"):
            if self.policy.is_admitted(key):
                self.policy.touch(key, self._last_active(nb))
                self._state[key] = "Admitted"
                ann = annotations_of(nb)
                if (nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION not in ann
                        or nbapi.PREEMPTED_ANNOTATION in ann):
                    # The admit-time stamp patch failed (or a re-admitted
                    # victim still carries its stale Preempted verdict):
                    # without the stamp, culling clocks idleness from a
                    # pre-queue last-activity signal and stops the gang
                    # seconds after it finally started. Re-stamp with the
                    # ORIGINAL admission time until the patch lands.
                    alloc = self.policy.ledger.allocations[key]
                    await self._stamp_admitted(nb, alloc.admitted_at)
                self._requeue_credit.pop(key, None)
                self._reclaim_verdict.pop(key, None)
                reason_ann = migration.drain_reason(ann)
                if (migration.drain_requested_at(ann) is not None
                        and (reason_ann.startswith("preempt")
                             or reason_ann in (
                                 elastic.SPOT_RECLAIM_REASON,
                                 elastic.DEFRAG_REASON))
                        and key not in self._draining):
                    # Controller restarted mid-drain: the in-memory drain
                    # (and its beneficiary) is gone and this gang was
                    # re-seated as a plain holder. Clear the stale marks
                    # so the SDK stops checkpointing for a preemption
                    # that no longer exists; if the pressure persists the
                    # next arbitration pass re-issues a fresh drain.
                    try:
                        await self.kube.patch(
                            "Notebook", key[1],
                            {"metadata": {"annotations":
                                          migration.clear_drain_patch()}},
                            key[0])
                    except ApiError as exc:
                        log.debug("stale drain-mark clear for %s/%s "
                                  "failed (retried next pass): %s",
                                  key[0], key[1], exc)
                return Admission("Admitted")
            self._preempted.pop(key, None)  # resubmission clears the verdict
            if nbapi.PREEMPTED_ANNOTATION in annotations_of(nb):
                # The DURABLE verdict must clear with the in-memory one:
                # a former victim the user re-queues and later stops is a
                # plain stop, and release() would otherwise resurrect the
                # stale annotation as "Preempted" after a controller
                # restart. Best-effort — release() also guards on the
                # live queue entry.
                try:
                    await self.kube.patch(
                        "Notebook", key[1],
                        {"metadata": {"annotations": {
                            nbapi.PREEMPTED_ANNOTATION: None}}}, key[0])
                except ApiError as exc:
                    log.debug("stale Preempted clear for %s/%s failed "
                              "(release() re-guards on the live queue "
                              "entry): %s", key[0], key[1], exc)
            req = self._request_of(nb, ms, now)
            credit = self._requeue_credit.get(key)
            if credit is not None:
                # Re-queued reclaim/defrag victim: seniority from its
                # original admission — it must not age from zero behind
                # gangs that arrived while it was running.
                req = replace(req, submitted_at=min(credit, now))
            flex_hint = annotations_of(nb).get(
                nbapi.FLEX_POOL_ANNOTATION)
            if running and self.policy.reclaim(
                    req, now, borrow_first=bool(flex_hint),
                    prefer_pool=flex_hint):
                self._state[key] = "Admitted"
                self._refresh_gauges()
                return Admission("Admitted")
            self.policy.submit(req)
            # Debounce: a long queue re-runs this gate every
            # queued_requeue_seconds per notebook; when nothing changed
            # since the last full pass (gen unchanged) and one ran
            # within the interval, the outcome is identical — serve the
            # queue snapshot instead of re-arbitrating O(queue) times
            # per interval. Aging/idle transitions are picked up by the
            # at-least-one-pass-per-interval that still runs.
            if (self.policy.gen == self._last_pass_gen
                    and now - self._last_pass_at
                    < self.options.queued_requeue_seconds):
                queue = self.policy.schedule_preview(now)
            else:
                result = self._arbitrate(now)
                self._last_pass_gen = self.policy.gen
                self._last_pass_at = now
                queue = result.queue
        if result is not None:
            await self._apply(result, now, requester=nb)
        await self._elastic_post(now)
        if self.policy.is_admitted(key):
            return Admission("Admitted")
        info = next((q for q in queue if q.key == key), None)
        position = info.position if info else 0
        reason = info.reason if info else ""
        chips = info.chips if info else ms.num_chips
        if self._state.get(key) != "Queued":
            self._state[key] = "Queued"
            await self._event(
                nb, "Normal", "Queued",
                f"Queued for GPU capacity (position {position}): {reason}")
        intent = (self._intent_book.for_shape(
            ms.slice.accelerator.name, ms.slice.topology_str)
            if self._intent_book is not None else None)
        if intent is not None and key not in intent.for_keys:
            intent = None
        return Admission(
            "Queued", position=position, reason=reason,
            waiting_chips=chips,
            reclaimed=self._reclaim_verdict.get(key, ""),
            scale_up_chips=intent.chips if intent is not None else 0,
            scale_up_pending_sec=(
                round(intent.pending_seconds(now), 3)
                if intent is not None else -1.0))

    async def release(self, key: tuple,
                      nb: dict | None = None) -> Admission | None:
        """Drop a gang's hold (stop/delete). Frees its chips, runs an
        arbitration pass so waiting gangs can take them, and — for a
        stop caused by preemption — reports the ``Preempted`` state the
        victim's status should show. ``nb`` is the live CR for the stop
        path; None means the CR is GONE (delete), so the preemption
        verdict has nobody left to show it to and is dropped too.

        Discovers the fleet if needed (``_ensure_fleet``, not a bare
        ``active`` check): after a controller restart with a dynamic
        fleet source, a preempted victim's FIRST reconcile is this
        stopped path — returning early would wipe the annotation-backed
        Preempted verdict the end of this method restores."""
        if not await self._ensure_fleet():
            return None
        key = tuple(key)
        if nb is None:
            self._preempted.pop(key, None)
            self._auto_resume.pop(key, None)
            self._reclaim_verdict.pop(key, None)
            self._requeue_credit.pop(key, None)
        self._stop_pending.pop(key, None)  # it IS stopped (or gone) now
        now = self._now()
        had_queue_entry = key in self.policy.pending
        alloc = self.policy.release(key)
        self._state.pop(key, None)
        if alloc is not None or had_queue_entry:
            with span("schedule", key=f"{key[0]}/{key[1]}", release=True):
                result = self._arbitrate(now)
                self._last_pass_gen = self.policy.gen
                self._last_pass_at = now
            await self._apply(result, now)
        await self._elastic_post(now)
        if nb is not None and key in self._auto_resume:
            # An elastic (spot-reclaim/defrag) park: the gang is released
            # and its pods are parking under the stop annotation this
            # reconcile already read — un-park it now so the NEXT
            # reconcile re-queues it (with its aging credit) instead of
            # waiting for a user restart.
            reason, stamp = self._auto_resume[key]
            live_stop = annotations_of(nb).get(nbapi.STOP_ANNOTATION)
            if live_stop != stamp:
                # The stop on the CR is not OURS: the user (or another
                # actor) stopped the gang between the park and this
                # release — an explicit stop the auto-resume must not
                # silently revert. The gang stays parked, and the
                # DURABLE elastic verdict clears too: a controller
                # restart would otherwise read it back and un-park the
                # gang against the user's decision.
                self._auto_resume.pop(key, None)
                self._reclaim_verdict.pop(key, None)
                self._requeue_credit.pop(key, None)
                try:
                    await self.kube.patch(
                        "Notebook", key[1],
                        {"metadata": {"annotations": {
                            nbapi.PREEMPTED_ANNOTATION: None}}}, key[0])
                except ApiError as exc:
                    log.debug("durable Preempted clear for %s/%s after "
                              "a user stop failed (stale verdict may "
                              "survive one restart): %s",
                              key[0], key[1], exc)
            else:
                try:
                    await self.kube.patch(
                        "Notebook", key[1],
                        {"metadata": {"annotations": {
                            nbapi.STOP_ANNOTATION: None,
                            nbapi.PREEMPTED_ANNOTATION: None,
                        }}}, key[0])
                    # kftpu: ignore[await-race] release() runs only from this key's own reconcile (per-key workqueue serialization); the pop races no one
                    self._auto_resume.pop(key, None)
                    self._enqueue(key)
                except ApiError:
                    # Keep the entry and re-raise into workqueue backoff
                    # (the _retry_stop contract): nothing else ever
                    # reconciles a parked gang, so one transient
                    # apiserver error must not silently turn "re-queued
                    # with aging credit" into a permanent park.
                    raise ApiError(
                        f"elastic re-queue un-park for {key[0]}/{key[1]} "
                        f"({reason}) failed; retrying with backoff")
        if key in self._draining:
            # Stopped (or deleted) mid-drain: the release above already
            # freed the chips, so the drain is moot — drop it. The
            # Preempted verdict (stamped at drain time) still reports.
            self._draining.pop(key, None)
            self._refresh_gauges()
        if key in self._preempted:
            return Admission("Preempted", reason=self._preempted[key])
        if nb is not None and alloc is None and not had_queue_entry:
            # Controller restarted since the preemption: the in-memory
            # verdict is gone, but the annotation stamped on the victim
            # survives — keep showing WHY it is stopped. Only a gang that
            # was PARKED when stopped qualifies: one that was queued or
            # admitted at stop time has been re-queued/running since the
            # verdict, so its leftover annotation is stale and this is a
            # plain user stop.
            reason = annotations_of(nb).get(nbapi.PREEMPTED_ANNOTATION)
            if reason in (elastic.SPOT_RECLAIM_REASON,
                          elastic.DEFRAG_REASON):
                # An elastic park interrupted by a restart: the
                # auto-requeue lived only in memory, but the durable
                # verdict says this stop was a reclaim/defrag — finish
                # the migration now instead of leaving the gang parked
                # forever. (The aging credit is lost with the process;
                # the re-queue itself must not be.)
                self._reclaim_verdict[key] = reason
                try:
                    await self.kube.patch(
                        "Notebook", key[1],
                        {"metadata": {"annotations": {
                            nbapi.STOP_ANNOTATION: None,
                            nbapi.PREEMPTED_ANNOTATION: None,
                        }}}, key[0])
                    self._enqueue(key)
                except ApiError:
                    raise ApiError(
                        f"elastic re-queue un-park for "
                        f"{key[0]}/{key[1]} ({reason}) failed after "
                        "restart; retrying with backoff")
                return Admission("Preempted", reason=reason)
            if reason:
                return Admission("Preempted", reason=reason)
        return None

    # ---- serving workload class (kubeflow_tpu_torch/serving) --------------------------

    async def serving_admission(self, key: tuple, ms, *, namespace: str,
                                priority: int = 100, running: bool = False,
                                flex_pool: str | None = None,
                                ) -> Admission | None:
        """Arbitrate one serving replica's gang against the SAME ledger
        and policy queue as every notebook — one chip ledger, one fair
        order, one preemption path (a queued serving replica drains idle
        notebooks through the existing protocol; it is never a victim
        itself — Allocation.workload). Returns None while no fleet is
        known (transparent pass-through, like notebook admission);
        ``running=True`` re-seats a replica whose StatefulSet is already
        live (controller restart) instead of queueing it."""
        if not await self._ensure_fleet():
            return None
        key = tuple(key)
        self._serving_keys.add(key)
        now = self._now()
        await self._sweep_drains(now)
        await self._sweep_spot_reclaims(now)
        result = None
        with span("schedule", key=f"{key[0]}/{key[1]}", workload="serving"):
            if self.policy.is_admitted(key):
                self._state[key] = "Admitted"
                return Admission("Admitted")
            req = GangRequest(
                key=key, namespace=namespace or "",
                accelerator=ms.slice.accelerator.name,
                topology=ms.slice.topology_str,
                num_slices=ms.num_slices, chips=ms.num_chips,
                priority=priority,
                weight=float(self.options.weights.get(namespace, 1.0)),
                submitted_at=now, workload="serving")
            # ``flex_pool`` is the controller's durable borrow marker
            # (stamped per replica on the CR): a flex-placed replica
            # must re-seat as a BORROW across a restart — seating it
            # natively would resell the foreign host under its running
            # pods and flip their node selectors (same contract as the
            # notebook FLEX_POOL_ANNOTATION).
            if running and self.policy.reclaim(
                    req, now, borrow_first=bool(flex_pool),
                    prefer_pool=flex_pool):
                alloc = self.policy.ledger.allocations.get(key)
                if alloc is not None and (
                        alloc.forced
                        or set(alloc.placements)
                        & self.policy.ledger.unavailable):
                    # reclaim() never refuses — but a serving replica
                    # re-seated as overcommit, or back onto a revoked
                    # spot pool, must QUEUE instead: it restores from
                    # its checkpoint wherever capacity really exists,
                    # and pinning it to a dying pool would loop the
                    # spot sweep (release → force-re-admit → release)
                    # forever. Notebooks keep force-reclaim semantics —
                    # their pods hold un-checkpointed state.
                    self.policy.release(key)
                else:
                    self._state[key] = "Admitted"
                    self._refresh_gauges()
                    return Admission("Admitted")
            self.policy.submit(req)
            # Same debounce as notebook admission: identical queue state
            # within the interval serves the snapshot instead of paying
            # another O(queue) arbitration pass.
            if (self.policy.gen == self._last_pass_gen
                    and now - self._last_pass_at
                    < self.options.queued_requeue_seconds):
                queue = self.policy.schedule_preview(now)
            else:
                result = self._arbitrate(now)
                self._last_pass_gen = self.policy.gen
                self._last_pass_at = now
                queue = result.queue
        if result is not None:
            await self._apply(result, now)
        await self._elastic_post(now)
        if self.policy.is_admitted(key):
            return Admission("Admitted")
        info = next((q for q in queue if q.key == key), None)
        self._state[key] = "Queued"
        return Admission(
            "Queued",
            position=info.position if info else 0,
            reason=info.reason if info else "",
            waiting_chips=info.chips if info else ms.num_chips)

    async def serving_release(self, key: tuple) -> None:
        """Give a serving replica's chips back (scale-down, park-to-zero,
        or service deletion) and run the arbitration pass that hands
        them to whoever queues. No preemption verdict bookkeeping — a
        serving replica's lifecycle lives in its controller's status."""
        key = tuple(key)
        if not self.active:
            self._serving_keys.discard(key)
            return
        now = self._now()
        had_queue_entry = key in self.policy.pending
        alloc = self.policy.release(key)
        self._state.pop(key, None)
        if alloc is not None or had_queue_entry:
            with span("schedule", key=f"{key[0]}/{key[1]}", release=True,
                      workload="serving"):
                result = self._arbitrate(now)
                self._last_pass_gen = self.policy.gen
                self._last_pass_at = now
            await self._apply(result, now)
        await self._elastic_post(now)
        self._refresh_gauges()
        self._serving_keys.discard(key)

    # ---- warm pod pools (controllers/warmpool.py) ----------------------------------

    def on_warm_reclaimed(self, cb) -> None:
        """Register the warm-pool manager's teardown callback:
        ``await cb(slot_key)`` whenever a slot's reservation is
        cannibalized (arbitration preemption or spot reclaim)."""
        self._warm_cbs.append(cb)

    async def warm_reserve(self, key: tuple, *, namespace: str,
                           accelerator: str, topology: str) -> bool:
        """Book ONE warm slot's chips in the ledger as a low-priority
        reclaimable reservation. Never queues — pool replenishment is
        opportunistic: no free capacity means no warm pod (the pool
        rebuilds when pressure clears). Idempotent per key. Returns
        False when the slot cannot be backed right now; True also while
        no fleet is known (pass-through, like every admission)."""
        if not await self._ensure_fleet():
            return True
        key = tuple(key)
        if self.policy.is_admitted(key):
            self._warmpool_keys.add(key)
            return True
        try:
            shape = GpuSlice.parse(accelerator, topology)
        except TopologyError:
            return False
        plan = self.policy.ledger.fit(accelerator, topology, 1)
        if plan is None:
            return False
        self.policy.ledger.admit(Allocation(
            key=key, namespace=namespace or "",
            accelerator=accelerator, topology=topology,
            num_slices=1, chips=shape.num_chips, placements=plan,
            priority=WARM_POOL_PRIORITY, admitted_at=self._now(),
            # Epoch-old activity: among warm slots themselves, the
            # victim sort's idle ranking is moot (tier -1 already
            # outranks everything); this just keeps debug rows honest —
            # a warm slot is never "active".
            last_active_at=0.0,
            workload="warmpool",
        ))
        self.policy.gen += 1
        self._warmpool_keys.add(key)
        self._refresh_gauges()
        return True

    async def warm_release(self, key: tuple) -> None:
        """Give a warm slot's chips back (claim consumed the slot, spec
        shrink, pool teardown) and let waiters arbitrate for them."""
        key = tuple(key)
        self._warmpool_keys.discard(key)
        if not self.active:
            return
        if self.policy.release(key) is not None:
            now = self._now()
            with span("schedule", key=f"{key[0]}/{key[1]}", release=True,
                      workload="warmpool"):
                result = self._arbitrate(now)
                self._last_pass_gen = self.policy.gen
                self._last_pass_at = now
            await self._apply(result, now)
            self._refresh_gauges()

    async def _notify_warm_reclaimed(self, key: tuple) -> None:
        for cb in self._warm_cbs:
            try:
                await cb(key)
            except Exception:
                log.exception("warm-pool reclaim callback failed for %s",
                              key)

    # ---- decision application ---------------------------------------------------

    async def _apply(self, result, now: float,
                     requester: dict | None = None) -> None:
        req_key = ((namespace_of(requester), name_of(requester))
                   if requester is not None else None)
        for p in result.preempted:
            with span("preempt", victim=f"{p.key[0]}/{p.key[1]}",
                      reason=p.reason):
                await self._preempt(p, now)
        for p in getattr(result, "drains", ()):
            with span("drain", victim=f"{p.key[0]}/{p.key[1]}",
                      reason=p.reason):
                await self._request_drain(p, now)
        for a in result.admitted:
            with span("admit", key=f"{a.key[0]}/{a.key[1]}"):
                self.m_wait.observe(a.waited)
                # Time-to-admission SLI (runtime/slo.py): the same wait
                # the histogram records, scored against the objective.
                slo.observe("scheduler_time_to_admission", a.waited,
                            key=a.key, trace_id=current_trace_id())
                self._state[a.key] = "Admitted"
                self._requeue_credit.pop(a.key, None)
                self._reclaim_verdict.pop(a.key, None)
                # Serving replicas: no Notebook CR exists under this key
                # — skip the annotation/Event side effects; the enqueue
                # below routes to the serving controller, which owns its
                # own status surface.
                nb = (None if a.key in self._serving_keys
                      else requester if a.key == req_key
                      else await self._get_notebook(a.key))
                if nb is not None:
                    await self._stamp_admitted(nb, now)
                    hint = migration.restore_hint(annotations_of(nb))
                    if hint is not None:
                        # A parked-with-checkpoint gang coming back: the
                        # notebook controller stamps the hint into the
                        # pod env; announce the restore here so the
                        # lifecycle is auditable from Events alone.
                        with span("restore", key=f"{a.key[0]}/{a.key[1]}",
                                  step=hint[1]):
                            await self._event(
                                nb, "Normal", "Restoring",
                                f"Re-admitted; restoring from checkpoint "
                                f"{hint[0]}"
                                + (f" @ step {hint[1]}"
                                   if hint[1] is not None else ""))
                    await self._event(
                        nb, "Normal", "Admitted",
                        f"Admitted by the GPU fleet scheduler after "
                        f"{a.waited:.0f}s "
                        f"(slices: {_fmt_placements(a.placements)})")
                if a.key != req_key:
                    self._enqueue(a.key)
        self._refresh_gauges()

    async def _preempt(self, p, now: float) -> None:
        """Stop-annotate the victim: the notebook reconciler parks the
        whole gang (slice-atomic, replicas 0 everywhere) and its next
        reconcile releases the admission handle. Chips were already
        released in-ledger by the policy, so the beneficiary admits in
        this same pass. A failed stop patch is remembered and retried on
        the victim's next reconcile (``_retry_stop``) — the chips are
        gone from the ledger either way, so the victim MUST park or the
        fleet physically overcommits."""
        if p.key in self._warmpool_keys:
            # A cannibalized warm-pool reservation: no CR to stop and
            # nothing to checkpoint — the chips are already free; hand
            # the slot to the pool manager for (deferred) pod teardown.
            self._warmpool_keys.discard(p.key)
            self.m_preemptions.labels(reason=p.reason).inc()
            await self._notify_warm_reclaimed(p.key)
            return
        ns, name = p.key
        self._preempted[p.key] = p.reason
        self.m_preemptions.labels(reason=p.reason).inc()
        if not await self._stop_victim(p.key, p.reason, now):
            self._stop_pending[p.key] = p.reason
            log.warning("preemption stop patch failed for %s/%s; will "
                        "retry on its next reconcile", ns, name)
        else:
            nb = await self._get_notebook(p.key)
            if nb is not None:
                await self._event(
                    nb, "Warning", "Preempted",
                    f"Preempted ({p.reason}) to reclaim {p.chips} "
                    f"GPUs for {p.for_key[0]}/{p.for_key[1]}; restart "
                    "to re-queue")
        self._enqueue(p.key)

    # ---- preempt-to-checkpoint (kubeflow_tpu_torch/migration) ------------------------

    async def _request_drain(self, p, now: float, *,
                             requeue: bool = False,
                             annotation: str | None = None,
                             message: str | None = None) -> None:
        """Ask the victim to checkpoint instead of stopping it: stamp the
        drain annotations the in-pod SDK polls, start the grace clock,
        and keep its chips booked (policy marked the allocation draining)
        until :meth:`_finalize_drain` sees the ack or the deadline. The
        preemption verdict is recorded NOW so a victim the user stops
        mid-drain still reports why it parked.

        The elastic paths ride the SAME protocol — ``annotation`` is
        their drain-reason ("spot-reclaim"/"defrag" instead of
        "preempt:<reason>") and ``requeue`` makes the eventual park
        un-park and re-queue the victim instead of waiting for a user
        restart."""
        ns, name = p.key
        annotation = annotation or f"preempt:{p.reason}"
        self._preempted[p.key] = p.reason
        self._draining[p.key] = _Drain(
            reason=p.reason, for_key=p.for_key, chips=p.chips,
            requested_at=now,
            deadline=now + self.options.drain_grace_seconds,
            annotation=annotation, requeue=requeue)
        try:
            await self.kube.patch(
                "Notebook", name,
                {"metadata": {"annotations": migration.request_drain_patch(
                    annotation, now)}}, ns)
        except ApiError:
            # The sweep re-patches a victim whose CR lacks the request
            # mark; if the apiserver stays down past the grace deadline
            # the fallback hard-stop takes over.
            log.warning("drain request patch failed for %s/%s; will "
                        "retry on the next scheduler pass", ns, name)
        nb = await self._get_notebook(p.key)
        if nb is not None:
            await self._event(
                nb, "Warning", "DrainRequested",
                message or (
                    f"Checkpoint requested ({p.reason}) to reclaim "
                    f"{p.chips} GPUs for "
                    f"{p.for_key[0]}/{p.for_key[1]}; parking once the "
                    f"checkpoint commits (grace "
                    f"{self.options.drain_grace_seconds:.0f}s)"))
        self._enqueue(p.key)

    async def _drain_progress(self, key: tuple, nb: dict,
                              now: float) -> Admission:
        """The draining victim's own reconcile: ack → park with the
        checkpoint; deadline → today's hard stop; otherwise report
        Draining with a requeue that guarantees the deadline fires."""
        drain = self._draining[key]
        ann = annotations_of(nb)
        if migration.drain_requested_at(ann) is None:
            # The request patch never landed (or someone stripped it):
            # re-stamp with the ORIGINAL request time so the grace
            # deadline is unchanged.
            try:
                await self.kube.patch(
                    "Notebook", key[1],
                    {"metadata": {"annotations":
                                  migration.request_drain_patch(
                                      drain.annotation
                                      or f"preempt:{drain.reason}",
                                      drain.requested_at)}}, key[0])
            except ApiError as exc:
                log.debug("drain-request re-stamp for %s/%s failed "
                          "(grace fallback still fires): %s",
                          key[0], key[1], exc)
        elif migration.drain_acked(ann):
            return await self._finalize_drain(key, nb, checkpointed=True,
                                              now=now)
        if now >= drain.deadline:
            return await self._finalize_drain(key, nb, checkpointed=False,
                                              now=now)
        return Admission(
            "Draining", reason=drain.reason,
            requeue_after=max(0.1, drain.deadline - now + 0.05))

    async def _finalize_drain(self, key: tuple, nb: dict | None, *,
                              checkpointed: bool, now: float) -> Admission:
        """End one drain exactly once: count it, stop the victim (keeping
        the checkpoint marks — they are the restore hint), free its
        chips, and run the arbitration pass that admits the waiter."""
        drain = self._draining.pop(key, None)
        if drain is None:  # raced with release()/a concurrent finalize
            return Admission("Preempted",
                             reason=self._preempted.get(key, ""))
        self.m_preemptions.labels(reason=drain.reason).inc()
        if drain.reason == elastic.SPOT_RECLAIM_REASON:
            self.m_spot_reclaims.inc()
        if checkpointed:
            with span("checkpoint_ack", key=f"{key[0]}/{key[1]}",
                      waited=round(now - drain.requested_at, 3)):
                self.m_drain.observe(now - drain.requested_at)
            # Snapshot-then-ack (checkpoint fabric): the ack frees the
            # chips, but the durable upload may still be in flight —
            # watch for the commit mark until the commit grace expires,
            # at which point the park is marked dirty and the drain
            # counted as a fallback after all (satellite: an acked drain
            # whose upload never landed is NOT a clean drain).
            ann_now = annotations_of(nb) if nb is not None else {}
            if migration.checkpoint_committed(ann_now):
                slo.observe("checkpoint_commit", now - drain.requested_at,
                            key=key, trace_id=current_trace_id())
            else:
                self._commit_waits[key] = _CommitWait(
                    reason=drain.reason,
                    requested_at=drain.requested_at,
                    deadline=now + self.options.commit_grace_seconds)
        else:
            self.m_drain_fallback.inc()
        # Drain-roundtrip SLI: ack-less grace fallbacks count as bad
        # events at the full elapsed time — a fleet whose drains always
        # hard-stop is failing its migration promise even though chips
        # were never held hostage.
        slo.observe("drain_roundtrip", now - drain.requested_at,
                    key=key, trace_id=current_trace_id())
        park_stamp = None
        if drain.requeue:
            # Elastic park: once the victim's release path observes the
            # stop, un-park it so it re-queues with its aging credit —
            # the reclaim/defrag took its CAPACITY, not its place in
            # line. The park's stop stamp carries a unique nonce (no
            # consumer parses the value; presence is the contract) so
            # the un-park can tell OUR park from a user's own stop even
            # within the same fmt_iso second.
            self._park_seq = getattr(self, "_park_seq", 0) + 1
            park_stamp = f"{fmt_iso(now)}+park{self._park_seq}"
            alloc = self.policy.ledger.allocations.get(key)
            self._auto_resume[key] = (drain.reason, park_stamp)
            self._reclaim_verdict[key] = drain.reason
            self._requeue_credit[key] = (
                alloc.admitted_at if alloc is not None else now)
        if not await self._stop_victim(
                key, drain.reason, now, stop_value=park_stamp,
                extra=migration.clear_drain_patch(keep_reason=True)):
            # Same contract as an immediate preemption's failed stop:
            # chips are released below regardless, so the victim MUST
            # park — remember it and retry on its next reconcile.
            self._stop_pending[key] = drain.reason
        self.policy.release(key)
        self._state.pop(key, None)
        result = self._arbitrate(now)
        self._last_pass_gen = self.policy.gen
        self._last_pass_at = now
        await self._apply(result, now)
        if nb is not None:
            if checkpointed:
                step = migration.checkpoint_step(annotations_of(nb))
                await self._event(
                    nb, "Normal", "Checkpointed",
                    "Checkpoint committed"
                    + (f" @ step {step}" if step is not None else "")
                    + f"; parking ({drain.reason} preemption)")
            else:
                await self._event(
                    nb, "Warning", "DrainDeadlineExceeded",
                    f"No checkpoint ack within "
                    f"{self.options.drain_grace_seconds:.0f}s; stopped "
                    f"without a checkpoint ({drain.reason} preemption)")
        return Admission("Preempted", reason=drain.reason)

    async def _sweep_commits(self, now: float) -> None:
        """Advance every post-park commit watch: a commit mark closes it
        with a good ``checkpoint_commit`` SLI event; an expired commit
        grace marks the park commit-dirty, counts the drain as a
        fallback, and records the full elapsed time as a bad event.
        Runs with the drain sweep on every admission/release pass."""
        for key, wait in list(self._commit_waits.items()):
            nb = await self._get_notebook(key)
            if self._commit_waits.get(key) is not wait:
                continue  # resolved by a concurrent sweep in the await
            ann = annotations_of(nb) if nb is not None else {}
            if nb is not None and migration.checkpoint_committed(ann):
                # kftpu: ignore[await-race] re-validated after the await: the identity check above skips watches a concurrent sweep already resolved
                self._commit_waits.pop(key, None)
                with span("checkpoint_commit", key=f"{key[0]}/{key[1]}",
                          waited=round(now - wait.requested_at, 3)):
                    slo.observe("checkpoint_commit",
                                now - wait.requested_at,
                                key=key, trace_id=current_trace_id())
                continue
            if now < wait.deadline:
                continue
            self._commit_waits.pop(key, None)
            self.m_drain_fallback.inc()
            # A commit that never landed is a bad event by definition —
            # a short KFTPU_COMMIT_GRACE must not let the timeout slip
            # under the SLI objective and count as a fast commit.
            slo.observe("checkpoint_commit",
                        max(now - wait.requested_at,
                            slo.objective_for("checkpoint_commit")[0]
                            + 0.001),
                        key=key, trace_id=current_trace_id())
            if nb is None:
                continue
            try:
                await self.kube.patch(
                    "Notebook", key[1],
                    {"metadata": {"annotations":
                                  migration.mark_commit_dirty_patch(now)}},
                    key[0])
            except ApiError as exc:
                log.warning("commit-dirty patch for %s/%s failed: %s",
                            key[0], key[1], exc)
            await self._event(
                nb, "Warning", "CheckpointCommitTimeout",
                f"Checkpoint upload did not commit within "
                f"{self.options.commit_grace_seconds:.0f}s of the drain "
                f"request; parked checkpoint marked dirty "
                f"({wait.reason})")

    async def _sweep_drains(self, now: float, skip: tuple | None = None) \
            -> None:
        """Advance every in-flight drain that is not being handled inline
        by its own reconcile: finalize acks, fire expired deadlines, and
        re-patch victims whose request annotation never landed. Runs on
        every admission/release pass, so a waiter's safety-net requeue is
        enough to guarantee deadlines fire."""
        await self._sweep_commits(now)
        for key in list(self._draining):
            if key == skip or key not in self._draining:
                continue
            drain = self._draining[key]
            nb = await self._get_notebook(key)
            if nb is None:
                # CR gone mid-drain: nothing to stop; free the chips and
                # let the waiters arbitrate.
                # kftpu: ignore[await-race] re-validated after every await: the loop re-checks `key in self._draining` per iteration and every pop carries a default
                self._draining.pop(key, None)
                self._auto_resume.pop(key, None)
                if self.policy.release(key) is not None:
                    result = self._arbitrate(now)
                    self._last_pass_gen = self.policy.gen
                    self._last_pass_at = now
                    await self._apply(result, now)
                continue
            ann = annotations_of(nb)
            if nbapi.STOP_ANNOTATION in ann:
                continue  # its own release path owns the cleanup
            if migration.drain_acked(ann):
                await self._finalize_drain(key, nb, checkpointed=True,
                                           now=now)
            elif now >= drain.deadline:
                await self._finalize_drain(key, nb, checkpointed=False,
                                           now=now)
            elif migration.drain_requested_at(ann) is None:
                try:
                    await self.kube.patch(
                        "Notebook", key[1],
                        {"metadata": {"annotations":
                                      migration.request_drain_patch(
                                          drain.annotation
                                          or f"preempt:{drain.reason}",
                                          drain.requested_at)}}, key[0])
                except ApiError as exc:
                    log.debug("drain-request sweep re-stamp for %s/%s "
                              "failed (grace fallback still fires): %s",
                              key[0], key[1], exc)

    # ---- elastic fleet (kubeflow_tpu_torch/scheduler/elastic.py) ----------------------

    @property
    def elastic_active(self) -> bool:
        return self._intent_book is not None and self.active

    def _arbitrate(self, now: float):
        """One full arbitration pass: (elastic) flex overflow first —
        a waiter a free borrowed host can seat must not cost a running
        gang a preemption drain — then the native schedule, then a
        second overflow for gangs whose options the schedule pass just
        changed. Flex admissions ride the result's ``admitted`` list so
        every downstream side effect (stamp, events, re-enqueue) is
        identical to a native admission."""
        flex_pre = (elastic.overflow_pass(self.policy, now)
                    if self.elastic_active else [])
        result = self.policy.schedule(now)
        if flex_pre:
            result.admitted.extend(flex_pre)
        if self.elastic_active:
            flex = elastic.overflow_pass(self.policy, now)
            if flex:
                result.admitted.extend(flex)
        return result

    async def _elastic_post(self, now: float) -> None:
        """The elastic bookkeeping that follows an arbitration pass:
        sync scale-up intents against the queue's shortfalls (create /
        renew / withdraw, mirrored to ProvisioningRequest CRs) and run
        the interval-gated defrag planner. Cheap no-op with elastic off
        or no fleet."""
        if not self.elastic_active:
            return
        # Same debounce as the arbitration pass: shortfall computation
        # and idle-borrower scans are O(queue)/O(allocations) — a long
        # queue's safety-net requeues must not each pay them when
        # nothing changed. TTL renewals and the defrag interval still
        # tick through the one pass per interval this allows.
        if (self.policy.gen == self._last_elastic_gen
                and now - self._last_elastic_at
                < self.options.queued_requeue_seconds):
            return
        async with self._elastic_lock:
            # Re-check under the lock: the pass that held it ahead of us
            # may have just done this generation's work.
            if (self.policy.gen == self._last_elastic_gen
                    and now - self._last_elastic_at
                    < self.options.queued_requeue_seconds):
                return
            # kftpu: ignore[await-race] double-checked locking: the debounce pair is re-read under _elastic_lock right above before this write
            self._last_elastic_gen = self.policy.gen
            # kftpu: ignore[await-race] written with its pair under _elastic_lock after the re-check above
            self._last_elastic_at = now
            await self._sync_intents(now)
            await self._maybe_defrag(now)
            await self._evict_idle_borrowers(now)

    async def _evict_idle_borrowers(self, now: float) -> None:
        """Idle preemption at host granularity: a queued flexible gang
        with no free host to borrow drains the idlest borrower squatting
        on usable hosts (reason ``idle`` — the victim parks like any
        idle-preemption victim; no auto-requeue). One eviction per pass;
        requires migration (the drain path) — with it off, the idle
        culler remains the squatter remedy."""
        if not self.options.enable_preemption \
                or not self.options.enable_migration:
            return
        for req in self.policy._ordered_pending(now):
            victim = elastic.plan_idle_borrower_eviction(
                self.policy, req, now,
                idle_after=self.options.idle_preempt_after_seconds)
            if victim is None or victim.key in self._draining:
                continue
            victim.draining = True
            self.policy.gen += 1
            with span("drain", victim=f"{victim.key[0]}/{victim.key[1]}",
                      reason="idle", flex=True):
                await self._request_drain(
                    Preemption(key=victim.key, reason="idle",
                               for_key=req.key, chips=victim.chips),
                    now)
            return

    async def _sync_intents(self, now: float) -> None:
        book = self._intent_book
        shortfalls = elastic.compute_shortfalls(self.policy, now)
        events = book.sync(shortfalls, self.policy.fleet, now)
        ns = self.options.controller_namespace
        for intent in events.created:
            with span("scale_up", event="created", name=intent.name,
                      slices=intent.slices, chips=intent.chips):
                self.m_scale_up_events.labels(event="created").inc()
                log.info("scale-up intent %s: %d slice(s) / %d chips for "
                         "%s", intent.name, intent.slices, intent.chips,
                         [f"{k[0]}/{k[1]}" for k in intent.for_keys])
                try:
                    await self.kube.create(
                        "ProvisioningRequest",
                        intent.to_provisioning_request(ns), ns)
                except ApiError as exc:
                    # best-effort mirror; the book is the truth
                    log.debug("scale-up intent CR create %s failed: %s",
                              intent.name, exc)
                for key in intent.for_keys:
                    nb = await self._get_notebook(key)
                    if nb is not None:
                        await self._event(
                            nb, "Normal", "ScaleUpRequested",
                            f"No pool can host this gang even if fully "
                            f"drained; asked for {intent.slices} more "
                            f"{intent.accelerator}:{intent.topology} "
                            f"slice(s) ({intent.chips} chips) via "
                            f"ProvisioningRequest {intent.name}")
        for intent in events.renewed:
            with span("scale_up", event="renewed", name=intent.name,
                      renewals=intent.renewals):
                self.m_scale_up_events.labels(event="renewed").inc()
                log.warning(
                    "scale-up intent %s unanswered for %.0fs (renewal "
                    "#%d) — is the pool autoscaler watching?",
                    intent.name, intent.pending_seconds(now),
                    intent.renewals)
                if intent.denied:
                    # "Re-asserts on its TTL" is a promise: replace the
                    # Failed CR with a fresh ask and re-arm denial
                    # detection — otherwise the denial is terminal and
                    # the autoscaler never hears from us again.
                    intent.denied = False
                    try:
                        await self.kube.delete("ProvisioningRequest",
                                               intent.name, ns)
                    except (NotFound, ApiError) as exc:
                        log.debug("denied-intent CR delete %s failed "
                                  "(recreate below may 409): %s",
                                  intent.name, exc)
                    try:
                        await self.kube.create(
                            "ProvisioningRequest",
                            intent.to_provisioning_request(ns), ns)
                    except ApiError as exc:
                        log.debug("denied-intent CR recreate %s failed "
                                  "(re-asserted on the next TTL): %s",
                                  intent.name, exc)
        for intent in events.updated:
            # Keep the CR mirror honest about the current ask size.
            try:
                await self.kube.patch(
                    "ProvisioningRequest", intent.name,
                    {"spec": intent.to_provisioning_request(ns)["spec"]},
                    ns)
            except (NotFound, ApiError) as exc:
                # denial probe / TTL renewal recreate it
                log.debug("scale-up intent CR resize %s failed: %s",
                          intent.name, exc)
        for intent, reason in events.withdrawn:
            with span("scale_up", event=reason, name=intent.name):
                self.m_scale_up_events.labels(event=reason).inc()
                try:
                    await self.kube.delete("ProvisioningRequest",
                                           intent.name, ns)
                except (NotFound, ApiError) as exc:
                    log.debug("withdrawn-intent CR delete %s failed "
                              "(janitor sweeps strays): %s",
                              intent.name, exc)
        if book.intents:
            await self._probe_intent_denials(now)
        elif now >= getattr(self, "_intent_gc_next", 0.0):
            # Stray-intent janitor: the book is in-memory, so a restart
            # can orphan pool-scale-up CRs whose demand died with the
            # old process. With no live intents, sweep ours away
            # (throttled — this is a LIST).
            self._intent_gc_next = now + max(
                5.0, self.options.fleet_refresh_seconds)
            try:
                prs = await self.kube.list("ProvisioningRequest", ns)
            except ApiError:
                prs = []
            for pr in prs:
                labels = ((pr.get("metadata") or {}).get("labels")) or {}
                # OUR intents only — a notebook named pool-scale-up-*
                # has a capacity PR with a matching prefix but no
                # scale-up label; it must not be janitored.
                if keys.TPU_SCALE_UP_ACCELERATOR not in labels:
                    continue
                try:
                    await self.kube.delete("ProvisioningRequest",
                                           name_of(pr), ns)
                except (NotFound, ApiError) as exc:
                    log.debug("stray-intent janitor delete %s failed "
                              "(retried next sweep): %s",
                              name_of(pr), exc)
        self.m_scale_up.set(len(book.intents))

    async def _probe_intent_denials(self, now: float) -> None:
        """Surface a denial: the autoscaler (or an operator) stamped
        Failed=True on an intent's ProvisioningRequest. The intent stays
        in the book — the demand is real — but is marked, evented once,
        and re-asserted on its TTL. Throttled with the fleet refresh so
        pending intents don't add a GET per reconcile."""
        if now < getattr(self, "_denial_next_probe", 0.0):
            return
        self._denial_next_probe = now + max(
            1.0, min(self.options.fleet_refresh_seconds, 5.0))
        ns = self.options.controller_namespace
        for intent in list(self._intent_book.intents.values()):
            if intent.denied:
                continue
            try:
                pr = await self.kube.get_or_none(
                    "ProvisioningRequest", intent.name, ns)
            except ApiError as exc:
                log.debug("denial probe for intent %s failed (retried "
                          "on the next probe throttle): %s",
                          intent.name, exc)
                continue
            conditions = deep_get(pr or {}, "status", "conditions",
                                  default=[]) or []
            failed = next((c for c in conditions
                           if c.get("type") == "Failed"
                           and c.get("status") == "True"), None)
            if failed is None:
                continue
            intent.denied = True
            self.m_scale_up_events.labels(event="denied").inc()
            log.warning("scale-up intent %s denied: %s %s", intent.name,
                        failed.get("reason", ""),
                        failed.get("message", ""))
            for key in intent.for_keys:
                nb = await self._get_notebook(key)
                if nb is not None:
                    await self._event(
                        nb, "Warning", "ScaleUpDenied",
                        f"Pool scale-up {intent.name} was denied "
                        f"({failed.get('reason', '')}); the gang keeps "
                        "waiting and the ask re-asserts on its TTL")

    def flex_node_selectors(self, key: tuple) -> dict | None:
        """Node selectors for a flex (borrowed-node) gang: the lender
        pool's GPU node type (``cloud.google.com/gke-accelerator``) and
        its nodepool, not the gang's own shape — its own shape has no
        schedulable nodes (that is why it borrowed), so pods pinned to
        another pool would sit Pending while the ledger books the
        borrow. The card request stays the gang's own (a share of one
        node: its cards ≤ the lender's cards a node — the flex_plan
        admission precondition). None for native placements, so the
        common path is untouched."""
        alloc = self.policy.ledger.allocations.get(tuple(key))
        if alloc is None or not alloc.borrowed:
            return None
        pool = self.policy.fleet.by_name(next(iter(alloc.borrow)))
        if pool is None:
            return None
        # The node type alone is ambiguous across same-type pools (the
        # pods could land on a spot pool the ledger didn't book) — pin
        # the exact pool with the nodepool label. Operators name fleet
        # pools after their nodepools; `Fleet.from_nodes` keeps the
        # label value except for shape-disambiguated mixed pools.
        from kubeflow_tpu_torch.scheduler.fleet import GKE_NODEPOOL_LABEL

        return {**pool.slice_shape.node_selectors(),
                GKE_NODEPOOL_LABEL: pool.name}

    def note_node_event(self, node: dict) -> None:
        """Node-informer hook (sync): a reclaim taint on a spot pool's
        node starts that pool's reclaim; the taint clearing withdraws
        that node's signal. Non-spot pools ignore the signal — their
        teardown path is maintenance (the notebook controller's taint
        mirror), not capacity revocation."""
        if self._intent_book is None:
            return
        pool = elastic.pool_of_node(self.policy.fleet, node)
        if pool is None or not pool.spot:
            return
        signal = elastic.node_reclaim_signal(node)
        if signal is not None:
            self.note_spot_reclaim(pool.name, node=name_of(node),
                                   signal=signal)
        else:
            self._clear_node_signal(pool.name, name_of(node))

    def note_node_gone(self, node: dict) -> None:
        """A signaling node was deleted: its revocation is complete.
        The pool re-opens once every signaling node is gone AND the
        residents drained — with a dynamic fleet source the pool itself
        shrinks shortly after."""
        if self._intent_book is None:
            return
        pool = elastic.pool_of_node(self.policy.fleet, node)
        if pool is not None:
            self._clear_node_signal(pool.name, name_of(node))

    def _clear_node_signal(self, pool_name: str, node_name: str) -> None:
        episode = self._spot_reclaims.get(pool_name)
        if episode is None or node_name not in episode["nodes"]:
            return
        episode["nodes"].discard(node_name)
        if not episode["nodes"]:
            log.info("spot pool %s: revocation signal cleared", pool_name)

    def note_spot_reclaim(self, pool_name: str, *, node: str = "manual",
                          signal: str = "reclaim") -> None:
        """Begin (or extend) one spot pool's reclaim — idempotent per
        signaling node. While in progress the pool is UNAVAILABLE (the
        ledger sells none of its capacity, so drained gangs cannot
        bounce straight back onto dying nodes). The actual drains start
        on the next scheduler pass (:meth:`_sweep_spot_reclaims`); every
        resident gang is enqueued so those passes happen now, not at the
        next periodic requeue."""
        pool = self.policy.fleet.by_name(pool_name)
        if pool is None or not pool.spot:
            log.info("ignoring reclaim signal for non-spot pool %r",
                     pool_name)
            return
        episode = self._spot_reclaims.get(pool_name)
        if episode is None:
            episode = {"since": self._now(), "nodes": set()}
            self._spot_reclaims[pool_name] = episode
            self.policy.ledger.unavailable.add(pool_name)
            self.policy.gen += 1
            log.warning("spot pool %s: revocation signal (%s); draining "
                        "resident gangs through checkpoint", pool_name,
                        signal)
        episode["nodes"].add(node)
        for alloc in elastic.reclaimable(self.policy.ledger, pool_name):
            self._enqueue(alloc.key)

    async def _sweep_spot_reclaims(self, now: float) -> None:
        """Start a checkpoint drain for every gang still holding revoked
        spot capacity. Routed through :meth:`_request_drain` — NEVER a
        bare stop — so a revocation is a migration: checkpoint → park →
        re-queue at original priority with aging credit; the drain-grace
        hard stop remains the fallback for ack-less victims."""
        if not self._spot_reclaims:
            return
        for pool_name in list(self._spot_reclaims):
            # Re-validate after the drains awaited below: a concurrent
            # sweep (admission and serving_admission both run this) can
            # finish an episode and pop it while this task is awaiting a
            # drain request — the stale snapshot key would KeyError and
            # fail the whole reconcile into backoff.
            episode = self._spot_reclaims.get(pool_name)
            if episode is None:
                continue
            victims = elastic.reclaimable(self.policy.ledger, pool_name)
            drains_out = not any(d.for_key == ("pool", pool_name)
                                 for d in self._draining.values())
            if self.policy.fleet.by_name(pool_name) is None or (
                    not victims and drains_out
                    and not episode["nodes"]):
                # Episode over: the pool left the fleet, or the
                # revocation signal cleared with every resident drained.
                # Re-open what remains of the pool.
                # kftpu: ignore[await-race] re-validated after every await: the loop re-reads the episode via .get() per iteration (regression test test_concurrent_spot_sweep_survives_episode_removal) and the pop carries a default
                self._spot_reclaims.pop(pool_name, None)
                if pool_name in self.policy.ledger.unavailable:
                    self.policy.ledger.unavailable.discard(pool_name)
                    self.policy.gen += 1
                continue
            if not victims:
                continue  # drained; waiting for the signal to clear
            for alloc in victims:
                if alloc.key in self._draining:
                    continue
                if alloc.workload == "warmpool" \
                        or alloc.key in self._warmpool_keys:
                    # Warm slots on revoked spot capacity: release the
                    # reservation and tear the pod down — a warm pod
                    # must not sit on a dying node, and it holds no
                    # state worth the drain protocol.
                    with span("reclaim", pool=pool_name,
                              victim=f"{alloc.key[0]}/{alloc.key[1]}",
                              workload="warmpool"):
                        self.policy.release(alloc.key)
                        # kftpu: ignore[await-race] discard is idempotent and membership is re-derived per victim from the fresh ledger snapshot
                        self._warmpool_keys.discard(alloc.key)
                        await self._notify_warm_reclaimed(alloc.key)
                    continue
                if alloc.key in self._serving_keys \
                        or isvcapi.parse_replica_key(alloc.key) is not None:
                    # InferenceService REPLICAS (their key carries the
                    # impossible-CR-name "#r" marker, so this never
                    # matches a real Notebook) don't speak the notebook
                    # drain protocol — their durable state is the parked
                    # checkpoint the engine keeps, so a revocation just
                    # releases the booking; the serving controller's
                    # next pass re-admits the replica off the revoked
                    # pool (the ledger already marks it unavailable).
                    # A serving-class NOTEBOOK (workload="serving" but a
                    # real CR) deliberately falls through to the normal
                    # checkpoint drain below — it has state to save and
                    # a CR that speaks the protocol.
                    with span("reclaim", pool=pool_name,
                              victim=f"{alloc.key[0]}/{alloc.key[1]}",
                              workload="serving"):
                        self.m_spot_reclaims.inc()
                        self.policy.release(alloc.key)
                        self._state.pop(alloc.key, None)
                        self._enqueue(alloc.key)
                    continue
                # Chips stay booked while the victim checkpoints, but
                # marked draining: the victim search credits them as
                # incoming-free and never double-picks the gang.
                alloc.draining = True
                self.policy.gen += 1
                with span("reclaim", pool=pool_name,
                          victim=f"{alloc.key[0]}/{alloc.key[1]}"):
                    await self._request_drain(
                        Preemption(key=alloc.key,
                                   reason=elastic.SPOT_RECLAIM_REASON,
                                   for_key=("pool", pool_name),
                                   chips=alloc.chips),
                        now, requeue=True,
                        annotation=elastic.SPOT_RECLAIM_REASON,
                        message=(
                            f"Spot capacity on pool {pool_name} is being "
                            f"revoked; checkpointing now — the gang "
                            f"re-queues at its original priority (grace "
                            f"{self.options.drain_grace_seconds:.0f}s)"))

    async def _maybe_defrag(self, now: float) -> None:
        """Interval-gated defrag pass: migrate idle borrowers off
        pack-breaking pools so a waiting native gang's slices come
        free. Disabled by ``KFTPU_DEFRAG=off``; rate-limited by the
        interval and the per-pass move cap."""
        cfg = self._elastic_cfg
        if not cfg.enable_defrag:
            return
        if now - self._last_defrag_at < cfg.defrag_interval_seconds:
            return
        self._last_defrag_at = now
        moves = elastic.plan_defrag(self.policy, cfg, now)
        for move in moves:
            if move.key in self._draining:
                continue
            alloc = self.policy.ledger.allocations.get(move.key)
            if alloc is None:
                continue
            alloc.draining = True
            self.policy.gen += 1
            with span("defrag", victim=f"{move.key[0]}/{move.key[1]}",
                      source=move.source_pool,
                      waiter=f"{move.for_key[0]}/{move.for_key[1]}"):
                self.m_defrag.inc()
                self._defrag_moves += 1
                await self._request_drain(
                    Preemption(key=move.key,
                               reason=elastic.DEFRAG_REASON,
                               for_key=move.for_key, chips=move.chips),
                    now, requeue=True,
                    annotation=elastic.DEFRAG_REASON,
                    message=(
                        f"Migrating to a pack pool: this notebook's "
                        f"borrowed host on {move.source_pool} blocks a "
                        f"whole slice "
                        f"{move.for_key[0]}/{move.for_key[1]} is waiting "
                        f"for; checkpointing, then re-queueing onto a "
                        f"pool of its own shape"))

    async def _stop_victim(self, key: tuple, reason: str, now: float,
                           extra: dict | None = None,
                           stop_value: str | None = None) -> bool:
        annotations = {
            nbapi.STOP_ANNOTATION: stop_value or fmt_iso(now),
            nbapi.PREEMPTED_ANNOTATION: reason,
        }
        if extra:
            annotations.update(extra)
        try:
            await self.kube.patch(
                "Notebook", key[1],
                {"metadata": {"annotations": annotations}}, key[0])
            return True
        except ApiError:
            return False

    async def _retry_stop(self, key: tuple, now: float) -> Admission:
        reason = self._stop_pending[key]
        # A retried elastic park re-stamps the SAME recorded nonce, so
        # the un-park's user-stop guard still recognizes it as ours.
        recorded = self._auto_resume.get(key)
        if not await self._stop_victim(
                key, reason, now,
                stop_value=recorded[1] if recorded else None,
                extra=migration.clear_drain_patch(keep_reason=True)):
            # Keep failing the reconcile until the patch lands: the
            # workqueue's error backoff is the retry loop. Returning
            # normally here would end retries after this attempt — the
            # manager is event-driven, so an un-parked victim would run
            # forever on chips the ledger already gave away.
            raise ApiError(
                f"preemption stop patch for {key[0]}/{key[1]} failed; "
                "retrying with backoff")
        # kftpu: ignore[await-race] _retry_stop runs only from this key's own reconcile (per-key workqueue serialization); the pop races no one
        self._stop_pending.pop(key, None)
        return Admission("Preempted", reason=reason)

    async def _stamp_admitted(self, nb: dict, now: float) -> None:
        """Persist the admitted-at timestamp: culling clocks idleness from
        it (a gang that queued for hours must not be culled seconds after
        it finally starts), and a controller restart re-reads it. Drain
        marks — including the park's drain-reason marker — clear here:
        an admitted gang is past its park, and a leftover reason would
        make a later plain stop present as a checkpointed park."""
        key = (namespace_of(nb), name_of(nb))
        alloc = self.policy.ledger.allocations.get(key)
        flex_pool = (next(iter(alloc.borrow))
                     if alloc is not None and alloc.borrowed else None)
        try:
            await self.kube.patch(
                "Notebook", name_of(nb),
                {"metadata": {"annotations": {
                    nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION: fmt_iso(now),
                    nbapi.PREEMPTED_ANNOTATION: None,
                    # Durable borrow marker: a restart must re-seat a
                    # flex gang as a BORROW, not natively.
                    nbapi.FLEX_POOL_ANNOTATION: flex_pool,
                    **migration.clear_drain_patch(),
                }}}, namespace_of(nb))
        except ApiError as exc:
            # best-effort; the in-memory admitted_at still ranks, and
            # the holder's next reconcile self-heals the stamp
            log.debug("admitted-at stamp for %s failed: %s", key, exc)

    async def _get_notebook(self, key: tuple) -> dict | None:
        ns, name = key
        if self._nb_informer is not None:
            nb = self._nb_informer.get(name, ns)
            if nb is not None:
                return nb
        try:
            return await self.kube.get_or_none("Notebook", name, ns)
        except ApiError:
            return None

    async def _event(self, nb: dict, type_: str, reason: str,
                     message: str) -> None:
        try:
            await self.recorder.event(nb, type_, reason, message)
        except Exception:
            # Events are best-effort BY CONTRACT; the recorder only
            # counts API-level swallows, so count this one ourselves.
            self.recorder.count_drop()

    def _refresh_gauges(self) -> None:
        self.m_queue_depth.set(len(self.policy.pending))
        self.m_draining.set(len(self._draining))
        ns_chips = self.policy.ledger.ns_chips
        for ns in self._gauge_ns - set(ns_chips):
            self.m_admitted_ns.labels(namespace=ns or "").set(0)
        for ns, chips in ns_chips.items():
            self.m_admitted_ns.labels(namespace=ns or "").set(chips)
        self._gauge_ns = set(ns_chips)
        by_pool = self.policy.ledger.admitted_chips_by_pool()
        for pool in self._gauge_pools - set(by_pool):
            self.m_admitted_pool.labels(pool=pool).set(0)
        for pool, chips in by_pool.items():
            self.m_admitted_pool.labels(pool=pool).set(chips)
        self._gauge_pools = set(by_pool)
        borrowed = self.policy.ledger.borrowed
        for pool in self._gauge_borrow_pools - set(borrowed):
            self.m_borrowed.labels(pool=pool).set(0)
        for pool, hosts in borrowed.items():
            self.m_borrowed.labels(pool=pool).set(hosts)
        self._gauge_borrow_pools = set(borrowed)

    def note_telemetry(self, key: tuple, family: str, mfu) -> None:
        """Feed the efficiency ledger one telemetry window (the notebook
        controller dedups on the annotation's publish seq before calling
        this). Shape is derived from the gang's own allocation
        (accelerator:topology) so the family prior keys match the shapes
        explain/queue reports; keys the ledger doesn't hold are ignored
        — telemetry from a gang mid-release carries no signal."""
        key = tuple(key)
        alloc = self.policy.ledger.allocations.get(key)
        if alloc is None:
            return
        shape = f"{alloc.accelerator}:{alloc.topology}"
        self.policy.note_efficiency(key, family, shape, mfu)

    # ---- introspection ----------------------------------------------------------

    def debug_info(self) -> dict:
        now = self._now()
        info = self.policy.debug_info(now)
        info["active"] = self.active
        info["arbiter"] = self.arbiter
        info["fleet_source"] = (
            "explicit" if self.options.fleet_spec
            and self.options.fleet_spec != "auto"
            else ("nodes" if self.options.fleet_spec == "auto"
                  else ("configmap" if self.options.fleet_configmap
                        else "none")))
        info["preempted"] = {
            f"{k[0]}/{k[1]}": reason for k, reason in self._preempted.items()
        }
        info["migration_enabled"] = self.options.enable_migration
        info["elastic"] = {
            "enabled": self._intent_book is not None,
            "defrag_enabled": (self._intent_book is not None
                               and self._elastic_cfg.enable_defrag),
            "scale_up_intents": (
                self._intent_book.debug_rows(now)
                if self._intent_book is not None else []),
            "spot_reclaims_in_progress": {
                pool: {
                    "for_sec": round(now - episode["since"], 3),
                    "signaling_nodes": sorted(episode["nodes"]),
                }
                for pool, episode in sorted(self._spot_reclaims.items())
            },
            "defrag_moves_total": self._defrag_moves,
            "requeued": {
                f"{k[0]}/{k[1]}": reason
                for k, reason in sorted(self._reclaim_verdict.items())
            },
        }
        info["draining"] = {
            f"{k[0]}/{k[1]}": {
                "reason": d.reason,
                "for": f"{d.for_key[0]}/{d.for_key[1]}",
                "chips": d.chips,
                "deadline_in_sec": round(d.deadline - now, 3),
            }
            for k, d in self._draining.items()
        }
        return info

    def explain(self, key: tuple) -> dict:
        """Scheduler explainability (/debug/scheduler/explain): the pure
        policy explanation (queue position, rank breakdown, blocking
        shape, feasible-if-drained candidates, starvation-door state)
        plus the runtime-only context — the in-flight drain, the pending
        scale-up intent's age, the elastic re-queue verdict, and any
        failed-stop retry. Read-only."""
        key = tuple(key)
        now = self._now()
        if not self.active:
            return {"state": "Inactive",
                    "reason": "no fleet configured — every admission "
                              "passes through"}
        out = self.policy.explain(key, now)
        out["key"] = f"{key[0]}/{key[1]}"
        drain = self._draining.get(key)
        if drain is not None:
            out["drain"] = {
                "reason": drain.reason,
                "for": f"{drain.for_key[0]}/{drain.for_key[1]}",
                "requested_at": drain.requested_at,
                "deadline_in_sec": round(drain.deadline - now, 3),
                "auto_requeue": drain.requeue,
            }
        if key in self._stop_pending:
            out["stop_pending"] = self._stop_pending[key]
        if key in self._preempted:
            out["preempted_reason"] = self._preempted[key]
        if key in self._reclaim_verdict:
            out["reclaimed"] = self._reclaim_verdict[key]
        if key in self._requeue_credit:
            out["requeue_credit_seconds"] = round(
                now - self._requeue_credit[key], 3)
        if self._intent_book is not None and out.get("blocking_shape"):
            acc, _, topo = out["blocking_shape"].partition(":")
            intent = self._intent_book.for_shape(acc, topo)
            if intent is not None:
                out["scale_up_intent"] = {
                    "name": intent.name,
                    "chips": intent.chips,
                    "slices": intent.slices,
                    "pending_seconds": round(
                        intent.pending_seconds(now), 3),
                    "renewals": intent.renewals,
                    "denied": intent.denied,
                    "for_this_gang": key in intent.for_keys,
                }
        return out


def _fmt_placements(placements: dict) -> str:
    return ", ".join(f"{pool}x{n}" for pool, n in sorted(placements.items()))
