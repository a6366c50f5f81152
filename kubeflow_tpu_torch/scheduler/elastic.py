"""Elastic fleet policy: scale-up intents, flex placement, spot reclaim
and slice defragmentation (pure core).

The base scheduler arbitrates a *static* fleet: when the queue holds
gangs that fit no pool it can only age them. This module closes the
loop the ROADMAP calls out, as pure functions over the existing
:class:`~kubeflow_tpu_torch.scheduler.policy.PolicyQueue` /
:class:`~kubeflow_tpu_torch.scheduler.fleet.ChipLedger` state so tier-1 can
drive every decision without an event loop:

- **Scale-up intents** (:func:`compute_shortfalls` + :class:`IntentBook`)
  — gangs that fit no pool *even if the fleet fully drained* produce one
  ProvisioningRequest-shaped intent per slice shape (deduped, TTL'd,
  withdrawn when the need evaporates). The runtime materialises each as
  a ``ProvisioningRequest`` CR in the controller namespace — the same
  GKE queued-provisioning idiom the notebook capacity gate already
  speaks, aimed at the pool autoscaler instead of one workload. The
  moment the fleet source (ConfigMap / node inference) reflects granted
  capacity, the normal dynamic-fleet rebind admits the waiters.
- **Flex placement** (:func:`flex_plan` / :func:`overflow_pass`) — a
  single-node gang whose own shape has no (free) pool may *borrow* one
  node from a same-accelerator pool whose nodes hold at least its cards.
  A borrow takes the whole node. Borrowed nodes break whole native
  slices (``ChipLedger.broken_slices``): that is the fragmentation of
  the classic wedge — two 1x8 notebooks squatting on a 2x8 pool hold a
  16-card gang hostage.
- **Defragmentation** (:func:`plan_defrag`) — a periodic pass that finds
  *idle* borrowers straddling pack-breaking pools and migrates them
  (drain → checkpoint → park → re-queue onto a pack pool of their own
  shape) so whole multislice shapes come free. Rate-limited, and only
  ever plans moves whose migrant has a guaranteed native (pack) slice
  to land on. ``KFTPU_DEFRAG=off`` disables it.
- **Spot reclaim** (:func:`node_reclaim_signal` / :func:`reclaimable`) —
  pools marked ``spot`` get a reclaim-aware ledger entry: a revocation
  signal on their nodes routes every resident gang through the migration
  drain protocol (checkpoint → release → re-queue at original priority
  with aging credit preserved) instead of letting the node teardown
  kill work in flight; the drain-grace hard stop remains the fallback
  so chips are never held hostage.

Everything here is a function of (queue state, ledger state, ``now``) —
no Kubernetes imports, no clock reads. The async side (annotation
patches, Events, metrics, the ProvisioningRequest CRs) lives in
:mod:`kubeflow_tpu_torch.scheduler.runtime`.

Kill switches: ``KFTPU_ELASTIC=off`` disables the whole subsystem (the
scheduler then behaves exactly as the pre-elastic one did, proven byte-for-
byte by tier-1); ``KFTPU_DEFRAG=off`` disables only the defragmenter.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.objects import deep_get
from kubeflow_tpu_torch.scheduler.fleet import (
    GKE_NODEPOOL_LABEL,
    Allocation,
    Fleet,
    NodePool,
)
from kubeflow_tpu_torch.scheduler.policy import Admitted, GangRequest, PolicyQueue
from kubeflow_tpu_torch.gpu.topology import GpuSlice

# Drain reasons the elastic runtime stamps (migration protocol contract:
# the finalizer only acts on its own reasons — these are the scheduler's,
# next to its "preempt:*" family).
SPOT_RECLAIM_REASON = "spot-reclaim"
DEFRAG_REASON = "defrag"

# Node taints that mean "this capacity is being revoked". GKE graceful
# node termination stamps impending-node-termination ahead of both
# maintenance and spot/preemptible reclaim; the dedicated spot key is
# accepted for operators (and tests) that signal reclaim explicitly.
RECLAIM_TAINTS = (
    "cloud.google.com/gke-spot-termination",
    "cloud.google.com/impending-node-termination",
)

DEFAULT_SCALE_UP_TTL_SECONDS = 300.0
DEFAULT_DEFRAG_INTERVAL_SECONDS = 30.0
DEFAULT_DEFRAG_IDLE_SECONDS = 600.0
DEFAULT_DEFRAG_MAX_MOVES = 2

# Kill switches (docs/operations.md "Elastic fleet"):
ELASTIC_ENV = "KFTPU_ELASTIC"
DEFRAG_ENV = "KFTPU_DEFRAG"


def elastic_enabled(environ=os.environ) -> bool:
    """``KFTPU_ELASTIC`` master switch — anything but off/false/0/no
    leaves the elastic subsystem on. Off restores the pre-elastic scheduler
    behavior byte-for-byte (no borrows, no intents, no defrag, spot
    pools inert)."""
    return environ.get(ELASTIC_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


def defrag_enabled(environ=os.environ) -> bool:
    """``KFTPU_DEFRAG`` — defragmenter-only kill switch layered under
    the master one."""
    return environ.get(DEFRAG_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


@dataclass(frozen=True)
class ElasticConfig:
    """Pure-policy knobs (env contract in cmd/envconfig.py)."""

    scale_up_ttl_seconds: float = DEFAULT_SCALE_UP_TTL_SECONDS
    enable_defrag: bool = True
    defrag_interval_seconds: float = DEFAULT_DEFRAG_INTERVAL_SECONDS
    # A borrower must look idle this long (culling's last-activity
    # signal, floored at admission like the victim search) before the
    # defragmenter will migrate it — moving a busy notebook to satisfy a
    # waiter is preemption's job, with its own priority rules.
    defrag_idle_seconds: float = DEFAULT_DEFRAG_IDLE_SECONDS
    # Rate limit: at most this many migrations per defrag pass.
    defrag_max_moves: int = DEFAULT_DEFRAG_MAX_MOVES


# ---- flex (host-borrowing) placement -------------------------------------------


def _flexible(req: GangRequest) -> GpuSlice | None:
    """A gang is flex-placeable when it is one single-node slice — the
    unit a foreign pool can host without splitting a slice's
    ``torch.distributed`` world across pools. Returns the parsed slice,
    or None."""
    if req.num_slices != 1:
        return None
    try:
        shape = GpuSlice.parse(req.accelerator, req.topology)
    except Exception:
        return None
    return shape if shape.num_hosts == 1 else None


def flex_capable(fleet: Fleet, slice_shape: GpuSlice,
                 num_slices: int = 1) -> bool:
    """Could this gang EVER be flex-placed on this fleet (ignoring
    current occupancy)? The one capability predicate the shortfall
    computation and the webhook fast-fail share — a drifted copy would
    make admission reject gangs the scheduler could seat, or vice
    versa. Placement itself (occupancy-aware) is
    :meth:`~kubeflow_tpu_torch.scheduler.fleet.ChipLedger.borrow_fit`."""
    if num_slices != 1 or slice_shape.num_hosts != 1:
        return False
    acc = slice_shape.accelerator.name.lower()
    return any(
        p.accelerator.lower() == acc
        and p.chips_per_host >= slice_shape.chips_per_host
        for p in fleet.pools
    )


def flex_plan(ledger, req: GangRequest,
              *, protected_shapes: frozenset = frozenset()) -> dict | None:
    """Borrow plan (``{pool: 1}``) for a single-host gang that fits no
    pool of its own shape, or None. Pools whose native shape is in
    ``protected_shapes`` (a same-shape gang is waiting for native
    slices) accept no *new* breakage — flex must not manufacture the
    very fragmentation defrag exists to undo while a native waiter is
    queued. Placement preference lives in
    :meth:`~kubeflow_tpu_torch.scheduler.fleet.ChipLedger.borrow_fit`, which
    the restart/rebind re-seat path shares."""
    if _flexible(req) is None:
        return None
    return ledger.borrow_fit(req.accelerator, req.topology,
                             avoid_new_break_shapes=protected_shapes)


def overflow_pass(policy: PolicyQueue, now: float) -> list:
    """Seat queued flexible gangs on borrowed hosts. Gangs a native fit
    can place right now are skipped — native placement (and the fair
    ordering of :meth:`PolicyQueue.schedule`) always wins; the runtime
    runs this BEFORE the schedule pass too, so a free borrowable host is
    used ahead of planning a needless preemption drain for the same
    waiter. Returns the
    :class:`~kubeflow_tpu_torch.scheduler.policy.Admitted` records; the
    runtime applies the same side effects as native admissions. Shapes
    with a pending native waiter are protected from new breakage."""
    protected = frozenset(
        (r.accelerator.lower(), r.topology.lower())
        for r in policy.pending.values()
    )
    admitted: list[Admitted] = []
    for req in list(policy._ordered_pending(now)):
        if policy.ledger.fit(req.accelerator, req.topology,
                             req.num_slices) is not None:
            continue  # the native schedule pass will seat it
        plan = flex_plan(policy.ledger, req, protected_shapes=protected)
        if plan is None:
            continue
        policy.ledger.admit(Allocation(
            key=req.key, namespace=req.namespace,
            accelerator=req.accelerator, topology=req.topology,
            num_slices=req.num_slices, chips=req.chips,
            placements={}, borrow=dict(plan), priority=req.priority,
            admitted_at=now, workload=req.workload,
        ))
        del policy.pending[req.key]
        policy.gen += 1
        admitted.append(Admitted(
            key=req.key, placements=dict(plan),
            waited=max(0.0, now - req.submitted_at)))
    return admitted


# ---- scale-up intents ----------------------------------------------------------


@dataclass
class Shortfall:
    """One shape's unsatisfiable demand: no pool could host the gang(s)
    even with the whole fleet drained."""

    accelerator: str
    topology: str
    slices: int            # pool slices that must be ADDED
    chips: int
    keys: tuple            # the starved gangs, sorted


@dataclass
class ScaleUpIntent:
    """One pending pool-scale-up ask, ProvisioningRequest-shaped. Lives
    in the :class:`IntentBook` keyed by shape; the runtime mirrors it to
    a ProvisioningRequest CR named :attr:`name` so cluster tooling (and
    the chaos harness's grant/deny actions) can see and answer it."""

    accelerator: str
    topology: str
    slices: int
    chips: int
    for_keys: tuple
    created_at: float
    expires_at: float
    ceiling_at_creation: int = 0   # fleet slices of this shape back then
    renewals: int = 0
    denied: bool = False

    @property
    def shape(self) -> tuple[str, str]:
        return (self.accelerator.lower(), self.topology.lower())

    @property
    def name(self) -> str:
        return f"pool-scale-up-{self.accelerator}-{self.topology}".lower()

    def pending_seconds(self, now: float) -> float:
        return max(0.0, now - self.created_at)

    def to_provisioning_request(self, namespace: str) -> dict:
        """The intent as a ProvisioningRequest CR (the reference's GKE
        queued-provisioning flow, aimed at pool capacity): podSets count
        the HOSTS the new slices need, labeled with the shape so an
        autoscaler — or an operator reading /debug/scheduler — knows
        which nodepool to grow."""
        shape = GpuSlice.parse(self.accelerator, self.topology)
        return {
            "apiVersion": "autoscaling.x-k8s.io/v1beta1",
            "kind": "ProvisioningRequest",
            "metadata": {
                "name": self.name,
                "namespace": namespace,
                "labels": {
                    keys.TPU_SCALE_UP_ACCELERATOR: self.accelerator,
                    keys.TPU_SCALE_UP_TOPOLOGY: self.topology,
                },
            },
            "spec": {
                "provisioningClassName": "queued-provisioning.gke.io",
                "parameters": {
                    "accelerator": self.accelerator,
                    "topology": self.topology,
                    "slices": str(self.slices),
                    "chips": str(self.chips),
                },
                "podSets": [{
                    "podTemplateRef": {"name": self.name},
                    "count": self.slices * shape.num_hosts,
                }],
            },
        }


def compute_shortfalls(policy: PolicyQueue, now: float,
                       *, flex: bool = True) -> dict:
    """Shapes whose queued gangs fit no pool even if the fleet fully
    drained — the scale-up trigger. A gang that could still land via
    flex borrowing (single-host, some same-accelerator pool exists) is
    NOT short: it is waiting on churn, not on hardware. Per shape, the
    deficit is sized for the largest starved gang (enough for any one of
    them to admit; the rest follow as earlier ones complete)."""
    fleet = policy.fleet
    out: dict[tuple, Shortfall] = {}
    for req in policy.pending.values():
        shape = (req.accelerator.lower(), req.topology.lower())
        ceiling = fleet.total_slices(req.accelerator, req.topology)
        if ceiling >= req.num_slices:
            continue
        if flex:
            slice_shape = _flexible(req)
            if slice_shape is not None and flex_capable(fleet,
                                                        slice_shape):
                continue
        deficit = req.num_slices - ceiling
        chips_per_slice = GpuSlice.parse(
            req.accelerator, req.topology).num_chips
        prior = out.get(shape)
        keys = (req.key,) if prior is None else \
            tuple(sorted(set(prior.keys) | {req.key}))
        out[shape] = Shortfall(
            accelerator=req.accelerator.lower(),
            topology=req.topology.lower(),
            slices=max(deficit, prior.slices if prior else 0),
            chips=max(deficit, prior.slices if prior else 0)
            * chips_per_slice,
            keys=keys,
        )
    return out


@dataclass
class IntentSync:
    """What one :meth:`IntentBook.sync` pass changed."""

    created: list = field(default_factory=list)
    renewed: list = field(default_factory=list)      # TTL expired, still needed
    updated: list = field(default_factory=list)      # ask size changed
    withdrawn: list = field(default_factory=list)    # (intent, reason)


class IntentBook:
    """The deduped, TTL'd set of pending scale-up intents, keyed by
    shape. Pure bookkeeping — the runtime owns the CR mirror and the
    metrics."""

    def __init__(self, ttl_seconds: float = DEFAULT_SCALE_UP_TTL_SECONDS):
        self.ttl = ttl_seconds
        self.intents: dict[tuple, ScaleUpIntent] = {}

    def sync(self, shortfalls: dict, fleet: Fleet, now: float) -> IntentSync:
        """Reconcile the book against the current shortfalls: create
        intents for new shortfall shapes, renew expired-but-still-needed
        ones (the TTL bounds how long an unanswered ask sits before it
        is re-asserted — and alerted on), withdraw intents whose need
        evaporated. Withdrawal reasons: ``granted`` when the fleet now
        holds more of the shape than at creation (the capacity arrived),
        ``moot`` when the starved gangs went away."""
        events = IntentSync()
        for shape, short in shortfalls.items():
            intent = self.intents.get(shape)
            if intent is None:
                intent = ScaleUpIntent(
                    accelerator=short.accelerator,
                    topology=short.topology,
                    slices=short.slices, chips=short.chips,
                    for_keys=short.keys, created_at=now,
                    expires_at=now + self.ttl,
                    ceiling_at_creation=fleet.total_slices(
                        short.accelerator, short.topology),
                )
                self.intents[shape] = intent
                events.created.append(intent)
                continue
            if (intent.slices, intent.chips) != (short.slices,
                                                 short.chips):
                # Track the CURRENT deficit, shrinking included — a
                # partial grant must shrink the mirrored ask, or an
                # autoscaler that fills it provisions slices nobody
                # needs anymore.
                intent.slices = short.slices
                intent.chips = short.chips
                events.updated.append(intent)
            intent.for_keys = short.keys
            if now >= intent.expires_at:
                intent.expires_at = now + self.ttl
                intent.renewals += 1
                events.renewed.append(intent)
        for shape in list(self.intents):
            if shape in shortfalls:
                continue
            intent = self.intents.pop(shape)
            ceiling = fleet.total_slices(intent.accelerator,
                                         intent.topology)
            reason = "granted" if ceiling > intent.ceiling_at_creation \
                else "moot"
            events.withdrawn.append((intent, reason))
        return events

    def for_shape(self, accelerator: str,
                  topology: str) -> ScaleUpIntent | None:
        return self.intents.get((accelerator.lower(), topology.lower()))

    def debug_rows(self, now: float) -> list:
        return [
            {
                "name": i.name,
                "accelerator": i.accelerator,
                "topology": i.topology,
                "slices": i.slices,
                "chips": i.chips,
                "for": [f"{k[0]}/{k[1]}" for k in i.for_keys],
                "pending_sec": round(i.pending_seconds(now), 3),
                "renewals": i.renewals,
                "denied": i.denied,
            }
            for _, i in sorted(self.intents.items())
        ]


# ---- defragmentation -----------------------------------------------------------


@dataclass(frozen=True)
class DefragMove:
    """Migrate one idle borrower off a pack-breaking pool: drain →
    checkpoint → park → re-queue; it re-admits onto a pack pool of its
    own shape (guaranteed free at planning time)."""

    key: tuple             # the borrower to migrate
    source_pool: str       # where its borrowed host sits
    for_key: tuple         # the waiter whose shape comes free
    chips: int


def plan_defrag(policy: PolicyQueue, config: ElasticConfig,
                now: float) -> list:
    """One defragmentation planning pass (pure). For the highest-ranked
    queued gang that native-fit cannot place, find the pools of its
    shape broken by borrowers and pick the idlest borrowers whose
    migration (a) frees enough whole slices for the waiter and (b) has a
    native pack slice to land on. Emits at most
    ``config.defrag_max_moves`` moves; emits none when a partial
    migration would not actually admit the waiter (draining a notebook
    for no benefit is strictly worse than waiting)."""
    ledger = policy.ledger
    fleet = policy.fleet
    moves: list[DefragMove] = []
    # Native free slices per shape, for pack-home guarantees: each
    # planned migrant consumes one.
    pack_free: dict[tuple, int] = {}
    for pool in fleet.pools:
        pack_free[pool.shape_key] = pack_free.get(pool.shape_key, 0) \
            + ledger.free_slices(pool)

    def idle_borrowers(pool_name: str) -> list:
        out = []
        for alloc in ledger.allocations.values():
            if not alloc.borrowed or alloc.draining \
                    or alloc.workload != "notebook":
                continue
            if pool_name not in alloc.borrow:
                continue
            last = (None if alloc.last_active_at is None
                    else max(alloc.last_active_at, alloc.admitted_at))
            if last is None or now - last < config.defrag_idle_seconds:
                continue
            out.append((-(now - last), alloc.key, alloc))
        out.sort()
        return [a for *_rank, a in out]

    for req in policy._ordered_pending(now):
        if moves:
            break  # one waiter per pass — rate-limited by design
        shape = (req.accelerator.lower(), req.topology.lower())
        matching = fleet.matching(req.accelerator, req.topology)
        if not matching:
            continue
        if ledger.fit(req.accelerator, req.topology,
                      req.num_slices) is not None:
            continue  # the normal pass will admit it
        free = sum(max(ledger.free_slices(p), 0) for p in matching)
        candidate_moves: list[DefragMove] = []
        freed = 0
        for pool in matching:
            borrowed = ledger.borrowed.get(pool.name, 0)
            if not borrowed:
                continue
            for alloc in idle_borrowers(pool.name):
                if len(candidate_moves) >= config.defrag_max_moves:
                    break
                mshape = (alloc.accelerator.lower(),
                          alloc.topology.lower())
                if pack_free.get(mshape, 0) < 1:
                    continue  # no pack home — migrating would just
                              # re-borrow somewhere else
                pack_free[mshape] -= 1
                hosts = alloc.borrow[pool.name]
                before = math.ceil(borrowed / pool.hosts_per_slice)
                borrowed -= hosts
                freed += before - math.ceil(
                    borrowed / pool.hosts_per_slice)
                candidate_moves.append(DefragMove(
                    key=alloc.key, source_pool=pool.name,
                    for_key=req.key, chips=alloc.chips))
                if free + freed >= req.num_slices:
                    break
            if free + freed >= req.num_slices:
                break
        if candidate_moves and free + freed >= req.num_slices:
            moves = candidate_moves
    return moves


def plan_idle_borrower_eviction(policy: PolicyQueue, req: GangRequest,
                                now: float, *,
                                idle_after: float) -> Allocation | None:
    """Host-granular idle preemption: a flexible waiter with no free
    host to borrow may evict ONE *idle* borrower (most idle first, same
    idle rule as the native victim search — never a busy holder, and
    never a probe-less one) whose host the waiter can use. Without this,
    idle borrowers are invisible to every reclamation mechanism for a
    same-shape waiter whose shape has no native pool: not preemptible
    (they hold no slices), not defrag targets (no native pool is
    broken), and no scale-up intent (flex capacity nominally exists).
    The victim parks like any idle-preemption victim — NO auto-requeue —
    so two idle borrowers cannot ping-pong a host between themselves."""
    shape = _flexible(req)
    if shape is None:
        return None
    if flex_plan(policy.ledger, req) is not None:
        return None  # a free host exists; no eviction needed
    candidates = []
    for alloc in policy.ledger.allocations.values():
        if not alloc.borrowed or alloc.workload != "notebook":
            # Serving replicas are never eviction victims (workload-class
            # guard, kubeflow_tpu_torch/serving) — and they carry no activity
            # probe, so the idle rule below could never clear them anyway.
            continue
        if alloc.accelerator.lower() != req.accelerator.lower():
            continue
        pool = policy.fleet.by_name(next(iter(alloc.borrow)))
        if pool is None or pool.name in policy.ledger.unavailable \
                or pool.chips_per_host < shape.chips_per_host:
            continue
        if alloc.draining:
            # A usable host is already on its way out — evicting a
            # second borrower for the same one-host waiter would
            # double-kill.
            return None
        last = (None if alloc.last_active_at is None
                else max(alloc.last_active_at, alloc.admitted_at))
        if last is None or now - last < idle_after:
            continue
        candidates.append((-(now - last), alloc.key, alloc))
    if not candidates:
        return None
    candidates.sort()
    return candidates[0][2]


# ---- spot reclaim --------------------------------------------------------------


def node_reclaim_signal(node: dict) -> str | None:
    """The revocation signal on one Node: a reclaim taint key, or None.
    This is the same upstream signal podsim's DisruptionTarget models at
    the pod level — here it is read fleet-side so the drain starts while
    the grace window is still open."""
    for taint in deep_get(node, "spec", "taints", default=[]) or []:
        if taint.get("key") in RECLAIM_TAINTS:
            return taint.get("key")
    return None


def pool_of_node(fleet: Fleet, node: dict) -> NodePool | None:
    """Map a Node to its fleet pool: exact nodepool-label match first,
    then the shape-disambiguated ``<pool>-<acc>-<topo>`` names
    ``Fleet.from_nodes`` mints for mixed-label pools."""
    labels = ((node.get("metadata") or {}).get("labels")) or {}
    nodepool = labels.get(GKE_NODEPOOL_LABEL)
    if not nodepool:
        return None
    pool = fleet.by_name(nodepool)
    if pool is not None:
        return pool
    prefixed = [p for p in fleet.pools
                if p.name.startswith(nodepool + "-")]
    return prefixed[0] if len(prefixed) == 1 else None


def reclaimable(ledger, pool_name: str) -> list:
    """Allocations holding capacity on one (spot) pool — native slices
    or borrowed hosts — that a reclaim must drain. Draining gangs are
    already on their way out."""
    out = []
    for alloc in ledger.allocations.values():
        if alloc.draining:
            continue
        if alloc.placements.get(pool_name) or \
                (alloc.borrow or {}).get(pool_name):
            out.append(alloc)
    return sorted(out, key=lambda a: a.key)
