"""Pure policy core of the GPU fleet scheduler: a copy of
``kubeflow_tpu/scheduler/policy.py``, whose "chips" are cards here.

Kueue-style arbitration as a deterministic, clock-free state machine —
every decision is a function of (queue state, ledger state, the ``now``
the caller passes in), so tier-1 can property-test randomized
arrival/completion sequences without FakeKube or an event loop.

Policy, in admission order:

- **Gang admission**: a request is one Notebook's full MultiSlice; it is
  admitted with all of its slices placed or not at all (``ChipLedger.fit``
  never returns a partial plan).
- **Priority classes**: higher ``priority`` schedules first.
- **Weighted fair share** (DRF on chips — chips are the single dominant
  resource, so dominant-resource fairness reduces to admitted chips
  divided by namespace weight): among equal priority, the namespace with
  the smallest share goes first.
- **Aging** (bounded starvation): every ``aging_seconds`` of queue wait
  adds one effective priority step (capped at ``aging_max_boost``), and a
  request starved past ``starvation_reserve_seconds`` blocks backfill —
  smaller gangs stop jumping over it, so the capacity it needs eventually
  drains free.
- **Preemption**: when a request cannot fit, reclaim whole gangs (never a
  slice subset — mid-gang preemption would leave a broken NCCL world and a
  half-accounted ledger) from *idle* holders (culling's last-activity
  signal, any priority) or *strictly lower-priority* holders. Victims'
  chips are released in-ledger immediately so the waiting gang admits in
  the same pass; the runtime stop-annotates the victim CRs.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from kubeflow_tpu_torch.scheduler.fleet import Allocation, ChipLedger, Fleet
from kubeflow_tpu_torch.telemetry.ledger import EfficiencyLedger


def _eff_key(key: tuple) -> str:
    """Gang key as the efficiency ledger's string key (its rows appear in
    JSON debug payloads, where tuple keys can't)."""
    return "/".join(str(p) for p in key)


@dataclass(frozen=True)
class GangRequest:
    """One notebook's whole MultiSlice, as the queue sees it."""

    key: tuple                 # (namespace, name)
    namespace: str
    accelerator: str
    topology: str
    num_slices: int
    chips: int                 # total chips across the gang
    priority: int = 0
    weight: float = 1.0        # namespace weight (fair-share divisor)
    submitted_at: float = 0.0
    seq: int = 0               # arrival order; the final deterministic tie-break
    # Workload class ("notebook" | "serving", kubeflow_tpu_torch/serving): a
    # serving replica admits exactly like a notebook gang but is NEVER a
    # preemption victim — it has no notebook activity signal (no Jupyter
    # kernels), so the idle heuristic would misread a service under load
    # as idle forever, and its capacity is managed by its own autoscaler
    # (scale-down releases chips; killing one replica would just make
    # the service re-request it). Default keeps the pre-serving behavior
    # bit-identical.
    workload: str = "notebook"


@dataclass(frozen=True)
class Preemption:
    key: tuple                 # victim (namespace, name)
    reason: str                # "idle" | "priority"
    for_key: tuple             # the queued gang the chips were reclaimed for
    chips: int


@dataclass(frozen=True)
class Admitted:
    key: tuple
    placements: dict
    waited: float              # now - submitted_at (time-to-admission)


@dataclass(frozen=True)
class QueuedInfo:
    key: tuple
    position: int              # 1-based rank in the current queue order
    chips: int
    reason: str


@dataclass(frozen=True)
class ScheduleResult:
    admitted: list
    preempted: list
    queue: list                # QueuedInfo for everything still waiting
    # Deferred preemption only: victims that must be ASKED to checkpoint
    # (Preemption records; their chips stay booked until the runtime
    # observes the ack or the grace deadline and calls release()).
    drains: list = field(default_factory=list)


@dataclass(frozen=True)
class PolicyConfig:
    aging_seconds: float = 300.0
    aging_max_boost: int = 4
    starvation_reserve_seconds: float = 900.0
    enable_preemption: bool = True
    # A holder whose culling last-activity is older than this is fair
    # game for any queued gang that needs its chips.
    idle_preempt_after_seconds: float = 1800.0
    # Preempt-to-checkpoint (kubeflow_tpu_torch/migration): victims are DRAIN
    # requests, not in-pass releases — chips stay booked (alloc.draining)
    # until the runtime sees the checkpoint ack or the grace deadline and
    # releases them. False keeps the immediate-stop semantics.
    deferred_preemption: bool = False


@dataclass
class PolicyQueue:
    """The scheduler's brain: a pending queue over a chip ledger."""

    fleet: Fleet
    config: PolicyConfig = field(default_factory=PolicyConfig)
    ledger: ChipLedger = None  # type: ignore[assignment]
    pending: dict = field(default_factory=dict)   # key → GangRequest
    # Per-family x shape MFU history: fed from the telemetry
    # annotation by the runtime, consumed ONLY as a tie-break inside the
    # idle victim tier and by explain/debug_info.
    efficiency: EfficiencyLedger = field(default_factory=EfficiencyLedger)
    # Bumped on every state change (submit/release/touch/admission/
    # preemption/reclaim): the runtime skips redundant full arbitration
    # passes — each queued notebook's safety-net requeue would otherwise
    # run a global O(queue) pass — when gen is unchanged.
    gen: int = 0
    _seq: int = 0

    def __post_init__(self):
        if self.ledger is None:
            self.ledger = ChipLedger(self.fleet)

    @property
    def overcommitted(self) -> int:
        """Gangs reclaim() had to force-place over a too-small fleet
        (controller restart after a shrink, or their shape left the
        fleet) — surfaced in debug_info. Counted live from the ledger so
        a rebind_fleet() re-seat of a still-overcommitted gang never
        double-counts it, and the number drains as holders release."""
        return sum(1 for a in self.ledger.allocations.values() if a.forced)

    # ---- queue mutation ---------------------------------------------------------

    def submit(self, req: GangRequest) -> GangRequest:
        """Enqueue (or refresh) a gang. An existing pending entry keeps its
        original submitted_at/seq — a spec refresh must not reset aging —
        unless its shape changed, in which case demand is re-declared.
        Submitting an already-admitted key is a no-op (the holder's
        reconcile calls this idempotently)."""
        if req.key in self.ledger.allocations:
            return req
        prior = self.pending.get(req.key)
        if prior is not None and (
                prior.accelerator.lower(), prior.topology.lower(),
                prior.num_slices,
        ) == (req.accelerator.lower(), req.topology.lower(),
              req.num_slices):
            req = replace(req, submitted_at=prior.submitted_at,
                          seq=prior.seq)
        else:
            # New demand — or a shape EDIT while queued, which re-declares
            # it: aging/starvation credit earned as a small gang must not
            # transfer to an arbitrarily larger one (a tenant could wedge
            # the shape's starvation door without ever waiting as that
            # demand).
            self._seq += 1
            req = replace(req, seq=self._seq)
        if self.pending.get(req.key) != req:
            self.gen += 1
        self.pending[req.key] = req
        return req

    def release(self, key: tuple) -> Allocation | None:
        """Drop a gang entirely: its queue entry (stopped while waiting)
        and/or its allocation (stopped/deleted while running)."""
        dropped = self.pending.pop(key, None)
        alloc = self.ledger.release(key)
        self.efficiency.forget(_eff_key(key))
        if dropped is not None or alloc is not None:
            self.gen += 1
        return alloc

    def note_efficiency(self, key: tuple, family: str, shape: str,
                        mfu) -> None:
        """Feed one telemetry window (deduplicated by annotation seq at
        the caller). Deliberately no ``gen`` bump: efficiency only
        reorders victims *within* the idle tier, so it never makes a new
        admission possible and must not trigger re-arbitration churn."""
        self.efficiency.note(_eff_key(key), family, shape, mfu)

    def touch(self, key: tuple, last_active_at: float | None) -> None:
        """Refresh a holder's idle signal (culling's last-activity)."""
        alloc = self.ledger.allocations.get(key)
        if alloc is not None and last_active_at is not None \
                and alloc.last_active_at != last_active_at:
            alloc.last_active_at = last_active_at
            self.gen += 1

    def is_admitted(self, key: tuple) -> bool:
        return key in self.ledger.allocations

    def is_draining(self, key: tuple) -> bool:
        alloc = self.ledger.allocations.get(key)
        return alloc is not None and alloc.draining

    def reclaim(self, req: GangRequest, now: float, *,
                borrow_first: bool = False,
                prefer_pool: str | None = None) -> bool:
        """Re-seat an ALREADY-RUNNING gang after a controller restart
        (scheduler state is in-memory). Uses a normal fit when capacity
        allows; otherwise force-places on matching pools — the pods exist,
        so refusing would stop-annotate healthy workloads on every
        controller restart. Forced placements may transiently exceed a
        shrunken fleet's capacity; that is recorded as an overcommit, not
        a ledger violation, and drains as holders release.

        ``borrow_first`` (with ``prefer_pool``, the durable flex-pool
        annotation): the gang was flex-placed before the restart, so its
        pods run on a FOREIGN pool's host — restore the borrow even when
        a native fit now exists, or the host pool's capacity is resold
        under the running pods and the gang's node selectors flip."""
        if req.key in self.ledger.allocations:
            return True
        self.pending.pop(req.key, None)
        # Borrow re-seat (one shared block, two triggers): with the
        # durable flex hint, BEFORE the native fit — the gang's pods run
        # on a foreign pool's host, and seating it natively would
        # un-break that pool's slice, resell the occupied host, and flip
        # the gang's node selectors; without the hint, only as the
        # fallback when no native fit exists (an ex-native single-host
        # gang whose slice was resold is better borrowed than
        # force-overcommitted).
        borrow = (self.ledger.borrow_fit(req.accelerator, req.topology,
                                         prefer=prefer_pool)
                  if borrow_first else None)
        plan = (None if borrow is not None else
                self.ledger.fit(req.accelerator, req.topology,
                                req.num_slices))
        if borrow is None and plan is None:
            borrow = self.ledger.borrow_fit(req.accelerator, req.topology)
        if borrow is not None:
            self.ledger.admit(Allocation(
                key=req.key, namespace=req.namespace,
                accelerator=req.accelerator, topology=req.topology,
                num_slices=req.num_slices, chips=req.chips,
                placements={}, borrow=borrow,
                priority=req.priority, admitted_at=now,
                workload=req.workload,
            ))
            self.gen += 1
            return True
        overcommit = plan is None
        if overcommit:
            pools = self.fleet.matching(req.accelerator, req.topology)
            if not pools:
                # The shape left the fleet entirely but the gang's pods
                # still run: seat it on a shape pseudo-pool as pure
                # overcommit rather than queueing a live workload —
                # 'Queued' would suppress its child reconcile and tell
                # the UI nothing runs while pods serve traffic. It takes
                # no real pool's capacity and drains on release.
                plan = {f"{req.accelerator}:{req.topology}":
                        req.num_slices}
            else:
                plan = {}
                remaining = req.num_slices
                for pool in pools:
                    take = min(max(self.ledger.free_slices(pool), 0),
                               remaining)
                    if take:
                        plan[pool.name] = take
                        remaining -= take
                if remaining:
                    plan[pools[0].name] = \
                        plan.get(pools[0].name, 0) + remaining
        alloc = Allocation(
            key=req.key, namespace=req.namespace,
            accelerator=req.accelerator, topology=req.topology,
            num_slices=req.num_slices, chips=req.chips,
            placements=plan, priority=req.priority, admitted_at=now,
            workload=req.workload,
        )
        self.ledger.admit(alloc, force=overcommit)
        self.gen += 1
        return True

    def rebind_fleet(self, fleet: Fleet) -> None:
        """Swap the fleet under live allocations (dynamic fleet sources:
        ConfigMap edits, node-label inference). Allocations whose
        placements reference pools that left the fleet — or whose named
        pool now hosts a different shape — are released and re-seated
        via :meth:`reclaim`: a renamed pool (same hardware, new name)
        re-books onto the new name so its capacity is not double-sold to
        new gangs, and a shape that vanished falls back to the reclaim
        pseudo-pool overcommit. Everything else keeps its booking."""
        self.fleet = fleet
        self.ledger.fleet = fleet
        stale = []
        for alloc in self.ledger.allocations.values():
            ok = not alloc.forced
            for pool_name in alloc.placements:
                pool = fleet.by_name(pool_name)
                if pool is None or pool.shape_key != (
                        alloc.accelerator.lower(),
                        alloc.topology.lower()):
                    ok = False
                    break
            # A borrower's pool must still exist with the same
            # accelerator (its shape differs from the pool's by design);
            # gone → re-seat like any stale placement.
            for pool_name in (alloc.borrow or {}):
                pool = fleet.by_name(pool_name)
                if pool is None or pool.accelerator.lower() != \
                        alloc.accelerator.lower():
                    ok = False
                    break
            if not ok:
                stale.append(alloc)
        for alloc in stale:   # release all first: re-seating must see
            self.ledger.release(alloc.key)        # the full free space
        for alloc in stale:
            self.reclaim(
                GangRequest(
                    key=alloc.key, namespace=alloc.namespace,
                    accelerator=alloc.accelerator,
                    topology=alloc.topology,
                    num_slices=alloc.num_slices, chips=alloc.chips,
                    priority=alloc.priority, workload=alloc.workload),
                now=alloc.admitted_at,   # keep the original admission time
                # An ex-borrower re-seats as a borrow (its pods live on
                # a foreign pool's host, likely the renamed survivor).
                borrow_first=alloc.borrowed)
            reseated = self.ledger.allocations.get(alloc.key)
            if reseated is not None:
                reseated.last_active_at = alloc.last_active_at
                # A drain in flight survives the fleet swap: the victim
                # is still checkpointing and must not become a candidate
                # for a second preemption.
                reseated.draining = alloc.draining
        # A shrink that KEEPS a pool's name/shape can leave its live
        # gangs over the new capacity. That is deliberate drain-down
        # overcommit, not ledger drift — mark those gangs forced so
        # assert_consistent exempts the pool and debug_info reports the
        # overcommit (it clears when they release or a later rebind
        # re-seats them within capacity).
        for pool in fleet.pools:
            used = sum(a.placements.get(pool.name, 0)
                       for a in self.ledger.allocations.values())
            if used > pool.num_slices:
                for a in self.ledger.allocations.values():
                    if a.placements.get(pool.name):
                        a.forced = True
        self.gen += 1

    # ---- scheduling pass --------------------------------------------------------

    def _effective_priority(self, req: GangRequest, now: float) -> int:
        cfg = self.config
        if cfg.aging_seconds <= 0:
            return req.priority
        boost = int(max(0.0, now - req.submitted_at) // cfg.aging_seconds)
        return req.priority + min(boost, cfg.aging_max_boost)

    def _share(self, req: GangRequest) -> float:
        """Weighted fair-share term (admitted chips / namespace weight)
        — one definition for ranking AND the explain mirror."""
        return self.ledger.ns_chips.get(req.namespace, 0) \
            / max(req.weight, 1e-9)

    def _starved(self, req: GangRequest, now: float) -> bool:
        """Does this gang hold the starvation door for its shape? One
        predicate shared by schedule()'s backfill block and explain() —
        the explanation must mirror what admission actually enforces
        (incl. the never-fits ceiling exemption)."""
        return (now - req.submitted_at
                >= self.config.starvation_reserve_seconds
                and self.fleet.total_slices(req.accelerator, req.topology)
                >= req.num_slices)

    def _rank_key(self, req: GangRequest, now: float):
        return (-self._effective_priority(req, now), self._share(req),
                req.seq)

    def _ordered_pending(self, now: float) -> list:
        return sorted(self.pending.values(),
                      key=lambda r: self._rank_key(r, now))

    def _find_victims(self, req: GangRequest, now: float) -> list | None:
        """Whole-gang victims whose release lets ``req`` fit, or None.
        Idle holders (culling signal) are preemptible by anyone; busy
        holders only by strictly higher BASE priority — aging boosts
        where a gang sorts in the queue, never whom it may kill (an
        equal-priority gang that waited long enough must not stop-
        annotate a busy peer). Within the idle tier, gangs the
        efficiency ledger flags persistently-low-MFU rank first (the
        telemetry's placement signal — strictly a tie-break inside tier 0:
        serving/busy/priority protections all sort ahead of it); then
        most-idle, lowest priority, youngest admission (LIFO), so the
        decision is deterministic and the cheapest work dies first."""
        cfg = self.config
        shape = (req.accelerator.lower(), req.topology.lower())
        matching = {p.name
                    for p in self.fleet.matching(req.accelerator,
                                                 req.topology)}
        candidates = []
        # Capacity already on its way out (deferred preemption: gangs
        # asked to checkpoint but still holding chips) counts as incoming
        # free space — selecting a second victim for slices a first one
        # is already vacating would double-kill for one waiter.
        draining_by_pool: dict[str, int] = {}
        for alloc in self.ledger.allocations.values():
            if alloc.draining:
                if (alloc.accelerator.lower(),
                        alloc.topology.lower()) == shape:
                    for pool, n in alloc.placements.items():
                        if pool in matching:
                            draining_by_pool[pool] = \
                                draining_by_pool.get(pool, 0) + n
                continue  # never re-pick a draining gang as a victim
            if alloc.workload == "warmpool":
                # Warm-pool chips are a RESERVE by contract:
                # the reservation exists precisely so the scheduler can
                # cannibalize it under pressure — tier -1 makes every
                # warm slot a victim before any idle or lower-priority
                # REAL gang, and schedule() releases it instantly (a
                # warm pod holds no state worth a checkpoint drain).
                if (alloc.accelerator.lower(),
                        alloc.topology.lower()) != shape:
                    continue
                warm_reclaimable = sum(
                    n for pool, n in alloc.placements.items()
                    if pool in matching)
                if warm_reclaimable == 0:
                    continue
                candidates.append((-1, 0, 0.0, alloc.priority,
                                   -alloc.admitted_at, alloc.key,
                                   "warm-pool", warm_reclaimable, alloc))
                continue
            if alloc.workload != "notebook":
                # Workload-class guard (kubeflow_tpu_torch/serving): a serving
                # replica has no activity probe — "no kernels" must not
                # read as idle — and stopping one would not free capacity
                # for long (its autoscaler would re-bid immediately).
                # Serving capacity comes back through scale-down /
                # scale-to-zero, never through preemption.
                continue
            if (alloc.accelerator.lower(), alloc.topology.lower()) != shape:
                continue  # frees no capacity this gang can use
            # Only slices booked on REAL matching pools come back on
            # release: a gang force-seated on a shape pseudo-pool
            # (reclaim after the shape left the fleet) would be stopped
            # for zero benefit — the waiter still couldn't fit.
            reclaimable = sum(n for pool, n in alloc.placements.items()
                              if pool in matching)
            if reclaimable == 0:
                continue
            # Floored by the in-memory admitted_at: the durable
            # admitted-at annotation usually floors the culling signal
            # already, but its stamp patch is best-effort — if it failed,
            # a long-queued gang would look 'idle since before it ran'
            # seconds after admission.
            last = (None if alloc.last_active_at is None
                    else max(alloc.last_active_at, alloc.admitted_at))
            idle = (last is not None
                    and now - last >= cfg.idle_preempt_after_seconds)
            if idle:
                # Efficiency tie-break INSIDE tier 0 only: a persistently
                # low-MFU idle gang is the preferred reclaim, but the
                # signal can never promote a candidate across tiers.
                eff = 0 if self.efficiency.persistently_low(
                    _eff_key(alloc.key)) else 1
                candidates.append((0, eff, -(now - last),
                                   alloc.priority, -alloc.admitted_at,
                                   alloc.key, "idle", reclaimable, alloc))
            elif alloc.priority < req.priority:
                candidates.append((1, 0, 0.0, alloc.priority,
                                   -alloc.admitted_at, alloc.key,
                                   "priority", reclaimable, alloc))
        candidates.sort(key=lambda c: c[:6])
        # Per-pool simulation, not one aggregate sum: an overcommitted
        # pool's NEGATIVE free space (restart reclaim / fleet shrink)
        # must neither mask reclaimable capacity on healthy pools (the
        # deficit would hide a sufficient victim and wrongly refuse
        # preemption) nor count a victim's slices as usable when they
        # only drain that pool's deficit (over-selecting healthy gangs).
        # An unavailable pool (spot mid-reclaim) can never satisfy the
        # waiter: -inf keeps it unusable no matter how many of its
        # holders a victim search would free.
        free_by_pool = {
            p.name: (float("-inf")
                     if p.name in self.ledger.unavailable
                     else self.ledger.free_slices(p))
            for p in self.fleet.matching(req.accelerator, req.topology)}
        for pool, n in draining_by_pool.items():
            free_by_pool[pool] = free_by_pool.get(pool, 0) + n

        def usable() -> int:
            return sum(max(f, 0) for f in free_by_pool.values())

        victims = []
        for *_rank, _key, reason, _reclaimable, alloc in candidates:
            if usable() >= req.num_slices:
                break
            victims.append((alloc, reason))
            for pool, n in alloc.placements.items():
                if pool in free_by_pool:
                    free_by_pool[pool] += n
        # An EMPTY list is meaningful in deferred mode: enough capacity is
        # already draining, so no new victim is needed — the caller keeps
        # the requester queued without emitting further drains. None still
        # means preemption cannot help at all.
        return victims if usable() >= req.num_slices else None

    def schedule(self, now: float) -> ScheduleResult:
        """One deterministic arbitration pass. Mutates the ledger (admits,
        preempts) and returns everything the runtime must act on."""
        admitted: list[Admitted] = []
        preempted: list[Preemption] = []
        drains: list[Preemption] = []
        # Shapes whose warm-pool reserve was released THIS pass for a
        # requester still waiting on real drains: held for the whole
        # pass (across re-rank iterations), or a lower-ranked same-shape
        # gang would backfill onto the freed reserve and leave the
        # requester short — forcing a second real-gang drain later.
        warm_held: set = set()
        progressed = True
        while progressed and self.pending:
            progressed = False
            # Shapes a starved gang has reserved this scan: backfill of
            # the SAME shape must not jump it, but gangs for disjoint
            # pools take nothing it is waiting for and admit freely.
            blocked: set = set(warm_held)
            for req in self._ordered_pending(now):
                shape = (req.accelerator.lower(), req.topology.lower())
                if shape in blocked:
                    continue
                plan = self.ledger.fit(req.accelerator, req.topology,
                                       req.num_slices)
                if plan is None and self.config.enable_preemption:
                    victims = self._find_victims(req, now)
                    if victims is not None:
                        # Warm-pool reservations release INSTANTLY even
                        # in deferred mode: a warm pod has nothing to
                        # checkpoint, and the whole point of the reserve
                        # is that a real gang takes its chips in the
                        # same pass.
                        instant = [(a, r) for a, r in victims
                                   if a.workload == "warmpool"]
                        rest = [(a, r) for a, r in victims
                                if a.workload != "warmpool"]
                        for alloc, reason in instant:
                            self.ledger.release(alloc.key)
                            preempted.append(Preemption(
                                key=alloc.key, reason=reason,
                                for_key=req.key, chips=alloc.chips))
                    else:
                        instant, rest = [], []
                    if victims is not None and self.config.deferred_preemption:
                        # Drain, don't kill: mark the victims draining
                        # (chips stay booked — the fleet must not admit
                        # anyone onto slices that still hold un-saved
                        # state) and hand them to the runtime to ask for
                        # a checkpoint. The requester stays queued until
                        # the runtime observes the ack (or the grace
                        # deadline) and releases the victims for real.
                        # An empty list = enough capacity already
                        # draining for this shape; just keep waiting.
                        for alloc, reason in rest:
                            alloc.draining = True
                            drains.append(Preemption(
                                key=alloc.key, reason=reason,
                                for_key=req.key, chips=alloc.chips))
                        if instant and not rest:
                            # The reserve alone covered the ask — admit
                            # in this pass, like immediate preemption.
                            plan = self.ledger.fit(
                                req.accelerator, req.topology,
                                req.num_slices)
                        elif instant:
                            # Warm chips freed NOW for a requester that
                            # must still wait on real drains: hold the
                            # shape's door for the rest of this PASS
                            # (warm_held survives re-rank iterations).
                            # Future passes before the drains finalize
                            # keep a bounded window; _find_victims picks
                            # warm slots first in any follow-up search,
                            # so a real gang is still never preferred.
                            blocked.add(shape)
                            warm_held.add(shape)
                    elif victims:
                        for alloc, reason in rest:
                            self.ledger.release(alloc.key)
                            preempted.append(Preemption(
                                key=alloc.key, reason=reason,
                                for_key=req.key, chips=alloc.chips))
                        plan = self.ledger.fit(req.accelerator,
                                               req.topology, req.num_slices)
                if plan is not None:
                    self.ledger.admit(Allocation(
                        key=req.key, namespace=req.namespace,
                        accelerator=req.accelerator, topology=req.topology,
                        num_slices=req.num_slices, chips=req.chips,
                        placements=plan, priority=req.priority,
                        admitted_at=now, workload=req.workload,
                    ))
                    del self.pending[req.key]
                    admitted.append(Admitted(
                        key=req.key, placements=plan,
                        waited=max(0.0, now - req.submitted_at)))
                    progressed = True
                    break  # shares changed; re-rank from scratch
                if self._starved(req, now):
                    # Starved: hold the door on this SHAPE — no backfill
                    # jumps it, so the capacity it needs can drain free.
                    # Only for gangs the fleet CAN eventually host: a
                    # never-fits gang (over the shape ceiling — created
                    # before the fleet shrank, or past the CREATE-only
                    # webhook check) would otherwise wedge its shape
                    # forever; it stays queued with the ceiling in its
                    # reason instead.
                    blocked.add(shape)
        if admitted or preempted or drains:
            self.gen += 1
        return ScheduleResult(admitted=admitted, preempted=preempted,
                              drains=drains,
                              queue=self.schedule_preview(now))

    def _queue_reason(self, req: GangRequest) -> str:
        total = self.fleet.total_slices(req.accelerator, req.topology)
        if total == 0:
            return (f"no pool hosts {req.accelerator}:{req.topology} slices")
        if total < req.num_slices:
            return (f"gang needs {req.num_slices} "
                    f"{req.accelerator}:{req.topology} slice(s); the fleet "
                    f"ceiling is {total}")
        shape = (req.accelerator.lower(), req.topology.lower())
        draining = sum(
            1 for a in self.ledger.allocations.values()
            if a.draining and (a.accelerator.lower(),
                               a.topology.lower()) == shape)
        if draining:
            return (f"waiting for {draining} draining gang(s) to "
                    f"checkpoint ({req.chips} chips)")
        return (f"waiting for {req.chips} chips "
                f"({req.num_slices}x {req.accelerator}:{req.topology})")

    # ---- introspection ----------------------------------------------------------

    def debug_info(self, now: float) -> dict:
        # Per-pool chip attribution for the /debug/scheduler rows:
        # draining chips are still booked (the victim is checkpointing)
        # but on their way out — operators watching a reclaim want to
        # see them apart from plain used.
        draining_by_pool: dict[str, int] = {}
        for a in self.ledger.allocations.values():
            if not a.draining:
                continue
            for pool_name, n in a.placements.items():
                pool = self.fleet.by_name(pool_name)
                if pool is not None:
                    draining_by_pool[pool_name] = \
                        draining_by_pool.get(pool_name, 0) \
                        + n * pool.chips_per_slice
            for pool_name, hosts in (a.borrow or {}).items():
                pool = self.fleet.by_name(pool_name)
                if pool is not None:
                    draining_by_pool[pool_name] = \
                        draining_by_pool.get(pool_name, 0) \
                        + hosts * pool.chips_per_host
        return {
            "pools": [
                {
                    "name": p.name, "accelerator": p.accelerator,
                    "topology": p.topology, "slices": p.num_slices,
                    "free_slices": self.ledger.free_slices(p),
                    "chips": p.total_chips,
                    "used_chips":
                        self.ledger.used.get(p.name, 0)
                        * p.chips_per_slice
                        + self.ledger.borrowed.get(p.name, 0)
                        * p.chips_per_host,
                    "draining_chips": draining_by_pool.get(p.name, 0),
                    "free_chips": self.ledger.free_slices(p)
                    * p.chips_per_slice,
                    "borrowed_hosts": self.ledger.borrowed.get(p.name, 0),
                    "spot": p.spot,
                }
                for p in self.fleet.pools
            ],
            "admitted": [
                {
                    "key": list(a.key), "chips": a.chips,
                    "slices": a.num_slices, "priority": a.priority,
                    "placements": a.placements,
                    "borrow": a.borrow or {},
                    "admitted_at": a.admitted_at,
                    "last_active_at": a.last_active_at,
                    "draining": a.draining,
                    "workload": a.workload,
                }
                for a in sorted(self.ledger.allocations.values(),
                                key=lambda a: a.key)
            ],
            "queue": [
                {
                    "key": list(q.key), "position": q.position,
                    "chips": q.chips, "reason": q.reason,
                }
                for q in self.schedule_preview(now)
            ],
            "ns_chips": dict(sorted(self.ledger.ns_chips.items())),
            "violations": self.ledger.violations,
            "overcommitted": self.overcommitted,
            "efficiency": self.efficiency.debug_info(),
        }

    def schedule_preview(self, now: float) -> list:
        """Queue snapshot without mutating anything (for /debug)."""
        return [
            QueuedInfo(key=req.key, position=i + 1, chips=req.chips,
                       reason=self._queue_reason(req))
            for i, req in enumerate(self._ordered_pending(now))
        ]

    def explain(self, key: tuple, now: float) -> dict:
        """The machine answer to "why is this gang where it is" —
        read-only (``fit`` plans, ``_find_victims`` simulates; neither
        mutates the ledger). Three shapes: an Admitted/Draining holder,
        a Queued gang with its full rank breakdown, or Unknown."""
        key = tuple(key)
        alloc = self.ledger.allocations.get(key)
        if alloc is not None:
            eff = self.efficiency.explain(_eff_key(key))
            out = {
                "state": "Draining" if alloc.draining else "Admitted",
                "chips": alloc.chips,
                "slices": alloc.num_slices,
                "priority": alloc.priority,
                "placements": dict(alloc.placements),
                "borrow": dict(alloc.borrow or {}),
                "admitted_at": alloc.admitted_at,
                "forced_overcommit": alloc.forced,
                "workload": alloc.workload,
                "efficiency": eff,
            }
            if eff and eff.get("expected_mfu") is not None:
                out["efficiency"]["note"] = (
                    f"family {eff['family']} historically achieves "
                    f"{eff['expected_mfu']:.1%} MFU on {eff['shape']} "
                    f"({eff['family_samples']} window(s))")
            return out
        req = self.pending.get(key)
        if req is None:
            return {"state": "Unknown",
                    "reason": "not admitted, queued, or draining — the "
                              "scheduler does not track this key"}
        ordered = self._ordered_pending(now)
        position = next(i + 1 for i, r in enumerate(ordered)
                        if r.key == key)
        cfg = self.config
        waited = max(0.0, now - req.submitted_at)
        shape = (req.accelerator.lower(), req.topology.lower())
        fits_now = self.ledger.fit(req.accelerator, req.topology,
                                   req.num_slices) is not None
        victims = (self._find_victims(req, now)
                   if cfg.enable_preemption and not fits_now else None)
        total = self.fleet.total_slices(req.accelerator, req.topology)
        starved = self._starved(req, now)
        # Is an EARLIER starved gang holding this shape's door shut?
        door_holder = None
        for i, r in enumerate(ordered):
            if i >= position - 1:
                break
            if (r.accelerator.lower(), r.topology.lower()) == shape \
                    and self._starved(r, now):
                door_holder = r.key
                break
        draining_same_shape = [
            list(a.key) for a in self.ledger.allocations.values()
            if a.draining and (a.accelerator.lower(),
                               a.topology.lower()) == shape]
        return {
            "state": "Queued",
            "position": position,
            "of": len(ordered),
            "reason": self._queue_reason(req),
            "blocking_shape": f"{req.accelerator}:{req.topology}",
            "chips": req.chips,
            "slices": req.num_slices,
            "rank": {
                "priority": req.priority,
                "aging_boost": (self._effective_priority(req, now)
                                - req.priority),
                "effective_priority": self._effective_priority(req, now),
                "namespace_share": round(self._share(req), 3),
                "arrival_seq": req.seq,
            },
            "waited_seconds": round(waited, 3),
            "fits_now": fits_now,
            "feasible_if_drained": victims is not None,
            "drain_candidates": [
                {"key": list(a.key), "reason": reason, "chips": a.chips}
                for a, reason in (victims or [])
            ],
            "already_draining": draining_same_shape,
            "fleet_ceiling_slices": total,
            "over_ceiling": total < req.num_slices,
            "starvation": {
                "reserve_seconds": cfg.starvation_reserve_seconds,
                "holds_door": starved,
                "blocked_by_starved": (list(door_holder)
                                       if door_holder else None),
            },
        }
