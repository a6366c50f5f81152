"""Fleet model + chip ledger for the GPU fleet scheduler: the port of
``kubeflow_tpu/scheduler/fleet.py`` on :class:`~kubeflow_tpu_torch.gpu.
topology.GpuSlice`.

A **fleet** is the cluster's GPU inventory as node pools. Each pool hosts
slices of exactly one shape (``<nodes>x<cards a node>``, e.g. ``2x8``),
so a slice of shape S can only ever land on a pool of shape S. The
schedulable unit is therefore a **slice of the pool's shape**, and a
pool's capacity is counted in slices. The ledger's "chips" are cards
(``nvidia.com/gpu``), as ``status.gpu.chips`` counts them, and its
"hosts" are nodes.

The **ledger** tracks which gang (one Notebook's full MultiSlice) holds
which slices, with two hard invariants the property tests in
``tests/test_scheduler.py`` drive:

- *capacity*: admitted slices per pool never exceed the pool's capacity;
- *gang atomicity*: an allocation is always the request's whole slice set
  — there is no code path that records a partial gang.

Everything here is pure (no Kubernetes imports, no clock, no I/O) so the
policy core above it stays deterministic and property-testable.

Fleet sources, in the order the runtime tries them:

- ``KFTPU_FLEET`` env: ``a3=nvidia-h100-80gb:2x8:4,small=nvidia-h100-80gb:1x8:2``
  (``<name>=<accelerator>:<shape>:<num-slices>[:spot]`` — the
  optional 4th field marks a reclaimable spot/preemptible pool);
- a ConfigMap with the same format under ``data["fleet"]``
  (``KFTPU_FLEET_CONFIGMAP``, loaded by the runtime);
- ``KFTPU_FLEET=auto``: inferred from Node objects' GKE labels
  (``from_nodes``) — one pool per ``cloud.google.com/gke-nodepool``;
  nodes carrying ``cloud.google.com/gke-spot=true`` mark their pool
  spot. GPU nodes carry no slice-shape label (a TPU node carries
  ``gke-tpu-topology``), so each node counts as one ``1x<cards a
  node>`` slice of its node type; a pool of multi-node slices is
  declared in ``KFTPU_FLEET`` or the ConfigMap.

Elastic extension (kubeflow_tpu_torch/scheduler/elastic.py): with
``KFTPU_ELASTIC`` on, a single-node gang that fits no pool of its own
shape may *borrow* a node from a same-accelerator pool of another
shape. A borrow takes a whole node, as the reference's takes a whole
TPU host, so a ``1x1`` gang on a ``1x8`` pool books all 8 of its cards
out of the native capacity. Borrowed hosts are tracked host-granular (``ChipLedger.
borrowed``); each pool's borrowed hosts break ``ceil(borrowed /
hosts_per_slice)`` whole slices out of its native capacity — that is
the fragmentation the defragmenter exists to undo. With no borrows the
accounting below is bit-identical to the pre-elastic ledger.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

from kubeflow_tpu_torch.gpu.topology import (
    ACCELERATORS,
    GKE_ACCELERATOR_LABEL,
    GpuSlice,
    TopologyError,
)

GKE_NODEPOOL_LABEL = "cloud.google.com/gke-nodepool"
# GKE's well-known spot/preemptible marker on Nodes.
GKE_SPOT_LABEL = "cloud.google.com/gke-spot"

# Pool names feed metric labels, debug rows, and (auto mode) come from
# nodepool names — hold them to the same DNS-1123-ish contract so a typo
# like "pool a" or an empty name fails at parse time, not as a confusing
# ledger key later.
_POOL_NAME_RE = re.compile(r"^[a-z0-9]([-a-z0-9._]*[a-z0-9])?$",
                           re.IGNORECASE)


class FleetConfigError(ValueError):
    """Malformed fleet specification."""


class LedgerError(RuntimeError):
    """A ledger invariant would be violated (admitted > capacity, double
    admission, partial release). Raised, never swallowed — the policy layer
    must make these impossible; the bench counts raises (must be zero)."""


@dataclass(frozen=True)
class NodePool:
    """One GPU node pool: ``num_slices`` slices of one shape. ``spot``
    marks reclaimable (preemptible) capacity: the elastic runtime drains
    its gangs through the checkpoint protocol when a revocation signal
    lands, instead of letting the node teardown kill work in flight."""

    name: str
    accelerator: str       # GKE node type: nvidia-h100-80gb | ...
    topology: str          # slice shape, <nodes>x<cards a node>: "2x8"
    num_slices: int
    spot: bool = False

    def __post_init__(self):
        if not self.name or not _POOL_NAME_RE.match(self.name):
            raise FleetConfigError(
                f"bad pool name {self.name!r}: pool names must be "
                "non-empty and use only letters, digits, '-', '_', '.' "
                "(they become ledger keys, metric labels and nodepool "
                "references)")
        if self.num_slices < 1:
            raise FleetConfigError(
                f"pool {self.name}: num_slices must be >= 1, "
                f"got {self.num_slices}")
        # Validates accelerator/topology; raises TopologyError on garbage.
        GpuSlice.parse(self.accelerator, self.topology)

    @property
    def slice_shape(self) -> GpuSlice:
        return GpuSlice.parse(self.accelerator, self.topology)

    @property
    def chips_per_slice(self) -> int:
        return self.slice_shape.num_chips

    @property
    def hosts_per_slice(self) -> int:
        return self.slice_shape.num_hosts

    @property
    def chips_per_host(self) -> int:
        return self.slice_shape.chips_per_host

    @property
    def total_chips(self) -> int:
        return self.num_slices * self.chips_per_slice

    @property
    def shape_key(self) -> tuple[str, str]:
        return (self.accelerator.lower(), self.topology.lower())


@dataclass(frozen=True)
class Fleet:
    """Immutable pool inventory, keyed by pool name."""

    pools: tuple[NodePool, ...] = ()

    @classmethod
    def parse(cls, spec: str) -> "Fleet":
        """``a3=nvidia-h100-80gb:2x8:2,cheap=nvidia-h100-80gb:1x8:4:spot``
        → Fleet. Empty/
        None spec → empty fleet (scheduler passes everything through).
        The optional 4th field marks a spot (reclaimable) pool.

        Duplicate pool names are a hard error, not last-wins: the ledger
        resolves placements by name, so two entries under one name would
        silently sell one pool's capacity twice. The error names both
        entry positions so the operator can find the clash in a long
        spec."""
        pools: list[NodePool] = []
        seen: dict[str, int] = {}   # pool name → 1-based entry position
        position = 0
        for raw in (spec or "").replace("\n", ",").split(","):
            entry = raw.strip()
            if not entry:
                continue
            position += 1
            name, sep, shape = entry.partition("=")
            parts = shape.split(":")
            if not sep or len(parts) not in (3, 4):
                raise FleetConfigError(
                    f"bad fleet entry {entry!r}: want "
                    "<name>=<accelerator>:<shape>:<num-slices>[:spot]")
            acc, topo, n = (p.strip() for p in parts[:3])
            spot = False
            if len(parts) == 4:
                flag = parts[3].strip().lower()
                if flag == "spot":
                    spot = True
                elif flag not in ("", "reserved", "on-demand"):
                    raise FleetConfigError(
                        f"bad fleet entry {entry!r}: unknown pool flag "
                        f"{parts[3].strip()!r} — the 4th field is 'spot' "
                        "(reclaimable capacity) or omitted")
            try:
                num = int(n)
            except ValueError:
                raise FleetConfigError(
                    f"bad fleet entry {entry!r}: slice count {n!r} is not "
                    "an integer") from None
            name = name.strip()
            if name in seen:
                raise FleetConfigError(
                    f"duplicate pool name {name!r} (entries {seen[name]} "
                    f"and {position}): each pool must appear exactly once "
                    "— merge the slice counts into one entry or rename "
                    "one of the pools")
            seen[name] = position
            try:
                pools.append(NodePool(name, acc.lower(), topo.lower(), num,
                                      spot=spot))
            except TopologyError as e:
                raise FleetConfigError(f"bad fleet entry {entry!r}: {e}") \
                    from None
        return cls(pools=tuple(sorted(pools, key=lambda p: p.name)))

    @classmethod
    def from_nodes(cls, nodes: list[dict]) -> "Fleet":
        """Infer pools from Node objects' GKE labels: nodes sharing a
        ``gke-nodepool`` label and a node type form one pool. A GPU node
        carries its node type (``gke-accelerator``) and no slice shape,
        so each node is one ``1x<cards a node>`` slice, its cards taken
        from the node type's row of ``gpu.topology.ACCELERATORS``; nodes
        of an unknown type are skipped."""
        hosts: dict[tuple[str, str, str], int] = {}
        spot_pools: set[str] = set()
        for node in nodes:
            labels = ((node.get("metadata") or {}).get("labels")) or {}
            acc_row = ACCELERATORS.get(
                (labels.get(GKE_ACCELERATOR_LABEL) or "").lower())
            if acc_row is None:
                continue
            acc = acc_row.name
            topo = f"1x{acc_row.gpus_per_node}"
            pool = labels.get(GKE_NODEPOOL_LABEL) or f"{acc}-{topo}"
            hosts[(pool, acc, topo.lower())] = \
                hosts.get((pool, acc, topo.lower()), 0) + 1
            if labels.get(GKE_SPOT_LABEL) == "true":
                # ANY spot node marks the pool spot: treating a mixed
                # pool as reclaimable errs toward draining through the
                # checkpoint protocol — the safe direction.
                spot_pools.add(pool)
        # A nodepool label carrying two node types (mid-migration label
        # drift) must not yield two same-named pools: the ledger resolves
        # placements by name, and the collision would make every admit of
        # the second shape a LedgerError. Disambiguate with the shape —
        # but count only shapes that survive the whole-slice/parse
        # filters: a stray partial-slice or unparsable shape must not
        # rename the real pool (the rename would look like a fleet change
        # and rebind-churn every allocation booked on it).
        survivors = []
        name_shapes: dict[str, int] = {}
        for (pool, acc, topo), count in sorted(hosts.items()):
            try:
                per_slice = GpuSlice.parse(acc, topo).num_hosts
            except TopologyError:
                continue
            num_slices = count // per_slice
            if num_slices >= 1:
                survivors.append((pool, acc, topo, num_slices))
                name_shapes[pool] = name_shapes.get(pool, 0) + 1
        pools = []
        for pool, acc, topo, num_slices in survivors:
            name = (f"{pool}-{acc}-{topo}" if name_shapes[pool] > 1
                    else pool)
            try:
                pools.append(NodePool(name, acc, topo, num_slices,
                                      spot=pool in spot_pools))
            except FleetConfigError:
                # A garbage nodepool label must not wedge fleet
                # inference for the healthy pools.
                continue
        return cls(pools=tuple(pools))

    def by_name(self, name: str) -> NodePool | None:
        for p in self.pools:
            if p.name == name:
                return p
        return None

    def matching(self, accelerator: str, topology: str) -> list[NodePool]:
        """Pools that can host slices of this shape, name-sorted (the
        deterministic allocation order)."""
        key = (accelerator.lower(), topology.lower())
        return [p for p in self.pools if p.shape_key == key]

    def total_slices(self, accelerator: str, topology: str) -> int:
        """Whole-fleet ceiling for one shape — the webhook's can-never-fit
        check compares a gang's num_slices against this."""
        return sum(p.num_slices for p in self.matching(accelerator, topology))

    @property
    def total_chips(self) -> int:
        return sum(p.total_chips for p in self.pools)


@dataclass
class Allocation:
    """One admitted gang: the notebook's FULL slice set, spread over
    matching pools. ``placements`` maps pool name → slices taken there;
    its values always sum to the request's num_slices (gang atomicity —
    checked at admit time and by ``ChipLedger.assert_consistent``).

    Elastic flex placement (``borrow``): a single-host gang seated on a
    same-accelerator pool of a DIFFERENT shape occupies whole hosts, not
    slices — ``borrow`` maps pool name → hosts and ``placements`` is
    empty. Gang atomicity then means the borrow hosts sum to the gang's
    host count."""

    key: tuple              # (namespace, name)
    namespace: str
    accelerator: str
    topology: str
    num_slices: int
    chips: int
    placements: dict[str, int]
    priority: int = 0
    admitted_at: float = 0.0
    # Culling's last-activity signal (idle-preemption ranking); None means
    # "no probe data yet" and is never treated as idle.
    last_active_at: float | None = None
    # True for a gang force-admitted by reclaim() over a fleet that no
    # longer has room for it (controller restart after the fleet shrank):
    # its pods exist, so the ledger records it as a deliberate overcommit
    # and assert_consistent exempts its pools from the capacity check.
    forced: bool = False
    # Deferred preemption (kubeflow_tpu_torch/migration): a drain was requested
    # for this gang — it still holds its chips while it checkpoints, but
    # the victim search treats its capacity as incoming-free (no second
    # gang is drained for slices already on their way out) and never
    # re-picks it as a victim.
    draining: bool = False
    # Elastic flex placement: pool → borrowed hosts (see class docstring).
    # None/empty for every native (slice-granular) allocation.
    borrow: dict[str, int] | None = None
    # Workload class ("notebook" | "serving", kubeflow_tpu_torch/serving):
    # serving replicas are never preemption victims — no notebook
    # activity signal exists for them, so the idle heuristic would
    # misread a loaded service as idle, and their capacity is the
    # serving autoscaler's to give back. Default keeps the pre-serving
    # ledger bit-identical.
    workload: str = "notebook"

    @property
    def borrowed(self) -> bool:
        return bool(self.borrow)


@dataclass
class ChipLedger:
    """Admitted-vs-free accounting over a Fleet. All mutation goes through
    ``admit``/``release``; both enforce the invariants and raise
    LedgerError (counted in ``violations``) rather than record a bad
    state."""

    fleet: Fleet
    used: dict[str, int] = field(default_factory=dict)        # pool → slices
    allocations: dict[tuple, Allocation] = field(default_factory=dict)
    ns_chips: dict[str, int] = field(default_factory=dict)    # ns → chips
    # Elastic flex placement: pool → hosts borrowed by foreign-shape
    # single-host gangs. Empty (and the accounting below bit-identical
    # to pre-elastic) unless the elastic pass admits borrows.
    borrowed: dict[str, int] = field(default_factory=dict)
    # Pools that must sell NOTHING right now: a spot pool mid-reclaim
    # (its nodes carry a revocation signal) offers zero free slices and
    # zero borrowable hosts until the signal clears or the fleet source
    # drops the pool. Existing holders keep their booking — the drain
    # protocol vacates them. Empty unless the elastic runtime marks it.
    unavailable: set = field(default_factory=set)
    violations: int = 0

    def broken_slices(self, pool: NodePool) -> int:
        """Whole native slices a pool's borrowed hosts put out of
        service. Borrowers are packed onto the fewest slices, so the
        breakage is the ceiling, not one slice per borrower."""
        hosts = self.borrowed.get(pool.name, 0)
        return math.ceil(hosts / pool.hosts_per_slice) if hosts else 0

    def free_slices(self, pool: NodePool) -> int:
        if pool.name in self.unavailable:
            return 0
        return pool.num_slices - self.used.get(pool.name, 0) \
            - self.broken_slices(pool)

    def free_hosts(self, pool: NodePool) -> int:
        """Hosts available for elastic borrowing: everything not under a
        native slice allocation and not already borrowed."""
        if pool.name in self.unavailable:
            return 0
        native_hosts = self.used.get(pool.name, 0) * pool.hosts_per_slice
        return pool.num_slices * pool.hosts_per_slice - native_hosts \
            - self.borrowed.get(pool.name, 0)

    def fit(self, accelerator: str, topology: str,
            num_slices: int) -> dict[str, int] | None:
        """All-or-nothing placement plan for a gang: spread num_slices
        over matching pools in name order, or None if the whole gang
        cannot fit right now. Never returns a partial plan."""
        plan: dict[str, int] = {}
        remaining = num_slices
        for pool in self.fleet.matching(accelerator, topology):
            if remaining == 0:
                break
            take = min(self.free_slices(pool), remaining)
            if take > 0:
                plan[pool.name] = take
                remaining -= take
        return plan if remaining == 0 else None

    def borrow_fit(self, accelerator: str, topology: str,
                   *, avoid_new_break_shapes: frozenset = frozenset(),
                   prefer: str | None = None) -> dict | None:
        """Host-borrow plan (``{pool: 1}``) for ONE single-host slice of
        this shape — the elastic flex unit. Same-accelerator pools of a
        DIFFERENT shape with a free host and enough chips per host;
        prefers a pool where the borrow breaks no NEW slice (pack
        borrowers together), then name order. Pools whose native shape
        is in ``avoid_new_break_shapes`` accept no new breakage. None
        for multi-host or multi-slice shapes — a foreign pool can host a
        whole single-node slice, never a slice split across nodes."""
        try:
            shape = GpuSlice.parse(accelerator, topology)
        except TopologyError:
            return None
        if shape.num_hosts != 1:
            return None
        candidates = []
        for pool in self.fleet.pools:
            if pool.shape_key == (accelerator.lower(), topology.lower()):
                continue
            if pool.accelerator.lower() != accelerator.lower():
                continue
            if pool.chips_per_host < shape.chips_per_host:
                continue
            if self.free_hosts(pool) < 1:
                continue
            borrowed = self.borrowed.get(pool.name, 0)
            breaks = math.ceil((borrowed + 1) / pool.hosts_per_slice) \
                > math.ceil(borrowed / pool.hosts_per_slice)
            if breaks and pool.shape_key in avoid_new_break_shapes:
                continue
            # ``prefer`` (a restart's durable flex-pool hint) outranks
            # the no-new-break preference: the pods are already THERE.
            candidates.append((pool.name != prefer, breaks, pool.name))
        if not candidates:
            return None
        candidates.sort()
        return {candidates[0][-1]: 1}

    def admit(self, alloc: Allocation, *, force: bool = False) -> None:
        """Record one whole gang. ``force=True`` is the reclaim path
        (controller restart over a fleet that no longer has room): the
        per-pool capacity check — and ONLY it — is skipped, because the
        gang's pods already run; gang atomicity and no-double-admit
        still hold. The allocation is marked ``forced`` so
        ``assert_consistent`` treats the resulting over-capacity pools
        as overcommit, not as ledger drift; it drains on release."""
        if alloc.key in self.allocations:
            self.violations += 1
            raise LedgerError(f"{alloc.key} is already admitted")
        if alloc.borrowed:
            self._admit_borrow(alloc)
            return
        if sum(alloc.placements.values()) != alloc.num_slices:
            self.violations += 1
            raise LedgerError(
                f"{alloc.key}: partial gang ({alloc.placements} vs "
                f"{alloc.num_slices} slices) — gangs admit all-or-nothing")
        if force:
            alloc.forced = True
        else:
            for pool_name, n in alloc.placements.items():
                pool = self.fleet.by_name(pool_name)
                if pool is None or pool.shape_key != (
                        alloc.accelerator.lower(), alloc.topology.lower()):
                    self.violations += 1
                    raise LedgerError(
                        f"{alloc.key}: placement on unknown/mismatched "
                        f"pool {pool_name!r}")
                if self.used.get(pool_name, 0) + n > \
                        pool.num_slices - self.broken_slices(pool):
                    self.violations += 1
                    raise LedgerError(
                        f"{alloc.key}: pool {pool_name} over capacity "
                        f"({self.used.get(pool_name, 0)}+{n} > "
                        f"{pool.num_slices} slices, "
                        f"{self.broken_slices(pool)} broken by borrows)")
        for pool_name, n in alloc.placements.items():
            self.used[pool_name] = self.used.get(pool_name, 0) + n
        self.allocations[alloc.key] = alloc
        self.ns_chips[alloc.namespace] = \
            self.ns_chips.get(alloc.namespace, 0) + alloc.chips

    def _admit_borrow(self, alloc: Allocation) -> None:
        """Record an elastic flex (host-borrowing) gang. The invariants
        mirror the native path at host granularity: the borrow set must
        cover the gang's whole host count (atomicity), land on known
        same-accelerator pools, and fit the pools' free hosts."""
        shape = GpuSlice.parse(alloc.accelerator, alloc.topology)
        want_hosts = shape.num_hosts * alloc.num_slices
        if sum(alloc.borrow.values()) != want_hosts:
            self.violations += 1
            raise LedgerError(
                f"{alloc.key}: partial borrow ({alloc.borrow} vs "
                f"{want_hosts} host(s)) — gangs admit all-or-nothing")
        for pool_name, hosts in alloc.borrow.items():
            pool = self.fleet.by_name(pool_name)
            if pool is None \
                    or pool.accelerator.lower() != alloc.accelerator.lower():
                self.violations += 1
                raise LedgerError(
                    f"{alloc.key}: borrow on unknown/mismatched pool "
                    f"{pool_name!r}")
            if hosts > self.free_hosts(pool):
                self.violations += 1
                raise LedgerError(
                    f"{alloc.key}: pool {pool_name} has "
                    f"{self.free_hosts(pool)} free host(s), borrow wants "
                    f"{hosts}")
        for pool_name, hosts in alloc.borrow.items():
            self.borrowed[pool_name] = \
                self.borrowed.get(pool_name, 0) + hosts
        self.allocations[alloc.key] = alloc
        self.ns_chips[alloc.namespace] = \
            self.ns_chips.get(alloc.namespace, 0) + alloc.chips

    def release(self, key: tuple) -> Allocation | None:
        alloc = self.allocations.pop(key, None)
        if alloc is None:
            return None
        for pool_name, hosts in (alloc.borrow or {}).items():
            left = self.borrowed.get(pool_name, 0) - hosts
            if left < 0:
                self.violations += 1
                raise LedgerError(
                    f"{key}: releasing more borrowed hosts than admitted "
                    f"on {pool_name}")
            if left:
                self.borrowed[pool_name] = left
            else:
                self.borrowed.pop(pool_name, None)
        for pool_name, n in alloc.placements.items():
            left = self.used.get(pool_name, 0) - n
            if left < 0:
                self.violations += 1
                raise LedgerError(
                    f"{key}: releasing more slices than admitted on "
                    f"{pool_name}")
            if left:
                self.used[pool_name] = left
            else:
                self.used.pop(pool_name, None)
        left_chips = self.ns_chips.get(alloc.namespace, 0) - alloc.chips
        if left_chips:
            self.ns_chips[alloc.namespace] = left_chips
        else:
            self.ns_chips.pop(alloc.namespace, None)
        return alloc

    def admitted_chips_by_pool(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for pool in self.fleet.pools:
            chips = self.used.get(pool.name, 0) * pool.chips_per_slice \
                + self.borrowed.get(pool.name, 0) * pool.chips_per_host
            if chips:
                out[pool.name] = chips
        return out

    def assert_consistent(self) -> None:
        """Recompute used/borrowed/ns_chips from the allocations and
        compare — the property test calls this after every step."""
        used: dict[str, int] = {}
        borrowed: dict[str, int] = {}
        ns: dict[str, int] = {}
        for alloc in self.allocations.values():
            if alloc.borrowed:
                for pool_name, hosts in alloc.borrow.items():
                    borrowed[pool_name] = borrowed.get(pool_name, 0) + hosts
                ns[alloc.namespace] = \
                    ns.get(alloc.namespace, 0) + alloc.chips
                continue
            if sum(alloc.placements.values()) != alloc.num_slices:
                raise LedgerError(f"{alloc.key}: partial gang recorded")
            for pool_name, n in alloc.placements.items():
                used[pool_name] = used.get(pool_name, 0) + n
            ns[alloc.namespace] = ns.get(alloc.namespace, 0) + alloc.chips
        if used != self.used or ns != self.ns_chips \
                or borrowed != self.borrowed:
            raise LedgerError(
                f"ledger drift: used {self.used} vs {used}, borrowed "
                f"{self.borrowed} vs {borrowed}, "
                f"ns_chips {self.ns_chips} vs {ns}")
        # Pools carrying a force-admitted (reclaimed-with-overcommit)
        # gang are legitimately over capacity until it releases.
        forced_pools = {
            pool_name
            for alloc in self.allocations.values() if alloc.forced
            for pool_name in alloc.placements
        }
        for pool in self.fleet.pools:
            if pool.name in forced_pools:
                continue
            if used.get(pool.name, 0) + self.broken_slices(pool) \
                    > pool.num_slices:
                raise LedgerError(
                    f"pool {pool.name} over capacity: "
                    f"{used.get(pool.name, 0)} native + "
                    f"{self.broken_slices(pool)} borrow-broken > "
                    f"{pool.num_slices}")
