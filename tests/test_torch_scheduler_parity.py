"""The port's scheduler policy against the reference's: the same seeded
arrivals, completions, idle marks, drain acks and ``now``s drive the JAX
package's ``PolicyQueue`` (with ``elastic.overflow_pass``,
``compute_shortfalls``, ``IntentBook`` and ``plan_defrag``) on a TPU
fleet, and the port's on the GPU fleet it maps to. Their decision traces
must be equal key for key: admissions with their placements and borrows,
the queue with each gang's position and reason, preemption victims and
drains, defrag moves, shortfalls and scale-up intents, and the ledger's
books after every pass.

**The shape mapping.** Every pool keeps its name, its slice count and
the nodes (hosts) of each slice; the cards of a node are the chips of a
host times one factor a mapping:

- ``v5e`` → ``nvidia-h100-80gb``, factor 1: ``1x1``/``2x2``/``2x4``
  (one host of 1, 4, 8 chips) → ``1x1``/``1x4``/``1x8``; ``4x4``/
  ``4x8``/``8x8`` (2, 4, 8 hosts of 8) → ``2x8``/``4x8``/``8x8``;
- ``v5p`` → ``nvidia-h100-80gb``, factor 2: ``2x2x1``/``2x2x2``/
  ``2x4x4``/``4x4x4`` (1, 2, 8, 16 hosts of 4) → ``1x8``/``2x8``/
  ``8x8``/``16x8``.

Chip counts (requests, reasons, victims, intents, ``ns_chips``) compare
through the factor; shapes in reasons through the mapping.
"""

import random
import re

import pytest

from kubeflow_tpu.scheduler import elastic as jax_elastic
from kubeflow_tpu.scheduler import policy as jax_policy
from kubeflow_tpu.scheduler.fleet import Fleet as JaxFleet
from kubeflow_tpu.tpu.topology import TpuSlice
from kubeflow_tpu_torch.gpu.topology import GpuSlice
from kubeflow_tpu_torch.scheduler import elastic as gpu_elastic
from kubeflow_tpu_torch.scheduler import policy as gpu_policy
from kubeflow_tpu_torch.scheduler.fleet import Fleet as GpuFleet

H100 = "nvidia-h100-80gb"

MAPPINGS = {
    "v5e": dict(factor=1, shapes={"1x1": "1x1", "2x2": "1x4", "2x4": "1x8",
                                  "4x4": "2x8", "4x8": "4x8", "8x8": "8x8"},
                fleet=[("a", "4x4", 2), ("b", "2x4", 2), ("c", "2x2", 1),
                       ("d", "4x8", 1), ("e", "1x1", 2)],
                # 8x8 matches no pool: it must queue and ask for scale-up.
                asks=["1x1", "2x2", "2x4", "2x4", "4x4", "4x8", "8x8"]),
    "v5p": dict(factor=2, shapes={"2x2x1": "1x8", "2x2x2": "2x8",
                                  "2x4x4": "8x8", "4x4x4": "16x8"},
                fleet=[("a", "2x2x2", 3), ("b", "2x2x1", 2),
                       ("c", "2x4x4", 1)],
                asks=["2x2x1", "2x2x1", "2x2x2", "2x4x4", "4x4x4"]),
}
SEEDS = (0, 1, 2)
STEPS = 160


@pytest.mark.parametrize("acc", sorted(MAPPINGS))
def test_the_mapping_keeps_slices_nodes_and_scales_cards(acc):
    m = MAPPINGS[acc]
    for tpu_topo, gpu_topo in m["shapes"].items():
        tpu = TpuSlice.parse(acc, tpu_topo)
        gpu = GpuSlice.parse(H100, gpu_topo)
        assert gpu.num_hosts == tpu.num_hosts, tpu_topo
        assert gpu.chips_per_host == m["factor"] * tpu.chips_per_host
        assert gpu.num_chips == m["factor"] * tpu.num_chips
    jax_fleet, gpu_fleet = _fleets(acc)
    assert [(p.name, p.num_slices, p.hosts_per_slice, p.spot)
            for p in jax_fleet.pools] == [
        (p.name, p.num_slices, p.hosts_per_slice, p.spot)
        for p in gpu_fleet.pools]
    assert gpu_fleet.total_chips == m["factor"] * jax_fleet.total_chips


def _fleets(acc: str) -> tuple:
    m = MAPPINGS[acc]
    jax_spec = ",".join(f"{n}={acc}:{t}:{k}" for n, t, k in m["fleet"])
    gpu_spec = ",".join(f"{n}={H100}:{m['shapes'][t]}:{k}"
                        for n, t, k in m["fleet"])
    return JaxFleet.parse(jax_spec), GpuFleet.parse(gpu_spec)


class Side:
    """One package's policy core, fed the drive's operations."""

    def __init__(self, policy_mod, elastic_mod, fleet, acc, topo_of,
                 chips_of, deferred):
        self.p, self.e = policy_mod, elastic_mod
        self.acc, self.topo_of, self.chips_of = acc, topo_of, chips_of
        self.q = policy_mod.PolicyQueue(fleet=fleet, config=(
            policy_mod.PolicyConfig(
                aging_seconds=50.0, starvation_reserve_seconds=200.0,
                idle_preempt_after_seconds=300.0,
                deferred_preemption=deferred)))
        self.book = elastic_mod.IntentBook(ttl_seconds=120.0)
        self.defrag = elastic_mod.ElasticConfig(
            defrag_idle_seconds=200.0, defrag_max_moves=2)

    def submit(self, key, ns, tpu_topo, slices, priority, now):
        topo = self.topo_of(tpu_topo)
        self.q.submit(self.p.GangRequest(
            key=key, namespace=ns, accelerator=self.acc, topology=topo,
            num_slices=slices, chips=self.chips_of(topo) * slices,
            priority=priority, submitted_at=now))

    def requeue(self, alloc, now):
        """The runtime's re-queue of a migrated (defragged) gang."""
        self.q.submit(self.p.GangRequest(
            key=alloc.key, namespace=alloc.namespace,
            accelerator=alloc.accelerator, topology=alloc.topology,
            num_slices=alloc.num_slices, chips=alloc.chips,
            priority=alloc.priority, submitted_at=now))

    def step(self, now) -> dict:
        """One arbitration pass, as the runtime runs it: the flex pass
        first, the schedule, the flex pass again, then shortfalls,
        intents and a defrag plan (applied: the migrant is released and
        re-queued, as after its checkpoint ack)."""
        borrows = self.e.overflow_pass(self.q, now)
        result = self.q.schedule(now)
        borrows += self.e.overflow_pass(self.q, now)
        short = self.e.compute_shortfalls(self.q, now)
        sync = self.book.sync(short, self.q.fleet, now)
        moves = self.e.plan_defrag(self.q, self.defrag, now)
        for move in moves:
            alloc = self.q.release(move.key)
            self.requeue(alloc, now)
        self.q.ledger.assert_consistent()
        return {
            "borrows": [(a.key, a.placements) for a in borrows],
            "admitted": [(a.key, a.placements, round(a.waited, 6))
                         for a in result.admitted],
            "preempted": [(p.key, p.reason, p.for_key, p.chips)
                          for p in result.preempted],
            "drains": [(p.key, p.reason, p.for_key, p.chips)
                       for p in result.drains],
            "queue": [(x.key, x.position, x.chips, x.reason)
                      for x in self.q.schedule_preview(now)],
            "shortfalls": sorted(
                (s.accelerator, s.topology, s.slices, s.chips, s.keys)
                for s in short.values()),
            "intents": {
                kind: sorted((i.accelerator, i.topology, i.slices, i.chips,
                              i.for_keys) for i in getattr(sync, kind))
                for kind in ("created", "renewed", "updated")},
            "withdrawn": sorted((i.topology, why)
                                for i, why in sync.withdrawn),
            "defrag": [(m.key, m.source_pool, m.for_key, m.chips)
                       for m in moves],
            "ledger": (dict(sorted(self.q.ledger.used.items())),
                       dict(sorted(self.q.ledger.borrowed.items())),
                       dict(sorted(self.q.ledger.ns_chips.items()))),
        }


def _as_port(trace: dict, acc: str) -> dict:
    """A JAX pass's trace in the port's units (module docstring)."""
    m = MAPPINGS[acc]
    k = m["factor"]

    def reason(text):
        text = re.sub(rf"\b{acc}:([0-9x]+)",
                      lambda g: f"{H100}:{m['shapes'][g.group(1)]}", text)
        return re.sub(r"\b(\d+) chips\b",
                      lambda g: f"{int(g.group(1)) * k} chips", text)

    def shape(topo):
        return m["shapes"][topo]

    used, borrowed, ns_chips = trace["ledger"]
    return {
        **trace,
        "preempted": [(a, r, f, c * k) for a, r, f, c in trace["preempted"]],
        "drains": [(a, r, f, c * k) for a, r, f, c in trace["drains"]],
        "queue": [(key, pos, c * k, reason(why))
                  for key, pos, c, why in trace["queue"]],
        "shortfalls": sorted((H100, shape(t), s, c * k, keys)
                             for _a, t, s, c, keys in trace["shortfalls"]),
        "intents": {kind: sorted((H100, shape(t), s, c * k, keys)
                                 for _a, t, s, c, keys in rows)
                    for kind, rows in trace["intents"].items()},
        "withdrawn": sorted((shape(t), why) for t, why in trace["withdrawn"]),
        "defrag": [(a, p, f, c * k) for a, p, f, c in trace["defrag"]],
        "ledger": (used, borrowed, {n: c * k for n, c in ns_chips.items()}),
    }


def _drive(acc: str, seed: int) -> tuple:
    m = MAPPINGS[acc]
    jax_fleet, gpu_fleet = _fleets(acc)
    deferred = seed % 2 == 1
    jax_side = Side(jax_policy, jax_elastic, jax_fleet, acc, lambda t: t,
                    lambda t: TpuSlice.parse(acc, t).num_chips, deferred)
    gpu_side = Side(gpu_policy, gpu_elastic, gpu_fleet, H100,
                    lambda t: m["shapes"][t],
                    lambda t: GpuSlice.parse(H100, t).num_chips, deferred)
    sides = (jax_side, gpu_side)
    rng = random.Random(seed)
    now, counter, traces = 0.0, 0, []
    for _ in range(STEPS):
        now += rng.uniform(0.5, 40.0)
        op = rng.random()
        ledger = jax_side.q.ledger
        if op < 0.40:
            counter += 1
            ns = f"ns{rng.randrange(3)}"
            args = ((ns, f"nb{counter}"), ns, rng.choice(m["asks"]),
                    rng.choice([1, 1, 1, 2]), rng.choice([0, 0, 100, -100]),
                    now)
            for side in sides:
                side.submit(*args)
        elif op < 0.60 and ledger.allocations:
            key = rng.choice(sorted(ledger.allocations))
            for side in sides:
                side.q.release(key)
        elif op < 0.68 and jax_side.q.pending:
            key = rng.choice(sorted(jax_side.q.pending))
            for side in sides:
                side.q.release(key)
        elif op < 0.88 and ledger.allocations:
            key = rng.choice(sorted(ledger.allocations))
            idle_since = now - rng.uniform(0.0, 900.0)
            for side in sides:
                side.q.touch(key, idle_since)
        draining = sorted(k for k, a in ledger.allocations.items()
                          if a.draining)
        if draining and rng.random() < 0.5:
            # The victim's checkpoint ack: its chips come free.
            key = rng.choice(draining)
            for side in sides:
                side.q.release(key)
        traces.append((jax_side.step(now), gpu_side.step(now)))
    return traces, jax_side, gpu_side


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("acc", sorted(MAPPINGS))
def test_decision_traces_are_equal_through_the_mapping(acc, seed):
    traces, jax_side, gpu_side = _drive(acc, seed)
    for n, (jax_trace, gpu_trace) in enumerate(traces):
        assert gpu_trace == _as_port(jax_trace, acc), f"pass {n}"
    assert jax_side.q.ledger.violations == gpu_side.q.ledger.violations == 0
    # The drive reached every kind of decision the traces compare.
    seen = {kind for jax_trace, _ in traces for kind in (
        "borrows", "admitted", "preempted", "drains", "queue", "shortfalls",
        "defrag") if jax_trace[kind]}
    seen |= {"intents"} if any(t["intents"]["created"]
                               for t, _ in traces) else set()
    assert {"borrows", "admitted", "queue", "shortfalls",
            "intents"} <= seen, seen
    assert ("drains" if seed % 2 else "preempted") in seen, seen
