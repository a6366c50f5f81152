"""The port's fleet model and card ledger (``kubeflow_tpu_torch/scheduler/
fleet.py``): ``Fleet.parse`` on GPU specs, ``Fleet.from_nodes`` on GPU
node labels, and the ledger's two hard invariants — capacity and gang
atomicity — as hypothesis properties over random admit/release/borrow
sequences, as tests/test_scheduler.py drives the reference's ledger.
"""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kubeflow_tpu_torch.gpu.topology import GKE_ACCELERATOR_LABEL, GpuSlice
from kubeflow_tpu_torch.scheduler import (
    Fleet,
    FleetConfigError,
    LedgerError,
)
from kubeflow_tpu_torch.scheduler.fleet import (
    GKE_NODEPOOL_LABEL,
    GKE_SPOT_LABEL,
    Allocation,
    ChipLedger,
)

H100 = "nvidia-h100-80gb"
MEGA = "nvidia-h100-mega-80gb"


def _alloc(key, shape, placements=None, *, slices=1, borrow=None, ns="ns"):
    gpu = GpuSlice.parse(H100, shape)
    return Allocation(key=key, namespace=ns, accelerator=H100,
                      topology=shape, num_slices=slices,
                      chips=gpu.num_chips * slices,
                      placements=placements or {}, borrow=borrow)


# ---- Fleet.parse -------------------------------------------------------------


def test_fleet_parse_gpu_spec_roundtrip():
    f = Fleet.parse(f"b={H100}:2x8:4, a={H100}:1x8:2,"
                    f"cheap={MEGA}:1x8:3:spot")
    assert [p.name for p in f.pools] == ["a", "b", "cheap"]
    assert f.by_name("a").chips_per_slice == 8
    assert f.by_name("b").chips_per_slice == 16
    assert f.by_name("b").hosts_per_slice == 2
    assert f.by_name("b").chips_per_host == 8
    assert f.by_name("cheap").spot and not f.by_name("a").spot
    assert f.total_chips == 2 * 8 + 4 * 16 + 3 * 8
    assert f.total_slices(H100, "2x8") == 4
    assert f.total_slices(H100, "4x8") == 0
    # Sub-node shapes are pool shapes too.
    assert Fleet.parse(f"s={H100}:1x1:8").by_name("s").chips_per_slice == 1
    assert Fleet.parse("") == Fleet()


@pytest.mark.parametrize("spec,match", [
    ("nope", "want"),
    (f"a={H100}:1x8", "want"),
    (f"a={H100}:1x8:x", "not an integer"),
    ("a=v5e:4x4:1", "unknown accelerator"),
    (f"a={H100}:1x16:1", "does not fit one"),
    (f"a={H100}:2x4:1", "whole"),
    (f"a={H100}:2x2x2:1", "<nodes>x<gpus per node>"),
    (f"a={H100}:1x8:1,a={H100}:2x8:1", "duplicate pool name"),
    (f"a={H100}:1x8:0", "num_slices must be >= 1"),
    (f"a={H100}:1x8:1:preemptible", "unknown pool flag"),
    (f"pool a={H100}:1x8:1", "bad pool name"),
])
def test_fleet_parse_rejects_garbage(spec, match):
    with pytest.raises(FleetConfigError, match=match):
        Fleet.parse(spec)


# ---- Fleet.from_nodes ----------------------------------------------------------


def _node(name, pool=None, acc=H100, spot=False):
    labels = {GKE_ACCELERATOR_LABEL: acc} if acc else {}
    if pool:
        labels[GKE_NODEPOOL_LABEL] = pool
    if spot:
        labels[GKE_SPOT_LABEL] = "true"
    return {"metadata": {"name": name, "labels": labels}}


def test_from_nodes_infers_one_whole_node_slice_a_node():
    nodes = [_node(f"a{i}", "a3") for i in range(3)]
    nodes += [_node("m0", "mega", MEGA)]
    nodes += [_node("cpu", "cpu-pool", None)]            # no GPU label
    nodes += [_node("odd", "odd", "nvidia-l4")]          # unknown node type
    f = Fleet.from_nodes(nodes)
    assert [(p.name, p.accelerator, p.topology, p.num_slices)
            for p in f.pools] == [("a3", H100, "1x8", 3),
                                  ("mega", MEGA, "1x8", 1)]
    assert f.total_chips == 4 * 8


def test_from_nodes_spot_marks_and_nodepool_names():
    nodes = [_node("s0", "cheap", spot=True), _node("s1", "cheap"),
             _node("r0", "res"), _node("x0", None), _node("x1", None),
             _node("bad0", "Not A Pool!")]
    f = Fleet.from_nodes(nodes)
    # ANY spot node marks its pool spot; a node without a nodepool label
    # lands in the <node type>-<shape> pool; a nodepool name that is no
    # valid pool name drops only its own nodes.
    assert {p.name: (p.num_slices, p.spot) for p in f.pools} == {
        "cheap": (2, True), "res": (1, False),
        f"{H100}-1x8": (2, False)}
    # One nodepool label over two node types names a pool each.
    mixed = Fleet.from_nodes([_node("a", "drift"),
                              _node("b", "drift", MEGA)])
    assert sorted(p.name for p in mixed.pools) == [
        f"drift-{H100}-1x8", f"drift-{MEGA}-1x8"]
    ledger = ChipLedger(mixed)
    for pool in mixed.pools:
        ledger.admit(Allocation(
            key=("ns", pool.name), namespace="ns",
            accelerator=pool.accelerator, topology=pool.topology,
            num_slices=1, chips=8, placements={pool.name: 1}))
    ledger.assert_consistent()


# ---- ChipLedger ----------------------------------------------------------------


def test_ledger_rejects_partial_gang_double_admit_and_overfill():
    ledger = ChipLedger(Fleet.parse(f"a={H100}:2x8:2"))
    good = _alloc(("ns", "x"), "2x8", {"a": 2}, slices=2)
    ledger.admit(good)
    with pytest.raises(LedgerError, match="already admitted"):
        ledger.admit(good)
    ledger.release(("ns", "x"))
    with pytest.raises(LedgerError, match="partial gang"):
        ledger.admit(_alloc(("ns", "y"), "2x8", {"a": 1}, slices=2))
    with pytest.raises(LedgerError, match="over capacity"):
        ledger.admit(_alloc(("ns", "z"), "2x8", {"a": 3}, slices=3))
    with pytest.raises(LedgerError, match="mismatched"):
        ledger.admit(_alloc(("ns", "w"), "1x8", {"a": 1}))
    assert ledger.violations == 4
    ledger.assert_consistent()


def test_a_borrow_takes_a_whole_node_and_breaks_a_slice():
    """A 1x1 gang borrowed onto a 2x8 pool books one whole node (all 8
    cards of it in the pool's admitted count) and breaks one 2-node
    slice out of the native capacity."""
    ledger = ChipLedger(Fleet.parse(f"pack={H100}:2x8:2"))
    pool = ledger.fleet.by_name("pack")
    plan = ledger.borrow_fit(H100, "1x1")
    assert plan == {"pack": 1}
    ledger.admit(_alloc(("ns", "tiny"), "1x1", borrow=plan))
    assert ledger.free_hosts(pool) == 3
    assert ledger.broken_slices(pool) == 1
    assert ledger.free_slices(pool) == 1
    assert ledger.admitted_chips_by_pool() == {"pack": 8}
    assert ledger.ns_chips == {"ns": 1}
    # The next borrow packs onto the already broken slice.
    assert ledger.borrow_fit(H100, "1x4") == {"pack": 1}
    # Multi-node and multi-slice shapes never borrow.
    assert ledger.borrow_fit(H100, "2x8") is None
    ledger.release(("ns", "tiny"))
    assert ledger.borrowed == {} and ledger.free_slices(pool) == 2
    ledger.assert_consistent()


SHAPES = ["1x1", "1x4", "1x8", "2x8", "4x8"]
FLEET = f"a={H100}:1x8:2,b={H100}:2x8:2,c={H100}:1x4:1,d={H100}:4x8:1"
OPS = st.lists(
    st.tuples(st.sampled_from(["admit", "borrow", "release", "force"]),
              st.sampled_from(SHAPES), st.integers(1, 3),
              st.integers(0, 9)),
    min_size=1, max_size=60)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(OPS)
def test_property_capacity_and_gang_atomicity_hold(ops):
    """Random admit/borrow/release sequences: every admit goes through
    ``fit``/``borrow_fit`` (all-or-nothing), a forged partial or
    over-capacity allocation is refused, and after every step the books
    balance, no pool holds more than its slices, and every gang holds
    its whole slice set (or its whole node count)."""
    fleet = Fleet.parse(FLEET)
    ledger = ChipLedger(fleet)
    live = set()
    for n, (op, shape, slices, pick) in enumerate(ops):
        key = ("ns%d" % (pick % 3), f"g{n}")
        if op == "release" and live:
            gone = sorted(live)[pick % len(live)]
            assert ledger.release(gone).key == gone
            live.discard(gone)
        elif op == "admit":
            plan = ledger.fit(H100, shape, slices)
            if plan is not None:
                assert sum(plan.values()) == slices
                ledger.admit(_alloc(key, shape, plan, slices=slices))
                live.add(key)
        elif op == "borrow":
            plan = ledger.borrow_fit(H100, shape)
            if plan is not None:
                assert GpuSlice.parse(H100, shape).num_hosts == 1
                ledger.admit(_alloc(key, shape, borrow=plan))
                live.add(key)
        elif op == "force":
            # A forged plan one slice short, or one past the pool: the
            # ledger refuses both and records nothing.
            pool = next(iter(fleet.matching(H100, shape)), None)
            if pool is not None:
                before = dict(ledger.used)
                with pytest.raises(LedgerError):
                    ledger.admit(_alloc(key, shape, {pool.name: slices},
                                        slices=slices + 1))
                with pytest.raises(LedgerError):
                    ledger.admit(_alloc(key, shape,
                                        {pool.name: pool.num_slices + 1},
                                        slices=pool.num_slices + 1))
                assert ledger.used == before and key not in ledger.allocations
        ledger.assert_consistent()
        for pool in fleet.pools:
            assert ledger.used.get(pool.name, 0) \
                + ledger.broken_slices(pool) <= pool.num_slices
            assert 0 <= ledger.free_hosts(pool) <= \
                pool.num_slices * pool.hosts_per_slice
        for alloc in ledger.allocations.values():
            if alloc.borrowed:
                assert sum(alloc.borrow.values()) == 1 and not alloc.placements
            else:
                assert sum(alloc.placements.values()) == alloc.num_slices
                assert all(fleet.by_name(p).shape_key
                           == (H100, alloc.topology) for p in alloc.placements)
        assert sum(ledger.ns_chips.values()) == sum(
            a.chips for a in ledger.allocations.values())
    for key in list(ledger.allocations):
        ledger.release(key)
    assert (ledger.used, ledger.borrowed, ledger.ns_chips) == ({}, {}, {})
    assert ledger.violations == sum(2 for op in ops if op[0] == "force"
                                    and fleet.matching(H100, op[1]))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(st.lists(st.sampled_from(SHAPES), min_size=1, max_size=12),
       st.sets(st.sampled_from(["a", "b", "c", "d"])))
def test_property_unavailable_pools_sell_nothing(shapes, down):
    """A pool marked unavailable (a spot pool mid-reclaim) offers no free
    slice and no borrowable node, whatever else is booked."""
    ledger = ChipLedger(Fleet.parse(FLEET))
    ledger.unavailable = set(down)
    for n, shape in enumerate(shapes):
        native = ledger.fit(H100, shape, 1)
        borrow = None if native else ledger.borrow_fit(H100, shape)
        if native is None and borrow is None:
            continue
        assert not set(native or borrow) & set(down)
        ledger.admit(_alloc(("ns", f"g{n}"), shape, native, borrow=borrow))
        ledger.assert_consistent()
    for name in down:
        pool = ledger.fleet.by_name(name)
        assert ledger.free_slices(pool) == 0 and ledger.free_hosts(pool) == 0
