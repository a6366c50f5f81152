"""The port's expert-parallel MoE layer against the JAX package's.

Inputs come from a numpy seed and go through both sides as the same
numbers; the JAX layer runs on one CPU device (a 1x1 ("data", "expert")
mesh, as bench.py runs it on one chip), the port's on CPU tensors with
``mesh=None``. f32 throughout: the two sides differ in summation order
only, so the routing decisions are the same and are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from kubeflow_tpu.parallel import moe as jax_moe
from kubeflow_tpu_torch.parallel import moe

torch.set_num_threads(1)

# f32 values that differ only in summation order (measured on the layer
# cases: y and aux within 2.3e-7, each gradient within 4.1e-7 of its
# largest magnitude).
RTOL, ATOL = 1e-5, 1e-6


def _rng(seed):
    return np.random.default_rng(seed)


def _to_np(t):
    return t.detach().numpy()


def _assert_choices_equal(got, want):
    assert len(got) == len(want)
    for (e, pos, gate, keep), (je, jpos, jgate, jkeep) in zip(got, want):
        np.testing.assert_array_equal(_to_np(e), np.asarray(je))
        np.testing.assert_array_equal(_to_np(pos), np.asarray(jpos))
        np.testing.assert_array_equal(_to_np(keep), np.asarray(jkeep))
        np.testing.assert_allclose(_to_np(gate), np.asarray(jgate),
                                   rtol=RTOL, atol=ATOL)


# (name, tokens, experts, capacity, k, logits): random logits with room to
# spare; the same under capacity pressure (drops); integer-valued logits
# from {0, 1, 2}, whose exact ties fall to the lower expert index as in
# jax.lax.top_k; one row of all-equal logits among them.
def _logits(kind, t, e, seed=0):
    rng = _rng(seed)
    if kind == "ties":
        x = rng.integers(0, 3, (t, e)).astype(np.float32)
        x[0] = 1.0
        return x
    return rng.normal(size=(t, e)).astype(np.float32) * 2.0


ROUTER_CASES = {
    "k1_room": ("random", 32, 4, 16, 1),
    "k1_pressure": ("random", 32, 4, 5, 1),
    "k2_room": ("random", 32, 4, 32, 2),
    "k2_pressure": ("random", 32, 4, 9, 2),
    "k1_ties": ("ties", 48, 4, 10, 1),
    "k2_ties": ("ties", 48, 4, 20, 2),
    "k2_ties_8_experts": ("ties", 64, 8, 12, 2),
}


@pytest.mark.parametrize("case", sorted(ROUTER_CASES))
def test_router_slots_match_jax(case):
    kind, t, e, capacity, k = ROUTER_CASES[case]
    logits = _logits(kind, t, e)
    want, wprobs, widx = jax_moe.router_slots(jnp.asarray(logits), e,
                                              capacity, k=k)
    got, probs, idx = moe.router_slots(torch.from_numpy(logits), e,
                                       capacity, k=k)
    _assert_choices_equal(got, want)
    np.testing.assert_array_equal(_to_np(idx), np.asarray(widx))
    np.testing.assert_allclose(_to_np(probs), np.asarray(wprobs), rtol=RTOL,
                               atol=ATOL)
    if "pressure" in case:       # the case drops choices
        assert not all(bool(keep.all()) for *_, keep in got)


def test_top_k_puts_the_lower_index_first_among_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.2, 0.4, 0.0]])
    values, idx = moe.top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 3], [0, 1, 2], [0, 2, 1]]
    _, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(values.numpy(),
                                  np.take_along_axis(probs.numpy(),
                                                     idx.numpy(), 1))


@pytest.mark.parametrize("case", ["k1_pressure", "k2_pressure", "k2_ties"])
def test_router_dispatch_and_load_balancing_loss_match_jax(case):
    kind, t, e, capacity, k = ROUTER_CASES[case]
    logits = _logits(kind, t, e, seed=1)
    want = jax_moe.router_dispatch(jnp.asarray(logits), e, capacity, k=k)
    got = moe.router_dispatch(torch.from_numpy(logits), e, capacity, k=k)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_to_np(g), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    _, _, probs, idx = got
    np.testing.assert_allclose(
        float(moe.load_balancing_loss(probs, idx, e)),
        float(jax_moe.load_balancing_loss(want[2], want[3], e)),
        rtol=RTOL)


def test_router_dispatch_capacity_and_positions():
    """tests/test_moe.py's first case, on the port."""
    logits = torch.tensor([[9.0, 0.0], [9.0, 0.0], [9.0, 0.0], [0.0, 9.0]])
    dispatch, _, probs, idx = moe.router_dispatch(logits, 2, capacity=2)
    assert idx.tolist() == [0, 0, 0, 1]
    assert [float(dispatch[i].sum()) for i in range(4)] == [1, 1, 0, 1]
    assert float(dispatch[3, 1, 0]) == 1
    assert float(moe.load_balancing_loss(probs, idx, 2)) > 0


def test_kept_choice_with_zero_gate_keeps_gate_gradient():
    """The port of tests/test_moe.py's case: the combine masks the gate
    gradient on the router's keep flags, not on ``all_scales > 0``: a kept
    choice whose gate is exactly 0.0 keeps the <dy, expert output>
    gradient, and a dropped one gets none."""
    d, n_seats = 4, 6
    out_flat = torch.arange(n_seats * d, dtype=torch.float32).reshape(
        n_seats, d)
    all_slots = torch.tensor([[1, 3]])
    seat_tok = torch.zeros((n_seats,), dtype=torch.int64)
    seat_scale = torch.zeros((n_seats,))
    seat_scale[1] = 0.5

    def dscale(keep):
        scales = torch.tensor([[0.5, 0.0]], requires_grad=True)
        y = moe._CombineGather.apply(out_flat, all_slots, scales,
                                     torch.tensor([keep]), seat_tok,
                                     seat_scale)
        y.sum().backward()
        return scales.grad

    kept = dscale([True, True])
    torch.testing.assert_close(
        kept, torch.tensor([[out_flat[1].sum(), out_flat[3].sum()]]),
        rtol=1e-6, atol=0)
    assert float(kept[0, 1]) != 0.0
    assert float(dscale([True, False])[0, 1]) == 0.0


# The layer: (tokens, d, ff, experts, capacity_factor, k). cf 1.0 at k 2
# is bench.py's MOE_MODEL setting, and it drops choices here.
LAYER_CASES = {
    "k1": (64, 16, 32, 4, 1.25, 1),
    "k1_tight": (64, 16, 32, 4, 0.5, 1),
    "k2_bench_cf": (64, 16, 32, 8, 1.0, 2),
}
AUX_WEIGHT = 0.5    # large enough that the aux term moves the router


def _layer_inputs(case, seed=3):
    t, d, ff, e, cf, k = LAYER_CASES[case]
    rng = _rng(seed)
    return dict(
        x=rng.normal(size=(t, d)).astype(np.float32),
        router=(rng.normal(size=(d, e)) * 0.5).astype(np.float32),
        w1=(rng.normal(size=(e, d, ff)) * 0.2).astype(np.float32),
        w2=(rng.normal(size=(e, ff, d)) * 0.2).astype(np.float32),
        r=rng.normal(size=(t, d)).astype(np.float32)), cf, k


def _jax_layer(inputs, cf, k):
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "expert"))

    def loss(x, router, w1, w2):
        y, aux = jax_moe.moe_ffn(x[None], router, w1, w2, mesh,
                                 capacity_factor=cf, router_top_k=k)
        return (y[0] * inputs["r"]).sum() + AUX_WEIGHT * aux, (y[0], aux)

    args = [jnp.asarray(inputs[n]) for n in ("x", "router", "w1", "w2")]
    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return np.asarray(y), float(aux), [np.asarray(g) for g in grads]


def _torch_layer(inputs, cf, k):
    args = [torch.from_numpy(inputs[n]).requires_grad_()
            for n in ("x", "router", "w1", "w2")]
    y, aux = moe.moe_ffn_local(*args, None, capacity_factor=cf,
                               router_top_k=k)
    loss = (y * torch.from_numpy(inputs["r"])).sum() + AUX_WEIGHT * aux
    grads = torch.autograd.grad(loss, args)
    return _to_np(y), float(aux.detach()), [_to_np(g) for g in grads]


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_moe_ffn_local_output_aux_and_gradients_match_jax(case):
    inputs, cf, k = _layer_inputs(case)
    y, aux, grads = _torch_layer(inputs, cf, k)
    wy, waux, wgrads = _jax_layer(inputs, cf, k)
    np.testing.assert_allclose(y, wy, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux, waux, rtol=RTOL)
    for name, g, w in zip(("x", "router", "w1", "w2"), grads, wgrads):
        top = np.abs(w).max()
        assert top > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=RTOL * top,
                                   err_msg=name)


def test_moe_ffn_takes_a_batch_and_one_shard():
    inputs, cf, k = _layer_inputs("k2_bench_cf")
    x = torch.from_numpy(inputs["x"])
    rest = [torch.from_numpy(inputs[n]) for n in ("router", "w1", "w2")]
    y, aux = moe.moe_ffn(x.reshape(4, 16, -1), *rest, None,
                         capacity_factor=cf, router_top_k=k)
    y_local, aux_local = moe.moe_ffn_local(x, *rest, capacity_factor=cf,
                                           router_top_k=k)
    assert torch.equal(y.reshape(y_local.shape), y_local)
    assert torch.equal(aux, aux_local)


def test_two_runs_are_bitwise_equal():
    inputs, cf, k = _layer_inputs("k2_bench_cf", seed=4)
    first = _torch_layer(inputs, cf, k)
    again = _torch_layer(inputs, cf, k)
    np.testing.assert_array_equal(first[0], again[0])
    assert first[1] == again[1]
    for a, b in zip(first[2], again[2]):
        np.testing.assert_array_equal(a, b)
