"""The port's Ulysses attention, and its ring composition, against the
JAX package's.

World size 4, as in ``test_torch_ring.py``: the torch side runs in 4 CPU
processes on gloo, each holding its blocks of the same numpy inputs; the
JAX side runs on the conftest's virtual CPU devices with the same mesh.
Ulysses runs on ("data", "seq") meshes of 1×4 and 2×2, the composition on
a 2×2 ("seq_ring", "seq_uly") mesh with the sequence sharded ring-major.
This module imports JAX only inside the functions that need it.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel import ulysses
from torch_world import run_world

torch.set_num_threads(1)

SHAPE = (2, 64, 4, 16)             # [b, S, h, d]; heads divide by 4
LONG = (1, 1536, 4, 16)            # S = 1536: flash blocks of 768
# (strategy, mesh axis names, mesh shape): ulysses on data × seq, the
# composition on its two sequence axes (sequence block = rank there).
CASES = {
    "ulysses/1x4": ("ulysses", ("data", "seq"), (1, 4)),
    "ulysses/2x2": ("ulysses", ("data", "seq"), (2, 2)),
    "ring_ulysses/2x2": ("ring_ulysses", ("seq_ring", "seq_uly"), (2, 2)),
}
IMPLS = ("xla", "flash")
# As in test_torch_ring.py: outputs at the JAX tests' 2e-5, gradients at
# 2e-4 (f32; summation order only).
TOL_OUT = 2e-5
TOL_GRAD = 2e-4


def _inputs(shape=SHAPE, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _block(shape, names, mesh_shape, rank):
    """(batch rows, sequence columns) of ``rank``: batch over "data",
    the sequence over the rest, ring-major."""
    dp = mesh_shape[0] if names[0] == "data" else 1
    sp = 4 // dp
    data, seq = divmod(rank, sp)
    b, s = shape[0] // dp, shape[1] // sp
    return slice(data * b, (data + 1) * b), slice(seq * s, (seq + 1) * s)


def _assemble(blocks, names, mesh_shape, shape):
    out = np.zeros(shape, np.float32)
    for rank, block in enumerate(blocks):
        out[_block(shape, names, mesh_shape, rank)] = block.float().numpy()
    return out


def _attend(strategy, q, k, v, mesh, names, impl):
    if strategy == "ulysses":
        return ulysses.ulysses_attention(q, k, v, mesh, block_impl=impl)
    return ulysses.ring_ulysses_attention(q, k, v, mesh, axis_name=names,
                                          block_impl=impl)


def _ulysses_world(rank, q, k, v, do, long_qkv):
    from torch.distributed.device_mesh import DeviceMesh

    results = {}
    for case, (strategy, names, mesh_shape) in CASES.items():
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(mesh_shape),
                          mesh_dim_names=names)
        rows, cols = _block(q.shape, names, mesh_shape, rank)

        def local(a):
            return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))

        for impl in IMPLS:
            leaves = [local(t).requires_grad_() for t in (q, k, v)]
            out = _attend(strategy, *leaves, mesh, names, impl)
            grads = torch.autograd.grad(out, leaves, local(do))
            results[f"{case}/{impl}"] = [out.detach(), *grads]
        # Heads that do not divide by the ulysses axis raise before any
        # exchange, on every process.
        few = local(q)[:, :, :3]          # 3 heads on 4 or 2 shards
        try:
            _attend(strategy, few, few, few, mesh, names, "xla")
        except ValueError as err:
            results[f"{case}/heads"] = str(err)
        if case == "ulysses/1x4":
            rows, cols = _block(LONG, names, mesh_shape, rank)
            with torch.no_grad():
                results["long"] = ulysses.ulysses_attention(
                    *(torch.from_numpy(np.ascontiguousarray(t[rows, cols]))
                      for t in long_qkv), mesh, block_impl="flash")
    return results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    q, k, v, do = _inputs()
    long_qkv = _inputs(LONG, n=3, seed=11)
    ranks = run_world(_ulysses_world, tmp_path_factory.mktemp("ulysses"),
                      q, k, v, do, long_qkv)
    return (q, k, v, do), long_qkv, ranks


def _jax_attend(strategy, names, mesh_shape, impl, q, k, v, do=None):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kubeflow_tpu.parallel.ulysses import (
        ring_ulysses_attention,
        ulysses_attention,
    )

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(mesh_shape), names)
    if strategy == "ulysses":
        spec = P("data", "seq", None, None)

        def attend(q, k, v):
            return ulysses_attention(q, k, v, mesh, block_impl=impl)
    else:
        spec = P(None, names, None, None)

        def attend(q, k, v):
            return ring_ulysses_attention(q, k, v, mesh, axis_name=names,
                                          block_impl=impl)
    args = [jax.device_put(jnp.asarray(t), NamedSharding(mesh, spec))
            for t in (q, k, v)]
    if do is None:
        return np.asarray(jax.jit(attend)(*args))

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(attend, q, k, v)
        return (out, *vjp(do))

    return [np.asarray(t) for t in run(*args, jnp.asarray(do))]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_matches_jax_at_world_4(world, case, impl):
    (q, k, v, do), _, ranks = world
    strategy, names, mesh_shape = CASES[case]
    got = [_assemble([r[f"{case}/{impl}"][i] for r in ranks], names,
                     mesh_shape, SHAPE) for i in range(4)]
    ref = _jax_attend(strategy, names, mesh_shape, impl, q, k, v, do)
    np.testing.assert_allclose(got[0], ref[0], rtol=TOL_OUT, atol=TOL_OUT)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=TOL_GRAD, atol=TOL_GRAD)


@pytest.mark.parametrize("case", sorted(CASES))
def test_indivisible_heads_raise_with_the_jax_words(world, case):
    _, _, ranks = world
    words = ("heads % ulysses shards" if case.startswith("ring")
             else "heads % shards")
    assert all(words in r[f"{case}/heads"] for r in ranks)


def test_flash_at_s_1536_matches_jax(world):
    """S = 1536 gathers to blocks of 768 (not the default 1024): the
    port's flash attention takes them, as JAX's does."""
    _, long_qkv, ranks = world
    names, mesh_shape = ("data", "seq"), (1, 4)
    got = _assemble([r["long"] for r in ranks], names, mesh_shape, LONG)
    ref = _jax_attend("ulysses", names, mesh_shape, "flash", *long_qkv)
    np.testing.assert_allclose(got, ref, rtol=TOL_OUT, atol=TOL_OUT)


def test_largest_divisor_block_keeps_the_jax_contract():
    from kubeflow_tpu.parallel.ulysses import (
        _largest_divisor_block as jax_block,
    )

    for s in (192, 1024, 1536, 2560, 4096, 8192, 24576):
        assert ulysses._largest_divisor_block(s) == jax_block(s)
        assert s % ulysses._largest_divisor_block(s) == 0
    assert ulysses._largest_divisor_block(1536) == 768
    with pytest.raises(ValueError, match="divisible by 128"):
        ulysses._largest_divisor_block(1030)


@pytest.mark.parametrize("impl", IMPLS)
def test_one_shard_ulysses_is_dense_causal_attention(impl):
    from kubeflow_tpu_torch.parallel.ring import reference_causal_attention

    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(seed=2))
    out = ulysses.ulysses_attention(q, k, v, None, block_impl=impl)
    torch.testing.assert_close(out, reference_causal_attention(q, k, v),
                               rtol=TOL_OUT, atol=TOL_OUT)
    with pytest.raises(ValueError, match="block_impl"):
        ulysses.ulysses_attention(q, k, v, None, block_impl="pallas")
