"""The port's ring attention against the JAX package's.

World size 4: the torch side runs in 4 CPU processes on gloo
(``torch_world.run_world``), each holding its ``[b_local, s_local, h, d]``
blocks of the same numpy inputs; the JAX side runs ``ring_attention`` on
the conftest's virtual CPU devices with the same mesh shape. Outputs and
q/k/v gradients (for one numpy output gradient) are assembled from the
processes' blocks and compared. World size 1 (``mesh=None``) runs in this
process. This module imports JAX only inside the functions that need it,
so the spawned processes load torch and the port alone.
"""

import numpy as np
import pytest
import torch

from kubeflow_tpu_torch.parallel import ring
from kubeflow_tpu_torch.telemetry import sections
from torch_world import run_world

torch.set_num_threads(1)

# ("data", "seq") mesh shapes of the 4 processes.
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
IMPLS = ("xla", "flash")
SHAPE = (2, 64, 2, 16)            # [b, S, h, d]
# Outputs at the JAX ring tests' 2e-5; gradients at 2e-4, the bound of
# test_ring_flash_grads_match_xla_ring (f32 throughout; the two sides
# differ in summation order).
TOL_OUT = 2e-5
TOL_GRAD = 2e-4


def _inputs(shape=SHAPE, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _block(shape, mesh_shape, rank):
    """This rank's (batch rows, sequence columns) of a global [b, S, ...]
    array on a (data, seq) mesh laid out as arange(4).reshape(mesh)."""
    dp, sp = mesh_shape
    data, seq = divmod(rank, sp)
    b, s = shape[0] // dp, shape[1] // sp
    return slice(data * b, (data + 1) * b), slice(seq * s, (seq + 1) * s)


def _assemble(blocks, mesh_shape, shape):
    out = np.zeros(shape, np.float32)
    for rank, block in enumerate(blocks):
        out[_block(shape, mesh_shape, rank)] = block.float().numpy()
    return out


def _ring_world(rank, q, k, v, do, k_late, v_late):
    """Every case on the 4 processes: outputs and gradients of both block
    implementations on both meshes, the causality probe, a profiled hop,
    and the mesh-axis error."""
    from torch.distributed.device_mesh import DeviceMesh

    results = {}
    for name, mesh_shape in MESHES.items():
        mesh = DeviceMesh("cpu", torch.arange(4).reshape(mesh_shape),
                          mesh_dim_names=("data", "seq"))
        rows, cols = _block(q.shape, mesh_shape, rank)

        def local(a):
            return torch.from_numpy(np.ascontiguousarray(a[rows, cols]))

        for impl in IMPLS:
            leaves = [local(t).requires_grad_() for t in (q, k, v)]
            out = ring.ring_attention(*leaves, mesh, block_impl=impl)
            grads = torch.autograd.grad(out, leaves, local(do))
            results[f"{name}/{impl}"] = [out.detach(), *grads]
        if name == "1x4":
            with torch.no_grad():
                results["causal"] = ring.ring_attention(
                    local(q), local(k_late), local(v_late), mesh)
            with torch.profiler.profile() as prof:
                ring.ring_attention(local(q), local(k), local(v), mesh)
            results["sections"] = sorted({e.key for e in prof.key_averages()
                                          if e.key.startswith("kftpu.")})
            try:
                ring.ring_attention(local(q), local(k), local(v), mesh,
                                    axis_name="model")
            except ValueError as err:
                results["missing_axis"] = str(err)
    return results


@pytest.fixture(scope="module")
def world():
    q, k, v, do = _inputs()
    k_late, v_late = k.copy(), v.copy()
    k_late[:, -1] += 100.0
    v_late[:, -1] += 100.0
    ranks = run_world(_ring_world, q, k, v, do, k_late, v_late)
    return (q, k, v, do), ranks


def _jax_ring(mesh_shape, impl, q, k, v, do, axis_names=("data", "seq")):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from kubeflow_tpu.parallel.ring import ring_attention

    n = int(np.prod(mesh_shape))
    mesh = Mesh(np.array(jax.devices()[:n]).reshape(mesh_shape), axis_names)
    spec = NamedSharding(mesh, P(*axis_names, None, None)
                         if len(axis_names) == 2 else P(None, "seq"))
    args = [jax.device_put(jnp.asarray(t), spec) for t in (q, k, v)]

    @jax.jit
    def run(q, k, v, do):
        out, vjp = jax.vjp(
            lambda q, k, v: ring_attention(q, k, v, mesh, block_impl=impl),
            q, k, v)
        return (out, *vjp(do.astype(out.dtype)))

    return [np.asarray(jnp.asarray(t, jnp.float32))
            for t in run(*args, jnp.asarray(do))]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_matches_jax_at_world_4(world, mesh, impl):
    (q, k, v, do), ranks = world
    got = [_assemble([r[f"{mesh}/{impl}"][i] for r in ranks], MESHES[mesh],
                     SHAPE) for i in range(4)]
    ref = _jax_ring(MESHES[mesh], impl, q, k, v, do)
    np.testing.assert_allclose(got[0], ref[0], rtol=TOL_OUT, atol=TOL_OUT)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=TOL_GRAD, atol=TOL_GRAD)


def test_ring_is_causal_across_processes(world):
    """Changing the last token's K and V (on the last process) changes no
    earlier output, on any process."""
    _, ranks = world
    base = _assemble([r["1x4/xla"][0] for r in ranks], MESHES["1x4"], SHAPE)
    late = _assemble([r["causal"] for r in ranks], MESHES["1x4"], SHAPE)
    np.testing.assert_allclose(late[:, :-1], base[:, :-1], rtol=1e-5,
                               atol=1e-5)
    assert not np.allclose(late[:, -1], base[:, -1])


def test_ring_hops_run_in_their_registered_section(world):
    _, ranks = world
    assert all(r["sections"] == ["kftpu.ring_kv_hop"] for r in ranks)
    assert all("no axis 'model'" in r["missing_axis"] for r in ranks)


@pytest.mark.parametrize("impl", IMPLS)
def test_one_shard_ring_matches_jax(impl):
    """mesh=None is one shard: one hop at offsets (0, 0), no collective;
    the flash backward runs the partial grads with delta given."""
    q, k, v, do = _inputs()
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = ring.ring_attention(*leaves, None, block_impl=impl)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    ref = _jax_ring((1,), impl, q, k, v, do, axis_names=("seq",))
    np.testing.assert_allclose(out.detach().numpy(), ref[0], rtol=TOL_OUT,
                               atol=TOL_OUT)
    for g, r in zip(grads, ref[1:]):
        np.testing.assert_allclose(g.numpy(), r, rtol=TOL_GRAD, atol=TOL_GRAD)
    dense = ring.reference_causal_attention(*leaves)
    torch.testing.assert_close(out, dense, rtol=TOL_OUT, atol=TOL_OUT)


def test_xla_ring_keeps_the_jax_rounding_points_in_bf16():
    """bf16: the einsum's logits are rounded to bf16 before the f32 cast
    and the scale, and P·V to bf16 before the f32 accumulation, on both
    sides; the outputs then agree to a bf16 ulp at |o| < 2 (2**-7),
    where keeping f32 logits would move them further."""
    import jax.numpy as jnp

    q, k, v, do = _inputs(seed=1)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    got = ring.ring_attention(*bf, None).float().numpy()
    ref = _jax_ring((1,), "xla", *(jnp.asarray(t, jnp.bfloat16)
                                   for t in (q, k, v)), do,
                    axis_names=("seq",))[0]
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 ** -7)
    f32_logits = ring.ring_attention(
        *(t.float() for t in bf), None).to(torch.bfloat16).float().numpy()
    assert np.abs(f32_logits - ref).max() > np.abs(got - ref).max()


def test_sections_reject_unregistered_names_and_keep_the_jax_names():
    from kubeflow_tpu.telemetry.sections import SECTION_NAMES as JAX_NAMES

    assert sections.SECTION_NAMES <= JAX_NAMES
    assert sections.collective("ring_kv_hop", lambda x: x + 1, 1) == 2
    with pytest.raises(ValueError, match="unregistered"):
        sections.collective("ring_hop", lambda: None)
