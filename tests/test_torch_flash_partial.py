"""The port's ring-hop partial attention against the JAX package's.

On CPU tensors ``flash_attention_partial`` is the plain version of the
partial kernel; the JAX side runs ``_partial_kernel`` in interpret mode,
as its own tests do. Both get the same numpy inputs. The card's kernel is
held against the plain version in ``test_torch_cuda_kernels.py``.

The two differ, by design, in one place: a row that no key of the block
reaches, inside a block that is live for other rows. That happens only at
offsets that are not multiples of the JAX block, which a ring never
makes; there the TPU kernel leaves the masked columns' count in l and
their V sum in acc (with m = -1e30), the port writes (0, -1e30, 0), and
the ring's fold gives such a row no weight either way. Raw outputs are
compared at block-aligned offsets, the other rows through the fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeflow_tpu.ops.flash_attention import (
    flash_attention_partial as jax_partial,
)
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel.ring import finish, fold_hop

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

# acc, as a fraction of the JAX acc's largest magnitude: f32 differs in
# summation order only; bf16 rounds P to bf16 on both sides, against the
# final max here and against a running max in JAX's multi-block case, so
# an element may land one bf16 ulp (2**-8) apart: 1e-2. m and l are f32
# from f32 scores on both sides: m within 1e-5, l within 1e-5 of its
# largest value.
TOL_ACC = {"float32": 1e-5, "bfloat16": 1e-2}
TOL_M = 1e-5
TOL_L = 1e-5
# A 4-shard ring's hops of 128-row blocks: the K block below the
# diagonal, on it, and above it (no key reaches any query).
HOPS = {"below": (128, 0), "diagonal": (128, 128), "above": (0, 128)}


def _inputs(shape, dtype, n=3, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def _assert_partial_close(got, ref, dtype):
    (o, m, l), (ro, rm, rl) = (tuple(_np(t) for t in got),
                               tuple(_np(t) for t in ref))
    assert o.shape == ro.shape and m.shape == rm.shape and l.shape == rl.shape
    np.testing.assert_allclose(o, ro, rtol=0,
                               atol=TOL_ACC[dtype] * np.abs(ro).max())
    np.testing.assert_allclose(m, rm, rtol=0, atol=TOL_M)
    np.testing.assert_allclose(l, rl, rtol=0, atol=TOL_L * max(rl.max(), 1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hop", sorted(HOPS))
def test_partial_matches_jax_at_each_hop(hop, dtype):
    q_off, k_off = HOPS[hop]
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 128, 2, 128), dtype, seed=1)
    ref = jax_partial(jq, jk, jv, q_off, k_off)
    got = fa.flash_attention_partial(tq, tk, tv, q_off, k_off)
    assert all(t.dtype == torch.float32 for t in got)
    assert got[0].shape == tq.shape and got[1].shape == (1, 2, 128)
    _assert_partial_close(got, ref, dtype)
    if hop == "above":
        o, m, l = got
        assert bool((o == 0).all()) and bool((l == 0).all())
        assert bool((m == -1e30).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [256, 1024])
@pytest.mark.parametrize("hop", ["below", "diagonal"])
def test_partial_matches_jax_at_wide_heads(hop, d, dtype):
    """Heads as the wide library takes them: d = 256 (the wgmma
    instantiation's width) and 1024 (four output-column slices of the
    simple kernels), at a hop below the diagonal and on it."""
    q_off, k_off = HOPS[hop]
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 128, 2, d), dtype, seed=d)
    ref = jax_partial(jq, jk, jv, q_off, k_off)
    got = fa.flash_attention_partial(tq, tk, tv, q_off, k_off)
    assert got[0].shape == tq.shape and got[1].shape == (1, 2, 128)
    _assert_partial_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hop", sorted(HOPS))
def test_partial_matches_jax_across_blocks(hop, dtype):
    """JAX at 128-row blocks over s = 512: its online softmax runs across
    four K blocks per Q block and skips those above the diagonal."""
    q_off, k_off = (4 * x for x in HOPS[hop])
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 512, 2, 64), dtype, seed=2)
    ref = jax_partial(jq, jk, jv, q_off, k_off, block_q=128, block_k=128)
    got = fa.flash_attention_partial(tq, tk, tv, q_off, k_off,
                                     block_q=128, block_k=128)
    _assert_partial_close(got, ref, dtype)


def test_four_hops_folded_equal_flash_attention_reference():
    """A 4-shard ring simulated in one process: every query block's four
    hops (its own block first, as the ring visits them) folded in f32 give
    the one-shot attention's o and lse."""
    (_, _, _), (q, k, v) = _inputs((2, 512, 2, 64), "float32", seed=3)
    n, s_local = 4, 128
    outs, lses = [], []
    for my in range(n):
        blocks = slice(my * s_local, (my + 1) * s_local)
        carry = None
        for t in range(n):
            src = (my - t) % n
            keys = slice(src * s_local, (src + 1) * s_local)
            carry = fold_hop(carry, *fa.flash_attention_partial(
                q[:, blocks], k[:, keys], v[:, keys], my * s_local,
                src * s_local))
        out, lse = finish(carry, q.dtype)
        outs.append(out)
        lses.append(lse)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(torch.cat(outs, 1), ref_o, rtol=2e-5,
                               atol=2e-5)
    torch.testing.assert_close(torch.cat(lses, 2).reshape(4, 512), ref_lse,
                               rtol=2e-5, atol=2e-5)


def test_rows_with_no_visible_key_agree_through_the_fold():
    """Queries at positions [64, 192) against keys [0, 128) and then
    [128, 256): in the second hop the first 64 rows see no key inside a
    live block. Raw, JAX keeps their masked columns in l and acc and the
    port writes zeros; folded after the first hop, both give the same
    attention, and the other rows agree raw as well."""
    (jq, jk, jv), (tq, tk, tv) = _inputs((1, 128, 2, 64), "float32", seed=4)
    (jk2, jv2), (tk2, tv2) = _inputs((1, 128, 2, 64), "float32", n=2, seed=5)
    port = [fa.flash_attention_partial(tq, tk, tv, 64, 0),
            fa.flash_attention_partial(tq, tk2, tv2, 64, 128)]
    ref = [tuple(torch.from_numpy(np.array(t)) for t in hop)
           for hop in (jax_partial(jq, jk, jv, 64, 0),
                       jax_partial(jq, jk2, jv2, 64, 128))]
    (o, m, l), (ro, rm, rl) = port[1], ref[1]
    unseen = slice(0, 64)
    assert bool((m[..., unseen] == -1e30).all())
    assert bool((rm[..., unseen] == -1e30).all())
    assert bool((l[..., unseen] == 0).all()) and bool((o[:, unseen] == 0).all())
    assert bool((rl[..., unseen] == 128).all())    # JAX: the masked count
    _assert_partial_close((o[:, 64:], m[..., 64:], l[..., 64:]),
                          (ro[:, 64:], rm[..., 64:], rl[..., 64:]), "float32")
    folded, ref_folded = None, None
    for hop, ref_hop in zip(port, ref):
        folded = fold_hop(folded, *hop)
        ref_folded = fold_hop(ref_folded, *ref_hop)
    for got, want in zip(finish(folded, tq.dtype),
                         finish(ref_folded, tq.dtype)):
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# Offsets that are multiples of 64 but not of 128 put the diagonal in the
# middle of the card kernel's 128-row tile (test_torch_cuda_kernels.py
# holds the kernel at the same offsets). Tolerance of the folded bf16 o:
# one bf16 ulp of |o| < 2, as TOL_O on the card.
MID_TILE_SHAPE = (2, 256, 4, 128)
TOL_FOLD = {"float32": 2e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partial_matches_jax_with_the_diagonal_mid_tile(dtype):
    """Queries at [192, 448) against keys at [64, 320): every row sees
    key 0 of the block, so acc, m and l compare raw."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(MID_TILE_SHAPE, dtype, seed=7)
    ref = jax_partial(jq, jk, jv, 192, 64)
    got = fa.flash_attention_partial(tq, tk, tv, 192, 64)
    assert bool((got[2] > 0).all())
    _assert_partial_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_before_a_mid_tile_diagonal_agree_through_the_fold(dtype):
    """Queries at [64, 320) against keys at [192, 448): rows 0-127 see no
    key of the block (JAX keeps the masked count in l there, the port
    writes (0, -1e30, 0)), rows 128-255 do and agree raw; folded after a
    hop against keys at [0, 256), both give the same attention."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(MID_TILE_SHAPE, dtype, seed=8)
    (jk2, jv2), (tk2, tv2) = _inputs(MID_TILE_SHAPE, dtype, n=2, seed=9)
    port = [fa.flash_attention_partial(tq, tk, tv, 64, 0),
            fa.flash_attention_partial(tq, tk2, tv2, 64, 192)]
    ref = [tuple(torch.from_numpy(np.array(jnp.asarray(t, jnp.float32)))
                 for t in hop)
           for hop in (jax_partial(jq, jk, jv, 64, 0),
                       jax_partial(jq, jk2, jv2, 64, 192))]
    (o, m, l), (ro, rm, rl) = port[1], ref[1]
    unseen, seen = slice(0, 128), slice(128, None)
    assert bool((m[..., unseen] == -1e30).all())
    assert bool((l[..., unseen] == 0).all()) and bool((o[:, unseen] == 0).all())
    assert bool((rm[..., unseen] == -1e30).all())
    assert bool((rl[..., unseen] == 256).all())    # JAX: the masked count
    _assert_partial_close((o[:, seen], m[..., seen], l[..., seen]),
                          (ro[:, seen], rm[..., seen], rl[..., seen]), dtype)
    folded, ref_folded = None, None
    for hop, ref_hop in zip(port, ref):
        folded = fold_hop(folded, *hop)
        ref_folded = fold_hop(ref_folded, *ref_hop)
    for got, want in zip(finish(folded, tq.dtype),
                         finish(ref_folded, tq.dtype)):
        torch.testing.assert_close(got.float(), want.float(), rtol=0,
                                   atol=TOL_FOLD[dtype])


def test_partial_shape_contract_raises_where_jax_raises():
    (jq, _, _), (tq, _, _) = _inputs((1, 1536, 1, 16), "float32")
    with pytest.raises(ValueError, match="divide"):
        jax_partial(jq, jq, jq, 0, 0)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention_partial(tq, tq, tq, 0, 0)
    # 768-row blocks divide 1536: both accept, and agree.
    ref = jax_partial(jq, jq, jq, 0, 0, block_q=768, block_k=768)
    got = fa.flash_attention_partial(tq, tq, tq, 0, 0, block_q=768,
                                     block_k=768)
    _assert_partial_close(got, ref, "float32")


def test_partial_rejects_mismatched_inputs_and_never_launches_on_cpu():
    q = torch.zeros((1, 16, 2, 64))
    with pytest.raises(ValueError):
        fa.flash_attention_partial(q, q[:, :8], q, 0, 0)
    with pytest.raises(TypeError):
        fa.flash_attention_partial(q, q, q.double(), 0, 0)
    before = fa.PARTIAL_LAUNCHES
    fa.flash_attention_partial(q, q, q, 16, 0)
    assert fa.PARTIAL_LAUNCHES == before


def test_flash_attention_takes_the_jax_blocks_at_s_1536():
    """The shape contract follows the caller's blocks, as in JAX: at
    S = 1536 the default 1024 raises in both, and 768-row blocks (what
    ulysses picks for that length) run forward and backward in both."""
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs((1, 1536, 1, 16),
                                                   "float32", n=4, seed=6)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(tq, tk, tv)
    blocks = dict(block_q=768, block_k=768)
    ref, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, **blocks),
                       jq, jk, jv)
    ref_grads = vjp(jdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = fa.flash_attention(*leaves, **blocks)
    grads = torch.autograd.grad(out, leaves, tdo)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=2e-5, atol=2e-5)
    for g, r in zip(grads, ref_grads):
        r = _np(r)
        np.testing.assert_allclose(_np(g), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max())
