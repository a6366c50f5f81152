"""The port's flash-attention backward against the JAX package's.

On CPU tensors the port's ``flash_attention`` is a
``torch.autograd.Function`` whose backward is the plain version of the
dQ and dK/dV kernels; the JAX side takes ``jax.vjp`` through its custom
VJP with the Pallas kernels in interpret mode, as its own tests run them.
Both get the same numpy inputs and output gradient. The card's kernels
are held against the plain version in ``test_torch_cuda_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeflow_tpu.ops.flash_attention import (
    flash_attention_partial_grads as jax_partial_grads,
)
from kubeflow_tpu_torch.ops import flash_attention as fa

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

# Tolerances are fractions of the JAX gradient's largest magnitude. f32:
# the two sides differ in summation order only (measured ≤ 1.7e-6).
# bf16: P and dS are rounded to bf16 at the same points on both sides,
# but an f32 value on a rounding boundary may round the other way, and
# dq, dk, dv are stored in bf16 (one ulp is 2**-8 of a value): measured
# 7.6e-4, bound 1e-2.
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# (shape [b, s, h, d], dtype, causal)
CASES = {
    "f32_causal": ((2, 128, 2, 128), "float32", True),
    "f32_full": ((2, 128, 2, 128), "float32", False),
    "f32_d64": ((2, 128, 2, 64), "float32", True),
    "f32_s32": ((2, 32, 2, 128), "float32", True),
    "f32_s256": ((2, 256, 2, 128), "float32", True),
    "bf16_causal": ((2, 128, 2, 128), "bfloat16", True),
    # Heads wider than the 128-column kernels (the wide library on the
    # card): 136 (no multiple of 64) and Gemma's 256.
    "f32_d136": ((2, 128, 2, 136), "float32", True),
    "f32_d256": ((2, 128, 2, 256), "float32", True),
    "bf16_d136": ((2, 128, 2, 136), "bfloat16", True),
    "bf16_d256": ((2, 128, 2, 256), "bfloat16", True),
}
# One ring hop of 128-row blocks: the K block below the diagonal, on it,
# and above it (no key reaches any query: all three gradients are zero);
# and offsets whose diagonal crosses the middle of the block: at (64, 0)
# every row sees a key, at (0, 64) rows 0-63 see none (their dq is zero).
HOPS = {"below": (128, 0), "diagonal": (128, 128), "above": (0, 128),
        "mid_below": (64, 0), "mid_above": (0, 64)}


def _inputs(shape, dtype, n=4, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _assert_close(got, ref, dtype):
    for g, r in zip(got, ref):
        g = g.float().numpy()
        r = np.asarray(jnp.asarray(r, jnp.float32))
        assert g.shape == r.shape
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=TOL[dtype] * np.abs(r).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(case):
    shape, dtype, causal = CASES[case]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs(shape, dtype)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v, causal=causal),
                     jq, jk, jv)
    ref = vjp(jdo)
    for t in (tq, tk, tv):
        t.requires_grad_()
    o = fa.flash_attention(tq, tk, tv, causal=causal)
    got = torch.autograd.grad(o, (tq, tk, tv), grad_outputs=tdo)
    assert [g.dtype for g in got] == [tq.dtype] * 3
    _assert_close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hop", sorted(HOPS))
def test_partial_grads_match_jax_at_each_hop(hop, dtype):
    q_offset, k_offset = HOPS[hop]
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _inputs((1, 128, 2, 128), dtype,
                                                   seed=1)
    rng = np.random.default_rng(9)
    # The final ring lse and delta, [b, h, s_q].
    lse = (rng.standard_normal((1, 2, 128)) + 5.0).astype(np.float32)
    delta = rng.standard_normal((1, 2, 128)).astype(np.float32)
    ref = jax_partial_grads(jq, jk, jv, jdo, jnp.asarray(lse),
                            jnp.asarray(delta), q_offset, k_offset)
    got = fa.flash_attention_partial_grads(
        tq, tk, tv, tdo, torch.from_numpy(lse), torch.from_numpy(delta),
        q_offset, k_offset)
    _assert_close(got, ref, dtype)
    if hop == "above":
        assert all(bool((g == 0).all()) for g in got)
    if hop == "mid_above":
        assert bool((got[0][:, :64] == 0).all())


def test_cpu_backward_is_the_function_running_the_plain_version(monkeypatch):
    """The gradient comes from the Function's backward (the kernels' plain
    version), not from autograd through the dense forward, and no kernel
    launch is counted on the CPU."""
    calls = []

    def counted(name):
        plain = getattr(fa, name)

        def run(*args, **kwargs):
            calls.append((name, args[0].shape))
            return plain(*args, **kwargs)
        return run

    names = ("flash_attention_bwd_dq_reference",
             "flash_attention_bwd_dkv_reference")
    for name in names:
        monkeypatch.setattr(fa, name, counted(name))
    _, (tq, tk, tv, tdo) = _inputs((1, 64, 2, 64), "float32")
    for t in (tq, tk, tv):
        t.requires_grad_()
    launches = (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    o = fa.flash_attention(tq, tk, tv)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.backward(tdo)
    assert calls == [(name, tq.shape) for name in names]
    assert all(t.grad is not None for t in (tq, tk, tv))
    assert (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == launches


def test_backward_of_qkv_column_slices_reaches_the_fused_tensor():
    """As in the model: q, k, v are column slices of one qkv product, and
    the gradient flows back into it through the Function."""
    b, s, h, d = 2, 32, 2, 64
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(
        rng.standard_normal((b, s, 3 * h * d)).astype(np.float32))
    qkv.requires_grad_()
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    fa.flash_attention(q, k, v).sum().backward()
    dense = qkv.detach().clone().requires_grad_()
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in dense.split(h * d, dim=-1))
    torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True).transpose(1, 2).sum().backward()
    assert bool((qkv.grad != 0).any())
    torch.testing.assert_close(qkv.grad, dense.grad, rtol=1e-4, atol=1e-5)


def test_backward_checks_its_inputs():
    _, (tq, tk, tv, tdo) = _inputs((1, 32, 2, 64), "float32")
    o, lse = fa.flash_attention_fwd(tq, tk, tv)
    with pytest.raises(ValueError, match="o or delta"):
        fa.flash_attention_bwd(tq, tk, tv, None, lse, tdo)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(tq, tk, tv, o, lse[:, :16], tdo)
    with pytest.raises(ValueError, match="disagree"):
        fa.flash_attention_bwd(tq, tk[:, :, :1], tv, o, lse, tdo)
    with pytest.raises(TypeError):
        fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo.double())
    # s_q != s_k is allowed, as in _flash_bwd.
    k2, v2 = torch.cat([tk, tk], 1), torch.cat([tv, tv], 1)
    dq, dk, dv = fa.flash_attention_bwd(tq, k2, v2, o, lse, tdo,
                                        q_offset=32)
    assert dq.shape == tq.shape and dk.shape == dv.shape == k2.shape


def test_delta_is_the_rowsum_of_do_times_o():
    _, (o, do) = _inputs((2, 16, 3, 8), "float32", n=2)
    want = np.einsum("bshd,bshd->bhs", do.numpy(), o.numpy()).reshape(6, 16)
    np.testing.assert_allclose(fa.attention_delta(o, do).numpy(), want,
                               rtol=1e-6, atol=1e-6)
