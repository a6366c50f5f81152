"""The port's flash-attention forward against the JAX package's.

On CPU tensors the port runs its plain version; the JAX side runs the
Pallas kernel in interpret mode, as its own tests do. Both get the same
numpy inputs. O is held against ``flash_attention`` and lse against
``_flash_fwd``'s ``lse[:, 0, :]`` (the TPU's sublane-replicated layout).
The card's kernel is held against the plain version in
``test_torch_cuda_kernels.py``; here also the arithmetic the card's
wrapper relies on for head dims that are no multiple of 8 (zero-padded
heads), the wide library's plan for each head dim, and that no head dim
is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_tpu.ops.flash_attention import _flash_fwd
from kubeflow_tpu.ops.flash_attention import flash_attention as jax_flash
from kubeflow_tpu_torch.ops import flash_attention as fa

# The shapes are tiny: one intra-op thread keeps torch's OpenMP pool
# from spinning on cores that the other test workers share.
torch.set_num_threads(1)

# (shape [b, s, h, d], dtype, causal, rtol/atol on O). f32 at 2e-5 is
# test_forward_matches_reference's tolerance. bf16: both sides round P and
# O to bf16 after f32 math in another order, so O may differ by about one
# bf16 ulp of |O| < 2 (2**-7 = 7.8e-3): 1e-2.
CASES = {
    "f32_causal": ((2, 256, 2, 128), "float32", True, 2e-5),
    "f32_full": ((2, 256, 2, 128), "float32", False, 2e-5),
    "f32_d64": ((2, 256, 2, 64), "float32", True, 2e-5),
    "f32_s32": ((2, 32, 2, 128), "float32", True, 2e-5),
    "bf16_causal": ((2, 256, 2, 128), "bfloat16", True, 1e-2),
    # Across the card kernel's 128-row Q and 128-key K/V tiles: 1.5 tiles
    # causal, 2.5 tiles full at head dim 64.
    "bf16_causal_s192": ((2, 192, 4, 128), "bfloat16", True, 1e-2),
    "bf16_full_s320_d64": ((1, 320, 2, 64), "bfloat16", False, 1e-2),
}
LSE_TOL = 2e-5   # lse is f32 in both, from f32 scores


def _inputs(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, th


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_lse_match_jax(case):
    shape, dtype, causal, tol = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype)
    b, s, h, d = shape

    o_jax = jax_flash(jq, jk, jv, causal=causal)

    def fold(t):
        return t.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    _, lse_jax = _flash_fwd(fold(jq), fold(jk), fold(jv), scale=d ** -0.5,
                            causal=causal, block_q=1024, block_k=1024,
                            interpret=True)
    o, lse = fa.flash_attention_fwd(tq, tk, tv, causal=causal)

    assert o.dtype == tq.dtype and o.shape == tq.shape
    assert lse.dtype == torch.float32 and lse.shape == (b * h, s)
    np.testing.assert_allclose(_np(o), _np(o_jax), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax[:, 0, :]),
                               rtol=LSE_TOL, atol=LSE_TOL)
    # The public wrapper is the forward's O.
    assert torch.equal(fa.flash_attention(tq, tk, tv, causal=causal), o)


def test_shape_contract_raises_where_jax_raises():
    (jq, _, _), (tq, _, _) = _inputs((1, 1536, 1, 64), "float32")
    with pytest.raises(ValueError, match="divide"):
        jax_flash(jq, jq, jq)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_attention(tq, tq, tq)
    # 2048 = 2 × 1024 and anything up to 1024 are accepted by both.
    (_, _, _), (t2, _, _) = _inputs((1, 2048, 1, 8), "float32")
    assert fa.flash_attention(t2, t2, t2).shape == t2.shape


def test_rejects_other_dtypes_and_mismatched_inputs():
    q = torch.zeros((1, 16, 1, 64), dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 16, 1, 64))
    with pytest.raises(ValueError):
        fa.flash_attention(q, q[:, :8], q)


def test_cpu_tensors_never_launch_the_kernel():
    before = fa.LAUNCHES
    _, (tq, tk, tv) = _inputs((1, 64, 2, 128), "bfloat16")
    fa.flash_attention_fwd(tq, tk, tv)
    assert fa.LAUNCHES == before


def test_kernel_layout_check_takes_qkv_slices_and_refuses_the_rest():
    """The kernel reads through strides and never copies: the column
    slices of a fused qkv product pass, layouts its 16-byte loads cannot
    read raise."""
    b, s, h, d = 2, 16, 2, 64
    qkv = torch.zeros((b, s, 3 * h * d), dtype=torch.bfloat16)
    for t in qkv.split(h * d, dim=-1):
        fa._check_kernel_layout("q", t.reshape(b, s, h, d))
    x = torch.zeros((b, s, h, d + 4), dtype=torch.bfloat16)
    refused = {
        "head_dim stride": torch.zeros((b, s, d, h),
                                       dtype=torch.bfloat16).transpose(2, 3),
        "row stride": x[..., :d],
        "start": x.reshape(-1)[4:4 + b * s * h * d].reshape(b, s, h, d),
    }
    for why, t in refused.items():
        with pytest.raises(ValueError, match="16-byte"):
            fa._check_kernel_layout(why, t)


def test_plain_version_is_causal_and_floors_masked_rows():
    _, (tq, tk, tv) = _inputs((1, 64, 2, 64), "float32", seed=3)
    o1, _ = fa.flash_attention_fwd(tq, tk, tv)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, -1] += 100.0
    tv2[:, -1] += 100.0
    o2, _ = fa.flash_attention_fwd(tq, tk2, tv2)
    torch.testing.assert_close(o1[:, :-1], o2[:, :-1], rtol=0, atol=0)
    assert not torch.allclose(o1[:, -1], o2[:, -1])


@pytest.mark.parametrize("d", [20, 36, 130])
def test_zero_padded_heads_give_the_same_attention_and_gradients(d):
    """What the card does with a head dim that is no multiple of 8: zero
    columns up to the next multiple of 8, the scale of the true d, the
    outputs sliced back. Zero columns add exactly 0 to every product and
    to delta, so the plain versions agree on padded and unpadded heads
    (f32, summation order only)."""
    _, (q, k, v) = _inputs((1, 48, 2, d), "float32", seed=5)
    do = torch.from_numpy(np.random.default_rng(6).standard_normal(
        q.shape).astype(np.float32))
    pq, pk, pv, pdo = fa._pad_heads(q, k, v, do)
    assert pq.shape[-1] == -(-d // 8) * 8 and pq.is_contiguous()
    assert bool((pq[..., d:] == 0).all())
    scale = 1.0 / d ** 0.5
    o, lse = fa.flash_attention_reference(q, k, v)
    po, plse = fa.flash_attention_reference(pq, pk, pv, scale=scale)
    torch.testing.assert_close(po[..., :d], o, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(plse, lse, rtol=2e-6, atol=2e-6)
    assert bool((po[..., d:] == 0).all())
    grads = fa.flash_attention_bwd_reference(q, k, v, o, lse, do)
    padded = fa.flash_attention_bwd_reference(
        pq, pk, pv, *fa._pad_heads(o), lse, pdo, scale=scale)
    for g, p in zip(grads, padded):
        torch.testing.assert_close(p[..., :d], g, rtol=2e-6, atol=2e-6)
        assert bool((p[..., d:] == 0).all())


@pytest.mark.parametrize("d", [20, 36, 64])
def test_on_kernel_pads_head_arguments_and_slices_head_outputs(d):
    """``_on_kernel``, the one place where the CUDA wrappers pad: every
    ``[b, s, h, d]`` argument reaches the launcher at the padded width and
    every other argument as it was; ``[b, s, h, d]`` outputs come back at
    d. The plain versions stand in for the launchers here (f32, summation
    order only)."""
    _, (q, k, v) = _inputs((1, 48, 2, d), "float32", seed=7)
    do = torch.from_numpy(np.random.default_rng(8).standard_normal(
        q.shape).astype(np.float32))
    width = -(-d // 8) * 8
    scale = 1.0 / d ** 0.5
    seen = []

    def fwd(q, k, v, causal, scale):
        seen.append(tuple(t.shape[-1] for t in (q, k, v)))
        return fa.flash_attention_reference(q, k, v, causal=causal,
                                            scale=scale)

    def dq(q, k, v, o, lse, do, delta, causal, scale, q_offset, k_offset):
        seen.append(tuple(t.shape[-1] for t in (q, k, v, o, do)))
        assert lse.dim() == 2 and delta is None
        return fa.flash_attention_bwd_dq_reference(
            q, k, v, o, lse, do, causal=causal, scale=scale,
            q_offset=q_offset, k_offset=k_offset)

    def partial(q, k, v, q_offset, k_offset, scale):
        seen.append(tuple(t.shape[-1] for t in (q, k, v)))
        return fa.flash_attention_partial_reference(q, k, v, q_offset,
                                                    k_offset, scale=scale)

    o, lse = fa._on_kernel(fwd, q, k, v, True, scale)
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o, ref_o, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(lse, ref_lse, rtol=2e-6, atol=2e-6)
    dq_got, delta = fa._on_kernel(dq, q, k, v, o, lse, do, None, True,
                                  scale, 0, 0)
    ref_dq, ref_delta = fa.flash_attention_bwd_dq_reference(q, k, v, o, lse,
                                                           do)
    torch.testing.assert_close(dq_got, ref_dq, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(delta, ref_delta, rtol=2e-6, atol=2e-6)
    acc, m, l = fa._on_kernel(partial, q, k, v, 48, 0, scale)
    ref_acc, ref_m, ref_l = fa.flash_attention_partial_reference(q, k, v,
                                                                 48, 0)
    assert acc.shape == q.shape and m.shape == ref_m.shape
    torch.testing.assert_close(acc, ref_acc, rtol=2e-6, atol=2e-6)
    torch.testing.assert_close(l, ref_l, rtol=2e-6, atol=2e-6)
    assert seen == [(width,) * 3, (width,) * 5, (width,) * 3]


def test_kernel_refuses_no_head_dim():
    """No head dim is refused for its width, as the JAX kernels refuse
    none: ``_on_kernel``, the one gate of every CUDA wrapper, hands the
    launcher each width (padded to a multiple of 8), well past what one
    CTA's shared memory held before the output-column split (824). The
    plain version stands in for the launcher here."""
    seen = []

    def fwd(q, k, v, causal, scale):
        seen.append(q.shape[-1])
        return fa.flash_attention_reference(q, k, v, causal=causal,
                                            scale=scale)

    for d in (8, 20, 128, 136, 821, 825, 832, 1024, 4100):
        _, (q, k, v) = _inputs((1, 8, 1, d), "float32", seed=d)
        o, lse = fa._on_kernel(fwd, q, k, v, True, 1.0 / d ** 0.5)
        assert o.shape == q.shape and lse.shape == (1, 8)
        assert bool(torch.isfinite(o).all())
    assert seen == [8, 24, 128, 136, 824, 832, 832, 1024, 4104]


# (d, dtype) -> the wide library's kernels: bf16 up to 256 columns on the
# wgmma kernels at the next instantiation up, the rest on the sliced
# kernels over 256-column output slices.
WIDE_PLANS = {
    (136, "bfloat16"): ("wgmma", 192, 1),
    (192, "bfloat16"): ("wgmma", 192, 1),
    (200, "bfloat16"): ("wgmma", 256, 1),
    (248, "bfloat16"): ("wgmma", 256, 1),
    (256, "bfloat16"): ("wgmma", 256, 1),
    (264, "bfloat16"): ("sliced", None, 2),
    (832, "bfloat16"): ("sliced", None, 4),
    (1024, "bfloat16"): ("sliced", None, 4),
    (136, "float32"): ("sliced", None, 1),
    (256, "float32"): ("sliced", None, 1),
    (264, "float32"): ("sliced", None, 2),
    (1024, "float32"): ("sliced", None, 4),
}


@pytest.mark.parametrize("d,dtype", sorted(WIDE_PLANS))
def test_wide_plan_routes_each_head_dim(d, dtype):
    assert fa._wide_plan(d, getattr(torch, dtype)) == WIDE_PLANS[d, dtype]


# Wide heads against the JAX kernels in interpret mode: the forward with
# lse and the backward (dq, dk, dv through jax.vjp), at the tolerances of
# CASES and of test_torch_flash_backward.py (f32: summation order only;
# bf16: one bf16 ulp of the output, 1e-2 of the largest gradient). d = 256
# is the wgmma instantiation's width, d = 1024 four output-column slices
# of the simple kernels.
WIDE_TOL_O = {"float32": 2e-5, "bfloat16": 1e-2}
WIDE_TOL_GRAD = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [256, 1024])
def test_wide_heads_match_jax(d, dtype):
    shape = (1, 128, 2, d)
    b, s, h, _ = shape
    (jq, jk, jv), (tq, tk, tv) = _inputs(shape, dtype, seed=d)
    rng = np.random.default_rng(d + 1)
    do = rng.standard_normal(shape).astype(np.float32)
    jdo, tdo = jnp.asarray(do).astype(dtype), torch.from_numpy(do).to(
        getattr(torch, dtype))

    def fold(t):
        return t.transpose(0, 2, 1, 3).reshape(b * h, s, d)

    o_jax, vjp = jax.vjp(lambda q, k, v: jax_flash(q, k, v), jq, jk, jv)
    _, lse_jax = _flash_fwd(fold(jq), fold(jk), fold(jv), scale=d ** -0.5,
                            causal=True, block_q=1024, block_k=1024,
                            interpret=True)
    o, lse = fa.flash_attention_fwd(tq, tk, tv)
    tol = WIDE_TOL_O[dtype]
    np.testing.assert_allclose(_np(o), _np(o_jax), rtol=tol, atol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_jax[:, 0, :]),
                               rtol=LSE_TOL, atol=LSE_TOL)
    for t in (tq, tk, tv):
        t.requires_grad_()
    got = torch.autograd.grad(fa.flash_attention(tq, tk, tv), (tq, tk, tv),
                              grad_outputs=tdo)
    for g, r in zip(got, vjp(jdo)):
        r = _np(r)
        assert g.dtype == tq.dtype and g.shape == r.shape
        np.testing.assert_allclose(
            _np(g.detach()), r, rtol=0,
            atol=WIDE_TOL_GRAD[dtype] * np.abs(r).max())
