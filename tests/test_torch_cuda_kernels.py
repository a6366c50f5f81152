"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serving engine's, the train step's and the long-context
ring's device paths through them.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so on
a machine with a card and without JAX it runs with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``.
"""

import pytest
import torch

from kubeflow_tpu_torch.models import burnin
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.parallel import ring
from kubeflow_tpu_torch.serving.engine import (
    EngineOptions,
    Request,
    ServingEngine,
)

# bf16 O: one bf16 ulp at |O| < 2 (2**-7), from P rounded against a
# running rather than the final max: 2e-2. f32: summation order only.
TOL_O = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
TOL_LSE = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device).to(dtype)
            for _ in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,causal", [
    ((8, 1024, 16, 128), torch.bfloat16, True),    # the decode step
    ((1, 32, 16, 128), torch.bfloat16, True),      # a prefill chunk
    ((2, 2048, 4, 128), torch.bfloat16, True),     # past the JAX block
    ((2, 100, 3, 64), torch.bfloat16, False),      # ragged, full
    ((2, 256, 4, 64), torch.float32, False),
    ((1, 77, 2, 128), torch.float32, True),
    # Across the 128-row Q tile and the 128-key K/V tile: 1.5 and 2.5 tiles.
    ((2, 192, 4, 128), torch.bfloat16, True),
    ((1, 320, 2, 64), torch.bfloat16, False),
])
def test_kernel_matches_plain_version(cuda, shape, dtype, causal):
    q, k, v = _qkv(shape, dtype, cuda)
    before = fa.LAUNCHES
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 1
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), rtol=0,
                               atol=TOL_O[dtype])
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)


# Backward: dQ, dK, dV are stored in bf16 (one ulp is 2**-8 of the value)
# after P and dS were rounded to bf16 at the same points as the plain
# version, where an f32 value on a rounding boundary may go the other
# way: 1e-2 of the reference's largest magnitude. f32: summation order
# only: 1e-4 of it.
TOL_GRAD = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
TRAIN_SHAPE = (8, 1024, 16, 128)     # the train step's attention
BWD_CASES = {
    "train": (TRAIN_SHAPE, torch.bfloat16, True, 0, 0),
    "multi_tile": ((2, 2048, 4, 128), torch.bfloat16, True, 0, 0),
    "ragged_full_d64": ((2, 100, 3, 64), torch.bfloat16, False, 0, 0),
    "f32_causal": ((1, 77, 2, 128), torch.float32, True, 0, 0),
    # Ring hops: the K block below the diagonal, on it, and above it.
    "hop_below": ((2, 256, 4, 128), torch.bfloat16, True, 256, 0),
    "hop_diagonal": ((2, 256, 4, 128), torch.bfloat16, True, 256, 256),
    "hop_above": ((2, 256, 4, 128), torch.bfloat16, True, 0, 256),
    # Across the kernels' tiles (128 owned rows, 64 streamed): 1.5 Q tiles
    # and 3 key tiles; 2.5 tiles, full; an lse/delta row of 77 floats,
    # whose pitch is no multiple of 16 bytes.
    "straddle_causal": ((2, 192, 4, 128), torch.bfloat16, True, 0, 0),
    "straddle_full_d64": ((1, 320, 2, 64), torch.bfloat16, False, 0, 0),
    "ragged_causal": ((1, 77, 2, 128), torch.bfloat16, True, 0, 0),
    # Hops whose diagonal falls half-way into a 128-row tile: every row
    # sees a key at (192, 64); rows 0-127 see none at (64, 192).
    "hop_192_64": ((2, 256, 4, 128), torch.bfloat16, True, 192, 64),
    "hop_64_192": ((2, 256, 4, 128), torch.bfloat16, True, 64, 192),
}


def _bwd_inputs(shape, dtype, device, seed=3):
    q, k, v = _qkv(shape, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn(shape, generator=gen, device=device).to(dtype)
    o, lse = fa.flash_attention_reference(q, k, v)
    return q, k, v, o, lse, do


def _assert_grads_close(got, ref, dtype):
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape, name
        bound = TOL_GRAD[dtype] * r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= bound, (name, err, bound)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_backward_kernels_match_plain_version(cuda, case):
    shape, dtype, causal, q_off, k_off = BWD_CASES[case]
    q, k, v, o, lse, do = _bwd_inputs(shape, dtype, cuda)
    hop = q_off or k_off
    # A hop is handed the final lse and delta; a full call computes delta.
    delta = fa.attention_delta(o, do) if hop else None
    before = (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)
    got = fa.flash_attention_bwd(q, k, v, None if hop else o, lse, do,
                                 causal=causal, q_offset=q_off,
                                 k_offset=k_off, delta=delta)
    torch.cuda.synchronize()
    assert (fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES) == (before[0] + 1,
                                                         before[1] + 1)
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, do,
                                           causal=causal, q_offset=q_off,
                                           k_offset=k_off, delta=delta)
    _assert_grads_close(got, ref, dtype)
    if case == "hop_above":   # no key of the block reaches any query
        assert all(bool((g == 0).all()) for g in got)
    if case == "hop_64_192":  # rows 0-127 see no key: their dq is zero
        assert bool((got[0][:, :128] == 0).all())


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(cuda):
    q, k, v, o, lse, do = _bwd_inputs(TRAIN_SHAPE, torch.bfloat16, cuda)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dq_kernel_writes_the_delta_of_the_plain_version(cuda):
    q, k, v, o, lse, do = _bwd_inputs((2, 256, 4, 128), torch.bfloat16, cuda)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    torch.testing.assert_close(delta, fa.attention_delta(o, do), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.cuda
def test_backward_reads_qkv_slices_and_copies_only_an_expanded_do(cuda):
    b, s, h, d = 2, 256, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    o, lse = fa.flash_attention_fwd(q, k, v)
    do = torch.randn(o.shape, generator=gen, device=cuda).to(torch.bfloat16)
    copies = fa.DO_COPIES
    sliced = fa.flash_attention_bwd(q, k, v, o, lse, do)
    dense = fa.flash_attention_bwd(q.contiguous(), k.contiguous(),
                                   v.contiguous(), o, lse, do)
    assert fa.DO_COPIES == copies
    for a, c in zip(sliced, dense):
        assert torch.equal(a, c)
    ones = torch.ones((), device=cuda, dtype=torch.bfloat16).expand(o.shape)
    got = fa.flash_attention_bwd(q, k, v, o, lse, ones)
    assert fa.DO_COPIES == copies + 1
    ref = fa.flash_attention_bwd_reference(q, k, v, o, lse, ones)
    _assert_grads_close(got, ref, torch.bfloat16)


@pytest.mark.cuda
def test_kernel_reads_qkv_column_slices_through_their_strides(cuda):
    b, s, h, d = 2, 256, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    o, lse = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                      v.contiguous())
    torch.testing.assert_close(o, o2, rtol=0, atol=0)
    torch.testing.assert_close(lse, lse2, rtol=0, atol=0)


@pytest.mark.cuda
def test_forward_kernel_is_deterministic(cuda):
    q, k, v = _qkv((2, 1024, 4, 128), torch.bfloat16, cuda, seed=11)
    first = fa.flash_attention_fwd(q, k, v)
    again = fa.flash_attention_fwd(q, k, v)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_take_head_dims_past_the_old_cap(cuda, dtype):
    # The wide kernels once stopped at 824 columns (what one CTA's shared
    # memory held in dK/dV) and refused 825 and 832. Now the sliced
    # kernels split the output's columns into slices of 256 and stream
    # the inputs 64 columns a panel where they do not fit: 825 (padded to
    # 832), 832, 1024 and 4096 through all four kernels against their
    # plain versions, nothing refused.
    for d in (825, 832, 1024, 4096):
        _check_forward_and_backward((1, 64, 2, d), True, dtype, cuda)
        _check_partial_and_hop_backward((1, 96, 2, d), 96, 0, dtype, cuda)
        _check_partial_and_hop_backward((1, 96, 2, d), 0, 0, dtype, cuda)


# Plans the wide library has no kernels for, (d, dtype, width, slices):
# a wgmma width narrower than d, f32 or a third width on wgmma, wgmma
# over two slices, and too few or too many sliced slices.
LACKING_PLANS = [
    (256, torch.bfloat16, 192, 1),
    (136, torch.float32, 192, 1),
    (136, torch.bfloat16, 128, 1),
    (256, torch.bfloat16, 256, 2),
    (264, torch.bfloat16, 0, 1),
    (264, torch.float32, 0, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,width,slices", LACKING_PLANS)
def test_wide_library_refuses_plans_it_lacks(cuda, monkeypatch, d, dtype,
                                             width, slices):
    # The wrapper's _wide_plan chooses the wide kernels and hands the plan
    # to the library, which runs it or refuses it; it never chooses.
    q, k, v = _qkv((1, 64, 2, d), dtype, cuda)
    o, lse = fa.flash_attention_reference(q, k, v)
    monkeypatch.setattr(fa, "_plan_args", lambda q: (width, slices))
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention_fwd(q, k, v)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention_partial(q, k, v, 0, 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention_bwd_dkv(q, k, v, lse, q, lse)
    with pytest.raises(RuntimeError, match="launch failed"):
        fa.flash_attention_bwd_dq(q, k, v, o, lse, q)


# Every head dim the JAX kernels take: no multiple of 8 (20, 36: padded
# with zero columns onto the 128-column kernels); above their tile: 136
# and 192 (the wgmma kernels at 192 columns), 200, 248 and Gemma's 256 (at
# 256), 264 (two output-column slices of the sliced kernels), 824, 832 and
# 1024 (four); through all four kernels at the tolerances above. Causal
# cases span 1.25 of the 128-row Q tiles and 2.5 of dK/dV's 64-key tiles;
# full cases are ragged.
ANY_HEAD_DIMS = (20, 36, 136, 192, 200, 248, 256, 264, 824, 832, 1024)


def _any_head_dim_shape(d, causal):
    if d >= 824:
        return (1, 64, 2, d) if causal else (1, 45, 1, d)
    return (2, 160, 3, d) if causal else (1, 77, 2, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
def test_any_head_dim_forward_and_backward_match_plain_version(cuda, d,
                                                               causal,
                                                               dtype):
    _check_forward_and_backward(_any_head_dim_shape(d, causal), causal,
                                dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", ANY_HEAD_DIMS)
@pytest.mark.parametrize("case", ["below", "diagonal", "above",
                                  "unaligned"])
def test_any_head_dim_partial_and_hop_backward_match_plain_version(
        cuda, case, d, dtype):
    shape, q_off, k_off = PARTIAL_CASES[case]
    shape = (1, 96, 2, d) if d >= 824 else shape[:3] + (d,)
    _check_partial_and_hop_backward(shape, q_off * shape[1] // 256,
                                    k_off * shape[1] // 256, dtype, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [136, 192, 200, 248, 256])
@pytest.mark.parametrize("case", ["straddle_192_64", "straddle_64_192",
                                  "ragged_diagonal"])
def test_wgmma_head_dims_hop_backward_matches_plain_version(cuda, case, d):
    # The wgmma dQ and dK/dV at hops whose diagonal falls half-way into a
    # 128-row Q tile and a ragged one, delta given: at (64, 192) rows 0-127
    # see no key of the block and get a zero dq.
    shape, q_off, k_off = PARTIAL_CASES[case]
    q, k, v, o, lse, do = _bwd_inputs(shape[:3] + (d,), torch.bfloat16,
                                      cuda)
    delta = fa.attention_delta(o, do)
    got = fa.flash_attention_bwd(q, k, v, None, lse, do, q_offset=q_off,
                                 k_offset=k_off, delta=delta)
    _assert_grads_close(got, fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, q_offset=q_off, k_offset=k_off, delta=delta),
        torch.bfloat16)
    if case == "straddle_64_192":
        assert bool((got[0][:, :128] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [20, 136, 256])
def test_any_head_dim_reads_qkv_column_slices(cuda, d):
    """Heads d elements apart in one [b, s, 3*h*d] product, as the models
    hand them over: the same bits as the contiguous case."""
    b, s, h = 2, 96, 3
    gen = torch.Generator(device=cuda).manual_seed(13)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn((b, s, h, d), generator=gen,
                     device=cuda).to(torch.bfloat16)
    dense = [t.contiguous() for t in (q, k, v)]
    o, lse = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(*dense)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, c in zip(fa.flash_attention_bwd(q, k, v, o, lse, do),
                    fa.flash_attention_bwd(*dense, o, lse, do)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_wide_dq_kernel_is_deterministic(cuda):
    # The wgmma dQ at 256 columns, computing delta from O: no atomics; the
    # same inputs give the same bits, dq and delta.
    q, k, v, o, lse, do = _bwd_inputs((8, 1024, 16, 256), torch.bfloat16,
                                      cuda)
    first = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,kernel", [
    (136, torch.bfloat16, "wide_dq_bf16_kernel<192>"),
    (200, torch.bfloat16, "wide_dq_bf16_kernel<256>"),
    (256, torch.bfloat16, "wide_dq_bf16_kernel<256>"),
    (264, torch.bfloat16, "wide_dq_bf16_sliced_kernel"),
    (136, torch.float32, "dq_f32_tiled_kernel<192>"),
])
def test_wide_dq_launches_the_kernel_of_its_plan(cuda, d, dtype, kernel):
    # bf16 heads up to 256 columns take the wgmma dQ at the narrowest
    # width that holds them, wider bf16 heads the sliced wgmma dQ; f32
    # heads the register-tiled dQ.
    from torch.profiler import ProfilerActivity, profile

    q, k, v, o, lse, do = _bwd_inputs((1, 128, 2, d), dtype, cuda)
    fa.flash_attention_bwd_dq(q, k, v, o, lse, do)   # built, loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_bwd_dq(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if "wide_dq" in ev.key or "dq_f32_tiled" in ev.key]
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,kernel", [
    (136, torch.bfloat16, "wide_dkv_bf16_kernel<192>"),
    (200, torch.bfloat16, "wide_dkv_bf16_kernel<256>"),
    (256, torch.bfloat16, "wide_dkv_bf16_kernel<256>"),
    (264, torch.bfloat16, "wide_dkv_bf16_sliced_kernel"),
    (1024, torch.bfloat16, "wide_dkv_bf16_sliced_kernel"),
    (136, torch.float32, "dkv_f32_tiled_kernel<192>"),
])
def test_wide_dkv_launches_the_kernel_of_its_plan(cuda, d, dtype, kernel):
    # dK/dV as dQ: the wgmma kernel at the narrowest width that holds a
    # bf16 head up to 256 columns, the sliced wgmma kernel above, the
    # register-tiled one in f32.
    from torch.profiler import ProfilerActivity, profile

    q, k, v, o, lse, do = _bwd_inputs((1, 128, 2, d), dtype, cuda)
    delta = fa.attention_delta(o, do)
    fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta)   # built, loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta)
        torch.cuda.synchronize()
    names = [ev.key for ev in prof.key_averages()
             if "wide_dkv" in ev.key or "dkv_f32_tiled" in ev.key]
    assert len(names) == 1 and kernel in names[0], names


@pytest.mark.cuda
def test_wide_dq_sliced_plan_matches_plain_version(cuda):
    # The sliced dQ takes bf16 at 256 columns too (the plan (0, 1)), where
    # it is timed beside the wgmma dQ.
    q, k, v, o, lse, do = _bwd_inputs((2, 160, 3, 256), torch.bfloat16,
                                      cuda)
    got, delta = fa._launch_dq(q, k, v, o, lse, do, None, True,
                               256 ** -0.5, 0, 0, plan=(0, 1))
    ref, rdelta = fa.flash_attention_bwd_dq_reference(q, k, v, o, lse, do)
    bound = TOL_GRAD[torch.bfloat16] * ref.float().abs().max().item()
    assert (got.float() - ref.float()).abs().max().item() <= bound
    torch.testing.assert_close(delta, rdelta, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_wide_dkv_kernel_is_deterministic(cuda):
    # The wgmma dK/dV at 256 columns: two warpgroups hand P^T over through
    # shared memory, no atomics; the same inputs give the same bits.
    q, k, v, o, lse, do = _bwd_inputs((2, 1024, 4, 256), torch.bfloat16,
                                      cuda)
    delta = fa.attention_delta(o, do)
    first = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta)
    again = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_column_slices_share_their_softmax_statistics(cuda, dtype):
    # At d = 1024 each of the four output-column slices of a wide kernel
    # computes the softmax statistics (lse; m and l; delta) on its own, and
    # slice 0 alone writes them. With q, k, v and dO made of four equal
    # 256-column blocks, every slice's output block comes from the same
    # statistics and the same products in the same order: the four blocks
    # of o, acc, dq, dk and dv must be bitwise equal; lse and the partial
    # are held against their plain versions too.
    b, s, h, d = 1, 96, 2, 1024
    block = [t.contiguous() for t in _bwd_inputs((b, s, h, 256), dtype,
                                                 cuda)]
    q, k, v, _, _, do = (t.repeat(1, 1, 1, 4) for t in block)
    o, lse = fa.flash_attention_fwd(q, k, v)
    acc, m, l = fa.flash_attention_partial(q, k, v, 0, 0)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for t in (o, acc, *grads):
        parts = t.split(256, dim=-1)
        assert all(torch.equal(parts[0], p) for p in parts[1:])
    _, rlse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)
    _assert_partial_close((acc, m, l), fa.flash_attention_partial_reference(
        q, k, v, 0, 0), dtype)


# The sliced bf16 backward (wide_dq_bf16_sliced_kernel and
# wide_dkv_bf16_sliced_kernel, wgmma over 256-column output slices): Q and
# dO resident in dQ up to 320 columns, K and V in dK/dV up to 384, both
# streamed above. Causal cases span several 128-row Q tiles and 64-key
# tiles; full cases are ragged.
SLICED_BWD_DIMS = (264, 320, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", SLICED_BWD_DIMS)
def test_sliced_bf16_backward_matches_plain_version(cuda, d, causal):
    shape = _redesigned_shape(d, causal)
    q, k, v, _, _, do = _bwd_inputs(shape, torch.bfloat16, cuda, seed=d)
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    before = _counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _counts()[1:] == (before[1] + 2, before[2] + 1)
    _assert_grads_close(got, fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=causal), torch.bfloat16)
    torch.testing.assert_close(delta, fa.attention_delta(o, do), rtol=0,
                               atol=1e-3)


@pytest.mark.cuda
def test_sliced_bf16_backward_is_deterministic(cuda):
    # No atomics: dq (delta computed from O), dk and dv of the sliced pair
    # at two slices repeat bitwise.
    q, k, v, o, lse, do = _bwd_inputs((2, 1024, 4, 320), torch.bfloat16,
                                      cuda)
    first = fa.flash_attention_bwd(q, k, v, o, lse, do)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kernels_take_more_than_65535_batch_heads(cuda, dtype):
    # b*h = 66560: past a grid's y and z limits, which the f32 kernels
    # once put heads on.
    shape = (1040, 64, 64, 16)
    q, k, v, _, _, do = _bwd_inputs(shape, dtype, cuda)
    before = _counts() + (fa.PARTIAL_LAUNCHES,)
    o, lse = fa.flash_attention_fwd(q, k, v)
    ro, rlse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(o.float(), ro.float(), rtol=0,
                               atol=TOL_O[dtype])
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)
    del o, lse
    _assert_grads_close(
        fa.flash_attention_bwd(q, k, v, ro, rlse, do),
        fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do), dtype)
    _assert_partial_close(
        fa.flash_attention_partial(q, k, v, 64, 0),
        fa.flash_attention_partial_reference(q, k, v, 64, 0), dtype)
    torch.cuda.synchronize()
    assert _counts() + (fa.PARTIAL_LAUNCHES,) == tuple(
        c + 1 for c in before)


# Narrow heads, as the JAX package's default configs give them (d_model
# 128 over 4 heads: 32; bench.py's MC_LONGCTX_MODEL: 16), and two more
# multiples of 8 on each tile width, through all four kernels in both
# dtypes, at the same tolerances as the wide heads.
NARROW_CASES = {
    "d16_causal": ((2, 256, 4, 16), True),
    "d32_causal": ((2, 192, 4, 32), True),
    "d32_full_ragged": ((2, 100, 3, 32), False),
    "d16_full_ragged": ((1, 77, 2, 16), False),
    "d8_causal": ((1, 128, 2, 8), True),
    "d40_causal": ((1, 160, 2, 40), True),
    "d96_causal": ((1, 256, 2, 96), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(NARROW_CASES))
def test_narrow_heads_forward_and_backward_match_plain_version(cuda, case,
                                                               dtype):
    shape, causal = NARROW_CASES[case]
    _check_forward_and_backward(shape, causal, dtype, cuda)


def _check_forward_and_backward(shape, causal, dtype, device):
    """The forward and the backward (one launch each) against their plain
    versions, and the two backward kernels alone as a ring hop calls them
    (delta given)."""
    q, k, v, _, _, do = _bwd_inputs(shape, dtype, device)
    before = _counts()
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
    got = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal=causal)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + 1 for c in before)
    assert o.shape == q.shape and all(g.shape == q.shape for g in got)
    torch.testing.assert_close(o.float(), ro.float(), rtol=0,
                               atol=TOL_O[dtype])
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)
    ref = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                           causal=causal)
    _assert_grads_close(got, ref, dtype)
    delta = fa.attention_delta(ro, do)
    dq, _ = fa.flash_attention_bwd_dq(q, k, v, None, rlse, do,
                                      causal=causal, delta=delta)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, rlse, do, delta,
                                        causal=causal)
    _assert_grads_close((dq, dk, dv), ref, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [16, 32])
@pytest.mark.parametrize("case", ["below", "diagonal", "above",
                                  "straddle_64_192"])
def test_narrow_heads_partial_and_hop_backward_match_plain_version(
        cuda, case, d, dtype):
    shape, q_off, k_off = PARTIAL_CASES[case]
    _check_partial_and_hop_backward(shape[:3] + (d,), q_off, k_off, dtype,
                                    cuda)


def _check_partial_and_hop_backward(shape, q_off, k_off, dtype, device):
    """The partial kernel at a hop's offsets and the backward kernels
    there (the final delta given) against their plain versions."""
    q, k, v, o, lse, do = _bwd_inputs(shape, dtype, device)
    before = fa.PARTIAL_LAUNCHES
    got = fa.flash_attention_partial(q, k, v, q_off, k_off)
    delta = fa.attention_delta(o, do)
    grads = fa.flash_attention_bwd(q, k, v, None, lse, do, q_offset=q_off,
                                   k_offset=k_off, delta=delta)
    torch.cuda.synchronize()
    assert fa.PARTIAL_LAUNCHES == before + 1
    _assert_partial_close(
        got, fa.flash_attention_partial_reference(q, k, v, q_off, k_off),
        dtype)
    _assert_grads_close(grads, fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, q_offset=q_off, k_offset=k_off, delta=delta),
        dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32])
def test_narrow_heads_read_qkv_column_slices_through_their_strides(cuda, d):
    """As ``burnin._attention`` hands them over: q, k, v are column slices
    of one [b, s, 3*h*d] product, their heads d elements apart."""
    b, s, h = 2, 256, 4
    gen = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn((b, s, h, d), generator=gen,
                     device=cuda).to(torch.bfloat16)
    o, lse = fa.flash_attention_fwd(q, k, v)
    dense = [t.contiguous() for t in (q, k, v)]
    o2, lse2 = fa.flash_attention_fwd(*dense)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for a, c in zip(fa.flash_attention_bwd(q, k, v, o, lse, do),
                    fa.flash_attention_bwd(*dense, o, lse, do)):
        assert torch.equal(a, c)
    for a, c in zip(fa.flash_attention_partial(q, k, v, 256, 256),
                    fa.flash_attention_partial(*dense, 256, 256)):
        assert torch.equal(a, c)


@pytest.mark.cuda
def test_kernel_refuses_layouts_it_cannot_read_instead_of_copying(cuda):
    q, k, v = _qkv((1, 64, 2, 128), torch.bfloat16, cuda)
    before = fa.LAUNCHES
    q_heads_minor = q.mT.contiguous().mT     # head_dim stride 2, not 1
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_fwd(q_heads_minor, k, v)
    assert fa.LAUNCHES == before


@pytest.mark.cuda
def test_flash_forward_matches_dense_on_the_card(cuda):
    cfg = burnin.BurninConfig(vocab=256, d_model=256, n_heads=2,
                              n_layers=2, d_ff=512, seq_len=128,
                              attention="flash")
    params = burnin.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (2, cfg.seq_len), generator=gen,
                           device=cuda)
    before = fa.LAUNCHES
    with torch.inference_mode():
        flash = burnin.forward(params, tokens, cfg)
        dense = burnin.forward(
            params, tokens,
            burnin.BurninConfig(**{**cfg.__dict__, "attention": "xla"}))
    assert fa.LAUNCHES == before + cfg.n_layers
    assert bool(torch.isfinite(flash).all())
    # bf16 rounding of attention at other points (see chip_smoke.py).
    assert (flash - dense).abs().max().item() < 0.125


@pytest.mark.cuda
def test_engine_serves_through_the_kernel(cuda):
    cfg = burnin.BurninConfig(vocab=128, d_model=128, n_heads=2, n_layers=2,
                              d_ff=256, seq_len=64, attention="flash")
    engine = ServingEngine(cfg, max_batch=4, use_mesh=False,
                           options=EngineOptions(prefill_chunk=16))
    assert engine.device.type == "cuda"
    before = fa.LAUNCHES
    engine.cold_start(seed=0)
    report = engine.serve([Request(rid=i, arrival=0.0, tokens_out=3,
                                   prompt_tokens=40 if i == 0 else 0)
                           for i in range(6)])
    forwards = 2 + report.steps + report.prefill_chunks   # 2 = warm-up
    assert len(report.completions) == 6
    assert report.prefill_chunks == 3                     # ceil(40 / 16)
    assert fa.LAUNCHES - before == cfg.n_layers * forwards
    engine.kv.assert_consistent()
    assert engine.kv.used_blocks == 0


# Flash vs dense gradients in bf16: the dense path rounds logits and
# probabilities to bf16, the flash path keeps scores in f32 (measured on
# this config with the plain versions on the CPU: rel L2 1.2e-2, cosine
# 0.99994; loss 1.7e-4).
TOL_GRAD_REL_L2 = 0.05
MIN_GRAD_COSINE = 0.999
SMALL_TRAIN = dict(vocab=256, d_model=256, n_heads=2, n_layers=2, d_ff=512,
                   seq_len=129, attention="flash")


def _train_inputs(cfg, device, seed=0):
    params = burnin.init_params(cfg, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 7)
    tokens = torch.randint(0, cfg.vocab, (2, cfg.seq_len), generator=gen,
                           device=device)
    return params, tokens


def _counts():
    return (fa.LAUNCHES, fa.BWD_DQ_LAUNCHES, fa.BWD_DKV_LAUNCHES)


@pytest.mark.cuda
def test_flash_gradients_reach_qkv_and_ln1_and_match_dense(cuda):
    """The forward kernel's output used to carry no grad_fn, so with
    attention="flash" on the card the backward stopped at every attention
    block: qkv got no gradient and ln1 only part of its. Through the
    autograd Function every leaf gets the dense path's gradient."""
    cfg = burnin.BurninConfig(**SMALL_TRAIN)
    dense = burnin.BurninConfig(**{**SMALL_TRAIN, "attention": "xla"})
    params, tokens = _train_inputs(cfg, cuda)
    before = _counts()
    loss, grads = burnin.value_and_grad(burnin.loss_fn, params, tokens, cfg)
    torch.cuda.synchronize()
    assert _counts() == tuple(c + cfg.n_layers for c in before)
    ref_loss, ref = burnin.value_and_grad(burnin.loss_fn, params, tokens,
                                          dense)
    assert abs(float(loss) - float(ref_loss)) < 0.01
    it = iter(grads)
    tree = burnin.map_params(lambda _: next(it), params)
    for layer in tree["layers"]:
        assert bool((layer["qkv"] != 0).any())
        assert bool((layer["ln1"] != 0).any())
    for g, r in zip(grads, ref):
        assert bool(torch.isfinite(g).all())
        rel = ((g - r).norm() / r.norm()).item()
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), r.flatten(), dim=0).item()
        assert rel <= TOL_GRAD_REL_L2 and cos >= MIN_GRAD_COSINE, (rel, cos)


@pytest.mark.cuda
def test_train_step_on_the_card(cuda):
    cfg = burnin.BurninConfig(**SMALL_TRAIN)
    params, tokens = _train_inputs(cfg, cuda, seed=1)
    step = burnin.make_train_step(cfg)
    before, copies = _counts(), fa.DO_COPIES
    params, loss1 = step(params, tokens)
    params, loss2 = step(params, tokens)
    assert params["embed"].device.type == "cuda"
    assert bool(torch.isfinite(loss1)) and float(loss2) < float(loss1)
    # One forward, one dQ and one dK/dV launch per layer and step, and the
    # step's dO reaches the kernels with no copy.
    assert _counts() == tuple(c + 2 * cfg.n_layers for c in before)
    assert fa.DO_COPIES == copies


# The ring hop's partial kernel. acc is f32 from bf16 P (rounded against
# the running max in the kernel, the final max in the plain version): 1e-2
# of the reference's largest magnitude in bf16, 1e-4 in f32 (summation
# order only). m and l are f32 from f32 scores in both: m within 1e-4, l
# within 1e-4 of its largest value.
TOL_ACC = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
TOL_M = 1e-4
TOL_L = 1e-4
# (shape, q_offset, k_offset): a 4-shard ring's hops below, on and above
# the diagonal, and offsets that are not multiples of the tile, where some
# rows of a live tile see no key. The straddle cases put the diagonal
# half-way into a 128-row tile: at (192, 64) every row sees a key, at
# (64, 192) rows 0-127 see none and rows 128-255 do.
PARTIAL_CASES = {
    "below": ((2, 256, 4, 128), 256, 0),
    "diagonal": ((2, 256, 4, 128), 256, 256),
    "above": ((2, 256, 4, 128), 0, 256),
    "unaligned": ((2, 192, 3, 128), 96, 160),
    "ragged_diagonal": ((1, 100, 2, 128), 100, 100),
    "straddle_192_64": ((2, 256, 4, 128), 192, 64),
    "straddle_64_192": ((2, 256, 4, 128), 64, 192),
}


def _assert_partial_close(got, ref, dtype):
    (o, m, l), (ro, rm, rl) = got, ref
    assert o.dtype == m.dtype == l.dtype == torch.float32
    assert o.shape == ro.shape and m.shape == rm.shape == l.shape
    top = ro.abs().max().item()
    assert (o - ro).abs().max().item() <= TOL_ACC[dtype] * max(top, 1e-30)
    assert (m - rm).abs().max().item() <= TOL_M
    assert (l - rl).abs().max().item() <= TOL_L * max(rl.max().item(), 1.0)
    unseen = rm == -1e30                   # rows no key of the block reaches
    assert torch.equal(unseen, m == -1e30)
    assert bool((l[unseen] == 0).all())
    assert bool((o.transpose(1, 2)[unseen] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
def test_partial_kernel_matches_plain_version(cuda, case, d, dtype):
    shape, q_off, k_off = PARTIAL_CASES[case]
    q, k, v = _qkv(shape[:3] + (d,), dtype, cuda, seed=6)
    before = fa.PARTIAL_LAUNCHES
    got = fa.flash_attention_partial(q, k, v, q_off, k_off)
    torch.cuda.synchronize()
    assert fa.PARTIAL_LAUNCHES == before + 1
    ref = fa.flash_attention_partial_reference(q, k, v, q_off, k_off)
    _assert_partial_close(got, ref, dtype)
    if case == "above":        # no key reaches any query: exactly nothing
        o, m, l = got
        assert bool((o == 0).all()) and bool((l == 0).all())
        assert bool((m == -1e30).all())


@pytest.mark.cuda
def test_partial_kernel_reads_qkv_column_slices_through_their_strides(cuda):
    b, s, h, d = 1, 512, 4, 128
    gen = torch.Generator(device=cuda).manual_seed(8)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    sliced = fa.flash_attention_partial(q, k, v, 512, 512)
    dense = fa.flash_attention_partial(q.contiguous(), k.contiguous(),
                                       v.contiguous(), 512, 512)
    for a, c in zip(sliced, dense):
        assert torch.equal(a, c)


# The redesigned forward kernels: f32 at every head dim on the CUDA cores
# (flash_attention_f32.cuh: 16-128 output columns in the 128-column
# library, 192 and 256-column slices in the wide one) and bf16 above 256
# columns on wgmma (wide_{fwd,partial}_bf16_sliced_kernel: Q resident up
# to 512 columns, streamed above). Causal cases span several 64- and
# 128-row Q tiles and 64-key K tiles; full cases are ragged.
REDESIGNED_FWD = ([(d, torch.float32)
                   for d in (16, 32, 64, 128, 136, 256, 264, 1024)]
                  + [(d, torch.bfloat16) for d in (264, 320, 512, 1024)])


def _redesigned_shape(d, causal):
    if d >= 512:
        return (1, 200, 2, d) if causal else (1, 137, 2, d)
    return (2, 300, 3, d) if causal else (2, 211, 3, d)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d,dtype", REDESIGNED_FWD)
def test_redesigned_forward_matches_plain_version(cuda, d, dtype, causal):
    q, k, v = _qkv(_redesigned_shape(d, causal), dtype, cuda, seed=d)
    before = fa.LAUNCHES
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    again = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.LAUNCHES == before + 2
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
    assert o.dtype == dtype and o.shape == q.shape
    torch.testing.assert_close(o.float(), ro.float(), rtol=0,
                               atol=TOL_O[dtype])
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)
    # Two launches on the same inputs: the same bits.
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["below", "diagonal", "above"])
@pytest.mark.parametrize("d,dtype", REDESIGNED_FWD)
def test_redesigned_partial_matches_plain_version(cuda, case, d, dtype):
    shape, q_off, k_off = PARTIAL_CASES[case]
    shape = (1, 256, 2, d) if d >= 512 else shape[:3] + (d,)
    q, k, v = _qkv(shape, dtype, cuda, seed=d + 1)
    before = fa.PARTIAL_LAUNCHES
    got = fa.flash_attention_partial(q, k, v, q_off, k_off)
    again = fa.flash_attention_partial(q, k, v, q_off, k_off)
    torch.cuda.synchronize()
    assert fa.PARTIAL_LAUNCHES == before + 2
    _assert_partial_close(got, fa.flash_attention_partial_reference(
        q, k, v, q_off, k_off), dtype)
    assert all(torch.equal(a, c) for a, c in zip(got, again))
    if case == "above":        # no key reaches any query: exactly nothing
        o, m, l = got
        assert bool((o == 0).all()) and bool((l == 0).all())
        assert bool((m == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(16, torch.float32),
                                     (136, torch.float32),
                                     (264, torch.float32),
                                     (264, torch.bfloat16),
                                     (320, torch.bfloat16),
                                     (1024, torch.bfloat16)])
def test_redesigned_forward_reads_qkv_column_slices(cuda, d, dtype):
    """Heads d elements apart in one [b, s, 3*h*d] product, as the models
    hand them over: the forward and the partial give the contiguous
    case's bits."""
    b, s, h = 2, 160, 3
    gen = torch.Generator(device=cuda).manual_seed(14)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=cuda).to(dtype)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    dense = [t.contiguous() for t in (q, k, v)]
    for got, want in ((fa.flash_attention_fwd(q, k, v),
                       fa.flash_attention_fwd(*dense)),
                      (fa.flash_attention_partial(q, k, v, s, 0),
                       fa.flash_attention_partial(*dense, s, 0))):
        assert all(torch.equal(a, c) for a, c in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype", [(512, torch.bfloat16),
                                     (512, torch.float32),
                                     (2048, torch.bfloat16)])
def test_redesigned_forward_slices_share_their_statistics(cuda, d, dtype):
    # Two slices with Q resident (bf16 512), two f32 slices, and eight with
    # Q streamed (bf16 2048): with q, k, v made of equal 256-column blocks
    # every slice's block of o and acc is bitwise equal to slice 0's, and
    # lse, m and l (which slice 0 writes) hold against the plain versions.
    q, k, v = (t.repeat(1, 1, 1, d // 256)
               for t in _qkv((1, 192, 2, 256), dtype, cuda, seed=15))
    o, lse = fa.flash_attention_fwd(q, k, v)
    acc, m, l = fa.flash_attention_partial(q, k, v, 0, 0)
    torch.cuda.synchronize()
    for t in (o, acc):
        parts = t.split(256, dim=-1)
        assert all(torch.equal(parts[0], x) for x in parts[1:])
    _, rlse = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(lse, rlse, rtol=0, atol=TOL_LSE)
    _assert_partial_close((acc, m, l), fa.flash_attention_partial_reference(
        q, k, v, 0, 0), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,kernel", [
    (16, torch.float32, "fwd_f32_tiled_kernel<16, {}>"),
    (64, torch.float32, "fwd_f32_tiled_kernel<64, {}>"),
    (128, torch.float32, "fwd_f32_tiled_kernel<128, {}>"),
    (136, torch.float32, "fwd_f32_tiled_kernel<192, {}>"),
    (264, torch.float32, "fwd_f32_tiled_kernel<256, {}>"),
    (264, torch.bfloat16, "wide_{}_bf16_sliced_kernel"),
    (320, torch.bfloat16, "wide_{}_bf16_sliced_kernel"),
])
def test_forward_launches_the_kernel_of_its_route(cuda, d, dtype, kernel):
    # Every f32 head runs the CUDA-core design at the narrowest output
    # width that holds it; bf16 above 256 columns the sliced wgmma kernel.
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _qkv((1, 128, 2, d), dtype, cuda)
    fa.flash_attention_fwd(q, k, v)
    fa.flash_attention_partial(q, k, v, 0, 0)   # built, loaded
    torch.cuda.synchronize()
    for run, want in (
            (lambda: fa.flash_attention_fwd(q, k, v),
             kernel.format("false" if "f32" in kernel else "fwd")),
            (lambda: fa.flash_attention_partial(q, k, v, 0, 0),
             kernel.format("true" if "f32" in kernel else "partial"))):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        names = [ev.key for ev in prof.key_averages()
                 if "f32_tiled" in ev.key or "bf16_sliced" in ev.key]
        assert len(names) == 1 and want in names[0], (want, names)


# The redesigned f32 backward: dq_f32_tiled_kernel and dkv_f32_tiled_kernel
# (flash_attention_f32_bwd.cuh) at every head dim, 16-128 output columns in
# the 128-column library and 192- or 256-column slices in the wide one.
# Causal cases span several 64- and 128-row owned tiles and 64-row
# streamed tiles; full cases are ragged.
F32_BWD_DIMS = (8, 16, 32, 64, 128, 136, 256, 264, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", F32_BWD_DIMS)
def test_redesigned_f32_backward_matches_plain_version(cuda, d, causal):
    shape = _redesigned_shape(d, causal)
    q, k, v, _, _, do = _bwd_inputs(shape, torch.float32, cuda, seed=d)
    o, lse = fa.flash_attention_reference(q, k, v, causal=causal)
    before = _counts()
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert _counts()[1:] == (before[1] + 3, before[2] + 2)
    _assert_grads_close(got, fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, causal=causal), torch.float32)
    torch.testing.assert_close(delta, fa.attention_delta(o, do), rtol=0,
                               atol=1e-3)
    # Two launches on the same inputs: the same bits.
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128, 264])
@pytest.mark.parametrize("case", ["below", "diagonal", "above", "unaligned",
                                  "straddle_64_192"])
def test_redesigned_f32_hop_backward_matches_plain_version(cuda, case, d):
    # One ring hop's backward as the ring calls it: the final lse and delta
    # as [b, h, s], the blocks' global offsets; a query that sees no key
    # of the block gets a zero dq, a key that no query sees zero dk, dv.
    shape, q_off, k_off = PARTIAL_CASES[case]
    q, k, v, o, lse, do = _bwd_inputs(shape[:3] + (d,), torch.float32, cuda)
    b, s, h, _ = q.shape
    delta = fa.attention_delta(o, do)
    before = _counts()
    got = fa.flash_attention_partial_grads(
        q, k, v, do, lse.reshape(b, h, s), delta.reshape(b, h, s), q_off,
        k_off)
    torch.cuda.synchronize()
    assert _counts()[1:] == (before[1] + 1, before[2] + 1)
    _assert_grads_close(got, fa.flash_attention_bwd_reference(
        q, k, v, o, lse, do, q_offset=q_off, k_offset=k_off, delta=delta),
        torch.float32)
    if case == "above":
        assert all(bool((g == 0).all()) for g in got)
    if case == "straddle_64_192":
        assert bool((got[0][:, :128] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128, 264])
def test_redesigned_f32_backward_reads_qkv_column_slices(cuda, d):
    """Heads d elements apart in one [b, s, 3*h*d] product, as the models
    hand them over: dq, dk and dv are the contiguous case's bits."""
    b, s, h = 2, 160, 3
    gen = torch.Generator(device=cuda).manual_seed(16)
    qkv = torch.randn((b, s, 3 * h * d), generator=gen, device=cuda)
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(h * d, dim=-1))
    do = torch.randn((b, s, h, d), generator=gen, device=cuda)
    dense = [t.contiguous() for t in (q, k, v)]
    o, lse = fa.flash_attention_reference(*dense)
    for a, c in zip(fa.flash_attention_bwd(q, k, v, o, lse, do),
                    fa.flash_attention_bwd(*dense, o, lse, do)):
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("d,width", [(8, 16), (16, 16), (32, 32), (40, 64),
                                     (64, 64), (128, 128), (136, 192),
                                     (256, 256), (264, 256)])
def test_f32_backward_launches_the_kernels_of_its_route(cuda, d, width):
    # Every f32 head runs the register-tiled pair at the narrowest output
    # width that holds it (256-column slices above 256).
    from torch.profiler import ProfilerActivity, profile

    q, k, v, o, lse, do = _bwd_inputs((1, 128, 2, d), torch.float32, cuda)
    fa.flash_attention_bwd(q, k, v, o, lse, do)   # built, loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
    names = sorted(ev.key for ev in prof.key_averages()
                   if "_kernel" in ev.key and ("dq" in ev.key
                                               or "dkv" in ev.key))
    assert len(names) == 2, names
    assert f"dkv_f32_tiled_kernel<{width}>" in names[0], names
    assert f"dq_f32_tiled_kernel<{width}>" in names[1], names


@pytest.mark.cuda
def test_ring_flash_on_one_card_matches_the_dense_ring(cuda):
    """World size 1: one hop at offsets (0, 0) through the partial kernel
    forward and the dQ and dK/dV kernels backward (delta given), against
    autograd through the dense ("xla") ring on the same bf16 inputs."""
    shape = (1, 1024, 4, 128)
    q, k, v = _qkv(shape, torch.bfloat16, cuda, seed=9)
    gen = torch.Generator(device=cuda).manual_seed(10)
    do = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    axis = ring.Axis()
    results = {}
    for impl in ("flash", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = (fa.LAUNCHES, fa.PARTIAL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
                  fa.BWD_DKV_LAUNCHES)
        out = ring.ring_attention_local(*leaves, axis, block_impl=impl)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        after = (fa.LAUNCHES, fa.PARTIAL_LAUNCHES, fa.BWD_DQ_LAUNCHES,
                 fa.BWD_DKV_LAUNCHES)
        results[impl] = (out, grads, [a - b for a, b in zip(after, before)])
    (out, grads, launches), (ref_out, ref_grads, _) = (results["flash"],
                                                       results["xla"])
    assert launches == [0, 1, 1, 1]
    # The dense ring rounds logits to bf16, the kernels keep f32 scores.
    assert (out.float() - ref_out.float()).abs().max().item() < 2e-2
    for g, r in zip(grads, ref_grads):
        g, r = g.float(), r.float()
        rel = ((g - r).norm() / r.norm()).item()
        cos = torch.nn.functional.cosine_similarity(
            g.flatten(), r.flatten(), dim=0).item()
        assert rel <= TOL_GRAD_REL_L2 and cos >= MIN_GRAD_COSINE, (rel, cos)
