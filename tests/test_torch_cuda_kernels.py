"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the serving engine's device path through them.

Every test here needs an NVIDIA GPU and skips without one (a CUDA kernel
has no CPU mode). The file imports neither JAX nor the JAX package, so on
a machine with a card and without JAX it runs with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``.
"""

import pytest
import torch

from kubeflow_tpu_torch.models import burnin
from kubeflow_tpu_torch.ops import flash_attention as fa
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
def test_kernel_refuses_head_dims_it_lacks(cuda):
    q, k, v = _qkv((1, 64, 2, 32), torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q, k, v)


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
