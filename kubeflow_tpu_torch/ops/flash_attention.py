"""Fused flash-attention forward: the Hopper kernel and its plain version.

The port of ``kubeflow_tpu/ops/flash_attention.py``'s forward
(``_fwd_kernel``, reached through ``flash_attention``). The CUDA source is
``csrc/flash_attention_fwd.cu``; its header states the bound on an H100
and what the design does about it.

Dispatch is by the tensors' device. A CUDA tensor launches the kernel
(built from the source at first use, see :mod:`._build`) or raises; it
never falls back. A CPU tensor takes :func:`flash_attention_reference`,
the plain PyTorch version the tests hold the JAX package against and the
card's kernel is compared with.

Layout and shape contract follow the JAX wrapper: q, k, v are
``[batch, seq, heads, head_dim]`` of one dtype (bfloat16 or float32),
the default scale is ``1/sqrt(head_dim)``, and a sequence longer than the
JAX default block (1024) must be a multiple of it. The kernel's own tiles
are internal. The kernel takes head dims 64 and 128; the plain version
takes any.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubeflow_tpu_torch.ops import _build

#: Kernel launches by this process (one per successful CUDA launch; the
#: plain version never counts).
LAUNCHES = 0

SOURCE = "flash_attention_fwd.cu"
KERNEL_HEAD_DIMS = (64, 128)
_NEG_BIG = -1e30
# The JAX wrapper's default blocks (DEFAULT_BLOCK_Q/K) fix which sequence
# lengths it accepts; the port keeps that contract.
_JAX_BLOCK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one [b, s, h, d] shape: "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes bfloat16 or float32 q, k, v "
                        f"of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    s = q.shape[1]
    block = min(_JAX_BLOCK, s)
    if s % block:
        raise ValueError(f"seq {s} must divide by blocks {block}/{block}")


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: float | None = None):
    """Dense softmax attention in f32 with P rounded to V's dtype before
    PV: ``(o [b, s, h, d] in q's dtype, lse [b*h, s] f32)``."""
    b, s, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf = q.float().transpose(1, 2)                       # [b, h, s, d]
    kf = k.float().transpose(1, 2)
    vf = v.float().transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)) * scale          # [b, h, s, s] f32
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, _NEG_BIG)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = (p.to(v.dtype).float() @ vf) / l
    lse = (m + torch.log(l)).reshape(b * h, s)
    return o.transpose(1, 2).to(q.dtype).contiguous(), lse


def _check_kernel_layout(name: str, t: torch.Tensor) -> None:
    """Raise unless the kernel's 16-byte loads can read ``t`` through its
    strides: unit stride along head_dim, a 16-byte aligned start, and
    16-byte multiples for the batch, seq and head strides."""
    per16 = 16 // t.element_size()
    if not (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:3])):
        raise ValueError(
            f"{name}: the CUDA kernel reads 16-byte aligned rows with unit "
            f"head_dim stride; got strides {t.stride()} at offset "
            f"{t.data_ptr() % 16} bytes from 16-byte alignment")


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    fn = lib.kftpu_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.kftpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kftpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(q, k, v, causal: bool, scale: float):
    global LAUNCHES
    b, s, h, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {d}: the CUDA kernel takes "
                         f"{KERNEL_HEAD_DIMS}")
    if b * h > 65535:
        raise ValueError(f"batch*heads {b * h} exceeds the kernel grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_layout(name, t)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kftpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, d, _DTYPE_CODES[q.dtype],
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            scale, int(causal), stream)
    if err:
        raise RuntimeError("flash_attention_fwd launch failed: "
                           + lib.kftpu_cuda_error_string(err).decode())
    LAUNCHES += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """``(o [b, s, h, d], lse [b*h, s] f32)`` of softmax attention; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None):
    """Fused attention. q/k/v ``[batch, seq, heads, head_dim]``; returns
    o in the same layout and q's dtype."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]
