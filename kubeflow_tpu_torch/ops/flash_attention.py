"""Fused flash attention, forward and backward, and the ring hop's partial
forward: the Hopper kernels and their plain versions.

The port of ``kubeflow_tpu/ops/flash_attention.py``: the forward
(``_fwd_kernel``) and the two backward kernels (``_bwd_dq_kernel``,
``_bwd_dkv_kernel``), joined by a ``torch.autograd.Function`` as the JAX
package joins them by ``jax.custom_vjp``, and the ring hop's partial
forward (``_partial_kernel``, :func:`flash_attention_partial`), whose
backward is :func:`flash_attention_partial_grads` on the backward kernels.
The CUDA sources are ``csrc/flash_attention_fwd.cu`` (the forward and the
partial share its loop) and ``csrc/flash_attention_bwd.cu``, built on the
Hopper helpers of ``csrc/hopper.cuh``, for heads up to 128 columns, and
``csrc/flash_attention_wide.cu`` for wider heads; both run the f32 forward
and partial of ``csrc/flash_attention_f32.cuh`` and the f32 dQ and dK/dV
of ``csrc/flash_attention_f32_bwd.cuh``. Their headers state each
kernel's bound on an H100 and what the design does about it.

Dispatch is by the tensors' device. A CUDA tensor launches the kernel
(built from the source at first use, see :mod:`._build`) or raises; it
never falls back. A CPU tensor takes the plain PyTorch version beside
each kernel (``flash_attention_reference``,
``flash_attention_bwd_dq_reference``, ``flash_attention_bwd_dkv_reference``,
``flash_attention_partial_reference``),
which the tests hold the JAX package against and the card's kernels are
compared with.

Layout and shape contract follow the JAX wrapper: q, k, v are
``[batch, seq, heads, head_dim]`` of one dtype (bfloat16 or float32),
the default scale is ``1/sqrt(head_dim)``, and a sequence longer than a
block must be a multiple of it: ``block_q`` and ``block_k`` (the JAX
default 1024) enter only that check. lse and delta are f32
``[batch * heads, seq]``. The kernels' own tiles are internal.

Head dims: every head dim, as the JAX kernels take. f32 runs the CUDA
cores' register-tiled kernels at every head dim (the forward and partial
of ``flash_attention_f32.cuh``, dQ and dK/dV of
``flash_attention_f32_bwd.cuh``), on the narrowest output width that
holds d up to 128 and over 256-column output slices above. In bf16 the
128-column kernels take every multiple of 8 up to ``TILE_MAX_HEAD_DIM``
(128; a narrower head runs on a 64- or 128-column tile whose columns past
it are zeros); wider heads run the wide library, whose kernel for each
head dim and dtype :func:`_wide_plan` chooses: the forward, partial, dQ
and dK/dV on wgmma at 192 or 256 columns up to 256; above that, wgmma
kernels that split the output's columns into slices of 256. A head dim
that is no multiple of 8 is copied into zero-padded ``[b, s, h,
round_up(d, 8)]`` tensors first (zero columns add exactly 0 to every
product and to delta; the scale stays ``1/sqrt(d)`` of the true d), and
the outputs are sliced back to d. Any batch * heads is taken. The plain
versions, like the JAX kernels, take any head dim.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.ops import _build

#: Kernel launches by this process, one counter per kernel (one per
#: successful CUDA launch; the plain versions never count).
LAUNCHES = 0          # the forward
BWD_DQ_LAUNCHES = 0
BWD_DKV_LAUNCHES = 0
PARTIAL_LAUNCHES = 0  # the ring hop's partial forward
#: Backward calls whose dO the kernels could not read through its strides
#: (an expanded gradient, say) and which copied it first.
DO_COPIES = 0

SOURCE = "flash_attention_fwd.cu"
BWD_SOURCE = "flash_attention_bwd.cu"
WIDE_SOURCE = "flash_attention_wide.cu"
# TMA moves rows whose strides are multiples of 16 bytes, and the heads of
# a qkv slice lie head_dim elements apart: the kernels take multiples of 8
# (others are padded to one), the 128-column ones up to their widest tile.
TILE_MAX_HEAD_DIM = 128
# The wide library's wgmma kernels (bf16 forward, partial, dQ, dK/dV) come
# at 192 and 256 columns; its sliced kernels accumulate 256 output columns
# a CTA (its kSliceCols).
WIDE_WGMMA_WIDTHS = (192, 256)
WIDE_SLICE_COLS = 256
_NEG_BIG = -1e30
# The JAX wrapper's blocks (default DEFAULT_BLOCK_Q/K) fix which sequence
# lengths it accepts; the port keeps that contract.
_JAX_BLOCK = 1024
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_seq(s_q: int, s_k: int, block_q: int, block_k: int) -> None:
    bq, bk = min(block_q, s_q), min(block_k, s_k)
    if s_q % bq or s_k % bk:
        seq = s_q if s_q == s_k else f"{s_q}/{s_k}"
        raise ValueError(f"seq {seq} must divide by blocks {bq}/{bk}")


def _check(q, k, v, block_q: int = _JAX_BLOCK,
           block_k: int = _JAX_BLOCK) -> None:
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
    _check_seq(q.shape[1], q.shape[1], block_q, block_k)


def _default_scale(scale, q) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale


def flash_attention_reference(q, k, v, *, causal: bool = True,
                              scale: float | None = None):
    """Dense softmax attention in f32 with P rounded to V's dtype before
    PV: ``(o [b, s, h, d] in q's dtype, lse [b*h, s] f32)``."""
    b, s, h, d = q.shape
    scale = _default_scale(scale, q)
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
    if not _kernel_readable(t):
        raise ValueError(
            f"{name}: the CUDA kernel reads 16-byte aligned rows with unit "
            f"head_dim stride; got strides {t.stride()} at offset "
            f"{t.data_ptr() % 16} bytes from 16-byte alignment")


def _kernel_readable(t: torch.Tensor) -> bool:
    per16 = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in t.stride()[:3]))


def _padded_dim(d: int) -> int:
    return -(-d // 8) * 8


def _pad_heads(*tensors):
    """Each tensor (or None) copied into a contiguous one whose head dim
    is padded with zero columns to the next multiple of 8."""
    return [None if t is None
            else F.pad(t, (0, _padded_dim(t.shape[-1]) - t.shape[-1]))
            for t in tensors]


def _on_kernel(launch, *args):
    """``launch(*args)``, the kernel launcher, on CUDA tensors. A head dim
    that is no multiple of 8 is zero-padded to the next one in every
    ``[b, s, h, d]`` argument (q, k, v, o, dO), and the ``[b, s, h, d]``
    outputs are sliced back to d: zero columns add exactly 0 to QK^T,
    dO V^T and delta, and the caller's scale is that of the true d."""
    d = args[0].shape[-1]
    if d % 8 == 0:
        return launch(*args)
    outs = launch(*(_pad_heads(a)[0]
                    if isinstance(a, torch.Tensor) and a.dim() == 4 else a
                    for a in args))
    return tuple(t[..., :d] if t.dim() == 4 else t for t in outs)


def _wide(q) -> bool:
    return q.shape[-1] > TILE_MAX_HEAD_DIM


class WidePlan(NamedTuple):
    """How the wide library (``WIDE_SOURCE``) runs one head dim: on the
    ``"wgmma"`` kernels at ``width`` columns, or (``"sliced"``) over
    ``slices`` output-column slices, on the sliced kernels: bf16 on
    wgmma, f32 on the CUDA cores' register tiles."""
    kernels: str
    width: int | None
    slices: int


def _wide_plan(d: int, dtype: torch.dtype) -> WidePlan:
    """The wide library's kernels for head dim d (a multiple of 8) in
    ``dtype``: bf16 up to 256 columns on wgmma at the narrowest width
    that holds d (TMA zero-fills the columns past d); f32 and wider bf16
    heads over 256-column output slices, on the sliced kernels: in bf16
    ``wide_{fwd,partial,dq,dkv}_bf16_sliced_kernel`` on wgmma, in f32
    ``fwd_f32_tiled_kernel``, ``dq_f32_tiled_kernel`` and
    ``dkv_f32_tiled_kernel`` on the CUDA cores. The launches hand this
    plan to the library, which checks that it has its kernels and does
    not choose."""
    if dtype == torch.bfloat16 and d <= WIDE_WGMMA_WIDTHS[-1]:
        width = min(w for w in WIDE_WGMMA_WIDTHS if w >= d)
        return WidePlan("wgmma", width, 1)
    return WidePlan("sliced", None, -(-d // WIDE_SLICE_COLS))


def _plan_args(q) -> tuple:
    """The wide library's plan arguments for q's head dim and dtype:
    ``(width, slices)``, width 0 for the sliced kernels."""
    plan = _wide_plan(q.shape[-1], q.dtype)
    return plan.width or 0, plan.slices


@contextlib.contextmanager
def _on_device(device):
    """Make ``device`` current; yields its current stream's handle."""
    with torch.cuda.device(device):
        yield torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, lib, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: "
                           + lib.kftpu_cuda_error_string(err).decode())


def _library(lib: ctypes.CDLL | None = None) -> ctypes.CDLL:
    """The forward library, its entry points typed. ``lib`` replaces the
    one built from ``csrc/`` (another build of the same C interface, to
    time two kernels in one process)."""
    lib = _build.load(SOURCE) if lib is None else lib
    fn = lib.kftpu_flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.kftpu_flash_attention_partial.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
            + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
        lib.kftpu_flash_attention_partial.restype = ctypes.c_int
        lib.kftpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kftpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _wide_library(lib: ctypes.CDLL | None = None) -> ctypes.CDLL:
    """The wide-head library (head dims above ``TILE_MAX_HEAD_DIM``), its
    entry points typed; ``lib`` replaces the one built from ``csrc/`` as
    in :func:`_library`."""
    lib = _build.load(WIDE_SOURCE) if lib is None else lib
    if lib.kftpu_wide_fwd.argtypes is None:
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.kftpu_wide_fwd.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
            + [strides, ctypes.c_float] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.kftpu_wide_bwd_dq.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [strides, ctypes.c_float] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])
        lib.kftpu_wide_bwd_dkv.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [strides, ctypes.c_float] + [ctypes.c_int] * 5
            + [ctypes.c_void_p])
        for fn in (lib.kftpu_wide_fwd, lib.kftpu_wide_bwd_dq,
                   lib.kftpu_wide_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.kftpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kftpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch_wide_fwd(q, k, v, o, lse, m, l, causal, scale, q_offset,
                     k_offset, what, lib=None):
    b, s, h, d = q.shape
    lib = _wide_library(lib)
    with _on_device(q.device) as stream:
        err = lib.kftpu_wide_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            _ptr(lse), _ptr(m), _ptr(l), b, s, h, d, _DTYPE_CODES[q.dtype],
            _strides(q, k, v, o, None, None, None, None), scale, int(causal),
            q_offset, k_offset, int(m is not None), *_plan_args(q), stream)
    _raise_on(err, lib, what)


def _launch(q, k, v, causal: bool, scale: float, lib=None):
    global LAUNCHES
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_layout(name, t)
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s), dtype=torch.float32, device=q.device)
    if _wide(q):
        _launch_wide_fwd(q, k, v, o, lse, None, None, causal, scale, 0, 0,
                         "flash_attention_fwd", lib)
        LAUNCHES += 1
        return o, lse
    lib = _library(lib)
    with _on_device(q.device) as stream:
        err = lib.kftpu_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, d, _DTYPE_CODES[q.dtype],
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            scale, int(causal), stream)
    _raise_on(err, lib, "flash_attention_fwd")
    LAUNCHES += 1
    return o, lse


def flash_attention_fwd(q, k, v, *, causal: bool = True,
                        scale: float | None = None,
                        block_q: int = _JAX_BLOCK, block_k: int = _JAX_BLOCK):
    """``(o [b, s, h, d], lse [b*h, s] f32)`` of softmax attention; the
    kernel on CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v, block_q, block_k)
    scale = _default_scale(scale, q)
    if q.device.type == "cuda":
        return _on_kernel(_launch, q, k, v, causal, scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal, scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")


class _FlashAttention(torch.autograd.Function):
    """Attention with its gradient, as the JAX package's ``_flash``
    custom VJP: the forward kernel saves q, k, v, o and lse, and the
    backward runs :func:`flash_attention_bwd` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        o, lse = flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                     block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, _default_scale(scale, q)
        ctx.blocks = dict(block_q=block_q, block_k=block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal, scale=ctx.scale,
                                         **ctx.blocks)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None, block_q: int = _JAX_BLOCK,
                    block_k: int = _JAX_BLOCK):
    """Fused attention. q/k/v ``[batch, seq, heads, head_dim]``; returns
    o in the same layout and q's dtype, differentiable in q, k and v.
    ``block_q``/``block_k`` are the JAX wrapper's blocks: they decide
    which sequence lengths are accepted, not the kernels' tiles."""
    return _FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)


# ---------------------------------------------------------------- backward


def _check_bwd(q, k, v, o, lse, do, delta, block_q, block_k) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or do.shape != q.shape or (o is not None and o.shape != q.shape) \
            or (k.shape[0], k.shape[2], k.shape[3]) \
            != (q.shape[0], q.shape[2], q.shape[3]):
        raise ValueError(
            f"q, dO, o [b, s_q, h, d] and k, v [b, s_k, h, d] disagree: "
            f"{tuple(q.shape)}, {tuple(do.shape)}, "
            f"{None if o is None else tuple(o.shape)}, {tuple(k.shape)}, "
            f"{tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or any(
            t.dtype != q.dtype for t in (k, v, do, o) if t is not None):
        raise TypeError(f"flash attention's backward takes bfloat16 or "
                        f"float32 q, k, v, o, dO of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}, {do.dtype}")
    b, s_q, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and (t.dtype != torch.float32
                              or tuple(t.shape) != (b * h, s_q)):
            raise ValueError(f"{name} must be f32 [{b * h}, {s_q}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if o is None and delta is None:
        raise ValueError("the backward needs o or delta")
    if any(t.device != q.device for t in (k, v, o, lse, do, delta)
           if t is not None):
        raise ValueError("flash attention's backward takes tensors on one "
                         "device")
    _check_seq(s_q, k.shape[1], block_q, block_k)


def _bwd_probs_and_ds(q, k, v, lse, do, delta, causal, scale, q_offset,
                      k_offset):
    """P = exp(S * scale - lse) from f32 scores, masked entries at -1e30
    before the exp, and dS = P (dO V^T - delta): both f32
    ``[b, h, s_q, s_k]``."""
    b, s_q, h, _ = q.shape
    s_k = k.shape[1]
    qf = q.float().transpose(1, 2)
    kf = k.float().transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(s_q, device=q.device) + q_offset
        cols = torch.arange(s_k, device=q.device) + k_offset
        scores = scores.masked_fill(cols[None, :] > rows[:, None], _NEG_BIG)
    p = torch.exp(scores - lse.reshape(b, h, s_q, 1))
    dp = do.float().transpose(1, 2) @ v.float().transpose(1, 2).transpose(
        -1, -2)
    return p, p * (dp - delta.reshape(b, h, s_q, 1))


def attention_delta(o, do) -> torch.Tensor:
    """``rowsum(f32(dO) * f32(O))`` as f32 ``[b*h, s]``: the backward's
    delta (a plain sum outside the TPU kernels; fused into the dQ kernel
    on the card)."""
    b, s, h, _ = o.shape
    return (do.float() * o.float()).sum(-1).transpose(1, 2).reshape(
        b * h, s).contiguous()  # at b = 1 the reshape is a strided view


def flash_attention_bwd_dq_reference(q, k, v, o, lse, do, *,
                                     causal: bool = True,
                                     scale: float | None = None,
                                     q_offset: int = 0, k_offset: int = 0,
                                     delta=None):
    """The dQ kernel's plain version: ``(dq, delta)``, with dS rounded to
    k's dtype before dS K and the scale applied to the f32 product."""
    scale = _default_scale(scale, q)
    if delta is None:
        delta = attention_delta(o, do)
    _, ds = _bwd_probs_and_ds(q, k, v, lse, do, delta, causal, scale,
                              q_offset, k_offset)
    dq = (ds.to(k.dtype).float() @ k.float().transpose(1, 2)) * scale
    return dq.transpose(1, 2).to(q.dtype).contiguous(), delta


def flash_attention_bwd_dkv_reference(q, k, v, lse, do, delta, *,
                                      causal: bool = True,
                                      scale: float | None = None,
                                      q_offset: int = 0, k_offset: int = 0):
    """The dK/dV kernel's plain version: ``(dk, dv)``, with P rounded to
    dO's dtype before P^T dO and dS to q's before dS^T Q."""
    scale = _default_scale(scale, q)
    p, ds = _bwd_probs_and_ds(q, k, v, lse, do, delta, causal, scale,
                              q_offset, k_offset)
    dv = p.to(do.dtype).float().transpose(-1, -2) \
        @ do.float().transpose(1, 2)
    dk = (ds.to(q.dtype).float().transpose(-1, -2)
          @ q.float().transpose(1, 2)) * scale
    return (dk.transpose(1, 2).to(k.dtype).contiguous(),
            dv.transpose(1, 2).to(v.dtype).contiguous())


def flash_attention_bwd_reference(q, k, v, o, lse, do, *,
                                  causal: bool = True,
                                  scale: float | None = None,
                                  q_offset: int = 0, k_offset: int = 0,
                                  delta=None):
    """The backward's plain version: ``(dq, dk, dv)``."""
    kw = dict(causal=causal, scale=scale, q_offset=q_offset,
              k_offset=k_offset)
    dq, delta = flash_attention_bwd_dq_reference(q, k, v, o, lse, do,
                                                 delta=delta, **kw)
    dk, dv = flash_attention_bwd_dkv_reference(q, k, v, lse, do, delta, **kw)
    return dq, dk, dv


def _bwd_library(lib: ctypes.CDLL | None = None) -> ctypes.CDLL:
    """The backward library, its entry points typed; ``lib`` replaces
    the one built from ``csrc/`` as in :func:`_library`."""
    lib = _build.load(BWD_SOURCE) if lib is None else lib
    if lib.kftpu_flash_attention_bwd_dq.argtypes is None:
        strides = ctypes.POINTER(ctypes.c_longlong)
        lib.kftpu_flash_attention_bwd_dq.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [strides, ctypes.c_float] + [ctypes.c_int] * 4
            + [ctypes.c_void_p])
        lib.kftpu_flash_attention_bwd_dkv.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
            + [strides, ctypes.c_float] + [ctypes.c_int] * 3
            + [ctypes.c_void_p])
        lib.kftpu_flash_attention_bwd_dq.restype = ctypes.c_int
        lib.kftpu_flash_attention_bwd_dkv.restype = ctypes.c_int
        lib.kftpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kftpu_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _strides(*tensors):
    """(batch, seq, head) strides of q, k, v, o, dO, dQ, dK, dV in that
    order, zeros for a tensor the launch does not touch."""
    values = []
    for t in tensors:
        values += list(t.stride()[:3]) if t is not None else [0, 0, 0]
    return (ctypes.c_longlong * len(values))(*values)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_stats_contiguous(lse, delta) -> None:
    for name, t in (("lse", lse), ("delta", delta)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the kernel")


def _launch_dq(q, k, v, o, lse, do, delta, causal, scale, q_offset,
               k_offset, lib=None, plan=None):
    """The dQ launch; ``plan`` replaces :func:`_plan_args`'s plan for a
    wide head (``(0, slices)`` times the sliced dQ beside the wgmma one
    in one build)."""
    global BWD_DQ_LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do), ("o", o)):
        if t is not None:
            _check_kernel_layout(name, t)
    _check_stats_contiguous(lse, delta)
    b, s_q, h, d = q.shape
    compute_delta = delta is None
    if compute_delta:
        delta = torch.empty((b * h, s_q), dtype=torch.float32,
                            device=q.device)
    dq = torch.empty((b, s_q, h, d), dtype=q.dtype, device=q.device)
    if _wide(q):
        lib = _wide_library(lib)
        entry, plan = lib.kftpu_wide_bwd_dq, plan or _plan_args(q)
    else:
        lib = _bwd_library(lib)
        entry, plan = lib.kftpu_flash_attention_bwd_dq, ()
    with _on_device(q.device) as stream:
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(o), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            b, s_q, k.shape[1], h, d, _DTYPE_CODES[q.dtype],
            _strides(q, k, v, o, do, dq, None, None), scale, int(causal),
            q_offset, k_offset, int(compute_delta), *plan, stream)
    _raise_on(err, lib, "flash_attention_bwd_dq")
    BWD_DQ_LAUNCHES += 1
    return dq, delta


def _launch_dkv(q, k, v, lse, do, delta, causal, scale, q_offset, k_offset,
                lib=None):
    global BWD_DKV_LAUNCHES
    for name, t in (("q", q), ("k", k), ("v", v), ("dO", do)):
        _check_kernel_layout(name, t)
    _check_stats_contiguous(lse, delta)
    b, s_q, h, d = q.shape
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if _wide(q):
        lib = _wide_library(lib)
        entry, plan = lib.kftpu_wide_bwd_dkv, _plan_args(q)
    else:
        lib = _bwd_library(lib)
        entry, plan = lib.kftpu_flash_attention_bwd_dkv, ()
    with _on_device(q.device) as stream:
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s_q, k.shape[1], h, d, _DTYPE_CODES[q.dtype],
            _strides(q, k, v, None, do, None, dk, dv), scale, int(causal),
            q_offset, k_offset, *plan, stream)
    _raise_on(err, lib, "flash_attention_bwd_dkv")
    BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, o, lse, do, *, causal: bool = True,
                           scale: float | None = None, q_offset: int = 0,
                           k_offset: int = 0, delta=None,
                           block_q: int = _JAX_BLOCK,
                           block_k: int = _JAX_BLOCK):
    """``(dq, delta)``: the dQ kernel on CUDA tensors (which computes
    delta from o and dO first when it is not given), the plain version on
    CPU tensors."""
    _check_bwd(q, k, v, o, lse, do, delta, block_q, block_k)
    args = (_default_scale(scale, q), int(q_offset), int(k_offset))
    if q.device.type == "cuda":
        return _on_kernel(_launch_dq, q, k, v, o, lse, do, delta, causal,
                          *args)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_reference(
            q, k, v, o, lse, do, causal=causal, scale=args[0],
            q_offset=args[1], k_offset=args[2], delta=delta)
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_bwd_dkv(q, k, v, lse, do, delta, *, causal: bool = True,
                            scale: float | None = None, q_offset: int = 0,
                            k_offset: int = 0, block_q: int = _JAX_BLOCK,
                            block_k: int = _JAX_BLOCK):
    """``(dk, dv)``: the dK/dV kernel on CUDA tensors, the plain version
    on CPU tensors."""
    _check_bwd(q, k, v, None, lse, do, delta, block_q, block_k)
    args = (_default_scale(scale, q), int(q_offset), int(k_offset))
    if q.device.type == "cuda":
        return _on_kernel(_launch_dkv, q, k, v, lse, do, delta, causal,
                          *args)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_reference(
            q, k, v, lse, do, delta, causal=causal, scale=args[0],
            q_offset=args[1], k_offset=args[2])
    raise ValueError(f"no flash attention for device {q.device}")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: float | None = None, q_offset: int = 0,
                        k_offset: int = 0, delta=None,
                        block_q: int = _JAX_BLOCK, block_k: int = _JAX_BLOCK):
    """``(dq, dk, dv)`` of attention for the output gradient ``do``, from
    the forward's o and lse: the two kernels on CUDA tensors, the plain
    version on CPU tensors. Query row i sits at global position
    ``q_offset + i`` and key j at ``k_offset + j`` for the causal mask (a
    ring hop's blocks); ``delta`` (f32 ``[b*h, s_q]``) replaces the one
    computed from o and dO when given."""
    global DO_COPIES
    _check_bwd(q, k, v, o, lse, do, delta, block_q, block_k)
    # The scale of the true d, before any padding.
    kw = dict(causal=causal, scale=_default_scale(scale, q),
              q_offset=q_offset, k_offset=k_offset, block_q=block_q,
              block_k=block_k)

    def pair(q, k, v, o, lse, do, delta):
        dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, delta=delta,
                                           **kw)
        return (dq, *flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw))

    if q.device.type != "cuda":
        return pair(q, k, v, o, lse, do, delta)
    if q.shape[-1] % 8 == 0 and not _kernel_readable(do):
        # Autograd may hand over an expanded dO (zero strides, e.g. after
        # a .sum()); the kernels' 16-byte loads need real rows, so copy.
        do = do.contiguous()
        DO_COPIES += 1
    # Padded once for both kernels.
    return _on_kernel(pair, q, k, v, o, lse, do, delta)


def flash_attention_partial_grads(q, k, v, do, lse, delta, q_offset,
                                  k_offset, *, scale: float | None = None):
    """One ring hop's backward: the block pair's partial ``(dq, dk, dv)``.

    q/do ``[b, s_q, h, d]``, k/v ``[b, s_k, h, d]``; ``lse`` is the final
    ring logsumexp ``[b, h, s_q]`` (after folding every hop) and
    ``delta`` the rowsum(do·o_final) ``[b, h, s_q]``. With those, the
    causal flash backward restricted to this block pair, at the blocks'
    global starts ``q_offset`` and ``k_offset``, gives exactly this hop's
    share of the gradients.
    """
    b, s_q, h, _ = q.shape

    def fold_stat(t):  # [b, h, s] -> [b*h, s]
        return t.reshape(b * h, s_q).contiguous()

    return flash_attention_bwd(q, k, v, None, fold_stat(lse), do,
                               causal=True, scale=scale, q_offset=q_offset,
                               k_offset=k_offset, delta=fold_stat(delta))


# --------------------------------------------------- ring partial attention


def flash_attention_partial_reference(q, k, v, q_offset: int, k_offset: int,
                                      *, scale: float | None = None):
    """The partial kernel's plain version: causal block attention at the
    global positions ``q_offset + i`` (queries) and ``k_offset + j``
    (keys), from f32 scores masked at -1e30, with P rounded to V's dtype
    before PV. Returns ``(o_unnorm [b, s, h, d] f32, m [b, h, s] f32,
    l [b, h, s] f32)``; a row that no key reaches is ``(0, -1e30, 0)``."""
    b, s, h, d = q.shape
    scale = _default_scale(scale, q)
    qf = q.float().transpose(1, 2)                       # [b, h, s, d]
    kf = k.float().transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)).mul_(scale)      # [b, h, s, s] f32
    rows = torch.arange(s, device=q.device) + int(q_offset)
    cols = torch.arange(s, device=q.device) + int(k_offset)
    keep = cols[None, :] <= rows[:, None]
    scores.masked_fill_(~keep, _NEG_BIG)
    m = scores.amax(dim=-1, keepdim=True)
    p = scores.sub_(m).exp_().mul_(keep.any(dim=-1, keepdim=True))
    l = p.sum(dim=-1)
    o = p.to(v.dtype).float() @ v.float().transpose(1, 2)
    return o.transpose(1, 2).contiguous(), m.squeeze(-1), l


def _launch_partial(q, k, v, q_offset: int, k_offset: int, scale: float,
                    lib=None):
    global PARTIAL_LAUNCHES
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_kernel_layout(name, t)
    o = torch.empty((b, s, h, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if _wide(q):
        _launch_wide_fwd(q, k, v, o, None, m, l, True, scale, q_offset,
                         k_offset, "flash_attention_partial", lib)
        PARTIAL_LAUNCHES += 1
        return o, m, l
    lib = _library(lib)
    with _on_device(q.device) as stream:
        err = lib.kftpu_flash_attention_partial(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            m.data_ptr(), l.data_ptr(), b, s, h, d, _DTYPE_CODES[q.dtype],
            _strides(q, k, v, o), scale, q_offset, k_offset, stream)
    _raise_on(err, lib, "flash_attention_partial")
    PARTIAL_LAUNCHES += 1
    return o, m, l


def flash_attention_partial(q, k, v, q_offset: int, k_offset: int, *,
                            scale: float | None = None,
                            block_q: int = _JAX_BLOCK,
                            block_k: int = _JAX_BLOCK):
    """One ring hop's attention block, the forward half: the partial
    kernel on CUDA tensors, the plain version on CPU tensors.

    q/k/v ``[batch, s_block, heads, head_dim]`` of one shape;
    ``q_offset``/``k_offset`` are the blocks' global sequence starts.
    Returns ``(o_unnorm [b, s, h, d] f32, m [b, h, s] f32, l [b, h, s]
    f32)``: the online-softmax carry terms that ring attention folds
    across hops, m in the natural units of ``q.k * scale``. The matching
    per-hop backward is :func:`flash_attention_partial_grads`."""
    _check(q, k, v, block_q, block_k)
    scale = _default_scale(scale, q)
    if q.device.type == "cuda":
        return _on_kernel(_launch_partial, q, k, v, int(q_offset),
                          int(k_offset), scale)
    if q.device.type == "cpu":
        return flash_attention_partial_reference(q, k, v, q_offset, k_offset,
                                                 scale=scale)
    raise ValueError(f"no flash attention for device {q.device}")


def tensor_map_encode_ns(q, k, v, iters: int = 1000) -> float:
    """Host nanoseconds that one bf16 launch spends encoding the TMA
    tensor maps of q, k and v (CUDA tensors), averaged over ``iters``."""
    lib = _library()
    fn = lib.kftpu_flash_attention_encode_ns
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int])
        fn.restype = ctypes.c_double
    b, s, h, d = q.shape
    ns = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), b, s, h, d,
            _strides(q, k, v), iters)
    if ns < 0:
        raise RuntimeError("tensor map encode failed")
    return ns
