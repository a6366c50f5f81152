"""Ring attention: causal attention over a sequence-sharded mesh axis.

The port of ``kubeflow_tpu/parallel/ring.py`` on ``torch.distributed``.
Each process holds its query block, and the K/V blocks travel around the
ring one neighbour per hop (JAX's ``ppermute`` by +1 becomes
``dist.batch_isend_irecv`` inside the axis's process group) while an online
softmax in f32 accumulates the output.

Two block implementations, as in the JAX package:

* ``"xla"``: plain PyTorch products with the JAX einsum's rounding points
  (bf16 logits rounded to bf16 before the f32 cast and the scale, P·V
  rounded to bf16 before the f32 accumulation). It is trainable through
  autograd: the hop is a ``torch.autograd.Function`` whose gradient goes
  back by -1.
* ``"flash"``: each hop is :func:`flash_attention_partial` (the Hopper
  partial kernel on the card) folded in f32, and the backward is the JAX
  custom VJP's second rotation: each hop's partial gradients from the
  backward kernels with the final logsumexp, dq kept at home, the dK/dV
  accumulators travelling with their K/V blocks (``_RingFlash``).

Processes see the mesh through :class:`Axis`. A ``None`` mesh, or an axis
of size 1, is one shard: no collective runs and no process group is
needed, as on one card. Data axes shard the batch: each process passes its
own ``[b_local, s_local, h, d]`` blocks.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops.flash_attention import (
    flash_attention_partial,
    flash_attention_partial_grads,
)
from kubeflow_tpu_torch.parallel.mesh import Axis
from kubeflow_tpu_torch.telemetry import sections

_NEG_BIG = -1e30  # not -inf: keeps the online-softmax max finite pre-first-hit


def shift(tensors, axis: Axis, section: str, step: int = 1) -> list:
    """Send each tensor ``step`` indices along ``axis`` and receive, in
    its place, those of the index ``step`` behind: JAX's ``ppermute`` by
    ``step``. One batch of point-to-point ops, one tag per tensor, inside
    the registered section ``section``. Over gloo a CUDA tensor travels
    through a host copy: gloo's point-to-point ops hand the tensor's
    pointer to the host's socket calls, which refuse device memory
    (``writev ... Bad address``)."""
    dst = axis.ranks[(axis.index + step) % axis.size]
    src = axis.ranks[(axis.index - step) % axis.size]
    on_host = dist.get_backend(axis.group) == dist.Backend.GLOO
    sent = [t.contiguous() for t in tensors]
    wire = [t.cpu() for t in sent] if on_host else sent
    got = [torch.empty_like(t) for t in wire]
    ops = []
    for tag, (out, into) in enumerate(zip(wire, got)):
        ops += [dist.P2POp(dist.isend, out, dst, axis.group, tag),
                dist.P2POp(dist.irecv, into, src, axis.group, tag)]

    def exchange():
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    sections.collective(section, exchange)
    if on_host:
        return [g.to(t.device) for g, t in zip(got, sent)]
    return got


class _Hop(torch.autograd.Function):
    """One ring hop (+1) of a tensor; its gradient travels back (-1)."""

    @staticmethod
    def forward(ctx, x, axis, section):
        ctx.axis, ctx.section = axis, section
        return shift([x], axis, section)[0]

    @staticmethod
    def backward(ctx, grad):
        return shift([grad], ctx.axis, ctx.section, step=-1)[0], None, None


def _block_causal_mask(q_block: int, k_block: int, s_local: int, device):
    """[s_local, s_local] causal mask between global blocks q_block/k_block."""
    q_pos = q_block * s_local + torch.arange(s_local, device=device)[:, None]
    k_pos = k_block * s_local + torch.arange(s_local, device=device)[None, :]
    return k_pos <= q_pos


def ring_attention_local(q, k, v, axis: Axis, block_impl: str = "xla"):
    """Causal ring attention of this process's blocks. q/k/v
    ``[batch, s_local, heads, head_dim]``; returns the output block in the
    same shape and q's dtype, differentiable in q, k and v."""
    if block_impl == "flash":
        return _RingFlash.apply(q, k, v, axis)
    if block_impl != "xla":
        raise ValueError(f"unknown block_impl {block_impl!r} "
                         f"(want 'xla' or 'flash')")
    n, my = axis.size, axis.index
    b, s_local, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    m = torch.full((b, h, s_local), _NEG_BIG, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_local), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, s_local, h, d), dtype=torch.float32, device=q.device)
    k_t, v_t = k, v
    for t in range(n):
        src = (my - t) % n
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k_t).float() * scale
        mask = _block_causal_mask(my, src, s_local, q.device)
        logits = logits.masked_fill(~mask, _NEG_BIG)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        l = l * correction + p.sum(dim=-1)
        o = o * correction.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(v_t.dtype), v_t).float()
        m = m_new
        if t + 1 < n:  # the last hop's blocks would only travel home
            k_t = _Hop.apply(k_t, axis, "ring_kv_hop")
            v_t = _Hop.apply(v_t, axis, "ring_kv_hop")
    denom = l.clamp_min(1e-20).transpose(1, 2)[..., None]
    return (o / denom).to(q.dtype)


# ------------------------------------------------- trainable flash ring


def fold_hop(carry, o_blk, m_blk, l_blk):
    """Fold one hop's partial ``(o_unnorm, m, l)`` into the running
    ``(m, l, o)`` in f32, as ring.py's flash loop does; ``carry`` is
    ``None`` before the first hop (then the fold is the hop itself, which
    is exactly what folding into ``(-1e30, 0, 0)`` gives)."""
    if carry is None:
        return m_blk, l_blk, o_blk
    m, l, o = carry
    m_new = torch.maximum(m, m_blk)
    corr = torch.exp(m - m_new)
    corr_blk = torch.exp(m_blk - m_new)
    l = l * corr + l_blk * corr_blk
    o = (o * corr.transpose(1, 2)[..., None]
         + o_blk * corr_blk.transpose(1, 2)[..., None])
    return m_new, l, o


def finish(carry, dtype):
    """The folded ``(m, l, o)`` as ``(o / l in dtype, lse = m + log l)``,
    with l floored at 1e-20."""
    m, l, o = carry
    l_safe = l.clamp_min(1e-20)
    out = (o / l_safe.transpose(1, 2)[..., None]).to(dtype)
    return out, m + torch.log(l_safe)


def _ring_flash_forward(q, k, v, axis: Axis):
    """P hops of the partial kernel and the fold: ``(o, lse [b, h, s])``."""
    n, my = axis.size, axis.index
    s_local = q.shape[1]
    scale = 1.0 / math.sqrt(q.shape[-1])
    carry, k_t, v_t = None, k, v
    for t in range(n):
        src = (my - t) % n
        blk = flash_attention_partial(q, k_t, v_t, my * s_local,
                                      src * s_local, scale=scale)
        carry = fold_hop(carry, *blk)
        if t + 1 < n:
            k_t, v_t = shift([k_t, v_t], axis, "ring_flash_kv_hop")
    return finish(carry, q.dtype)


class _RingFlash(torch.autograd.Function):
    """The flash ring with the JAX package's custom VJP as its backward:
    a second rotation in which each hop's partial gradients come from the
    backward kernels with the FINAL logsumexp and delta = rowsum(dO·O),
    dq accumulates at home and the dK/dV accumulators travel with their
    K/V blocks, so after P hops they are home."""

    @staticmethod
    def forward(ctx, q, k, v, axis):
        out, lse = _ring_flash_forward(q, k, v, axis)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis = axis
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis = ctx.axis
        n, my = axis.size, axis.index
        s_local = q.shape[1]
        scale = 1.0 / math.sqrt(q.shape[-1])
        delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float())
        dq = dk_t = dv_t = None
        k_t, v_t = k, v
        for t in range(n):
            src = (my - t) % n
            dq_p, dk_p, dv_p = flash_attention_partial_grads(
                q, k_t, v_t, do, lse, delta, my * s_local, src * s_local,
                scale=scale)
            if t == 0:  # the home block's accumulators start here
                dq, dk_t, dv_t = dq_p.float(), dk_p.float(), dv_p.float()
            else:
                dq = dq + dq_p.float()
                dk_t = dk_t + dk_p.float()
                dv_t = dv_t + dv_p.float()
            if n > 1:
                moving = [dk_t, dv_t] + ([k_t, v_t] if t + 1 < n else [])
                moved = shift(moving, axis, "ring_flash_grad_hop")
                dk_t, dv_t = moved[:2]
                if t + 1 < n:
                    k_t, v_t = moved[2:]
        return dq.to(q.dtype), dk_t.to(k.dtype), dv_t.to(v.dtype), None


def ring_attention(q, k, v, mesh, axis_name: str = "seq",
                   block_impl: str = "xla"):
    """Ring attention over the mesh axis ``axis_name`` (a
    ``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names``,
    or ``None`` for one shard). q/k/v are this process's
    ``[b_local, s_local, heads, head_dim]`` blocks; the other axes shard
    the batch. ``block_impl="flash"`` runs each hop through the partial
    kernel, forward and backward."""
    return ring_attention_local(q, k, v, Axis.of(mesh, axis_name),
                                block_impl)


def reference_causal_attention(q, k, v):
    """Unsharded dense causal attention, the tests' reference: logits from
    the einsum in q's dtype, cast to f32 and scaled, softmax in f32, P in
    V's dtype."""
    s, d = q.shape[1], q.shape[3]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / d ** 0.5
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~mask, _NEG_BIG)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
