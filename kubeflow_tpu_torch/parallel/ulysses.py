"""Ulysses all-to-all sequence parallelism, and its composition with ring
attention.

The port of ``kubeflow_tpu/parallel/ulysses.py`` on ``torch.distributed``:
attention heads are exchanged for sequence shards with two all-to-alls,

    [b, S/P, H, d]  --a2a-->  [b, S, H/P, d]      (heads scatter, seq gather)
    full-sequence attention on H/P local heads    (exact softmax, no ring)
    [b, S, H/P, d]  --a2a-->  [b, S/P, H, d]      (seq scatter, heads gather)

JAX's tiled ``all_to_all`` becomes ``dist.all_to_all_single`` on a
``[P, ...]`` leading split, whose received chunks are concatenated back in
source order (JAX's concat order). The exchange is a
``torch.autograd.Function`` whose gradient is the inverse exchange
(scatter and gather swapped). Requires ``heads % P == 0``.

The ring×ulysses composition runs on a 2-D sequence mesh, sharded
ring-major (shard index ``ring_index * P_uly + uly_index``): the ulysses
exchange gathers the contiguous ring block, ring attention runs over the
ring axis, and the exchange goes back.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel.mesh import Axis
from kubeflow_tpu_torch.parallel.ring import ring_attention_local
from kubeflow_tpu_torch.telemetry import sections


def _largest_divisor_block(s: int, cap: int = 1024) -> int:
    """Largest block ≤ ``cap`` that divides ``s``: the flash shape
    contract requires s % block == 0, but ulysses callers pick S freely
    (e.g. S=1536 → block 768).

    ``s ≤ cap`` is always fine (one block). Beyond that, blocks stay
    multiples of 128 (the JAX package's lane-friendly floor against
    degenerate tiny blocks), so an awkward S (no 128-multiple divisor,
    e.g. 2×prime) raises here, at the call site where the config that
    chose S is visible."""
    if s <= cap:
        return s
    for block in range(cap, 127, -1):
        if s % block == 0 and block % 128 == 0:
            return block
    raise ValueError(
        f"gathered sequence {s} has no block-sized divisor ≤ {cap} "
        f"(multiple of 128); choose a sequence length divisible by 128"
    )


def _all_to_all(x, axis: Axis, scatter_dim: int, gather_dim: int,
                section: str):
    """JAX's tiled ``all_to_all``: ``x`` split into P chunks along
    ``scatter_dim``, chunk j sent to index j, the received chunks
    concatenated along ``gather_dim`` in source order."""
    send = torch.stack(x.chunk(axis.size, dim=scatter_dim)).contiguous()
    recv = torch.empty_like(send)
    sections.collective(section, dist.all_to_all_single, recv, send,
                        group=axis.group)
    return torch.cat(recv.unbind(0), dim=gather_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, scatter_dim, gather_dim, section):
        ctx.axis, ctx.dims, ctx.section = axis, (scatter_dim, gather_dim), \
            section
        return _all_to_all(x, axis, scatter_dim, gather_dim, section)

    @staticmethod
    def backward(ctx, grad):
        scatter_dim, gather_dim = ctx.dims
        return (_all_to_all(grad, ctx.axis, gather_dim, scatter_dim,
                            ctx.section), None, None, None, None)


def all_to_all(x, axis: Axis, scatter_dim: int, gather_dim: int,
               section: str = "ulysses_all_to_all"):
    """JAX's tiled ``all_to_all`` over ``axis`` inside the registered
    section ``section``, differentiable: its gradient is the inverse
    exchange. An axis of size 1 returns ``x`` and runs no collective."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, scatter_dim, gather_dim, section)


def ulysses_attention_local(q, k, v, axis: Axis, block_impl: str = "xla"):
    """Exact causal attention of this process's blocks via two
    all-to-alls. q/k/v ``[batch, s_local, heads, head_dim]`` with heads
    divisible by the axis size; returns the same shape.
    ``block_impl="flash"`` runs the gathered sequence through the flash
    kernels (forward and backward) with blocks from the gathered length's
    divisors; ``"xla"`` is the dense softmax."""
    p = axis.size
    b, s_local, h, d = q.shape
    if h % p:
        raise ValueError(
            f"ulysses needs heads % shards == 0, got {h} heads / {p} shards"
        )
    q, k, v = (all_to_all(t, axis, 2, 1) for t in (q, k, v))
    if block_impl == "flash":
        block = _largest_divisor_block(s_local * p)
        out = flash_attention(q, k, v, block_q=block, block_k=block)
    elif block_impl == "xla":
        s_full = s_local * p
        logits = (torch.einsum("bqhd,bkhd->bhqk", q, k).float()
                  * (1.0 / math.sqrt(d)))
        mask = torch.ones((s_full, s_full), dtype=torch.bool,
                          device=q.device).tril()
        logits = logits.masked_fill(~mask, -1e30)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    else:
        raise ValueError(
            f"unknown block_impl {block_impl!r} (want 'xla' or 'flash')"
        )
    return all_to_all(out, axis, 1, 2)


def ulysses_attention(q, k, v, mesh, axis_name: str = "seq",
                      block_impl: str = "xla"):
    """Ulysses attention over the mesh axis ``axis_name`` (a
    ``DeviceMesh`` or ``None`` for one shard), with ``ring_attention``'s
    signature: q/k/v are this process's ``[b_local, s_local, H, d]``
    blocks."""
    return ulysses_attention_local(q, k, v, Axis.of(mesh, axis_name),
                                   block_impl)


def ring_ulysses_attention_local(q, k, v, ring_axis: Axis, uly_axis: Axis,
                                 block_impl: str = "xla"):
    """Causal attention over a 2-D sequence mesh (sharded ring-major):
    the ulysses exchange over ``uly_axis`` gathers ring block
    ``ring_axis.index`` for H/P_uly heads, ring attention runs over
    ``ring_axis``, and the exchange goes back. Requires
    ``heads % P_uly == 0``."""
    p_uly, h = uly_axis.size, q.shape[2]
    if h % p_uly:
        raise ValueError(
            f"ring+ulysses needs heads % ulysses shards == 0, "
            f"got {h} heads / {p_uly} shards"
        )
    # [b, S/(Pr*Pu), H, d] -> [b, S/Pr, H/Pu, d]
    q, k, v = (all_to_all(t, uly_axis, 2, 1) for t in (q, k, v))
    out = ring_attention_local(q, k, v, ring_axis, block_impl)
    # [b, S/Pr, H/Pu, d] -> [b, S/(Pr*Pu), H, d]
    return all_to_all(out, uly_axis, 1, 2)


def ring_ulysses_attention(q, k, v, mesh,
                           axis_name=("seq_ring", "seq_uly"),
                           block_impl: str = "xla"):
    """The composed strategy: ``axis_name`` is the PAIR ``(ring_axis,
    uly_axis)`` of the mesh, and q/k/v are this process's blocks of a
    sequence sharded ring-major over both (what ``longctx.shard_inputs``
    gives with the tuple as its ``seq_axis``)."""
    ring_name, uly_name = axis_name
    return ring_ulysses_attention_local(
        q, k, v, Axis.of(mesh, ring_name), Axis.of(mesh, uly_name),
        block_impl)
