"""Expert parallelism: switch-style top-k MoE over a mesh "expert" axis.

The port of ``kubeflow_tpu/parallel/moe.py`` on ``torch.distributed``,
with its names and its arithmetic:

- tokens are batch-sharded over every mesh axis; the experts shard over
  the ``expert`` axis (each process holds ``E / P`` of them);
- routing assigns each token's k choices an (expert, slot) seat
  (``router_slots``), capacity counted choice-major: every first choice is
  seated before any second choice. The seats are inverted into a
  seat -> token table (one int scatter, drops going to a pad seat that is
  cut off), and the ``[E*C, d]`` slot rows are GATHERED from the tokens;
  the combine gathers each token's k slot rows back, scaled by its gates.
  Both are ``torch.autograd.Function``s whose backward is the other's
  gather, as the JAX package's custom VJPs are: no d-wide ``index_add_``
  or ``scatter_add_``, which are atomic on CUDA and sum in a varying
  order;
- two all-to-alls move the slots to the processes that hold their experts
  and back (``[E, C, d] -> [E/P, P*C, d]`` and the inverse), each the
  other's gradient; they are skipped when the expert axis has size 1;
- the expert products are plain batched GEMMs (``torch.bmm``), as the JAX
  package leaves its einsums to XLA.

The Switch load-balancing loss (§2.2) is returned beside the output and
averaged over every process of the mesh, as the JAX package's ``pmean``.

Top-k ties: ``jax.lax.top_k`` puts the lower expert first among equal
probabilities; ``torch.topk`` promises no order, so the choices come from
a stable descending sort. Equal probabilities are common: the router
logits are a bf16 product.

Each stage runs inside a ``torch.profiler.record_function`` range
(``kftpu.moe_router``, ``kftpu.moe_seat_table``, ``kftpu.moe_dispatch``,
``kftpu.moe_expert_ffn``, ``kftpu.moe_combine``), so a profile books the
layer's device time by stage.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.parallel.mesh import Axis, world_size
from kubeflow_tpu_torch.parallel.ulysses import all_to_all

__all__ = ["load_balancing_loss", "moe_ffn", "moe_ffn_local",
           "router_dispatch", "router_slots", "top_k"]


def _stage(name: str):
    return torch.profiler.record_function("kftpu.moe_" + name)


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest of each row, largest first, the
    lower index first among equal values. ``(values, indices)``."""
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]
    return probs.gather(1, idx), idx


def router_slots(logits, n_experts: int, capacity: int, k: int = 1):
    """Top-k routing as per-choice seat assignments.

    Returns ``(choices, probs, top_idx)`` where ``choices`` is a list of
    ``(expert_idx [T], slot_pos [T], gate [T], keep [T])``. The gate is the
    router probability for k = 1 (Switch) and the choice's probability
    renormalized over the k for k > 1. Capacity is counted choice-major;
    a choice past its expert's capacity gets ``keep=False`` and its token
    rides the residual."""
    probs = torch.softmax(logits.float(), dim=-1)            # [T, E]
    topk_p, topk_idx = top_k(probs, k)                       # [T, k]
    if k == 1:
        gates = topk_p
    else:
        gates = topk_p / topk_p.sum(-1, keepdim=True).clamp_min(1e-9)
    counts = torch.zeros((n_experts,), dtype=torch.int64,
                         device=logits.device)
    choices = []
    for j in range(k):
        expert = topk_idx[:, j]
        # [E, T]: the scan runs along the tokens, the innermost dim (down
        # an E-wide outer dim the card's scan runs E threads, ~1.4 ms at
        # T = 8192).
        onehot = F.one_hot(expert, n_experts).t().contiguous()
        # The seat of each token's choice j: its rank among the tokens
        # that chose the same expert here, after every earlier choice.
        pos = (onehot.cumsum(1).gather(0, expert[None, :]).squeeze(0) - 1
               + counts[expert])
        keep = pos < capacity
        choices.append((expert, pos, gates[:, j], keep))
        counts = counts + onehot.sum(1)
    return choices, probs, topk_idx[:, 0]


def router_dispatch(logits, n_experts: int, capacity: int, k: int = 1):
    """Top-k routing -> ``(dispatch, combine [T, E, C], probs [T, E],
    idx [T])``: the GShard one-hot form of :func:`router_slots`, the
    oracle the tests hold the seat path against."""
    choices, probs, idx = router_slots(logits, n_experts, capacity, k=k)
    t = logits.shape[0]
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    for expert, pos, gate, keep in choices:
        onehot_e = F.one_hot(expert, n_experts).float()
        onehot_c = F.one_hot(torch.where(keep, pos, capacity),
                             capacity + 1).float()[:, :capacity]
        disp_j = onehot_e[:, :, None] * onehot_c[:, None, :]
        dispatch = dispatch + disp_j
        combine = combine + disp_j * gate[:, None, None]
    return dispatch, combine, probs, idx


def load_balancing_loss(probs, idx, n_experts: int):
    """Switch aux loss: E * sum_e f_e * P_e (uniform routing -> 1.0)."""
    f = F.one_hot(idx, n_experts).float().mean(0)
    p = probs.mean(0)
    return n_experts * (f * p).sum()


def _pad_row(t):
    return torch.cat([t, t.new_zeros((1, t.shape[1]))], dim=0)


class _DispatchGather(torch.autograd.Function):
    """``slots[s] = x_pad[seat_tok[s]]``: the ``[S, d]`` seat rows of the
    ``[T + 1, d]`` tokens (row T is zeros, for empty seats). Backward:
    ``dx[t] = sum_j dslots[slot(t, j)]`` over kept choices, a gather, which
    is the whole transpose: each seat holds at most one token choice."""

    @staticmethod
    def forward(ctx, x_pad, seat_tok, all_slots, keep_mask):
        ctx.save_for_backward(all_slots, keep_mask)
        return x_pad.index_select(0, seat_tok)

    @staticmethod
    def backward(ctx, dslots):
        all_slots, keep_mask = ctx.saved_tensors
        n_seats = dslots.shape[0]
        contrib = _pad_row(dslots)[torch.where(keep_mask, all_slots,
                                               n_seats)]     # [T, k, d]
        return _pad_row(contrib.sum(1)), None, None, None


class _CombineGather(torch.autograd.Function):
    """``y[t] = sum_j out_flat[slot(t, j)] * scale(t, j)``, ``[T, d]``.

    ``keep_mask`` is the router's keep decision per (token, choice), not
    ``all_scales > 0``: a kept choice whose renormalized gate underflows
    to 0.0 still holds its seat and keeps its gate gradient, which is its
    expert output against dy. Backward: ``dout[s] = dy[seat_tok[s]] *
    seat_scale[s]`` (empty seats have scale 0) and that gate gradient,
    masked on ``keep_mask``: two gathers."""

    @staticmethod
    def forward(ctx, out_flat, all_slots, all_scales, keep_mask, seat_tok,
                seat_scale):
        rows = torch.where(keep_mask, all_slots, 0)
        ctx.save_for_backward(out_flat, rows, keep_mask, seat_tok,
                              seat_scale)
        g = out_flat[rows]                                   # [T, k, d]
        return (g * all_scales[..., None].to(out_flat.dtype)).sum(1)

    @staticmethod
    def backward(ctx, dy):
        out_flat, rows, keep_mask, seat_tok, seat_scale = ctx.saved_tensors
        dout = (_pad_row(dy).index_select(0, seat_tok)
                * seat_scale[:, None].to(dy.dtype))
        dscale = (out_flat[rows].float() * dy[:, None, :].float()).sum(-1)
        dscale = torch.where(keep_mask, dscale, 0.0)
        return dout, None, dscale, None, None, None


def moe_ffn_local(x, router_w, expert_w1, expert_w2, axis: Axis | None = None,
                  capacity_factor: float = 1.25, router_top_k: int = 1):
    """One process's switch/top-k FF layer.

    Args:
      x: ``[T, d]`` this process's tokens.
      router_w: ``[d, E_global]`` replicated router.
      expert_w1: ``[E_local, d, ff]`` this process's experts.
      expert_w2: ``[E_local, ff, d]``.
      axis: the expert axis (``None``: one shard).
    Returns ``(y [T, d] in x's dtype, aux_loss scalar f32)``; the aux loss
    is this shard's."""
    axis = Axis() if axis is None else axis
    p_e = axis.size
    e_local = expert_w1.shape[0]
    n_experts = e_local * p_e
    t, d = x.shape
    capacity = max(1, int(capacity_factor * router_top_k * t / n_experts))
    n_seats = n_experts * capacity

    with _stage("router"):
        logits = (x @ router_w.to(x.dtype)).float()           # [T, E]
        choices, probs, idx = router_slots(logits, n_experts, capacity,
                                           k=router_top_k)
        aux = load_balancing_loss(probs, idx, n_experts)

    with _stage("seat_table"):
        # Every dropped choice points at the pad seat n_seats, the only
        # seat written more than once; it is cut off below.
        all_slots = torch.stack(
            [torch.where(keep, expert * capacity + pos, n_seats)
             for expert, pos, _, keep in choices], dim=1)     # [T, k]
        all_scales = torch.stack([gate * keep for _, _, gate, keep
                                  in choices], dim=1)         # [T, k] f32
        keep_mask = torch.stack([keep for *_, keep in choices], dim=1)
        flat = all_slots.reshape(-1)
        seat_tok = torch.full((n_seats + 1,), t, dtype=torch.int64,
                              device=x.device)
        seat_tok[flat] = torch.arange(
            t, device=x.device).repeat_interleave(len(choices))
        # The gates per seat, for the combine's transpose (no gradient
        # flows through them: the gates' own gradient is dscale).
        seat_scale = torch.zeros((n_seats + 1,), dtype=torch.float32,
                                 device=x.device)
        seat_scale[flat] = all_scales.detach().reshape(-1)

    with _stage("dispatch"):
        slots = _DispatchGather.apply(_pad_row(x), seat_tok[:-1], all_slots,
                                      keep_mask).reshape(n_experts,
                                                         capacity, d)
    # [E, C, d] -> [E_local, P*C, d]: each process gets every peer's
    # slots for its own experts.
    slots = all_to_all(slots, axis, 0, 1, section="moe_dispatch_all_to_all")

    with _stage("expert_ffn"):
        h = F.gelu(torch.bmm(slots, expert_w1.to(x.dtype)),
                   approximate="tanh")
        out = torch.bmm(h, expert_w2.to(x.dtype))

    # And back to the tokens' processes: [E_local, P*C, d] -> [E, C, d].
    out = all_to_all(out, axis, 1, 0, section="moe_combine_all_to_all")
    with _stage("combine"):
        y = _CombineGather.apply(out.reshape(n_seats, d), all_slots,
                                 all_scales, keep_mask, seat_tok[:-1],
                                 seat_scale[:-1])
    return y, aux


class _WorldMean(torch.autograd.Function):
    """The mean of a scalar over every process of the world, as the JAX
    package's ``pmean`` over every mesh axis. Each process's loss is its
    share of the global loss and a replicated term enters each share
    divided by the world size, so the gradient of the mean on each
    process is the one that comes in, unchanged."""

    @staticmethod
    def forward(ctx, t):
        out = t.detach().clone()
        dist.all_reduce(out)
        return out / dist.get_world_size()

    @staticmethod
    def backward(ctx, grad):
        return grad


def moe_ffn(x, router_w, expert_w1, expert_w2, mesh=None,
            expert_axis: str = "expert", capacity_factor: float = 1.25,
            router_top_k: int = 1):
    """``x [b_local, s, d]``, this process's batch shard (the batch splits
    over every mesh axis); the experts split over ``expert_axis`` of the
    ``DeviceMesh`` ``mesh`` (``None``: one shard, no collective). Returns
    ``(y [b_local, s, d], aux)`` with aux averaged over the mesh."""
    b, s, d = x.shape
    axis = Axis.of(mesh, expert_axis)
    y, aux = moe_ffn_local(x.reshape(b * s, d), router_w, expert_w1,
                           expert_w2, axis, capacity_factor=capacity_factor,
                           router_top_k=router_top_k)
    if world_size(mesh) > 1:
        aux = _WorldMean.apply(aux)
    return y.reshape(b, s, d), aux
