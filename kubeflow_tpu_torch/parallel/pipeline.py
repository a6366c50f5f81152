"""Pipeline parallelism: the GPipe microbatch schedule over a stage axis.

The port of ``kubeflow_tpu/parallel/pipeline.py``. Each process holds a
contiguous slice of the layer stack (leaves stacked on a leading layer
dim, cut by ``pipeline_spans``), and a tick's activations go to the next
stage by one point-to-point hop (JAX's ``ppermute`` by +1 becomes
``dist.batch_isend_irecv`` inside the stage axis's process group, in the
registered section ``pipeline_stage_hop``). The schedule runs
``n_micro + n_stages - 1`` ticks; stage 0 injects microbatch ``t`` at tick
``t`` and re-injects the last one in the drain bubble, and the last stage
finishes microbatch ``m`` at tick ``m + n_stages - 1``.

JAX gets the backward schedule free: ``ppermute`` is linear and its
transpose is the inverse permutation. torch's point-to-point ops are not
differentiable, so the hop is :class:`_StageHop`, whose backward sends
the cotangent back one stage. Every process runs every tick, the bubble
and the wrap link's garbage included, and picks its input with
``torch.where`` rather than a branch on its rank: each process's autograd
graph then has the same shape, so all of them run the same hops in the
same order, forward and backward, as gloo and NCCL need.

``UNROLL_MAX_TICKS`` of the JAX module tunes how XLA unrolls the schedule's
``lax.scan``; eager PyTorch runs the ticks as a Python loop and has no
counterpart.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.parallel.mesh import Axis
from kubeflow_tpu_torch.parallel.ring import shift

SECTION = "pipeline_stage_hop"


def stage_ring_perm(n_stages: int) -> list[tuple[int, int]]:
    """Stage i forwards its activations to stage i+1 (circular; the wrap
    link only ever carries bubble garbage that stage 0 discards)."""
    return [(i, (i + 1) % n_stages) for i in range(n_stages)]


def pipeline_spans(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Even [start, stop) layer spans per stage; n_layers % n_stages == 0."""
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} stages")
    per = n_layers // n_stages
    return [(i * per, (i + 1) * per) for i in range(n_stages)]


def stage_axis(group, n_stages: int) -> Axis:
    """The stage axis of process group ``group`` as :class:`Axis`; one
    stage needs no group."""
    if n_stages == 1:
        return Axis()
    if group is None:
        raise ValueError(f"{n_stages} stages need the stage axis's process "
                         f"group")
    size = dist.get_world_size(group)
    if size != n_stages:
        raise ValueError(f"the stage group holds {size} processes, not "
                         f"{n_stages} stages")
    return Axis(group, size, dist.get_rank(group),
                tuple(dist.get_global_rank(group, i) for i in range(size)))


class _StageHop(torch.autograd.Function):
    """The stage ring's hop: this stage's tensor to stage i + 1, stage
    i - 1's in its place; the cotangent goes the other way (the transpose
    of a permutation is its inverse)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return shift([x], axis, SECTION)[0]

    @staticmethod
    def backward(ctx, grad):
        return shift([grad], ctx.axis, SECTION, step=-1)[0], None


def stage_hop(x, axis: Axis):
    """:class:`_StageHop` of ``x``; at one stage the identity."""
    return x if axis.size == 1 else _StageHop.apply(x, axis)


def pipeline_apply(stage_fn, stage_params, x_micro, *, n_stages: int,
                   group=None, force_schedule: bool = False):
    """Run microbatches through the stage ring.

    ``stage_fn(stage_params, h) -> h`` applies this process's slice of the
    layer stack to one microbatch ``h [mb, ...]``; ``x_micro [n_micro, mb,
    ...]`` holds the embedded microbatches, of which only stage 0's are
    read (so input gradients arise on stage 0 alone). ``group`` is the
    stage axis's process group (None at one stage). ``force_schedule``
    runs the tick schedule even at one stage, where the microbatches are
    otherwise folded into one batch.

    Returns ``[n_micro, mb, ...]``, valid on the last stage only; the
    other stages return their compute on bubble garbage (the loss masks it
    with a ``torch.where`` on the stage index).
    """
    n_micro = x_micro.shape[0]
    if n_stages == 1 and not force_schedule:
        # No bubble and no hop: the microbatches run as one batch, whose
        # GEMMs are n_micro times larger.
        flat = x_micro.reshape((-1,) + tuple(x_micro.shape[2:]))
        return stage_fn(stage_params, flat).reshape(x_micro.shape)
    axis = stage_axis(group, n_stages)
    last = n_stages - 1
    first = torch.tensor(axis.index == 0, device=x_micro.device)
    state = torch.zeros(x_micro.shape[1:], dtype=x_micro.dtype,
                        device=x_micro.device)
    inject = x_micro.unbind(0)   # one stack in the backward, not n gathers
    outs = []
    for t in range(n_micro + n_stages - 1):
        # The drain bubble re-injects the last microbatch; what it
        # computes never reaches an output slot.
        h = torch.where(first, inject[min(t, n_micro - 1)], state)
        out = stage_fn(stage_params, h)
        state = stage_hop(out, axis)   # the hop after the compute
        outs.append(out)
    return torch.stack(outs[last:last + n_micro])
