"""Pipelined burn-in on PyTorch: pipeline parallel, optionally x tensor
parallel.

The port of ``kubeflow_tpu/models/pipelined.py``. The decoder is the
burn-in one, its layer stack split into contiguous stages over a "stage"
mesh axis through the GPipe schedule of
:mod:`kubeflow_tpu_torch.parallel.pipeline`; with a "model" axis each
stage's products are Megatron-style tensor parallel (qkv and ff1 split by
column over whole heads and ff columns, attn_out and ff2 by row, each
row-parallel product summed over the model axis). Every layer leaf is
stacked on a leading layer dim, and attention uses the head-split layout
``qkv [L, d, 3, heads, head_dim]``, ``attn_out [L, heads, head_dim, d]``,
so a converted JAX tree is a copy.

What shard_map's varying-axes types do in the JAX step is explicit here.
Each process holds its data shard of the tokens and its stage's layers
(and model shard's heads and ff columns, ``shard_params``). Every process
computes its loss, masked to 0 off the last stage and scaled by
``1 / (data * model)``, so the losses sum over the world to the global
mean. The cotangents of the activations that the model axis replicates
are then shares, one per model process, that sum to the whole; the
transposes of the JAX step leave them so. The backward of the forward's
model-axis sum (``parallel.mesh.ModelSum``) therefore sums the shares,
and the train step sums each leaf's gradient once over exactly the mesh
axes its sharding rule leaves it replicated on (the JAX module's
``reduce_grads``).

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
world with axes ("data", "stage"[, "model"]) (``make_pp_mesh``), or None:
the one-card 1 x 1 mesh of bench.py's ``_family_bench``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.burnin import _rmsnorm
from kubeflow_tpu_torch.models.tree import leaves, map_with, value_and_grad
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel.mesh import (Axis, axis, grad_groups,
                                              model_sum, reduce_grads, shard,
                                              world_size)
from kubeflow_tpu_torch.parallel.pipeline import pipeline_apply, pipeline_spans
from kubeflow_tpu_torch.parallel.ring import reference_causal_attention

__all__ = ["PipelinedConfig", "init_params", "loss_fn", "make_pp_mesh",
           "make_train_step", "param_shapes", "param_sharding_rules",
           "reference_loss", "shard_params"]

# The layer leaves in the order a stage walks them.
_LAYER_LEAVES = ("ln1", "ln2", "qkv", "attn_out", "ff1", "ff2")


@dataclass(frozen=True)
class PipelinedConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4             # must divide by the model-axis size
    n_layers: int = 4            # must divide by n_stages
    d_ff: int = 512              # must divide by the model-axis size
    seq_len: int = 128
    n_micro: int = 4             # microbatches per global batch
    dtype: str = "bfloat16"
    # "xla": reference_causal_attention (dense scores); "flash": the
    # hand-written kernels (ops.flash_attention).
    attention: str = "xla"

    def __post_init__(self):
        if self.attention not in ("xla", "flash"):
            raise ValueError(
                f"attention={self.attention!r} — expected 'xla' or 'flash'")

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} does not divide by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def param_shapes(cfg: PipelinedConfig) -> dict:
    """The parameter tree (unsharded) with each leaf's shape in place of
    its value, in the JAX init's order."""
    n, d, f, h, hd = (cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_heads,
                      cfg.head_dim)
    return {"embed": (cfg.vocab, d), "pos": (cfg.seq_len, d),
            "out_norm": (d,),
            "layers": {"ln1": (n, d), "ln2": (n, d), "qkv": (n, d, 3, h, hd),
                       "attn_out": (n, h, hd, d), "ff1": (n, d, f),
                       "ff2": (n, f, d)}}


def init_params(cfg: PipelinedConfig, *, seed: int, device=None) -> dict:
    """Seeded random f32 parameters with the JAX init's tree and scales
    (normal x 0.02 for the embeddings; x 1/sqrt(fan_in) for the products,
    fan_in d_model for qkv, attn_out and ff1 and d_ff for ff2; ones for
    the norms), drawn on ``device`` (the card by default) from an explicit
    generator. The numbers differ from ``jax.random``'s; a test that needs
    the JAX values converts the JAX tree instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = param_shapes(cfg)
    fan_in = {"qkv": cfg.d_model, "attn_out": cfg.d_model,
              "ff1": cfg.d_model, "ff2": cfg.d_ff}

    def normal(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def draw(name, shape):
        if name in ("ln1", "ln2", "out_norm"):
            return torch.ones(shape, device=dev)
        if name in ("embed", "pos"):
            return normal(shape, 0.02)
        return normal(shape, (1.0 / fan_in[name]) ** 0.5)

    return {**{name: draw(name, shapes[name])
               for name in ("embed", "pos", "out_norm")},
            "layers": {name: draw(name, shape)
                       for name, shape in shapes["layers"].items()}}


def param_sharding_rules(cfg: PipelinedConfig,
                         model_axis: str | None = None) -> dict:
    """Each leaf's split, as the JAX package's ``PartitionSpec``s: a tuple
    of mesh axis names (or None) by dim, ``()`` for a replicated leaf.
    The layer stack splits over "stage"; with a model axis, heads and ff
    columns split over it; the embeddings and the final norm replicate."""
    m = model_axis
    return {"embed": (), "pos": (), "out_norm": (),
            "layers": {"ln1": ("stage", None), "ln2": ("stage", None),
                       "qkv": ("stage", None, None, m, None),
                       "attn_out": ("stage", m, None, None),
                       "ff1": ("stage", None, m), "ff2": ("stage", m, None)}}


def _model_axis_name(mesh, model_axis: str) -> str | None:
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return model_axis if model_axis in names else None


def shard_params(params: dict, mesh, cfg: PipelinedConfig,
                 stage_axis: str = "stage",
                 model_axis: str = "model") -> dict:
    """This process's parameters: its stage's layers and, with a model
    axis, its heads and ff columns, as contiguous copies; the replicated
    leaves as they are. ``mesh=None``: the tree itself."""
    stage = axis(mesh, stage_axis)
    pipeline_spans(cfg.n_layers, stage.size)  # clear divisibility error
    model = axis(mesh, model_axis)
    if cfg.n_heads % model.size or cfg.d_ff % model.size:
        raise ValueError(f"n_heads={cfg.n_heads} and d_ff={cfg.d_ff} must "
                         f"divide by model-axis size {model.size}")
    rules = param_sharding_rules(cfg, _model_axis_name(mesh, model_axis))
    return map_with(lambda p, spec: shard(p, spec, mesh), params, rules)


def _stage_fn(cfg: PipelinedConfig, model: Axis = Axis()):
    """``(local_layers, h) -> h``: the transformer layer over this
    process's slice of the stack; with a model axis, the local heads and
    ff columns and one model-axis sum after each row-parallel product."""

    def run(local_layers, h):
        dtype = h.dtype
        b, s, d = h.shape
        # One cast and one unbind a leaf (one stack in the backward), not
        # an index per layer.
        stacks = [local_layers[name] if name in ("ln1", "ln2")
                  else local_layers[name].to(dtype)
                  for name in _LAYER_LEAVES]
        for ln1, ln2, qkv_w, out_w, ff1, ff2 in zip(
                *(t.unbind(0) for t in stacks)):
            _, _, heads, hd = qkv_w.shape
            x = _rmsnorm(h, ln1)
            qkv = (x @ qkv_w.reshape(d, -1)).reshape(b, s, 3, heads, hd)
            # [mb, s, H, hd] views: the kernels read them through their
            # strides.
            q, k, v = (qkv[:, :, i] for i in range(3))
            if cfg.attention == "flash":
                ctx = flash_attention(q, k, v)
            else:
                ctx = reference_causal_attention(q, k, v)
            attn = ctx.reshape(b, s, heads * hd) @ out_w.reshape(-1, d)
            h = h + model_sum(attn, model)
            g = F.gelu(_rmsnorm(h, ln2) @ ff1, approximate="tanh")
            h = h + model_sum(g @ ff2, model)
        return h

    return run


def _logits_nll(params, x, tgt, dtype):
    x = _rmsnorm(x, params["out_norm"])
    logits = (x @ params["embed"].T.to(dtype)).float()
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1))


def _embed(params, inp, dtype):
    return (params["embed"][inp].to(dtype)
            + params["pos"][:inp.shape[1]].to(dtype))


def reference_loss(params: dict, tokens: torch.Tensor,
                   cfg: PipelinedConfig) -> torch.Tensor:
    """Unpipelined one-device loss on the same stacked params: the oracle
    for the schedule and the model-axis sums."""
    dtype = getattr(torch, cfg.dtype)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    x = _stage_fn(cfg)(params["layers"], _embed(params, inp, dtype))
    return _logits_nll(params, x, tgt, dtype)


def loss_fn(params: dict, tokens: torch.Tensor, cfg: PipelinedConfig,
            mesh=None, *, force_schedule: bool = False,
            data_axis: str = "data", stage_axis: str = "stage",
            model_axis: str = "model") -> torch.Tensor:
    """This process's share of the JAX step's loss on its shard of the
    params and of the batch: the mean next-token nll of the pipelined
    forward (on ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, f32 log
    softmax), 0 off the last stage, over ``data * model``. The shares sum
    over the world to the loss. ``force_schedule`` runs the GPipe tick
    schedule even at one stage."""
    data, stage, model = (axis(mesh, name)
                          for name in (data_axis, stage_axis, model_axis))
    dtype = getattr(torch, cfg.dtype)
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    b, s = inp.shape
    if b % cfg.n_micro:
        raise ValueError(f"local batch {b} not divisible by "
                         f"n_micro={cfg.n_micro}")
    x_micro = _embed(params, inp, dtype).reshape(
        cfg.n_micro, b // cfg.n_micro, s, cfg.d_model)
    outs = pipeline_apply(_stage_fn(cfg, model), params["layers"], x_micro,
                          n_stages=stage.size, group=stage.group,
                          force_schedule=force_schedule)
    nll = _logits_nll(params, outs.reshape(b, s, cfg.d_model), tgt, dtype)
    last = torch.tensor(stage.index == stage.size - 1, device=tokens.device)
    # Every model process computes the loss its axis replicates.
    return torch.where(last, nll, 0.0) / (data.size * model.size)


def make_train_step(cfg: PipelinedConfig, mesh=None, lr: float = 1e-3,
                    data_axis: str = "data", stage_axis: str = "stage",
                    model_axis: str = "model",
                    force_schedule: bool = False):
    """SGD train step ``(params, tokens) -> (params, loss)`` on this
    process's shard of the params (``shard_params``) and of the batch (its
    data shard). The gradients of its loss share (:func:`loss_fn`) are
    summed over the axes each leaf replicates on, and ``p - lr * g`` runs
    on every leaf in place (the counterpart of the JAX step's donated
    params). The loss returned is the global one, on the device."""
    pipeline_spans(cfg.n_layers, axis(mesh, stage_axis).size)  # divisibility
    world = world_size(mesh)
    if world > 1:
        rules = param_sharding_rules(cfg, _model_axis_name(mesh, model_axis))
        groups = [grad_groups(spec, mesh) for spec in leaves(rules)]
    loss_share = partial(loss_fn, cfg=cfg, mesh=mesh,
                         force_schedule=force_schedule, data_axis=data_axis,
                         stage_axis=stage_axis, model_axis=model_axis)

    def step(params, tokens):
        loss, grads = value_and_grad(loss_share, params, tokens)
        if world > 1:
            reduce_grads(grads, groups)
            dist.all_reduce(loss)
        with torch.no_grad():
            torch._foreach_add_(leaves(params), grads, alpha=-lr)
        return params, loss

    return step


def make_pp_mesh(n_stages: int = 2, n_model: int = 1,
                 device_type: str = "cuda", data_axis: str = "data",
                 stage_axis: str = "stage",
                 model_axis: str = "model") -> DeviceMesh:
    """A (data, stage[, model]) mesh over the world of the current process
    group, model innermost (its sums run every layer, the stage hop once
    a tick), data outermost. Needs
    ``torch.distributed.init_process_group`` first."""
    if not dist.is_initialized():
        raise RuntimeError("make_pp_mesh needs an initialized process group "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if world % (n_stages * n_model):
        raise ValueError(f"{world} devices not divisible into {n_stages} "
                         f"stages x {n_model} model shards")
    data = world // (n_stages * n_model)
    if n_model > 1:
        return DeviceMesh(device_type,
                          torch.arange(world).reshape(data, n_stages,
                                                      n_model),
                          mesh_dim_names=(data_axis, stage_axis, model_axis))
    return DeviceMesh(device_type, torch.arange(world).reshape(data, n_stages),
                      mesh_dim_names=(data_axis, stage_axis))
