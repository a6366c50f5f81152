"""Mixture-of-experts burn-in on PyTorch: the expert-parallel variant.

The port of ``kubeflow_tpu/models/moe.py``. The decoder skeleton is the
burn-in one (:mod:`.burnin`'s attention, RMSNorm and tied head, so
``attention="flash"`` runs the hand-written kernels), and every FF block is
a switch/top-k MoE (:func:`kubeflow_tpu_torch.parallel.moe.moe_ffn`) whose
experts shard over a mesh ``expert`` axis.

What GSPMD does implicitly in the JAX package is explicit here. Each
process holds its batch shard of the tokens (the batch splits over every
mesh axis: data and expert) and the replicated parameters, except
``expert_w1`` and ``expert_w2``, of which it holds its experts' slice
(``shard_params``). Each process's loss is its share of the global one:
its nll sum over the global token count, plus the aux term (already
averaged over the mesh) over the world size. The train step sums the
gradients of the replicated leaves over the whole world and those of the
expert leaves over the mesh axes they are not split on (the data axis);
the all-to-alls carry the expert gradients between expert shards.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` over the whole
world with an ``expert`` axis (``("data", "expert")`` as the JAX tests
and bench.py build it), or ``None`` for one shard.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.burnin import _attention, _rmsnorm
from kubeflow_tpu_torch.models.tree import leaves, map_with, value_and_grad
from kubeflow_tpu_torch.parallel.mesh import (Axis, grad_groups, reduce_grads,
                                              shard, world_size)
from kubeflow_tpu_torch.parallel.moe import moe_ffn

__all__ = ["MoEConfig", "forward", "init_params", "loss_fn",
           "make_train_step", "param_shapes", "param_sharding_rules",
           "shard_params"]


@dataclass(frozen=True)
class MoEConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 128
    n_experts: int = 4            # must be divisible by the expert-axis size
    capacity_factor: float = 1.25
    router_top_k: int = 1         # 1 = switch; 2 = GShard-style top-2
    aux_weight: float = 0.01      # Switch §2.2 load-balancing loss weight
    dtype: str = "bfloat16"
    attention: str = "xla"        # burnin._attention reads it

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} does not divide by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def param_shapes(cfg: MoEConfig) -> dict:
    """The parameter tree with each leaf's shape in place of its value
    (the experts' leaves unsharded)."""
    d, e = cfg.d_model, cfg.n_experts
    layer = {"ln1": (d,), "ln2": (d,), "qkv": (d, 3 * d), "attn_out": (d, d),
             "router": (d, e), "expert_w1": (e, d, cfg.d_ff),
             "expert_w2": (e, cfg.d_ff, d)}
    return {"embed": (cfg.vocab, d), "pos": (cfg.seq_len, d),
            "out_norm": (d,), "layers": [dict(layer)
                                         for _ in range(cfg.n_layers)]}


def init_params(cfg: MoEConfig, *, seed: int, device=None) -> dict:
    """Seeded random f32 parameters with the JAX init's tree and scales
    (normal x 0.02 for the embeddings and the router, x 1/sqrt(fan_in)
    with the fan-in the penultimate dim, so the expert tensors
    ``[E, fan_in, fan_out]`` do not scale by E; ones for the norms), drawn
    on ``device`` from an explicit generator. The numbers differ from
    ``jax.random``'s; a test that needs the JAX values converts the JAX
    tree instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def dense(shape, scale=None):
        scale = scale if scale is not None else (1.0 / shape[-2]) ** 0.5
        return torch.randn(shape, generator=gen, device=dev) * scale

    def draw(name, shape):
        if name in ("ln1", "ln2", "out_norm"):
            return torch.ones(shape, device=dev)
        if name in ("embed", "pos", "router"):
            return dense(shape, scale=0.02)
        return dense(shape)

    shapes = param_shapes(cfg)
    return {**{name: draw(name, shapes[name])
               for name in ("embed", "pos", "out_norm")},
            "layers": [{name: draw(name, shape) for name, shape in lay.items()}
                       for lay in shapes["layers"]]}


def param_sharding_rules(cfg: MoEConfig, expert_axis: str = "expert") -> dict:
    """Each leaf's split, as the JAX package's ``PartitionSpec``s: a tuple
    of mesh axis names by dim, ``()`` for a replicated leaf. The experts
    split over the expert axis; everything else replicates."""
    layer = {"ln1": (), "ln2": (), "qkv": (), "attn_out": (), "router": (),
             "expert_w1": (expert_axis, None, None),
             "expert_w2": (expert_axis, None, None)}
    return {"embed": (), "pos": (), "out_norm": (),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def shard_params(params: dict, mesh, cfg: MoEConfig,
                 expert_axis: str = "expert") -> dict:
    """This process's parameters: its experts' slice of ``expert_w1`` and
    ``expert_w2`` (contiguous copies), the other leaves as they are; the
    tree itself on one expert shard."""
    size = Axis.of(mesh, expert_axis).size
    if cfg.n_experts % size:
        raise ValueError(f"{cfg.n_experts} experts do not divide into "
                         f"{size} expert shards")
    return map_with(lambda p, spec: shard(p, spec, mesh), params,
                    param_sharding_rules(cfg, expert_axis))


def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig, mesh=None,
            expert_axis: str = "expert"):
    """This process's ``[b_local, seq]`` ids -> (f32 logits ``[b_local,
    seq, vocab]``, the aux loss averaged over the layers and the mesh)."""
    dtype = getattr(torch, cfg.dtype)
    s = tokens.shape[1]
    x = params["embed"][tokens].to(dtype) + params["pos"][:s].to(dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, cfg)
        y, aux = moe_ffn(_rmsnorm(x, layer["ln2"]), layer["router"],
                         layer["expert_w1"], layer["expert_w2"], mesh,
                         expert_axis=expert_axis,
                         capacity_factor=cfg.capacity_factor,
                         router_top_k=cfg.router_top_k)
        x = x + y
        aux_total = aux_total + aux
    x = _rmsnorm(x, params["out_norm"])
    logits = (x @ params["embed"].T.to(dtype)).float()
    return logits, aux_total / cfg.n_layers


def loss_fn(params: dict, tokens: torch.Tensor, cfg: MoEConfig, mesh=None,
            expert_axis: str = "expert") -> torch.Tensor:
    """This process's share of the JAX package's loss, the mean next-token
    nll (the forward on ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, f32
    log softmax) plus ``aux_weight`` times the aux loss: its nll sum over
    the global token count, and the aux term over the world size. The
    shares sum to the loss."""
    logits, aux = forward(params, tokens[:, :-1], cfg, mesh, expert_axis)
    world = world_size(mesh)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1), reduction="sum")
    return (nll / (logits.shape[0] * logits.shape[1] * world)
            + cfg.aux_weight * aux / world)


def make_train_step(cfg: MoEConfig, mesh=None, lr: float = 1e-3,
                    expert_axis: str = "expert"):
    """SGD train step ``(params, tokens) -> (params, loss)`` on this
    process's shard of the params (``shard_params``) and of the batch:
    gradients of its loss share, summed as GSPMD sums them (the replicated
    leaves over the world, the experts over the data axis), and
    ``p - lr * g`` on every leaf in place (the counterpart of the JAX
    step's donated params). The loss returned is the global one, on the
    device."""
    world = world_size(mesh)
    if world > 1:
        groups = [grad_groups(spec, mesh) for spec in
                  leaves(param_sharding_rules(cfg, expert_axis))]

    def step(params, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens, cfg, mesh,
                                     expert_axis)
        if world > 1:
            reduce_grads(grads, groups)
            dist.all_reduce(loss)
        with torch.no_grad():
            torch._foreach_add_(leaves(params), grads, alpha=-lr)
        return params, loss

    return step
