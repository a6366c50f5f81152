"""Burn-in transformer on PyTorch: forward, loss and SGD train step, on
one device or data x tensor parallel over a ("data", "model") mesh.

The port of ``kubeflow_tpu/models/burnin.py``: the config, the parameter
tree, ``forward``, ``loss_fn``, ``make_train_step`` and the tensor-parallel
rules and placement (``param_sharding_rules``, ``shard_params``, and
``unshard_params`` back to the global tree). Parameters are a plain
dict with the JAX tree's names, shapes and f32 master weights, in the
JAX layout (``x @ W`` with ``W: [d_in, d_out]``), so converting a JAX
tree is a copy (:mod:`.convert`). Compute follows the JAX code's
rounding points: weights cast to the compute dtype where they are used,
the embedding and position add and the residual adds in that dtype,
RMSNorm in f32, GELU in its tanh form, the tied head in the compute
dtype and then cast to f32. The plain GEMMs stay ``torch.matmul``, as
the JAX package leaves them to XLA; ``attention="flash"`` runs the
hand-written kernels (:mod:`kubeflow_tpu_torch.ops.flash_attention`): the
forward, and under autograd the dQ and dK/dV backward kernels. Gradients
land in f32 on the f32 master weights, as JAX's do through ``astype``.

Sharded, what GSPMD inserts in the JAX step is explicit
(:mod:`kubeflow_tpu_torch.parallel.mesh`). Megatron splits over "model":
qkv and ff1 by column, attn_out and ff2 by row, one model-axis sum after
each row-parallel product; each process passes its "data" shard of the
tokens; the embeddings, norms and tied head replicate, so every model
process computes the whole logits. Unlike the JAX package's contiguous
column blocks, a qkv shard holds whole heads of q, k and v (the columns of
heads ``[r H/m, (r+1) H/m)`` of each), so attention runs locally; where
``n_heads`` does not divide by the model axis, qkv and attn_out stay whole
on every model process and only the FF splits.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.tree import (leaves, map_params, map_with,
                                            value_and_grad)
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel.mesh import (Axis, Spec, axis, grad_groups,
                                              model_sum, reduce_grads, shard,
                                              unshard, world_size)

__all__ = ["BurninConfig", "forward", "init_params", "leaves", "loss_fn",
           "make_train_step", "map_params", "param_shapes",
           "param_sharding_rules", "shard_params", "unshard_params",
           "value_and_grad"]


@dataclass(frozen=True)
class BurninConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 128
    dtype: str = "bfloat16"
    # "xla": plain dense causal attention (the JAX package's XLA path).
    # "flash": the fused kernel (ops.flash_attention).
    attention: str = "xla"

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} does not divide by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def param_shapes(cfg: BurninConfig) -> dict:
    """The parameter tree with each leaf's shape in place of its value."""
    d = cfg.d_model
    layer = {"ln1": (d,), "ln2": (d,), "qkv": (d, 3 * d), "attn_out": (d, d),
             "ff1": (d, cfg.d_ff), "ff2": (cfg.d_ff, d)}
    return {"embed": (cfg.vocab, d), "pos": (cfg.seq_len, d),
            "out_norm": (d,), "layers": [dict(layer)
                                         for _ in range(cfg.n_layers)]}


def init_params(cfg: BurninConfig, *, seed: int, device=None) -> dict:
    """Seeded random f32 parameters with the JAX init's tree and scales
    (normal × 0.02 for the embeddings, × 1/sqrt(fan_in) for the dense
    layers, ones for the norms), drawn on ``device`` from an explicit
    generator. The numbers differ from ``jax.random``'s; a test that
    needs the JAX values converts the JAX tree instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shapes = param_shapes(cfg)

    def dense(shape, scale=None):
        scale = scale if scale is not None else (1.0 / shape[0]) ** 0.5
        return torch.randn(shape, generator=gen, device=dev) * scale

    def ones(shape):
        return torch.ones(shape, device=dev)

    return {
        "embed": dense(shapes["embed"], scale=0.02),
        "pos": dense(shapes["pos"], scale=0.02),
        "out_norm": ones(shapes["out_norm"]),
        "layers": [
            {"ln1": ones(lay["ln1"]), "ln2": ones(lay["ln2"]),
             "qkv": dense(lay["qkv"]), "attn_out": dense(lay["attn_out"]),
             "ff1": dense(lay["ff1"]), "ff2": dense(lay["ff2"])}
            for lay in shapes["layers"]
        ],
    }


def param_sharding_rules(cfg: BurninConfig) -> dict:
    """The JAX package's tensor-parallel rules, each leaf's split by dim
    as a ``PartitionSpec``'s tuple (``()`` replicated): qkv and ff1
    column-parallel, attn_out and ff2 row-parallel over "model". qkv and
    attn_out cut by whole heads (``parallel.mesh.Spec``)."""
    layer = {"ln1": (), "ln2": (),
             "qkv": Spec((None, "model"), parts=3, units=cfg.n_heads),
             "attn_out": Spec(("model", None), units=cfg.n_heads),
             "ff1": (None, "model"), "ff2": ("model", None)}
    return {"embed": (), "pos": (), "out_norm": (),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def shard_params(params: dict, mesh, cfg: BurninConfig) -> dict:
    """This process's parameters on ``mesh``: its heads' columns of qkv
    and rows of attn_out, its ff1 columns and ff2 rows, as contiguous
    copies; the replicated leaves as they are (the whole tree at one model
    shard). A width that does not divide into the model axis's shards
    raises ``ValueError``, as the JAX package's placement does."""
    return map_with(lambda p, spec: shard(p, spec, mesh), params,
                    param_sharding_rules(cfg))


def unshard_params(params: dict, mesh, cfg: BurninConfig) -> dict:
    """The global tree, in the JAX layout, of this process's shards (every
    process of the mesh calls it: the split leaves are gathered)."""
    return map_with(lambda p, spec: unshard(p, spec, mesh), params,
                    param_sharding_rules(cfg))


def _rmsnorm(x, gamma):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * scale * gamma).to(x.dtype)


def _attention(x, layer, cfg: BurninConfig, model: Axis = Axis()):
    """Causal self-attention over the heads in ``layer``'s qkv (this
    process's, sharded) and its attn_out rows. Where that is a share of
    the heads (``shard_params`` cut them), the product is summed over
    ``model``; whole heads on every model process need no sum."""
    b, s, _ = x.shape
    qkv = x @ layer["qkv"].to(x.dtype)                   # [b, s, 3 width]
    width = qkv.shape[-1] // 3
    n_heads = width // cfg.head_dim
    q, k, v = qkv.split(width, dim=-1)
    if width == cfg.d_model:
        model = Axis()

    if cfg.attention == "flash":
        # [b, s, h, hd] views of the qkv columns: the kernel reads them
        # through their strides.
        def heads_bshd(t):
            return t.reshape(b, s, n_heads, cfg.head_dim)

        ctx = flash_attention(heads_bshd(q), heads_bshd(k), heads_bshd(v))
        return model_sum(
            ctx.reshape(b, s, width) @ layer["attn_out"].to(x.dtype), model)

    def heads(t):
        return t.reshape(b, s, n_heads, cfg.head_dim).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    logits = (q @ k.transpose(-1, -2)) / (cfg.head_dim ** 0.5)
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    ctx = (probs @ v).transpose(1, 2).reshape(b, s, width)
    return model_sum(ctx @ layer["attn_out"].to(x.dtype), model)


def forward(params: dict, tokens: torch.Tensor, cfg: BurninConfig,
            mesh=None) -> torch.Tensor:
    """Token ids [batch, seq] → f32 logits [batch, seq, vocab]. With a
    ``mesh``, ``params`` are this process's shards (``shard_params``) and
    the logits are whole on every model process."""
    dtype = getattr(torch, cfg.dtype)
    model = axis(mesh, "model")
    x = (params["embed"][tokens].to(dtype)
         + params["pos"][: tokens.shape[1]].to(dtype))
    for layer in params["layers"]:
        x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, cfg, model)
        h = _rmsnorm(x, layer["ln2"])
        h = F.gelu(h @ layer["ff1"].to(dtype), approximate="tanh")
        x = x + model_sum(h @ layer["ff2"].to(dtype), model)
    x = _rmsnorm(x, params["out_norm"])
    return (x @ params["embed"].T.to(dtype)).float()


def loss_fn(params: dict, tokens: torch.Tensor, cfg: BurninConfig,
            mesh=None) -> torch.Tensor:
    """Next-token cross entropy (shift-by-one on the same sequence): the
    forward on ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, an f32 log
    softmax and the mean over ``batch * (seq - 1)``. With a ``mesh`` of
    more than one process, this process's share of the global loss: the
    mean over its data shard of the tokens, over the mesh's size (every
    model process computes the loss its data shard's model axis
    replicates); the shares sum over the world to the loss."""
    logits = forward(params, tokens[:, :-1], cfg, mesh)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))
    world = world_size(mesh)
    return loss if world == 1 else loss / world


def make_train_step(cfg: BurninConfig, mesh=None, lr: float = 1e-3):
    """SGD train step ``(params, tokens) -> (params, loss)``: gradients in
    f32 (the master weights' dtype) and ``p - lr * g`` on every leaf.

    With a ``mesh`` (a ("data", "model") ``DeviceMesh`` over the whole
    world), ``params`` are this process's shards (``shard_params``) and
    ``tokens`` its data shard; each gradient is summed over the mesh axes
    its leaf is replicated on and the loss over the world, as GSPMD sums
    them in the JAX step. At one process the step runs the unsharded ops,
    with no collective.

    The update is in place: the returned params are the tensors passed in,
    the counterpart of the JAX step's ``donate_argnums=(0,)`` (the caller
    gives up the old params). The loss stays on the device, so steps
    queue without a host sync; reading it synchronises.
    """
    world = world_size(mesh)
    if world > 1:
        groups = [grad_groups(spec, mesh)
                  for spec in leaves(param_sharding_rules(cfg))]

    def step(params, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens, cfg, mesh)
        if world > 1:
            reduce_grads(grads, groups)
            dist.all_reduce(loss)
        with torch.no_grad():
            torch._foreach_add_(leaves(params), grads, alpha=-lr)
        return params, loss

    return step
