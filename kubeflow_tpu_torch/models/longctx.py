"""Long-context burn-in on PyTorch: the sequence-parallel variant.

The port of ``kubeflow_tpu/models/longctx.py``. The decoder is the burn-in
one (:mod:`.burnin`'s RMSNorm, tanh GELU, tied head, the same parameter
tree), but each process holds one shard of the sequence (and of the batch
on the data axis) and attention runs through one of the sequence-parallel
strategies of :mod:`kubeflow_tpu_torch.parallel`. What GSPMD does
implicitly in the JAX package is explicit here:

* the parameters are replicated, and each process adds its own rows of the
  position table, ``[i·S/P, (i+1)·S/P)`` for sequence shard i;
* the targets are the circular roll of the GLOBAL sequence: a shard's last
  target is the first token of the next shard (one point-to-point
  exchange), and the last shard's is global token 0;
* each process's loss is its nll sum over the global ``batch · S`` count,
  and the train step sums the gradients (and the loss) over the whole
  world, data and sequence axes alike.

``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` whose axes are
data axes and the sequence axis (or the ring-major pair of sequence axes
for the ring×ulysses strategies), or ``None`` for one shard: then no
collective runs, as on one card.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.models import burnin
from kubeflow_tpu_torch.models.burnin import _rmsnorm, tied_head
from kubeflow_tpu_torch.models.tree import leaves, value_and_grad
from kubeflow_tpu_torch.parallel.mesh import Axis, world_size
from kubeflow_tpu_torch.parallel.ring import ring_attention
from kubeflow_tpu_torch.parallel.ulysses import (
    ring_ulysses_attention,
    ulysses_attention,
)

# The JAX package's strategies, by the same keys: ring bounds memory at
# O((S/P)^2) with P neighbour hops; ulysses does two all-to-alls and an
# exact full-sequence softmax over H/P heads; the *_flash variants run the
# hand-written kernels forward and backward; ring_ulysses composes both
# over a (ring_axis, uly_axis) pair passed as ``seq_axis``.
ATTENTION_STRATEGIES = {
    "ring": ring_attention,
    "ring_flash": partial(ring_attention, block_impl="flash"),
    "ulysses": ulysses_attention,
    "ulysses_flash": partial(ulysses_attention, block_impl="flash"),
    "ring_ulysses": ring_ulysses_attention,
    "ring_ulysses_flash": partial(ring_ulysses_attention,
                                  block_impl="flash"),
}


@dataclass(frozen=True)
class LongContextConfig:
    vocab: int = 256
    d_model: int = 128
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 1024          # the global S, sharded S/P per process
    dtype: str = "bfloat16"
    attention: str = "ring"      # any ATTENTION_STRATEGIES key

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(f"d_model {self.d_model} does not divide by "
                             f"n_heads {self.n_heads}")
        return self.d_model // self.n_heads


def init_params(cfg: LongContextConfig, *, seed: int, device=None) -> dict:
    """Seeded random f32 parameters with the JAX init's tree and scales,
    which are the burn-in model's (``burnin.param_shapes`` gives the
    tree), on ``device`` (``None``: the card)."""
    return burnin.init_params(cfg, seed=seed, device=device)


def _seq_names(seq_axis) -> tuple:
    return (seq_axis,) if isinstance(seq_axis, str) else tuple(seq_axis)


def _seq_shard(mesh, seq_axis) -> tuple[int, int]:
    """(this process's sequence shard, shard count), ring-major over the
    sequence axes."""
    index, count = 0, 1
    for name in _seq_names(seq_axis):
        axis = Axis.of(mesh, name)
        index, count = index * axis.size + axis.index, count * axis.size
    return index, count


def _seq_neighbour(mesh, seq_axis, step: int) -> int:
    """Global rank of the process holding sequence shard ``index + step``
    (mod the count) with this process's batch shard."""
    index, count = _seq_shard(mesh, seq_axis)
    target = (index + step) % count
    names = mesh.mesh_dim_names
    coord = list(mesh.get_coordinate())
    for name in reversed(_seq_names(seq_axis)):
        dim = names.index(name)
        coord[dim] = target % mesh.size(dim)
        target //= mesh.size(dim)
    return int(mesh.mesh[tuple(coord)])


def _next_tokens(tokens, mesh, seq_axis):
    """This shard's targets: ``roll(tokens, -1, axis=1)`` over the global
    sequence. The last target comes from the next shard's first token."""
    _, count = _seq_shard(mesh, seq_axis)
    if count == 1:
        return torch.roll(tokens, -1, dims=1)
    first = tokens[:, :1].contiguous()
    after = torch.empty_like(first)
    ops = [dist.P2POp(dist.isend, first, _seq_neighbour(mesh, seq_axis, -1)),
           dist.P2POp(dist.irecv, after, _seq_neighbour(mesh, seq_axis, 1))]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return torch.cat([tokens[:, 1:], after], dim=1)


def forward(params: dict, tokens: torch.Tensor, cfg: LongContextConfig,
            mesh=None, seq_axis="seq") -> torch.Tensor:
    """This process's ``[b_local, s_local]`` token ids → f32 logits
    ``[b_local, s_local, vocab]``."""
    dtype = getattr(torch, cfg.dtype)
    b, s = tokens.shape
    start = _seq_shard(mesh, seq_axis)[0] * s
    attn = ATTENTION_STRATEGIES[cfg.attention]
    x = (params["embed"][tokens].to(dtype)
         + params["pos"][start:start + s].to(dtype))
    for layer in params["layers"]:
        h = _rmsnorm(x, layer["ln1"])
        qkv = h @ layer["qkv"].to(dtype)
        q, k, v = (t.reshape(b, s, cfg.n_heads, cfg.head_dim)
                   for t in qkv.split(cfg.d_model, dim=-1))
        ctx = attn(q, k, v, mesh, seq_axis).reshape(b, s, cfg.d_model)
        x = x + ctx @ layer["attn_out"].to(dtype)
        h = _rmsnorm(x, layer["ln2"])
        h = F.gelu(h @ layer["ff1"].to(dtype), approximate="tanh")
        x = x + h @ layer["ff2"].to(dtype)
    x = _rmsnorm(x, params["out_norm"])
    return tied_head(x, params["embed"], dtype)


def loss_fn(params: dict, tokens: torch.Tensor, cfg: LongContextConfig,
            mesh=None, seq_axis="seq") -> torch.Tensor:
    """This process's share of the next-token loss: its nll sum (f32 log
    softmax, circular targets) over the global ``batch · S`` count, so the
    shares sum to the JAX package's mean."""
    logits = forward(params, tokens, cfg, mesh, seq_axis)
    targets = _next_tokens(tokens, mesh, seq_axis)
    count = tokens.numel() * (1 if mesh is None else mesh.size())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1), reduction="sum") / count


def make_train_step(cfg: LongContextConfig, mesh=None, lr: float = 1e-3,
                    seq_axis="seq"):
    """SGD train step ``(params, tokens) -> (params, loss)``: gradients of
    this process's loss share, summed over the world, and ``p - lr * g``
    on every leaf, in place (the counterpart of the JAX step's donated
    params). The loss returned is the global mean, on the device."""
    world = world_size(mesh)

    def step(params, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens, cfg, mesh,
                                     seq_axis)
        if world > 1:  # the params are replicated: sum every share
            for t in grads + [loss]:
                dist.all_reduce(t)
        with torch.no_grad():
            torch._foreach_add_(leaves(params), grads, alpha=-lr)
        return params, loss

    return step


def shard_inputs(tokens, params, mesh, seq_axis="seq",
                 data_axis: str = "data"):
    """This process's block of the global ``[batch, S]`` tokens (batch
    split over ``data_axis`` when the mesh has it, the sequence ring-major
    over ``seq_axis``) and the params, which stay replicated: each process
    indexes its own rows of ``pos``."""
    index, count = _seq_shard(mesh, seq_axis)
    b, s = tokens.shape
    if s % count:
        raise ValueError(f"seq {s} does not divide into {count} shards")
    s_local = s // count
    rows = slice(None)
    if mesh is not None and data_axis in (mesh.mesh_dim_names or ()):
        data = Axis.of(mesh, data_axis)
        if b % data.size:
            raise ValueError(f"batch {b} does not divide into {data.size} "
                             f"data shards")
        b_local = b // data.size
        rows = slice(data.index * b_local, (data.index + 1) * b_local)
    cols = slice(index * s_local, (index + 1) * s_local)
    return tokens[rows, cols].contiguous(), params
