"""Burn-in transformer on PyTorch: forward, loss and SGD train step.

The port of ``kubeflow_tpu/models/burnin.py`` on one device: the config,
the parameter tree, ``forward``, ``loss_fn`` and ``make_train_step``
(sharding waits for the sharded slice). Parameters are a plain
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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.tree import leaves, map_params, value_and_grad
from kubeflow_tpu_torch.ops.flash_attention import flash_attention

__all__ = ["BurninConfig", "forward", "init_params", "leaves", "loss_fn",
           "make_train_step", "map_params", "param_shapes", "value_and_grad"]


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


def _rmsnorm(x, gamma):
    x32 = x.float()
    scale = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + 1e-6)
    return (x32 * scale * gamma).to(x.dtype)


def _attention(x, layer, cfg: BurninConfig):
    b, s, d = x.shape
    qkv = x @ layer["qkv"].to(x.dtype)                   # [b, s, 3d]
    q, k, v = qkv.split(d, dim=-1)

    if cfg.attention == "flash":
        # [b, s, h, hd] views of the qkv columns: the kernel reads them
        # through their strides.
        def heads_bshd(t):
            return t.reshape(b, s, cfg.n_heads, cfg.head_dim)

        ctx = flash_attention(heads_bshd(q), heads_bshd(k), heads_bshd(v))
        return ctx.reshape(b, s, d) @ layer["attn_out"].to(x.dtype)

    def heads(t):
        return t.reshape(b, s, cfg.n_heads, cfg.head_dim).transpose(1, 2)

    q, k, v = heads(q), heads(k), heads(v)
    logits = (q @ k.transpose(-1, -2)) / (cfg.head_dim ** 0.5)
    keep = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~keep, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    ctx = (probs @ v).transpose(1, 2).reshape(b, s, d)
    return ctx @ layer["attn_out"].to(x.dtype)


def forward(params: dict, tokens: torch.Tensor,
            cfg: BurninConfig) -> torch.Tensor:
    """Token ids [batch, seq] → f32 logits [batch, seq, vocab]."""
    dtype = getattr(torch, cfg.dtype)
    x = (params["embed"][tokens].to(dtype)
         + params["pos"][: tokens.shape[1]].to(dtype))
    for layer in params["layers"]:
        x = x + _attention(_rmsnorm(x, layer["ln1"]), layer, cfg)
        h = _rmsnorm(x, layer["ln2"])
        h = F.gelu(h @ layer["ff1"].to(dtype), approximate="tanh")
        x = x + h @ layer["ff2"].to(dtype)
    x = _rmsnorm(x, params["out_norm"])
    return (x @ params["embed"].T.to(dtype)).float()


def loss_fn(params: dict, tokens: torch.Tensor,
            cfg: BurninConfig) -> torch.Tensor:
    """Next-token cross entropy (shift-by-one on the same sequence): the
    forward on ``tokens[:, :-1]``, targets ``tokens[:, 1:]``, an f32 log
    softmax and the mean over ``batch * (seq - 1)``."""
    logits = forward(params, tokens[:, :-1], cfg)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


def make_train_step(cfg: BurninConfig, lr: float = 1e-3):
    """SGD train step ``(params, tokens) -> (params, loss)``: gradients in
    f32 (the master weights' dtype) and ``p - lr * g`` on every leaf.

    The update is in place: the returned params are the tensors passed in,
    the counterpart of the JAX step's ``donate_argnums=(0,)`` (the caller
    gives up the old params). The loss stays on the device, so steps
    queue without a host sync; reading it synchronises.
    """

    def step(params, tokens):
        loss, grads = value_and_grad(loss_fn, params, tokens, cfg)
        with torch.no_grad():
            torch._foreach_add_(leaves(params), grads, alpha=-lr)
        return params, loss

    return step
