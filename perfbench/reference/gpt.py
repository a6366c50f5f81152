"""The plain reference of the burn-in GPT and its training steps, in f32.

A decoder as the configurations run it (their ``departures`` say where
that differs from the published model): learned absolute positions added
to the token embedding; per layer, RMSNorm (eps 1e-6, a gain and no
bias), causal multi-head attention over a fused qkv projection with scale
1/sqrt(head_dim), an output projection, a residual add, RMSNorm, the tanh
GELU MLP, a residual add; a final RMSNorm and the head tied to the token
embedding; next-token cross entropy, the mean over every trained
position. No linear layer has a bias.

Everything is f32 with TF32 off (:func:`f32_exact`). To fit a long row on
one card, each layer and each block of 1024 query rows of attention is
recomputed in the backward pass (``torch.utils.checkpoint``), which
changes no number. The weights may lie on several devices (a model too
large for one card): each layer runs where its weights are, the
activations moved there as tensors, and the head where the final norm
is; that too changes no number.

``matmul`` is the product of every linear layer and of the head: plain
``@`` for the reference; :func:`fp8_matmul` rounds both operands of every
product, forward and backward, to float8 e4m3 with a per-tensor scale,
the precision below the configurations' bf16 (the control).

The optimizers follow their published rules: AdamW (Loshchilov and
Hutter; b1 0.9, b2 0.999, eps 1e-8 outside the square root, weight decay
decoupled and scaled by the scheduled lr) after a clip of the global norm
(``g * max / ||g||`` when ``||g|| >= max``), with a linear warmup and a
cosine decay of the lr; SGD is ``p - lr * g``.

This module imports torch alone: nothing of the program under test.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

ATTENTION_BLOCK = 1024
RMS_EPS = 1e-6
FP8_MAX = 448.0          # largest finite float8 e4m3fn


@contextlib.contextmanager
def f32_exact():
    """f32 products in f32: TF32 off for cuBLAS and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def plain_matmul(a, b):
    return a @ b


def _fp8(x):
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, grad):
        qa, qb = ctx.saved_tensors
        qg = _fp8(grad)
        return qg @ qb.transpose(-1, -2), (
            qa.reshape(-1, qa.shape[-1]).transpose(0, 1)
            @ qg.reshape(-1, qg.shape[-1]))


def fp8_matmul(a, b):
    return _Fp8Matmul.apply(a, b)


def _rmsnorm(x, gain):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + RMS_EPS) * gain


def _attend_block(q, k, v, start: int):
    """Causal softmax attention of query rows ``start ..`` over keys
    ``0 .. start + rows``."""
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    rows = torch.arange(start, start + q.shape[2], device=q.device)
    cols = torch.arange(k.shape[2], device=q.device)
    scores = scores.masked_fill(cols[None, :] > rows[:, None], float("-inf"))
    return torch.softmax(scores, dim=-1) @ v


def _attention(q, k, v):
    """[b, h, s, d] causal attention, a block of query rows at a time."""
    s = q.shape[2]
    outs = []
    for start in range(0, s, ATTENTION_BLOCK):
        end = min(start + ATTENTION_BLOCK, s)
        outs.append(checkpoint(_attend_block, q[:, :, start:end],
                               k[:, :, :end], v[:, :, :end], start,
                               use_reentrant=False))
    return torch.cat(outs, dim=2)


def _layer(x, ln1, ln2, qkv, attn_out, ff1, ff2, *, n_heads: int, matmul):
    b, s, d = x.shape
    hd = d // n_heads
    q, k, v = matmul(_rmsnorm(x, ln1), qkv).split(d, dim=-1)

    def heads(t):
        return t.reshape(b, s, n_heads, hd).transpose(1, 2)

    ctx = _attention(heads(q), heads(k), heads(v))
    x = x + matmul(ctx.transpose(1, 2).reshape(b, s, d), attn_out)
    h = F.gelu(matmul(_rmsnorm(x, ln2), ff1), approximate="tanh")
    return x + matmul(h, ff2)


LAYER_LEAVES = ("ln1", "ln2", "qkv", "attn_out", "ff1", "ff2")


def loss(weights: dict, tokens: torch.Tensor, model: dict,
         matmul=plain_matmul) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens`` [batch, seq]: the
    forward on ``tokens[:, :-1]`` against ``tokens[:, 1:]``."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x = weights["embed"][inputs] + weights["pos"][: inputs.shape[1]]
    for i in range(model["n_layers"]):
        layer = [weights[f"layers.{i}.{name}"] for name in LAYER_LEAVES]
        x = checkpoint(_layer, x.to(layer[0].device), *layer,
                       n_heads=model["n_heads"], matmul=matmul,
                       use_reentrant=False)
    x = _rmsnorm(x.to(weights["out_norm"].device), weights["out_norm"])
    logits = matmul(x, weights["embed"].transpose(0, 1))
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def loss_and_grads(weights: dict, tokens, model: dict, matmul=plain_matmul):
    """(loss, gradient by leaf name) at ``weights``."""
    live = {name: w.detach().requires_grad_() for name, w in weights.items()}
    value = loss(live, tokens, model, matmul)
    grads = torch.autograd.grad(value, list(live.values()))
    return value.detach(), dict(zip(live, grads))


def lr_factor(count: int, warmup: int, decay_steps: int) -> float:
    """Linear warmup from 0 over ``warmup`` updates, then a cosine to 0 at
    ``decay_steps`` (at least ``warmup + 1``); ``count`` from 0."""
    if count < warmup:
        return count / warmup
    span = max(decay_steps, warmup + 1) - warmup
    return 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, span) / span))


def clip_global_norm(grads: dict, max_norm: float) -> None:
    """``g * max / ||g||`` on every leaf when the global norm ``||g|| >=
    max``; untouched below it."""
    first = next(iter(grads.values())).device
    norm = torch.sqrt(sum((g.double() ** 2).sum().to(first)
                          for g in grads.values()))
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(float(max_norm / norm))


class AdamW:
    def __init__(self, opt: dict):
        self.opt = opt
        self.m, self.v, self.count = {}, {}, 0

    def update(self, weights: dict, grads: dict) -> None:
        opt = self.opt
        lr = opt["lr"] * lr_factor(self.count, opt.get("warmup_steps", 0),
                                   opt.get("decay_steps", 10_000))
        self.count += 1
        t = self.count
        for name, w in weights.items():
            g = grads[name]
            m = self.m.setdefault(name, torch.zeros_like(w))
            v = self.v.setdefault(name, torch.zeros_like(w))
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            w.mul_(1 - lr * opt["weight_decay"])
            denom = (v.sqrt() / math.sqrt(1 - 0.999 ** t)).add_(1e-8)
            w.addcdiv_(m, denom, value=-lr / (1 - 0.9 ** t))


class SGD:
    def __init__(self, opt: dict):
        self.opt = opt

    def update(self, weights: dict, grads: dict) -> None:
        for name, w in weights.items():
            w.add_(grads[name], alpha=-self.opt["lr"])


OPTIMIZERS = {"adamw": AdamW, "sgd": SGD}


def norms(tensors: dict) -> dict:
    return {name: float(torch.linalg.vector_norm(t.double()))
            for name, t in tensors.items()}


def train(weights: dict, batches: list, model: dict, opt: dict,
          matmul=plain_matmul) -> dict:
    """Run one update per batch from ``weights`` (updated in place):
    each step's loss, the norms of the first gradient as the optimizer
    took it (after the clip), and the norms of each leaf's change over
    all the steps."""
    start = {name: w.detach().clone() for name, w in weights.items()}
    optimizer = OPTIMIZERS[opt["optimizer"]](opt)
    losses, grad_norms = [], None
    for tokens in batches:
        value, grads = loss_and_grads(weights, tokens, model, matmul)
        losses.append(float(value))
        with torch.no_grad():
            if opt.get("grad_clip"):
                clip_global_norm(grads, opt["grad_clip"])
            if grad_norms is None:
                grad_norms = norms(grads)
            optimizer.update(weights, grads)
        del grads
    del optimizer
    with torch.no_grad():
        change = {name: float(torch.linalg.vector_norm(
            (w - start.pop(name)).double())) for name, w in weights.items()}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change}
