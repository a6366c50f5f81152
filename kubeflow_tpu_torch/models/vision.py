"""Vision burn-in on PyTorch: the convolution workload of the model
families.

The port of ``kubeflow_tpu/models/vision.py``: a small pre-activation
residual convnet (space-to-depth stem, stages of residual blocks with
stride-2 downsamples between them, global pool, classifier), RMSNorm over
channels instead of batchnorm. The public functions keep the JAX layouts:
images ``[batch, H, W, C]`` and conv weights HWIO ``[kh, kw, cin, cout]``,
so a converted JAX tree is a copy. Inside, activations stay NHWC in
memory: a conv sees them as an NCHW tensor in ``channels_last`` memory
(a permuted view, no copy), and its weight goes to OIHW where it is used.
The convolutions are PyTorch's ``conv2d``, as the JAX package leaves its
``conv_general_dilated`` to XLA outside any Pallas kernel; ``"SAME"``
padding is XLA's: at stride 2 on an even size one row and column after and
none before.

Data parallel (``shard_batch``), each process holds the whole params and
its "data" shard of the batch; RMSNorm is per sample, so the shards'
losses are independent and the step sums the gradients and the loss
shares over the data axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.nn.functional as F

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models.burnin import _rmsnorm
from kubeflow_tpu_torch.models.tree import leaves, value_and_grad
from kubeflow_tpu_torch.parallel.mesh import Axis, shard, world_size

__all__ = ["VisionConfig", "conv2d", "forward", "forward_flops",
           "init_params", "loss_fn", "make_train_step", "param_shapes",
           "shard_batch", "space_to_depth"]


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 64
    channels: int = 3
    widths: tuple = (128, 256, 512)   # per stage; stride-2 between stages
    blocks_per_stage: int = 2
    num_classes: int = 1000
    dtype: str = "bfloat16"

    def __post_init__(self):
        # The space-to-depth stem folds 2x2 pixel blocks into channels
        # (its weight is [3, 3, 4 * channels, widths[0]]), so H and W must
        # be even.
        if self.image_size % 2:
            raise ValueError(
                f"image_size={self.image_size} must be even: the "
                f"space-to-depth stem folds 2x2 pixel blocks into channels")


def param_shapes(cfg: VisionConfig) -> dict:
    """The parameter tree with each leaf's shape in place of its value, in
    the JAX init's order (conv weights HWIO)."""
    stages, cin = [], cfg.widths[0]
    for width in cfg.widths:
        block = {"norm1": (width,), "conv1": (3, 3, width, width),
                 "norm2": (width,), "conv2": (3, 3, width, width)}
        stages.append({"down": (3, 3, cin, width),
                       "blocks": [dict(block)
                                  for _ in range(cfg.blocks_per_stage)]})
        cin = width
    return {"stem": (3, 3, 4 * cfg.channels, cfg.widths[0]),
            "stages": stages, "head_norm": (cfg.widths[-1],),
            "head": (cfg.widths[-1], cfg.num_classes)}


def init_params(cfg: VisionConfig, *, seed: int, device=None) -> dict:
    """Seeded random f32 parameters with the JAX init's tree and scales
    (He normal, sqrt(2 / (kh * kw * cin)), for the convs; normal x
    1/sqrt(width) for the head; ones for the norms), drawn on ``device``
    (the card by default). The numbers differ from ``jax.random``'s; a
    test that needs the JAX values converts the JAX tree instead."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def draw(shape):
        if len(shape) == 1:
            return torch.ones(shape, device=dev)
        if len(shape) == 2:     # the head
            scale = (1.0 / shape[0]) ** 0.5
        else:
            scale = (2.0 / (shape[0] * shape[1] * shape[2])) ** 0.5
        return torch.randn(shape, generator=gen, device=dev) * scale

    def build(tree):
        if isinstance(tree, dict):
            return {key: build(value) for key, value in tree.items()}
        if isinstance(tree, list):
            return [build(value) for value in tree]
        return draw(tree)

    return build(param_shapes(cfg))


def _same_pads(size: int, k: int, stride: int) -> tuple:
    """XLA's "SAME" padding (before, after) along one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1):
    """``[b, H, W, cin]`` (NHWC) conv HWIO ``w`` with XLA's "SAME"
    padding -> ``[b, H', W', cout]`` in x's dtype."""
    kh, kw = w.shape[:2]
    (top, bottom), (left, right) = (_same_pads(x.shape[1], kh, stride),
                                    _same_pads(x.shape[2], kw, stride))
    nchw = x.permute(0, 3, 1, 2)          # channels_last memory, no copy
    weight = w.to(x.dtype).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    if (top, left) == (bottom, right):
        y = F.conv2d(nchw, weight, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(nchw, (left, right, top, bottom)), weight,
                     stride=stride)
    return y.permute(0, 2, 3, 1)


def space_to_depth(x, r: int = 2):
    """``[B, H, W, C]`` -> ``[B, H/r, W/r, r*r*C]``: pixel blocks folded
    into channels, channel ``(rh * r + rw) * C + c``."""
    b, h, w, c = x.shape
    if h % r or w % r:
        raise ValueError(
            f"space-to-depth stem needs H and W divisible by {r}; "
            f"got {h}x{w} — pad or resize the input (or use an even "
            f"image_size)")
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, r * r * c)


def forward(params: dict, images: torch.Tensor,
            cfg: VisionConfig) -> torch.Tensor:
    """``[batch, H, W, C]`` images -> ``[batch, num_classes]`` f32
    logits."""
    dtype = getattr(torch, cfg.dtype)
    x = conv2d(space_to_depth(images.to(dtype)), params["stem"])
    for i, stage in enumerate(params["stages"]):
        # The stem already halved the resolution; stage 0 keeps it.
        x = conv2d(F.relu(x), stage["down"], stride=1 if i == 0 else 2)
        for block in stage["blocks"]:
            h = conv2d(F.relu(_rmsnorm(x, block["norm1"])), block["conv1"])
            h = conv2d(F.relu(_rmsnorm(h, block["norm2"])), block["conv2"])
            x = x + h
    x = _rmsnorm(x.mean(dim=(1, 2)), params["head_norm"])
    return (x @ params["head"].to(x.dtype)).float()


def forward_flops(cfg: VisionConfig) -> int:
    """Analytic FLOPs of one image's forward: 2 per multiply-add of every
    conv at its output resolution and of the head (norms, activations and
    the pool aside). A train step does about 3x the forward's."""
    res = cfg.image_size // 2          # the stem runs at half resolution
    flops = 2 * res * res * 9 * 4 * cfg.channels * cfg.widths[0]
    cin = cfg.widths[0]
    for i, width in enumerate(cfg.widths):
        res = res if i == 0 else -(-res // 2)
        flops += 2 * res * res * 9 * cin * width                 # down
        flops += cfg.blocks_per_stage * 2 * (2 * res * res * 9 * width
                                             * width)
        cin = width
    return flops + 2 * cfg.widths[-1] * cfg.num_classes


def loss_fn(params: dict, batch: tuple, cfg: VisionConfig,
            shards: int = 1) -> torch.Tensor:
    """``(images, labels)`` -> mean cross entropy; over ``shards`` data
    shards, this shard's share of the global mean."""
    images, labels = batch
    loss = F.cross_entropy(forward(params, images, cfg), labels)
    return loss if shards == 1 else loss / shards


def shard_batch(images, labels, mesh, data_axis: str = "data"):
    """This process's block of the global batch, split over ``data_axis``
    (the params replicate). A mesh without ``data_axis``, or a batch that
    does not divide, raises ``ValueError``, as the JAX package's placement
    does."""
    Axis.of(mesh, data_axis)
    return (shard(images, (data_axis,), mesh),
            shard(labels, (data_axis,), mesh))


def make_train_step(cfg: VisionConfig, mesh=None, lr: float = 1e-3,
                    data_axis: str = "data"):
    """SGD train step ``(params, (images, labels)) -> (params, loss)``:
    gradients in f32 on the f32 master weights and ``p - lr * g`` on every
    leaf in place (the counterpart of the JAX step's donated params).
    With a ``mesh``, ``batch`` is this process's data shard
    (``shard_batch``); the gradients and the loss shares are summed over
    the data axis, so the loss returned is the global mean. The mesh spans
    the whole world and has ``data_axis`` (else ``ValueError``)."""
    world_size(mesh)
    data = Axis.of(mesh, data_axis)

    def step(params, batch):
        loss, grads = value_and_grad(loss_fn, params, batch, cfg, data.size)
        if data.size > 1:
            for t in grads + [loss]:
                dist.all_reduce(t, group=data.group)
        with torch.no_grad():
            torch._foreach_add_(leaves(params), grads, alpha=-lr)
        return params, loss

    return step
