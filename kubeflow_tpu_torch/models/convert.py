"""JAX parameter tree → the port's parameters.

``jax.random`` cannot be reproduced in torch, so a test that holds the
port against the JAX package draws the JAX parameters, fetches them as
numpy arrays (``jax.device_get``) and converts them here. Both sides then
compute with the same numbers. The layouts agree, so each leaf is a
copy; names and shapes are checked against the config leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.models import burnin, moe, pipelined, vision
from kubeflow_tpu_torch.models.longctx import LongContextConfig

# Each config's parameter tree (the long-context model's is the burn-in's).
_CONFIGS = {burnin.BurninConfig: burnin.param_shapes,
            LongContextConfig: burnin.param_shapes,
            moe.MoEConfig: moe.param_shapes,
            pipelined.PipelinedConfig: pipelined.param_shapes,
            vision.VisionConfig: vision.param_shapes}


def params_from_jax(tree, cfg, device=None) -> dict:
    """The JAX pytree (numpy leaves) of a ``BurninConfig``,
    ``LongContextConfig``, ``MoEConfig``, ``PipelinedConfig`` or
    ``VisionConfig`` model as f32 tensors on ``device`` (an MoE or a
    pipelined tree unsharded: their ``shard_params`` cut it; a vision
    tree's conv weights HWIO, as the JAX package keeps them)."""
    param_shapes = _CONFIGS.get(type(cfg))
    if param_shapes is None:
        raise TypeError(f"no parameter tree for {type(cfg).__name__}; "
                        f"want one of {[c.__name__ for c in _CONFIGS]}")
    dev = resolve_device(device)

    def convert(ref, shape, path):
        if isinstance(shape, dict):
            if not isinstance(ref, dict) or set(ref) != set(shape):
                raise ValueError(f"{path}: keys {sorted(ref)} != "
                                 f"{sorted(shape)}")
            return {key: convert(ref[key], shape[key], f"{path}.{key}")
                    for key in shape}
        if isinstance(shape, list):
            if len(ref) != len(shape):
                raise ValueError(f"{path}: {len(ref)} entries, config has "
                                 f"{len(shape)}")
            return [convert(r, s, f"{path}[{i}]")
                    for i, (r, s) in enumerate(zip(ref, shape))]
        arr = np.asarray(ref)
        if arr.shape != shape:
            raise ValueError(f"{path}: shape {arr.shape}, config needs "
                             f"{shape}")
        return torch.from_numpy(arr.astype(np.float32)).to(dev)

    return convert(tree, param_shapes(cfg), "params")
