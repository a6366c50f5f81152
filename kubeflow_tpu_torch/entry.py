"""Entry point of the port, as ``__graft_entry__.entry`` is the JAX
package's: the burn-in forward at a small config with its inputs."""

from __future__ import annotations

from functools import partial

import torch

from kubeflow_tpu_torch.models.burnin import BurninConfig, forward, init_params


def entry(device=None):
    """``(fn, (params, tokens))``: ``fn(params, tokens)`` is the forward
    of ``BurninConfig(seq_len=64, d_model=128, n_layers=2)`` on seeded
    params and a ``[4, 64]`` batch of zeros, giving f32 logits
    ``[4, 64, 256]``. Runs on the current CUDA card unless ``device``
    says otherwise; raises with no card and no ``device``."""
    cfg = BurninConfig(seq_len=64, d_model=128, n_layers=2)
    params = init_params(cfg, seed=0, device=device)
    tokens = torch.zeros((4, cfg.seq_len), dtype=torch.int64,
                         device=params["embed"].device)
    return partial(forward, cfg=cfg), (params, tokens)
