"""kubeflow_tpu_torch: the port of kubeflow_tpu's accelerator path to
PyTorch and CUDA on an NVIDIA H100.

The JAX package ``kubeflow_tpu`` stays the reference; this package
imports nothing of it (and no JAX). Ported so far: the serving engine
(``serving.engine``) over the burn-in transformer (``models.burnin``),
whose attention runs through a hand-written Hopper flash-attention
forward (``ops.flash_attention``, CUDA source in ``ops/csrc/``).
"""

from kubeflow_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
