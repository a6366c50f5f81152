"""kubeflow_tpu_torch: the port of kubeflow_tpu's accelerator path to
PyTorch and CUDA on an NVIDIA H100.

The JAX package ``kubeflow_tpu`` stays the reference; this package
imports nothing of it (and no JAX). Ported so far, slice by slice:

1. serving: the serving engine (``serving.engine``) over the burn-in
   transformer's forward (``models.burnin``), whose attention runs
   through a hand-written Hopper flash-attention forward;
2. training: the burn-in loss and SGD train step (``models.burnin``) and
   the training harness (``models.trainer``: AdamW or SGD, warmup-cosine,
   global-norm clip, accumulation, ``fit``), whose attention gradient runs
   through two hand-written Hopper backward kernels, dQ and dK/dV, behind
   a ``torch.autograd.Function`` over the forward kernel;
3. long-context training (``models.longctx``) over ring and Ulysses
   sequence parallelism (``parallel.ring``, ``parallel.ulysses``), with a
   hand-written ring-hop partial-attention kernel;
4. mixture-of-experts training (``models.moe``) over expert parallelism
   (``parallel.moe``, two all-to-alls), on a ``DeviceMesh`` from
   ``parallel.mesh``;
5. the pipelined and vision families (``models.pipelined`` over
   ``parallel.pipeline``, ``models.vision``);
6. the sharded main path: the burn-in step data x tensor parallel, the
   trainer's sharded state and vision's data-parallel batch, on the
   tensor-parallel pieces of ``parallel.mesh``.

The kernels live in ``ops.flash_attention``, their CUDA sources in
``ops/csrc/``; ``entry.entry`` and ``entry.dryrun_multichip`` mirror the
JAX package's ``__graft_entry__`` entry points.
"""

from kubeflow_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
