#!/usr/bin/env python3
"""Drive the PyTorch port's serving, sharded serving, training (with its
step telemetry), sharded training, long-context training, MoE, vision and
pipelined training paths on one NVIDIA GPU and hold its kernels against
their plain versions.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``; it imports ``kubeflow_tpu_torch``
from the checkout and nothing of JAX or ``kubeflow_tpu``. Each phase
prints one JSON line; any failure raises and exits non-zero before the
last line. With no CUDA device it exits 1 and prints no result.

1. device  — the card's name and power limit (``nvidia-smi``); TF32 off
   for every float32 product (``allow_tf32 = False``), so float32
   comparisons are float32.
2. build   — every ``.cu`` source of the package, one ``nvcc`` each, in
   parallel; seconds, ptxas's register / spill / performance lines, and
   each library's wgmma, TMA-load and mma.sync instruction counts
   (``cuobjdump``), the wide library's also kernel by kernel.
3. kernels — the forward kernel against its plain PyTorch version at the
   shapes the serving and training paths give it (and the edge shapes the
   port promises, across the kernel's 128-row tiles), tolerances
   enforced; at the decode shape and at the ulysses_flash path's 8192
   tokens the kernel, the plain version and one PyTorch library call
   timed with CUDA events (median of 30 batches of 10 back-to-back calls,
   after 5 warm-up calls), the kernel's device time read by
   ``torch.profiler`` too, its bound share and TFLOP/s, and the host cost
   of the three TMA tensor maps a launch encodes.
4. bwd_kernels — the dQ and the dK/dV kernels against their plain
   versions at the training shape, the pipelined schedule's microbatch
   and the wide_heads step's [8, 1024, 8, 256] (both also forward
   cases), a multi-tile, a ragged, an f32 case,
   shapes across the kernels' tiles, ring-hop offsets (two straddling a
   128-row tile) and the long-context step's one-card hop; at the
   training shape a bitwise repeat, and q, k, v as column slices of one
   qkv tensor (as the model passes them), bitwise equal to the contiguous
   case; at the training shape and the one-card hop each kernel timed as
   above beside its plain version, its bound, and one SDPA backward (dq,
   dk, dv together) as the library yardstick, by CUDA events and by the
   profiler's device time, with the SDPA backend the profiler saw.
5. model   — the full-width burn-in serving config through ``forward``
   with ``attention="flash"`` and ``"xla"`` (plain dense) on the same
   seeded weights and tokens; logits within a stated bf16 tolerance; the
   flash forward launches the kernel once per layer.
6. serving (run after train, inside the world of one below) — a main
   path: ``ServingEngine`` (``use_mesh=True``, its default) cold start,
   model registration and swaps, a seeded open-loop trace, ``park`` and
   ``warm_restore``, a replay. Launch counts are zeroed just before and
   read just after, and must equal one per layer for every forward the
   engine ran. Then the decode step is timed and profiled, and the
   restored engine's argmax is checked against the dense forward.
7. train_grads — at full width (``BENCH_MODEL``, batch 8, seq 1025) the
   loss and every gradient leaf with ``attention="flash"`` against
   ``"xla"`` on the same seeded params and tokens, within stated bounds.
8. train   — the training main path: ``make_train_step`` at full width,
   2 warm-up steps, 100 steps in 4 chunks of 25 each ending in a host
   sync (as bench.py times its step), 3 profiled steps; step ms, TFLOP/s
   and MFU against the dense bf16 peak, the loss falling; launches
   counted from zero: one forward, one dQ and one dK/dV per layer and
   step.
9. trainer — ``trainer.fit`` with ``TrainerConfig()`` (AdamW,
   warmup-cosine, clip 1.0) and 2 accumulation steps, 10 steps at full
   width, with the telemetry hooks as the SDK wires them (a
   ``StepProfiler`` at ``sync_every=1`` and a ``TelemetryPublisher``);
   each kernel launches once per layer and microbatch. Step times from
   the per-step sync, the first step (which allocates the AdamW moments)
   apart from the steady ones; the profiler's summary held to them (p50
   within 5% of the steady median, MFU, memory high-water, the published
   annotation); then 3 more steps profiled.
10. partial_kernels — the ring hop's partial kernel against its plain
   version: the one-card hop of ``LONGCTX_MODEL`` ([1, 8192, 16, 128]
   bf16 at offsets (0, 0)), a 4-shard ring's hops below, on and above the
   diagonal (above: exactly acc = 0, l = 0, m = -1e30), an f32 head-dim-64
   case, the diagonal half-way into a 128-row tile, the decode shape, and
   q, k, v as column slices of one qkv tensor (bitwise equal to the
   contiguous case); at the one-card hop and the decode shape timed as the
   kernels phase times the forward, beside its bound and SDPA's causal
   forward.
11. ring_hops — a 4-shard ring simulated in one process at full width:
   the 16 block pairs of [1, 8192, 16, 128] bf16 through the partial
   kernel and the fold, and the backward through the dQ and dK/dV kernels
   with the final lse, held against the one-shot forward and backward
   kernels over the 8192 tokens.
12. longctx_grads — ``LONGCTX_MODEL`` at batch 1, one shard: the loss and
   every gradient leaf of ``"ring_flash"`` against the dense ``"ring"``
   on the same seeded params and tokens, within stated bounds.
13. longctx — the long-context main path, as bench.py's
   ``_longctx_bench``: ``longctx.make_train_step`` at ``LONGCTX_MODEL``,
   batch 1, ``"ring_flash"``, 2 warm-up steps, 40 steps in 4 chunks of 10
   each ending in a host sync, 3 profiled steps; launches counted from
   zero: one partial, one dQ and one dK/dV launch per layer and step, no
   forward launch. Then one step each of ``"ulysses_flash"`` (the forward,
   dQ and dK/dV kernels) and the dense ``"ring"``.
14. head_dims (run after bwd_kernels) — the four kernels at head dims 16
   and 32, at 20 and 36 (no multiple of 8: zero-padded onto the 128-column
   kernels), at 136, 192, 200 and 256 (the wide library's wgmma kernels
   in bf16) and at 264, 832 and 1024 (its simple kernels over 256-column
   output slices), bf16 and f32, causal and full, against their plain
   versions at the tolerances above, four cases also through qkv column
   slices (bitwise equal), and b*h = 66560 ([1040, 64, 64, 16]) in both
   dtypes; at d = 1024 the four column slices' outputs bitwise equal where the inputs' are
   (each slice computes the softmax statistics, slice 0 writes them); a
   bitwise repeat of the wgmma dQ and dK/dV at [8, 1024, 16, 256]; at
   training shapes of d = 32 [8, 1024, 64, 32], d = 20 [8, 1024, 64, 20]
   (with the padding copies timed apart) and d = 256 ([8, 1024, 16, 256],
   and the wide_heads step's [8, 1024, 8, 256]) the forward, dQ and dK/dV
   (at d = 256 also the partial, and the simple dQ through the plan
   (0, 1) beside the wgmma one) timed beside their bounds, plain versions
   and SDPA.
15. moe_grads — ``MOE_MODEL`` (bench.py's, uncut) at batch 8: the loss
   of ``attention="flash"`` against the dense path, the share of tokens
   whose top-1 expert differs between the two, and the gradients against
   a dense arm routed as the flash arm was, within stated bounds.
16. moe_default — ``MoEConfig()`` (head_dim 32) at ``attention="flash"``:
   the loss and gradients against the dense path on the same routing,
   then one train step.
17. moe — the MoE main path, as bench.py's ``_family_bench`` runs it on
   one chip: ``moe.make_train_step`` at ``MOE_MODEL``, batch 8,
   ``mesh=None``, 2 warm-up steps, 40 steps in 4 chunks of 10 each ending
   in a host sync, 3 profiled steps with the router, seat table,
   dispatch, expert GEMMs and combine booked apart; launches counted from
   zero: one forward, one dQ and one dK/dV launch per layer and step.
18. vision — the vision main path, as bench.py's ``_family_bench`` runs
   it: ``vision.make_train_step`` at ``VisionConfig()``, batch 256, bf16,
   timed as moe; images/s, TFLOP/s and MFU from the port's analytic conv
   count (``vision.forward_flops``); the bf16 logits against an f32
   forward's on the same weights, and two f32 forwards with a fault
   (conv kernels transposed, symmetric stride-2 padding) as controls that
   must miss the bound; no attention kernel launches.
19. pipelined_grads — ``PP_MODEL`` (bench.py's, uncut) at batch 8, one
   card: the loss and every gradient leaf with ``attention="flash"``
   against the dense path, then the ``force_schedule`` loss and every
   gradient leaf against the fused path's, beside a control (the last
   microbatch's tokens swapped for the first's) that must miss the bound.
20. pipelined — the pipelined main path (fused: the microbatches as one
   batch): ``pipelined.make_train_step`` at ``PP_MODEL``, batch 8,
   ``mesh=None``, timed as moe; launches counted from zero: one forward,
   one dQ and one dK/dV launch per layer and step.
21. pipelined_schedule — the same through the GPipe ticks
   (``force_schedule=True``): one launch of each kernel per layer,
   microbatch and step.
22. wide_heads — the training step at ``BENCH_MODEL``'s widths with 8
   heads (head_dim 256: the wide library's kernels, the same GEMMs as
   ``train``), batch 8, seq 1025: flash-vs-dense loss and every gradient
   leaf at the ``train_grads`` bounds, then 2 warm-up steps, 10 timed (2
   chunks of 5) and 3 profiled; launches counted from zero: one forward,
   one dQ and one dK/dV per layer and step.
23. serving_sharded (the end of serving) — the serving engine ran with
   ``use_mesh=True`` in a world of one over NCCL: it must hold no mesh and
   no control group, and after its warm swap, park and warm restore its
   decode and prefill scores of seeded tokens must be bitwise equal to
   the ``use_mesh=False`` engine's scores on the same weights.
24. sharded (run after train) — the sharded training main path at one
   shard: a process group of this process alone over NCCL, a 1 x 1
   ("data", "model") mesh, ``burnin.make_train_step(cfg, mesh)`` at
   ``BENCH_MODEL``, batch 8: two steps (launches counted from zero)
   bitwise equal (loss and every leaf) to two of the unsharded step from
   the same params and tokens. Not timed: at one shard its time could
   only echo ``train``'s.
25. dryrun (inside the same group) — ``entry.dryrun_multichip(1)`` on
   the card (the burn-in block); ``dryrun_multichip(4)`` over NCCL where
   the machine has 4 cards, else a line saying why it did not run.
26. sharded_grads — the sharded step at 2 x 2 ("data", "model"): 4
   processes share the card over gloo on CUDA tensors (NCCL takes one
   process a card), ``BENCH_MODEL``'s widths at 2 layers (a depth cut),
   global batch 8, flash, so each runs the kernels at [4, 1024, 8, 128];
   one step at lr 1, then rank 0's loss and every leaf's update
   (``unshard``-ed to the global layout) against the one-process step on
   the card at the ``train_grads`` bounds. Its seconds go through the
   host's gloo, not NVLink, and are no rate.
27. serving_sharded_world (the same 4 processes, after the step) —
   sharded serving in a world of 4: 4 processes share the card over
   gloo, each a ``ServingEngine(use_mesh=True)`` on
   the default 1 x 4 mesh (4 of the 16 heads a process, the forward
   kernel at [8, 1024, 4, 128]), the serving widths at 2 layers (a depth
   cut); rank 0 schedules a lane trace (every arrival at 0, prompts, a
   model swap) and the others follow its control words. Rank 0's
   last-position logits of every forward the engine ran, and of one
   score of seeded tokens, within rel L2 1e-2 of a one-process engine's
   on the card, the argmax equal where the margin is clear; every rank's
   report equal, and equal to the one-process engine's (structural).

Then the ``{"kernels": [...]}`` line (each kernel's times at the main
path's shape, with ``bound_share`` = bound_ms / ms and ``tflops``, ``at``
every timed shape, the d = 32 and d = 256 ones included,
``launches_by_path`` with ``moe``, ``vision``, ``pipelined``,
``pipelined_schedule``, ``wide_heads``, ``sharded``,
and ``sharded_grads`` and ``serving_sharded_world`` (each summed over
its 4 processes), and ``device_kernels``: the CUDA kernels behind each
entry, by head dim and dtype), the script's wall seconds, the card line,
and the result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from dataclasses import replace
from functools import partial

from kubeflow_tpu_torch.ops.compare import sass_counts, time_ms

# H100 SXM published dense peaks (NVIDIA data sheet): the bound a kernel
# is held against, with the card's power limit printed beside it.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_SEC = 3.35e12

# The serving config at full width: BENCH_MODEL's widths (bench.py) at
# seq_len 1024 (the decode program runs forward on [max_batch, seq_len],
# and 1025 breaks the flash contract); depth uncut.
MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=8, d_ff=16384,
             seq_len=1024, attention="flash", dtype="bfloat16")
MAX_BATCH = 8
PREFILL_CHUNK = 32
# Sharded serving in a world of 4 processes on the one card (the default
# 1 x 4 mesh): the serving widths at 2 layers, a depth cut that keeps the
# 4-process world short.
SERVING_SHARDED_MODEL = dict(MODEL, n_layers=2)
# Rank 0's last-position logits of the world-4 engine against the
# one-process engine's, as rel L2 over each forward's: bf16 shares summed over
# the model axis round elsewhere than one process's products (the tiny
# bf16 rehearsal on the CPU gave 0.0073).
TOL_SERVING_LOGITS_REL_L2 = 1e-2

# Kernel shapes: the decode step's, the prefill chunk's, several tiles
# past the JAX block (s > 1024), and the f32 / head-dim-64 / full path.
KERNEL_CASES = [
    ("decode", (MAX_BATCH, 1024, 16, 128), "bfloat16", True),
    ("prefill_chunk", (1, PREFILL_CHUNK, 16, 128), "bfloat16", True),
    ("multi_tile", (2, 2048, 4, 128), "bfloat16", True),
    ("f32_full_d64", (2, 256, 4, 64), "float32", False),
    # Across the kernel's 128-row Q and 128-key K/V tiles.
    ("straddle_causal", (2, 192, 4, 128), "bfloat16", True),
    ("straddle_full_d64", (1, 320, 2, 64), "bfloat16", False),
    # The ulysses_flash path's shape: LONGCTX_MODEL's 8192 tokens, timed too.
    ("long_context", (1, 8192, 16, 128), "bfloat16", True),
    # The pipelined_schedule path's shape: a microbatch of 2 of PP_MODEL.
    ("pp_micro", (2, 1024, 16, 128), "bfloat16", True),
    # The wide_heads path's: WIDE_MODEL's 8 heads of 256 at batch 8 (the
    # wgmma forward over 64 (batch, head) pairs, in more than one launch
    # group).
    ("wide_heads", (8, 1024, 8, 256), "bfloat16", True),
    # serving_sharded_world's, per process: 4 of the 16 heads at model 4,
    # the decode step's and the prefill chunk's.
    ("sharded_decode", (MAX_BATCH, 1024, 4, 128), "bfloat16", True),
    ("sharded_prefill_chunk", (1, PREFILL_CHUNK, 4, 128), "bfloat16", True),
]
# The kernels timed: the forward at both sequence lengths the main paths
# give it.
TIMED_KERNEL_CASES = ("decode", "long_context")
# O: bf16 outputs may differ by one bf16 ulp at |O| < 2 (2**-7) from P
# rounded against a running rather than the final max: 2e-2. f32: only
# the summation order differs: 1e-4. lse is f32 from f32 scores in both.
TOL_O = {"bfloat16": 2e-2, "float32": 1e-4}
TOL_LSE = 1e-3
# The training config: bench.py's BENCH_MODEL as it is (seq_len 1025:
# the loss trains on tokens[:, :-1], so attention runs at 1024), batch 8.
TRAIN_MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=8,
                   d_ff=16384, seq_len=1025, attention="flash",
                   dtype="bfloat16")
TRAIN_BATCH = 8
TRAIN_WARMUP, TRAIN_CHUNKS, TRAIN_CHUNK_STEPS, TRAIN_PROFILED = 2, 4, 25, 3
# The wide-head step: BENCH_MODEL's widths with 8 heads (head_dim 256, as
# Gemma's), batch 8: the same GEMMs as the train step, attention on the
# wide library. Its gradients are held at the train_grads bounds.
WIDE_MODEL = dict(TRAIN_MODEL, n_heads=8)
WIDE_WARMUP, WIDE_CHUNKS, WIDE_CHUNK_STEPS, WIDE_PROFILED = 2, 2, 5, 3
FIT_STEPS, FIT_ACCUM = 10, 2
# The step profiler's p50 against the phase's own steady median of the
# per-step marks (the same steps, both waiting on each loss): the two
# clocks differ by the publish and the host's work between marks.
TOL_TELEMETRY_P50_PCT = 5.0
# The sharded step's gradients at 2 x 2 (data, model): TRAIN_MODEL's
# widths at 2 layers (a depth cut), so each of the 4 processes that share
# the card runs the kernels at [4, 1024, 8, 128].
SHARDED_MODEL = dict(TRAIN_MODEL, n_layers=2)
SHARDED_MESH = (2, 2)
# The sharded step at one shard: two steps held bitwise to the unsharded
# step's.
SHARDED_STEPS = 2

# Backward cases (name, [b, s, h, d], dtype, causal, q_offset, k_offset,
# delta given): the train step's attention, several tiles past the JAX
# block, a ragged full case at head dim 64, the f32 path, three ring hops
# (the K block below the diagonal, on it, above it: all-zero gradients),
# which are handed the final delta as a ring's backward is.
BWD_CASES = [
    ("train", (TRAIN_BATCH, 1024, 16, 128), "bfloat16", True, 0, 0, False),
    ("multi_tile", (2, 2048, 4, 128), "bfloat16", True, 0, 0, False),
    ("ragged_full_d64", (2, 100, 3, 64), "bfloat16", False, 0, 0, False),
    ("f32_causal", (1, 77, 2, 128), "float32", True, 0, 0, False),
    ("hop_below", (2, 256, 4, 128), "bfloat16", True, 256, 0, True),
    ("hop_diagonal", (2, 256, 4, 128), "bfloat16", True, 256, 256, True),
    ("hop_above", (2, 256, 4, 128), "bfloat16", True, 0, 256, True),
    # Across the kernels' tiles (128 owned rows, 64 streamed): 1.5 Q tiles
    # and 3 key tiles; 2.5 tiles, full; lse and delta rows of 77 floats,
    # whose pitch is no multiple of 16 bytes.
    ("straddle_causal", (2, 192, 4, 128), "bfloat16", True, 0, 0, False),
    ("straddle_full_d64", (1, 320, 2, 64), "bfloat16", False, 0, 0, False),
    ("ragged_causal", (1, 77, 2, 128), "bfloat16", True, 0, 0, False),
    # Hops whose diagonal falls half-way into a 128-row tile: every row
    # sees a key at (192, 64); rows 0-127 see none at (64, 192) (dq 0).
    ("hop_192_64", (2, 256, 4, 128), "bfloat16", True, 192, 64, True),
    ("hop_64_192", (2, 256, 4, 128), "bfloat16", True, 64, 192, True),
    # The long-context step's one hop on one card: LONGCTX_MODEL's 8192
    # tokens at offsets (0, 0), delta given, as _RingFlash.backward calls
    # the kernels.
    ("one_card_hop", (1, 8192, 16, 128), "bfloat16", True, 0, 0, True),
    # The pipelined_schedule path's: a microbatch of 2 of PP_MODEL.
    ("pp_micro", (2, 1024, 16, 128), "bfloat16", True, 0, 0, False),
    # The wide_heads path's: the wgmma dQ and dK/dV at WIDE_MODEL's 8
    # heads of 256, in more than one launch group.
    ("wide_heads", (TRAIN_BATCH, 1024, 8, 256), "bfloat16", True, 0, 0,
     False),
]
# The backward timed: at the train step's shape and the one-card hop.
TIMED_BWD_CASES = ("train", "one_card_hop")
# The rows of hop_64_192 that see no key of the block.
UNSEEN_ROWS = {"hop_64_192": 128}
# dQ, dK, dV against the plain version, as a fraction of the plain
# version's largest magnitude. bf16: both round P and dS to bf16 at the
# same points, an f32 value on a rounding boundary may round the other
# way, and the outputs are stored in bf16 (one ulp is 2**-8 of a value):
# 1e-2. f32: summation order only: 1e-4. delta is f32 in both: 1e-3.
TOL_GRAD = {"bfloat16": 1e-2, "float32": 1e-4}
TOL_DELTA = 1e-3
# Flash vs dense gradients at full width (bounds fixed in PERF.md before
# the first run): the dense path rounds logits and probabilities to bf16,
# the flash path keeps scores in f32; measured with the plain versions on
# an 8-layer d_model-512 config: loss 1.9e-4, rel L2 <= 1.4e-2, cosine
# >= 0.99986 per leaf.
TOL_TRAIN_LOSS = 0.01
TOL_GRAD_REL_L2 = 0.10
MIN_GRAD_COSINE = 0.995
# Flash vs dense logits at full width: the dense path rounds scaled logits
# and probabilities to bf16, the flash path keeps scores in f32 and rounds
# P against a running max; the gap compounds over 8 residual layers
# (measured 0.023 max, 0.0033 mean on an 8-layer d_model-512 config).
TOL_LOGITS_MAX = 0.125
TOL_LOGITS_MEAN = 0.01

# The long-context config: bench.py's LONGCTX_MODEL uncut (8192 tokens,
# ring_flash, bf16), at batch 1 on one card, mesh=None (one shard, as
# _longctx_bench's 1x1 mesh).
LONGCTX_MODEL = dict(vocab=8192, d_model=2048, n_layers=2, d_ff=8192,
                     n_heads=16, seq_len=8192, attention="ring_flash",
                     dtype="bfloat16")
LONGCTX_BATCH = 1
LONGCTX_WARMUP, LONGCTX_CHUNKS, LONGCTX_CHUNK_STEPS = 2, 4, 10
LONGCTX_PROFILED = 3
# Partial-kernel cases (name, [b, s, h, d], dtype, q_offset, k_offset):
# the one-card hop of LONGCTX_MODEL, the hops of a 4-shard ring of it
# below, on and above the diagonal, and the f32 path at head dim 64.
PARTIAL_CASES = [
    ("one_card_hop", (1, 8192, 16, 128), "bfloat16", 0, 0),
    ("hop_below", (1, 2048, 16, 128), "bfloat16", 2048, 0),
    ("hop_diagonal", (1, 2048, 16, 128), "bfloat16", 2048, 2048),
    ("hop_above", (1, 2048, 16, 128), "bfloat16", 0, 2048),
    ("f32_d64", (2, 256, 4, 64), "float32", 256, 256),
    # The diagonal half-way into the kernel's 128-row tile: every row sees
    # a key at (192, 64); rows 0-127 see none at (64, 192).
    ("straddle_192_64", (2, 256, 4, 128), "bfloat16", 192, 64),
    ("straddle_64_192", (2, 256, 4, 128), "bfloat16", 64, 192),
    # The serving decode shape at offsets (0, 0), timed: the shared loop at
    # the forward's shorter length.
    ("decode_shape", (MAX_BATCH, 1024, 16, 128), "bfloat16", 0, 0),
]
TIMED_PARTIAL_CASES = ("one_card_hop", "decode_shape")
# The partial kernel against its plain version. acc, as a fraction of the
# plain acc's largest magnitude: bf16 P is rounded against the running max
# in the kernel and the final max in the plain version, so an element may
# land a bf16 ulp (2**-8) apart: 1e-2; f32: summation order only: 1e-4.
# m and l are f32 from f32 scores in both: m within 1e-4 (absolute, |m|
# is a few units), l within 1e-4 of its largest value.
TOL_PARTIAL_ACC = {"bfloat16": 1e-2, "float32": 1e-4}
TOL_PARTIAL_M = 1e-4
TOL_PARTIAL_L = 1e-4
RING_SHARDS = 4
# The simulated ring against the one-shot kernels: o in bf16 from a fold
# in another order, 2e-2 absolute as TOL_O; lse f32, TOL_LSE; dq, dk, dv
# sum four hops' partial gradients, each rounded to bf16 (2**-8 of a
# value) before the f32 sum, where the one-shot kernels round once: 2e-2
# of the largest magnitude.
TOL_RING_GRAD = 2e-2

# Head dims beside the main paths' 128: narrow heads, as the JAX
# package's config defaults give them (d_model 128 over 4 heads: 32) and
# bench.py's MC_LONGCTX_MODEL (16); head dims no multiple of 8 (20, 36),
# which the wrapper zero-pads onto the 128-column kernels; and heads above
# 128, which run the wide library: 136 and 192 (bf16: the wgmma kernels at
# 192 columns), 200 and Gemma's 256 (at 256), 264 (two 256-column output
# slices of the simple kernels), 832 and 1024 (four). (name, [b, s, h,
# d], dtype, causal), each through the forward, dQ and dK/dV, and (causal)
# the partial at a hop below and on the diagonal, at the tolerances above
# (TOL_O, TOL_LSE, TOL_GRAD, TOL_PARTIAL_*). Causal cases span 2.5 of the
# 128-row Q tiles (20 of the simple kernels' 16-row tiles); full cases
# are ragged.
HEAD_DIMS = (16, 32, 20, 36, 136, 192, 200, 256, 264, 832, 1024)
HEAD_DIM_CASES = [
    (f"d{d}_{dtype}_{'causal' if causal else 'full'}",
     (2, 320, 4, d) if causal else (1, 200, 3, d), dtype, causal)
    for d in HEAD_DIMS for dtype in ("bfloat16", "float32")
    for causal in (True, False)]
# The cases whose q, k, v are also read as column slices of one qkv
# tensor, as the models hand them over (heads d elements apart).
HEAD_DIM_STRIDED = ("d32_bfloat16_causal", "d20_bfloat16_causal",
                    "d136_bfloat16_causal", "d256_bfloat16_causal")
# Four 256-column output slices whose inputs are equal: their outputs must
# be bitwise equal (each slice computes the softmax statistics itself).
SLICE_STATS = ("slices_d1024", (1, 320, 4, 1024))
# The wgmma dQ's and dK/dV's bitwise repeat at the wide training shape.
WIDE_REPEAT = (8, 1024, 16, 256)
# More (batch, head) pairs than a grid's y dimension holds: b*h = 66560,
# each dtype through the four kernels.
MANY_HEADS = ("bh66560", (1040, 64, 64, 16))
# Timed: a d = 32 training shape (b*h = 512 heads of 1024 tokens), a
# d = 20 one (zero-padded to 24: the copies timed apart) and two d = 256
# ones (the wide library, also the partial and the simple dQ):
# [8, 1024, 16, 256], and the wide_heads step's [8, 1024, 8, 256].
HEAD_DIM_TIMED = [
    ("d32_train", (8, 1024, 64, 32), "bfloat16", True, 0, 0, False),
    ("d20_train", (8, 1024, 64, 20), "bfloat16", True, 0, 0, False),
    ("d256_train", (8, 1024, 16, 256), "bfloat16", True, 0, 0, False),
    # The shape the wide_heads step gives them: 8 heads of 256.
    ("wide_heads", (8, 1024, 8, 256), "bfloat16", True, 0, 0, False),
]
# The simple dQ (the wide library's plan (0, 1)), timed beside the wgmma
# dQ at the d = 256 shapes: tens of ms a call, so fewer calls.
SIMPLE_DQ_RUNS = dict(warmup=2, runs=10, batch=2)

# The MoE config: bench.py's MOE_MODEL uncut (bench.py:616-620; top-2 of 8
# experts at capacity factor 1.0, flash attention at head_dim 128), batch
# 8 on one card (mesh=None: _family_bench's 1x1 mesh), bf16.
MOE_MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=4,
                 d_ff=8192, seq_len=1025, n_experts=8, router_top_k=2,
                 attention="flash", capacity_factor=1.0, dtype="bfloat16")
MOE_BATCH = 8
MOE_WARMUP, MOE_CHUNKS, MOE_CHUNK_STEPS, MOE_PROFILED = 2, 4, 10, 3
# Flash vs dense MoE gradients. Routing is discontinuous: a token whose top
# choices are within a bf16 ulp flips expert when attention rounds
# elsewhere, and its gradient changes wholesale; measured with the plain
# versions on the CPU (bf16, d_model 512, 8 experts, top-2, cf 1.0, 4
# layers): 0.4-1% of top-1 choices flip a layer, and the free arms'
# gradient cosines fall to 0.86 (non-expert) and 0.94 (expert leaves)
# with the loss 5e-4 apart. So the loss is held on the free arms, and the
# gradients on a dense arm that takes the flash arm's routing (measured
# there: cosine >= 0.99985 on every leaf): non-expert leaves at
# MIN_GRAD_COSINE, expert leaves at MIN_EXPERT_GRAD_COSINE (fixed before
# the first chip run), every leaf at TOL_GRAD_REL_L2.
MIN_EXPERT_GRAD_COSINE = 0.995
# MoEConfig() as the JAX package defines it (head_dim 32) at
# attention="flash": one train step, batch 8.
MOE_DEFAULT_BATCH = 8

# The pipelined config: bench.py's PP_MODEL uncut (bench.py:626-629; 4
# microbatches, flash attention at head_dim 128), batch 8 on one card
# (mesh=None: _family_bench's 1x1 mesh, one stage), bf16. The fused path
# runs the microbatches as one batch; force_schedule runs the GPipe ticks
# (4 at one stage), each on a microbatch of 2.
PP_MODEL = dict(vocab=8192, d_model=2048, n_heads=16, n_layers=4,
                d_ff=8192, seq_len=1025, n_micro=4, attention="flash",
                dtype="bfloat16")
PP_BATCH = 8
PP_WARMUP, PP_CHUNKS, PP_CHUNK_STEPS, PP_PROFILED = 2, 4, 10, 3
# The force_schedule gradients against the fused path's, on the same
# params and tokens: the same function, but each weight gradient is a sum
# of 4 microbatches' bf16 products instead of one. Per leaf, rel L2:
# measured 2.9e-3 at most with the plain versions on the CPU (bf16,
# d_model 256, 2 layers); a control, the fused gradients with the last
# microbatch's tokens swapped for the first's (what a schedule that fed
# the wrong microbatch gives), sits at 0.54 or more on every leaf. Bound
# 2e-2, and the phase checks that the control lies above it. The losses
# were bitwise equal on the card and the CPU (one bf16 GEMM row does not
# depend on how many rows run beside it): bound 1e-4 of 8192 tokens'
# mean nll, where a wrong microbatch moves it about 1e-2.
TOL_SCHEDULE_GRAD_REL_L2 = 2e-2
TOL_SCHEDULE_LOSS = 1e-4

# The vision config: VisionConfig() (bench.py's, widths 128/256/512, 2
# blocks a stage, 64x64 images, 1000 classes), bf16, at bench.py's
# VISION_BATCH 256 (bench.py:634).
VISION_BATCH = 256
VISION_WARMUP, VISION_CHUNKS, VISION_CHUNK_STEPS, VISION_PROFILED = \
    2, 4, 10, 3
# The bf16 forward's logits against an f32 forward's on the same weights
# and (bf16-rounded) images, as rel L2 over all logits: bf16 activations
# through 13 convs and 14 norms. Measured with the plain CPU ops at batch
# 16: 4.3e-3 and 4.5e-3 on two seeds. Two controls, f32 forwards with a
# fault, measured there at 0.10 or more: every conv's kernel transposed
# (kh and kw swapped, a layout fault) and XLA's "SAME" at stride 2 read
# as padding=1 on both sides (0 before and 1 after is right). Bound 2e-2,
# and the phase checks that both controls lie above it.
TOL_VISION_LOGITS_REL_L2 = 2e-2


# Device kernels by what they do, for the profiled steps' breakdown: the
# first category whose key is in a kernel's name takes it.
KERNEL_CATEGORIES = (
    ("attention kernels (this port)", ("fwd_bf16_kernel", "dq_bf16_kernel",
                                       "dkv_bf16_kernel",
                                       "partial_bf16_kernel",
                                       "wide_fwd_kernel", "wide_dq_kernel",
                                       "wide_dkv_kernel",
                                       "wide_fwd_bf16_kernel",
                                       "wide_partial_bf16_kernel",
                                       "wide_dq_bf16_kernel",
                                       "wide_dkv_bf16_kernel")),
    ("convolutions (cuDNN)", ("conv", "fprop", "dgrad", "wgrad", "cudnn")),
    ("GEMMs (cuBLAS)", ("nvjet", "gemm", "cutlass", "xmma")),
    ("casts and copies", ("copy",)),
    ("foreach passes (SGD, AdamW, clip norm, accumulation)",
     ("multi_tensor_apply",)),
    ("reductions (norms, softmax, loss, embedding grad)",
     ("reduce", "softmax", "nll_loss", "norm", "embedding", "index")),
)


# The script's own clock: each phase line says when it was printed.
STARTED = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = {**obj, "at_sec": time.perf_counter() - STARTED}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _device_rows(prof, calls: int) -> list:
    """(device ms per call, kernel name, launches per call) of every
    device kernel a ``torch.profiler`` run saw, largest first. A range
    named on the host (``torch.optim``'s ``Optimizer.step#AdamW.step``)
    also shows on the device's timeline, spanning kernels counted on
    their own: it is left out."""
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0))
        if getattr(ev, "is_user_annotation", False):
            continue
        if dev_us and ev.device_type.name == "CUDA":
            rows.append((dev_us / calls / 1e3, ev.key, ev.count // calls))
    rows.sort(reverse=True)
    return rows


def profiled(fn, torch, *, runs=20) -> tuple:
    """Device time per call of ``fn`` as ``torch.profiler`` reads it (the
    kernels' own time, without host dispatch; None if the profiler saw no
    device time) and the device kernels' names, largest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    rows = _device_rows(prof, runs)
    return (sum(r[0] for r in rows) if rows else None,
            [name for _, name, _ in rows])


def sdpa_backend(kernels) -> str:
    """Which of SDPA's backends ran, from its device kernels' names."""
    names = " ".join(kernels).lower()
    for backend, keys in (("cudnn", ("cudnn",)),
                          ("flash", ("flash",)),
                          ("efficient", ("cutlassb", "efficient", "fmha"))):
        if any(key in names for key in keys):
            return backend
    return "math"


def attention_bound_ms(shape, dtype: str, causal: bool) -> tuple:
    """Least time for one flash forward on these inputs: q, k, v read
    once, o and lse written once, against the causal (or full) products
    QK^T and PV these inputs need."""
    b, s, h, d = shape
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 4 * b * s * h * d * elt + b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 4 * b * h * pairs * d
    return _bound(nbytes, flops, dtype)


def _bound(nbytes: int, flops: int, dtype: str) -> tuple:
    """(least ms, what bounds it, the operations) for moving ``nbytes``
    and doing ``flops`` at the card's published peaks."""
    peak = PEAK_BF16_FLOPS if dtype == "bfloat16" else PEAK_F32_FLOPS
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_SEC, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", flops)


def _rates(row: dict, prefix: str = "") -> None:
    """Add the bound share and TFLOP/s of a timed row's ``ms``."""
    ms, bound = row[f"{prefix}ms"], row[f"{prefix}bound_ms"]
    row[f"{prefix}bound_share"] = bound / ms
    row[f"{prefix}tflops"] = row[f"{prefix}flops"] / (ms / 1e3) / 1e12


def phase_kernels(torch, fa) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1234)
    out = {}
    for name, shape, dtype, causal in KERNEL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(getattr(torch, dtype)) for _ in range(3))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
        err_o = (o.float() - ro.float()).abs().max().item()
        err_lse = (lse - rlse).abs().max().item()
        ok = (bool(torch.isfinite(o).all()) and err_o <= TOL_O[dtype]
              and err_lse <= TOL_LSE)
        row = {"phase": "kernels", "case": name, "shape": list(shape),
               "dtype": dtype, "causal": causal, "max_err_o": err_o,
               "max_err_lse": err_lse, "tol_o": TOL_O[dtype],
               "tol_lse": TOL_LSE, "ok": ok}
        if name in TIMED_KERNEL_CASES:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal))
            row["profiler_ms"] = profiled(
                lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
                torch)[0]
            # The plain version moves ~20 GB a call at 8192: fewer runs.
            row["plain_ms"] = time_ms(
                lambda: fa.flash_attention_reference(q, k, v, causal=causal),
                **({} if name == "decode"
                   else dict(warmup=1, runs=5, batch=2)))
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal))
            row["bound_ms"], row["bound_by"], row["flops"] = \
                attention_bound_ms(shape, dtype, causal)
            _rates(row)
            # The host cost of the three TMA tensor maps each launch encodes.
            row["tensor_map_encode_us"] = fa.tensor_map_encode_ns(q, k, v) / 1e3
            del qt, kt, vt
        emit(row)
        if not ok:
            raise AssertionError(f"kernel disagrees with its plain version "
                                 f"at {name}: {row}")
        out[name] = row
        del q, k, v, o, lse, ro, rlse
        torch.cuda.empty_cache()
    return out


def bwd_bound_ms(shape, dtype: str, causal: bool, kernel: str,
                 delta_given: bool = False) -> tuple:
    """Least time for one backward kernel on these inputs. dQ reads q, k,
    v, dO and lse and writes dq, and either reads o and writes delta (it
    computes delta) or reads the delta it is given; dK/dV reads q, k, v,
    dO, lse and delta and writes dk and dv: six (or dQ with delta given,
    five) [b, s, h, d] tensors and two f32 [b*h, s] rows each. Against the
    causal (or full) products each needs: S, dP and dS K (dQ); S, dP,
    P^T dO and dS^T Q (dK/dV)."""
    b, s, h, d = shape
    elt = 2 if dtype == "bfloat16" else 4
    tensors = 5 if kernel == "dq" and delta_given else 6
    nbytes = tensors * b * s * h * d * elt + 2 * b * h * s * 4
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = (3 if kernel == "dq" else 4) * 2 * b * h * pairs * d
    return _bound(nbytes, flops, dtype)


def _max_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|)."""
    err = (got.float() - ref.float()).abs().max().item()
    top = ref.float().abs().max().item()
    return err, (err / top if top else (0.0 if err == 0 else math.inf))


def _time_bwd(row, torch, fa, case, q, k, v, o, lse, do, delta) -> None:
    """Time each backward kernel beside its plain version and its bound,
    and SDPA's backward (dq, dk and dv together: one PyTorch call for the
    same gradients, timed only, never on the port's path) by CUDA events
    and by the profiler's device time, naming the backend that ran."""
    import torch.nn.functional as F

    name, shape, dtype, causal, q_off, k_off, given = case
    kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
    o_in, delta_in = (None, delta) if given else (o, None)
    # The plain versions move ~20 GB a call at 8192 tokens: fewer runs.
    plain_runs = {} if shape[1] <= 1024 else dict(warmup=1, runs=5, batch=2)
    calls = {
        "dq": (lambda: fa.flash_attention_bwd_dq(q, k, v, o_in, lse, do,
                                                 delta=delta_in, **kw),
               lambda: fa.flash_attention_bwd_dq_reference(
                   q, k, v, o, lse, do, delta=delta_in, **kw)),
        "dkv": (lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta,
                                                   **kw),
                lambda: fa.flash_attention_bwd_dkv_reference(
                    q, k, v, lse, do, delta, **kw))}
    for key, (run, plain) in calls.items():
        row[f"{key}_ms"] = time_ms(run)
        row[f"{key}_profiler_ms"] = profiled(run, torch)[0]
        row[f"{key}_plain_ms"] = time_ms(plain, **plain_runs)
        (row[f"{key}_bound_ms"], row[f"{key}_bound_by"],
         row[f"{key}_flops"]) = bwd_bound_ms(shape, dtype, causal, key, given)
        _rates(row, f"{key}_")
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)

    def library():
        return torch.autograd.grad(ot, (qt, kt, vt), dot, retain_graph=True)

    row["library_ms"] = time_ms(library)
    row["library_profiler_ms"], kernels = profiled(library, torch)
    row["library_backend"] = sdpa_backend(kernels)
    row["library_kernels"] = [k[:80] for k in kernels[:4]]


def phase_bwd_kernels(torch, fa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4321)
    out = {}
    for case in BWD_CASES:
        name, shape, dtype, causal, q_off, k_off, given = case
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(getattr(torch, dtype)) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        # A ring hop is handed the final delta; a full call computes it.
        given_delta = fa.attention_delta(o, do) if given else None
        kw = dict(causal=causal, q_offset=q_off, k_offset=k_off)
        dq, delta = fa.flash_attention_bwd_dq(q, k, v, None if given else o,
                                              lse, do, delta=given_delta,
                                              **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, **kw)
        torch.cuda.synchronize()
        rdq, rdelta = fa.flash_attention_bwd_dq_reference(
            q, k, v, o, lse, do, delta=given_delta, **kw)
        rdk, rdv = fa.flash_attention_bwd_dkv_reference(q, k, v, lse, do,
                                                        rdelta, **kw)
        errs = {key: _max_err(g, r) for key, g, r in (
            ("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv))}
        err_delta = (delta - rdelta).abs().max().item()
        zeros = all(bool((g == 0).all()) for g in (dq, dk, dv))
        unseen = UNSEEN_ROWS.get(name, 0)
        ok = (all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
              and all(rel <= TOL_GRAD[dtype] for _, rel in errs.values())
              and err_delta <= TOL_DELTA
              and (zeros if name == "hop_above" else not zeros)
              and bool((dq[:, :unseen] == 0).all()))
        row = {"phase": "bwd_kernels", "case": name, "shape": list(shape),
               "dtype": dtype, "causal": causal, "q_offset": q_off,
               "k_offset": k_off, "delta_given": given,
               **{f"max_err_{key}": e for key, (e, _) in errs.items()},
               **{f"rel_err_{key}": r for key, (_, r) in errs.items()},
               "max_err_delta": err_delta, "tol_rel": TOL_GRAD[dtype],
               "all_zero": zeros, "unseen_rows_zero": unseen or None,
               "ok": ok}
        del rdelta
        if name == "train":
            again = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
            row["bitwise_repeat"] = all(
                torch.equal(a, b) for a, b in zip(again, (dq, dk, dv)))
            # As the model hands them over: q, k, v are column slices of
            # one [b, s, 3*h*d] qkv product, read through a seq stride of
            # 3*h*d; the same values must give the same bits.
            b, s, h, d = shape
            qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
            sq, sk, sv = (t.reshape(b, s, h, d)
                          for t in qkv.split(h * d, dim=-1))
            strided = fa.flash_attention_bwd(sq, sk, sv, o, lse, do,
                                             causal=causal)
            row["strided_seq_stride"] = sq.stride(1)
            row["strided_rel_err"] = max(
                _max_err(g, r)[1]
                for g, r in zip(strided, (rdq, rdk, rdv)))
            row["strided_bitwise_equal"] = all(
                torch.equal(a, b) for a, b in zip(strided, (dq, dk, dv)))
            ok = row["ok"] = (ok and row["bitwise_repeat"]
                              and sq.stride(1) == 3 * h * d
                              and row["strided_rel_err"] <= TOL_GRAD[dtype]
                              and row["strided_bitwise_equal"])
            del qkv, sq, sk, sv, strided, again
        del rdq, rdk, rdv
        if name in TIMED_BWD_CASES:
            _time_bwd(row, torch, fa, case, q, k, v, o, lse, do, delta)
        emit(row)
        if not ok:
            raise AssertionError(f"backward kernels disagree with their "
                                 f"plain versions at {name}: {row}")
        out[name] = row
        del q, k, v, do, o, lse, dq, dk, dv, delta
        torch.cuda.empty_cache()
    return out


def _head_dim_case(torch, fa, q, k, v, do, causal) -> tuple:
    """The four kernels on q, k, v (and dO) against their plain versions:
    (max errors, whether within the tolerances, launches, outputs)."""
    dtype = str(q.dtype).removeprefix("torch.")
    before = _launch_counts(fa)
    o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
    grads = fa.flash_attention_bwd(q, k, v, ro, rlse, do, causal=causal)
    ref = fa.flash_attention_bwd_reference(q, k, v, ro, rlse, do,
                                           causal=causal)
    hops = {}
    if causal:  # a hop below the diagonal and one on it
        for q_off, k_off in ((q.shape[1], 0), (0, 0)):
            hops[f"partial_{q_off}_{k_off}"] = _partial_errors(
                fa.flash_attention_partial(q, k, v, q_off, k_off),
                fa.flash_attention_partial_reference(q, k, v, q_off, k_off))
    torch.cuda.synchronize()
    launches = {key: n - before[key]
                for key, n in _launch_counts(fa).items()}
    errs = {key: _max_err(g, r)
            for key, g, r in zip(("dq", "dk", "dv"), grads, ref)}
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    ok = (all(bool(torch.isfinite(t).all()) for t in (o, *grads))
          and o.shape == q.shape and all(g.shape == q.shape for g in grads)
          and err_o <= TOL_O[dtype] and err_lse <= TOL_LSE
          and all(rel <= TOL_GRAD[dtype] for _, rel in errs.values())
          and all(e["rel_err_acc"] <= TOL_PARTIAL_ACC[dtype]
                  and e["max_err_m"] <= TOL_PARTIAL_M
                  and e["rel_err_l"] <= TOL_PARTIAL_L
                  for e in hops.values())
          and launches == {"fwd": 1, "dq": 1, "dkv": 1,
                           "partial": len(hops)})
    row = {"max_err_o": err_o, "max_err_lse": err_lse,
           **{f"max_err_{key}": e for key, (e, _) in errs.items()},
           **{f"rel_err_{key}": r for key, (_, r) in errs.items()},
           **hops, "launches": launches, "tol_o": TOL_O[dtype],
           "tol_lse": TOL_LSE, "tol_rel": TOL_GRAD[dtype]}
    return row, ok, (ro, rlse)


def phase_head_dims(torch, fa) -> dict:
    """The four kernels at HEAD_DIMS against their plain versions; four
    cases also through qkv column slices (bitwise equal to the contiguous
    case); b*h = 66560 in both dtypes; the column slices' shared
    statistics and the wgmma dQ's and dK/dV's bitwise repeat; the
    forward, dQ and dK/dV timed at d = 32, 20 and 256 training shapes
    beside their bounds, their plain versions and SDPA (and at d = 256 the
    partial, and the simple dQ beside the wgmma one)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(97531)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0, "partial": 0.0}

    def book(row):
        worst["fwd"] = max(worst["fwd"], row["max_err_o"])
        worst["dq"] = max(worst["dq"], row["max_err_dq"])
        worst["dkv"] = max(worst["dkv"], row["max_err_dk"],
                           row["max_err_dv"])
        worst["partial"] = max([worst["partial"]] + [
            e["max_err_acc"] for key, e in row.items()
            if key.startswith("partial_")])

    for name, shape, dtype, causal in HEAD_DIM_CASES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(getattr(torch, dtype)) for _ in range(4))
        found, ok, (ro, rlse) = _head_dim_case(torch, fa, q, k, v, do,
                                               causal)
        row = {"phase": "head_dims", "case": name, "shape": list(shape),
               "dtype": dtype, "causal": causal, **found, "ok": ok}
        if name in HEAD_DIM_STRIDED:
            b, s, h, d = shape
            qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
            sq, sk, sv = (t.reshape(b, s, h, d)
                          for t in qkv.split(h * d, dim=-1))
            outs = [(fa.flash_attention_fwd(sq, sk, sv),
                     fa.flash_attention_fwd(q, k, v)),
                    (fa.flash_attention_bwd(sq, sk, sv, ro, rlse, do),
                     fa.flash_attention_bwd(q, k, v, ro, rlse, do)),
                    (fa.flash_attention_partial(sq, sk, sv, s, 0),
                     fa.flash_attention_partial(q, k, v, s, 0))]
            same = all(torch.equal(a, c) for got, want in outs
                       for a, c in zip(got, want))
            row["strided_head_stride"] = sq.stride(2)
            row["strided_bitwise_equal"] = same
            ok = row["ok"] = ok and same and sq.stride(2) == d
            del qkv, sq, sk, sv, outs
        emit(row)
        if not ok:
            raise AssertionError(f"head-dim case {name} failed: {row}")
        book(row)
        del q, k, v, do, ro, rlse
    torch.cuda.empty_cache()

    name, shape = MANY_HEADS
    for dtype in ("bfloat16", "float32"):
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(getattr(torch, dtype)) for _ in range(4))
        found, ok, _ = _head_dim_case(torch, fa, q, k, v, do, True)
        row = {"phase": "head_dims", "case": f"{name}_{dtype}",
               "shape": list(shape), "batch_heads": shape[0] * shape[2],
               "dtype": dtype, "causal": True, **found, "ok": ok}
        emit(row)
        if not ok:
            raise AssertionError(f"head-dim case {name} failed: {row}")
        book(row)
        del q, k, v, do, _
        torch.cuda.empty_cache()

    _head_dim_slices(torch, fa, gen)
    _wide_bwd_repeat(torch, fa, gen)

    timed = {}
    for case in HEAD_DIM_TIMED:
        name, shape, dtype, causal = case[:4]
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(getattr(torch, dtype)) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        delta = fa.attention_delta(o, do)
        row = {"phase": "head_dims_timed", "case": name,
               "shape": list(shape), "dtype": dtype, "causal": causal,
               "kernels": "wide" if shape[3] > fa.TILE_MAX_HEAD_DIM
               else "hopper"}

        def run():
            return fa.flash_attention_fwd(q, k, v, causal=causal)

        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row["fwd_ms"] = time_ms(run)
        row["fwd_profiler_ms"] = profiled(run, torch)[0]
        row["fwd_plain_ms"] = time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=causal),
            warmup=1, runs=5, batch=2)
        row["fwd_library_ms"] = time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal))
        row["fwd_bound_ms"], row["fwd_bound_by"], row["fwd_flops"] = \
            attention_bound_ms(shape, dtype, causal)
        _rates(row, "fwd_")
        if shape[3] % 8:   # the padding copies inside those times
            row["pad_copy_fwd_ms"] = time_ms(lambda: fa._pad_heads(q, k, v))
            row["pad_copy_bwd_ms"] = time_ms(
                lambda: fa._pad_heads(q, k, v, o, do))
        if row["kernels"] == "wide":   # the partial at offsets (0, 0)

            def hop():
                return fa.flash_attention_partial(q, k, v, 0, 0)

            row["partial_ms"] = time_ms(hop)
            row["partial_profiler_ms"] = profiled(hop, torch)[0]
            row["partial_plain_ms"] = time_ms(
                lambda: fa.flash_attention_partial_reference(q, k, v, 0, 0),
                warmup=1, runs=5, batch=2)
            row["partial_library_ms"] = row["fwd_library_ms"]
            (row["partial_bound_ms"], row["partial_bound_by"],
             row["partial_flops"]) = partial_bound_ms(shape, dtype, 0, 0)
            _rates(row, "partial_")
        _time_bwd(row, torch, fa, case, q, k, v, o, lse, do, delta)
        if row["kernels"] == "wide":   # the simple dQ, the same build
            _time_simple_dq(row, torch, fa, q, k, v, o, lse, do, causal)
        emit(row)
        timed[name] = row
        del q, k, v, do, o, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "timed": timed}


def _time_simple_dq(row, torch, fa, q, k, v, o, lse, do, causal) -> None:
    """The simple dQ of the same library (the plan (0, slices)) timed
    beside the wgmma one, and how far its dq lies from the wgmma dq's."""
    d = q.shape[-1]
    plan = (0, -(-d // fa.WIDE_SLICE_COLS))

    def simple():
        return fa._launch_dq(q, k, v, o, lse, do, None, causal, d ** -0.5,
                             0, 0, plan=plan)

    got = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)[0]
    row["dq_simple_plan"] = list(plan)
    row["dq_simple_max_diff"] = _max_err(simple()[0], got)[0]
    row["dq_simple_ms"] = time_ms(simple, **SIMPLE_DQ_RUNS)
    row["dq_simple_bound_share"] = row["dq_bound_ms"] / row["dq_simple_ms"]
    row["dq_speedup_vs_simple"] = row["dq_simple_ms"] / row["dq_ms"]


def _head_dim_slices(torch, fa, gen) -> None:
    """At d = 1024 the simple kernels run four 256-column output slices,
    each computing the softmax statistics (lse; m and l; delta) from all
    of d, slice 0 alone writing them. With q, k, v and dO made of four
    equal 256-column blocks, each slice's block of o, acc, dq, dk and dv
    comes from the same statistics and products in the same order: the
    four blocks must be bitwise equal, in both dtypes."""
    name, (b, s, h, d) = SLICE_STATS
    for dtype in ("bfloat16", "float32"):
        q, k, v, do = (torch.randn((b, s, h, 256), generator=gen,
                                   device="cuda").to(getattr(torch, dtype))
                       .repeat(1, 1, 1, d // 256) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        acc, m, l = fa.flash_attention_partial(q, k, v, 0, 0)
        grads = fa.flash_attention_bwd(q, k, v, o, lse, do)
        torch.cuda.synchronize()
        equal = {key: all(torch.equal(parts[0], x) for x in parts[1:])
                 for key, t in zip(("o", "acc", "dq", "dk", "dv"),
                                   (o, acc, *grads))
                 for parts in [t.split(256, dim=-1)]}
        _, rlse = fa.flash_attention_reference(q, k, v)
        err_lse = (lse - rlse).abs().max().item()
        row = {"phase": "head_dims", "case": f"{name}_{dtype}",
               "shape": [b, s, h, d], "dtype": dtype,
               "slices_bitwise_equal": equal, "max_err_lse": err_lse,
               "tol_lse": TOL_LSE,
               "ok": all(equal.values()) and err_lse <= TOL_LSE}
        emit(row)
        if not row["ok"]:
            raise AssertionError(f"column slices disagree: {row}")
        del q, k, v, do, o, lse, acc, m, l, grads
    torch.cuda.empty_cache()


def _wide_bwd_repeat(torch, fa, gen) -> None:
    """The wgmma dQ (delta computed) and dK/dV at the wide training shape
    twice on the same inputs: the same bits (no atomics; dK/dV's P^T
    handed over in shared memory)."""
    q, k, v, do = (torch.randn(WIDE_REPEAT, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa.attention_delta(o, do)
    same = {}
    for key, run in (
            ("dq", lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse, do)),
            ("dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, do,
                                                       delta))):
        first, again = run(), run()
        same[key] = all(torch.equal(a, c) for a, c in zip(first, again))
        del first, again
    ok = all(same.values())
    emit({"phase": "head_dims", "case": "wide_bwd_bitwise_repeat",
          "shape": list(WIDE_REPEAT), "bitwise_repeat": same, "ok": ok})
    if not ok:
        raise AssertionError(f"a wgmma backward kernel is not "
                             f"deterministic: {same}")
    del q, k, v, do, o, lse, delta
    torch.cuda.empty_cache()


def phase_model(torch, fa, burnin) -> None:
    cfg = burnin.BurninConfig(**MODEL)
    dense = replace(cfg, attention="xla")
    params = burnin.init_params(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(7)
    tokens = torch.randint(0, cfg.vocab, (MAX_BATCH, cfg.seq_len),
                           generator=gen, device="cuda")
    with torch.inference_mode():
        before = fa.LAUNCHES
        flash_logits = burnin.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES - before
        dense_logits = burnin.forward(params, tokens, dense)
    diff = (flash_logits - dense_logits).abs()
    last = dense_logits[:, -1]
    top2 = last.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS_MAX
    argmax_equal = bool((flash_logits[:, -1].argmax(-1)[clear]
                         == last.argmax(-1)[clear]).all())
    row = {"phase": "model", "config": MODEL,
           "shape": list(flash_logits.shape),
           "finite": bool(torch.isfinite(flash_logits).all()),
           "max_abs_diff": diff.max().item(),
           "mean_abs_diff": diff.mean().item(),
           "tol_max": TOL_LOGITS_MAX, "tol_mean": TOL_LOGITS_MEAN,
           "logit_std": dense_logits.std().item(),
           "kernel_launches": launches, "n_layers": cfg.n_layers,
           "clear_margin_rows": int(clear.sum()),
           "argmax_equal_where_clear": argmax_equal}
    emit(row)
    if not (row["finite"]
            and list(flash_logits.shape) == [MAX_BATCH, cfg.seq_len,
                                             cfg.vocab]
            and row["max_abs_diff"] <= TOL_LOGITS_MAX
            and row["mean_abs_diff"] <= TOL_LOGITS_MEAN
            and launches == cfg.n_layers and argmax_equal):
        raise AssertionError(f"model phase failed: {row}")
    del params, flash_logits, dense_logits
    torch.cuda.empty_cache()


def _stage_kernel_ms(prof, steps: int) -> dict:
    """{(stage, kernel name): [device ms, launches] per step} of the
    kernels run inside a ``kftpu.moe_<stage>`` range of parallel/moe.py,
    forward and backward. A forward op belongs to the range around it; a
    backward op (under an ``autograd::engine::evaluate_function`` event)
    to the range of the forward op whose autograd node it runs, matched by
    sequence number (the last forward op to hold a number is the one that
    made its node)."""
    prefix = "kftpu.moe_"

    def stage_of(ev):
        while ev is not None:
            if ev.name.startswith(prefix) and ev.name[len(prefix):] in \
                    MOE_STAGES:
                return ev.name[len(prefix):]
            ev = ev.cpu_parent
        return None

    def node_of(ev):
        while ev is not None:
            if ev.name.startswith("autograd::engine::evaluate_function"):
                return ev
            ev = ev.cpu_parent
        return None

    cpu = sorted((ev for ev in prof.events()
                  if ev.device_type.name == "CPU"),
                 key=lambda ev: ev.time_range.start)
    by_seq = {}
    for ev in cpu:
        if ev.sequence_nr >= 0 and node_of(ev) is None:
            by_seq[ev.sequence_nr] = stage_of(ev)
    out = {}
    for ev in cpu:
        if not ev.kernels:
            continue
        node = node_of(ev)
        stage = stage_of(ev) if node is None else by_seq.get(node.sequence_nr)
        if stage is None:
            continue
        for kernel in ev.kernels:
            total = out.setdefault((stage, kernel.name), [0.0, 0])
            total[0] += kernel.duration / 1e3 / steps
            total[1] += 1
    return out


# The MoE layer's stages (parallel/moe.py's profiler ranges) and the name
# each takes in a breakdown; the expert FFN's GEMMs stand apart from its
# GELU and weight casts.
MOE_STAGES = {"router": "moe router (logits GEMM, softmax, top-k, seats)",
              "seat_table": "moe seat table",
              "dispatch": "moe dispatch (gather)",
              "expert_ffn": "moe expert GELU and weight casts",
              "combine": "moe combine (gather, gates)"}
MOE_EXPERT_GEMMS = "moe expert GEMMs"


def profile_steps(torch, fn, steps: int = 3, moe_stages: bool = False) -> dict:
    """Device time by kernel over ``steps`` calls of ``fn`` (one step
    each), host clock around them ending in a device sync. With
    ``moe_stages``, the kernels of each MoE stage (forward and backward)
    are booked to it before the rest go by name."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = _device_rows(prof, steps)
    busy_ms = sum(r[0] for r in rows)
    staged = _stage_kernel_ms(prof, steps) if moe_stages else {}
    gemm_keys = dict(KERNEL_CATEGORIES)["GEMMs (cuBLAS)"]
    by_category = {}

    def book(category, ms, calls):
        total = by_category.setdefault(category, [0.0, 0])
        total[0] += ms
        total[1] += calls

    for ms, name, calls in rows:
        for (stage, kernel), (stage_ms, stage_calls) in staged.items():
            if kernel != name:
                continue
            category = MOE_STAGES[stage]
            if stage == "expert_ffn" and any(k in name for k in gemm_keys):
                category = MOE_EXPERT_GEMMS
            stage_ms = min(stage_ms, ms)
            book(category, stage_ms, stage_calls // steps)
            ms, calls = ms - stage_ms, max(0, calls - stage_calls // steps)
        if ms <= 0:
            continue
        book(next((cat for cat, keys in KERNEL_CATEGORIES
                   if any(key in name for key in keys)),
                  "other elementwise"), ms, calls)
    out = {"wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms,
           "device_idle_share": (1 - busy_ms / wall_ms) if rows else None,
           "by_category": {cat: {"ms_per_step": round(ms, 4),
                                 "calls_per_step": calls}
                           for cat, (ms, calls) in sorted(
                               by_category.items(), key=lambda x: -x[1][0])},
           "top_kernels": [{"name": k[:90], "ms_per_step": round(ms, 4),
                            "calls_per_step": n} for ms, k, n in rows[:12]]}
    if moe_stages:
        out["moe_stage_ms_per_step"] = sum(v[0] for v in staged.values())
    return out


def _timed_steps(torch, step, warmup: int, chunks: int,
                 chunk_steps: int) -> dict:
    """bench.py's timing of a train step ``step() -> loss``: ``warmup``
    steps (the first loss kept), then ``chunks`` chunks of
    ``chunk_steps`` steps queued back to back, each ending in a host sync
    on the loss (which depends on every step before it)."""
    t0 = time.perf_counter()
    loss = step()
    first_loss = float(loss)
    for _ in range(warmup - 1):
        loss = step()
    float(loss)
    warmup_sec = time.perf_counter() - t0
    chunk_ms = []
    t1 = time.perf_counter()
    for _ in range(chunks):
        tc = time.perf_counter()
        for _ in range(chunk_steps):
            loss = step()
        float(loss)
        chunk_ms.append((time.perf_counter() - tc) * 1e3 / chunk_steps)
    steps = chunks * chunk_steps
    spread = sorted(chunk_ms)
    return {"warmup_steps": warmup, "warmup_sec": warmup_sec,
            "steps": steps,
            "step_ms": (time.perf_counter() - t1) * 1e3 / steps,
            "chunk_step_ms": chunk_ms,
            "step_spread_pct": 100.0 * (spread[-1] - spread[0])
            / statistics.median(spread),
            "loss_first": first_loss, "loss_last": float(loss)}


def phase_serving(torch, fa, burnin, engine_mod, loadgen) -> dict:
    cfg = burnin.BurninConfig(**MODEL)
    torch.cuda.reset_peak_memory_stats()
    fa.LAUNCHES = 0                      # ---- the main path starts here
    engine = engine_mod.ServingEngine(
        cfg, max_batch=MAX_BATCH,
        options=engine_mod.EngineOptions(prefill_chunk=PREFILL_CHUNK))
    cold_sec = engine.cold_start(seed=0)
    # Two more models behind the replica: cold-load both, which demotes
    # "default" (two resident slots) to a host-resident warm standby;
    # then swap it back warm, as bench.py's data plane does.
    engine.register_model("alt-a")
    engine.register_model("alt-b")
    engine.use_model("alt-a")
    engine.use_model("alt-b")
    engine.use_model("default")
    warm_swap_sec = engine.models.entry("default").warm_swap_sec
    cold_model_sec = engine.models.entry("alt-a").cold_init_sec
    launches0 = fa.LAUNCHES
    trace = loadgen.burst_trace(
        seed=11, warm_rate=10.0, burst_rate=80.0, warm_sec=1.0,
        burst_sec=0.5, cool_sec=1.0, tokens_out=8, tokens_jitter=4,
        long_prompt_frac=0.05, long_prompt_tokens=96,
        models={"default": 18, "alt-a": 1})
    report = engine.serve(trace)
    serve_launches = fa.LAUNCHES - launches0
    engine.kv.assert_consistent()
    ckpt = engine.park()
    restore_sec = engine.warm_restore()
    replay = engine.serve([engine_mod.Request(rid=10_000 + i, arrival=0.0,
                                              tokens_out=4)
                           for i in range(MAX_BATCH)])
    torch.cuda.synchronize()
    main_launches = fa.LAUNCHES          # ---- the main path ends here
    reg = engine.models
    forwards = (2 * (reg.swaps_cold + reg.swaps_warm) + report.steps
                + report.prefill_chunks + replay.steps
                + replay.prefill_chunks)
    expect_serve = cfg.n_layers * (report.steps + report.prefill_chunks
                                   + 2 * report.model_swaps)
    lat = sorted(c.latency for c in report.completions)
    row = {"phase": "serving", "requests": len(trace),
           "completed": len(report.completions),
           "tokens_out": report.tokens,
           "tokens_per_sec": report.tokens_per_sec,
           "p50_latency_sec": report.latency_percentile(0.50),
           "p99_latency_sec": report.latency_percentile(0.99),
           "max_latency_sec": lat[-1] if lat else None,
           "wall_sec": report.wall_sec,
           "decode_steps": report.steps,
           "batch_occupancy": report.batch_occupancy,
           "prefill_chunks": report.prefill_chunks,
           "model_swaps": report.model_swaps,
           "kv_violations": engine.kv.violations,
           "kv_used_blocks_after": engine.kv.used_blocks,
           "kv_peak_pressure": report.kv_peak_pressure,
           "cold_start_sec": cold_sec, "cold_model_sec": cold_model_sec,
           "warm_swap_sec": warm_swap_sec, "warm_restore_sec": restore_sec,
           "parked_checkpoint": ckpt,
           "replay_completed": len(replay.completions),
           "swaps": reg.debug_info()["swaps"],
           "serve_launches": serve_launches,
           "serve_launches_expected": expect_serve,
           "main_path_launches": main_launches,
           "main_path_launches_expected": cfg.n_layers * forwards,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    if not (row["completed"] == row["requests"] > 0
            and row["kv_violations"] == 0 and row["kv_used_blocks_after"] == 0
            and row["model_swaps"] >= 1
            and serve_launches == expect_serve
            and main_launches == cfg.n_layers * forwards > 0
            and row["replay_completed"] == MAX_BATCH):
        raise AssertionError(f"serving phase failed: {row}")

    # The decode step alone, host clock around work that ends in a sync.
    tokens = torch.zeros((MAX_BATCH, cfg.seq_len), dtype=torch.int64,
                         device="cuda")
    step_ms = []
    for _ in range(12):
        t0 = time.perf_counter()
        engine._step_fn(engine._params, tokens).cpu()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    prof = profile_steps(
        torch, lambda: engine._step_fn(engine._params, tokens).cpu())
    emit({"phase": "decode_step", "shape": [MAX_BATCH, cfg.seq_len],
          "median_ms": statistics.median(step_ms[2:]),
          "min_ms": min(step_ms[2:]), "max_ms": max(step_ms[2:]),
          "runs": len(step_ms) - 2, **prof})

    # The restored engine's answers against the dense forward.
    gen = torch.Generator(device="cuda").manual_seed(11)
    probe = torch.randint(0, cfg.vocab, (MAX_BATCH, cfg.seq_len),
                          generator=gen, device="cuda")
    got = engine._step_fn(engine._params, probe)
    with torch.inference_mode():
        ref = burnin.forward(engine._params, probe,
                             replace(cfg, attention="xla"))[:, -1]
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > TOL_LOGITS_MAX
    equal = bool((got[clear] == ref.argmax(-1)[clear]).all())
    emit({"phase": "engine_output", "clear_margin_rows": int(clear.sum()),
          "argmax_equal_where_clear": equal,
          "shape": list(got.shape)})
    if not (equal and list(got.shape) == [MAX_BATCH]):
        raise AssertionError("engine argmax disagrees with the dense forward")

    # The engine above ran with use_mesh=True (the default) in a world of
    # one: it built no mesh and no control group, so after its warm swap,
    # park and warm restore its scores are those the use_mesh=False engine
    # builds (ModelRegistry._build_fns without a mesh), bitwise.
    world = torch.distributed.get_world_size()
    plain = engine_mod.ModelRegistry._build_fns(cfg)[0]
    chunk = probe[:1, :PREFILL_CHUNK]
    bitwise = [torch.equal(got, plain(engine._params, probe)),
               torch.equal(engine._prefill_fn(engine._params, chunk),
                           plain(engine._params, chunk))]
    row = {"phase": "serving_sharded", "backend": "nccl", "world": world,
           "use_mesh": engine.use_mesh,
           "mesh": engine.models.mesh is not None,
           "control_group": engine._ctl is not None,
           "decode_and_prefill_bitwise_equal_to_use_mesh_false": bitwise,
           "note": "the serving phase's engine; at world 1 use_mesh=True "
                   "runs the use_mesh=False code (structural)"}
    emit(row)
    if not (world == 1 and engine.use_mesh and not row["mesh"]
            and not row["control_group"] and all(bitwise)):
        raise AssertionError(f"serving_sharded phase failed: {row}")
    return {"launches": main_launches}


def _recording_logits(engine_mod, calls: list):
    """Wrap the forward that the engine's scores call, so each call's
    last-position logits are appended to ``calls`` (f32, on the host);
    returns the function that restores it."""
    real = engine_mod.forward

    def recorded(params, tokens, cfg, mesh=None):
        logits = real(params, tokens, cfg, mesh)
        calls.append(logits[:, -1].float().cpu())
        return logits

    engine_mod.forward = recorded
    return lambda: setattr(engine_mod, "forward", real)


def _lanes(report) -> tuple:
    """What a ServeReport's lanes decided: the counts, and each completion
    with its request and model."""
    return (report.steps, report.prefill_chunks, report.model_swaps,
            [(c.rid, c.model) for c in report.completions])


def _serving_world_rank(rank: int, model: dict) -> dict:
    """One process of ``serving_sharded_world``: the engine with
    ``use_mesh=True`` on this rank's shards (the default mesh of a world
    of 4: 1 x 4), the lane trace, then one score-shaped forward whose
    last-position logits rank 0 keeps; rank 0 also keeps the
    last-position logits of every forward the engine ran (warm-ups,
    prefill chunks, decode steps), which its followers replayed. Runs in
    a child process of the gloo world."""
    import torch

    from kubeflow_tpu_torch.models import burnin
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.serving import engine as engine_mod

    cfg = burnin.BurninConfig(**model)
    scores = []
    restore = (_recording_logits(engine_mod, scores) if rank == 0
               else lambda: None)
    torch.cuda.synchronize()
    _zero_launch_counts(fa)
    t0 = time.perf_counter()
    try:
        engine = engine_mod.ServingEngine(
            cfg, max_batch=MAX_BATCH, use_mesh=True,
            options=engine_mod.EngineOptions(prefill_chunk=PREFILL_CHUNK))
        engine.cold_start(seed=0)
        engine.register_model("alt")
        report = engine.serve(_serving_world_trace(engine_mod))
    finally:
        restore()
    params, mesh = engine._params, engine.models.mesh
    probe = _serving_world_probe(torch, cfg)
    with torch.inference_mode():
        logits = burnin.forward(params, probe, cfg, mesh)[:, -1]
    torch.cuda.synchronize()
    serve_sec = time.perf_counter() - t0
    return {"lanes": _lanes(report), "launches": _launch_counts(fa),
            "local_heads": params["layers"][0]["qkv"].shape[1]
            // (3 * cfg.head_dim),
            "mesh": mesh.mesh.tolist(), "serve_sec": serve_sec,
            "forwards": 2 * (engine.models.swaps_cold
                             + engine.models.swaps_warm)
            + report.steps + report.prefill_chunks + 1,
            "logits": logits.cpu() if rank == 0 else None,
            "scores": scores}


def _serving_world_trace(engine_mod) -> list:
    """Every request arrives at 0, so the lanes depend on the trace alone
    (as the CPU tests' lane trace): prompts of two chunks on every third,
    and requests 3 and 4 on a second model (a swap and back)."""
    return [engine_mod.Request(rid=i, arrival=0.0, tokens_out=2 + i % 3,
                               prompt_tokens=40 if i % 3 == 0 else 0,
                               model="alt" if i in (3, 4) else "default")
            for i in range(7)]


def _serving_world_probe(torch, cfg):
    gen = torch.Generator(device="cuda").manual_seed(13)
    return torch.randint(0, cfg.vocab, (MAX_BATCH, cfg.seq_len),
                         generator=gen, device="cuda")


def _serving_world_reference(torch, burnin, engine_mod) -> dict:
    """The one-process engine on the card that ``serving_sharded_world``
    is held to: its lanes on the same trace, the last-position logits of
    every forward it ran there, and those of one score-shaped forward of
    its weights."""
    cfg = burnin.BurninConfig(**SERVING_SHARDED_MODEL)
    scores = []
    restore = _recording_logits(engine_mod, scores)
    try:
        engine = engine_mod.ServingEngine(
            cfg, max_batch=MAX_BATCH, use_mesh=False,
            options=engine_mod.EngineOptions(prefill_chunk=PREFILL_CHUNK))
        engine.cold_start(seed=0)
        engine.register_model("alt")
        lanes = _lanes(engine.serve(_serving_world_trace(engine_mod)))
    finally:
        restore()
    with torch.inference_mode():
        logits = burnin.forward(engine._params,
                                _serving_world_probe(torch, cfg),
                                cfg)[:, -1].float()
    return {"lanes": lanes, "logits": logits, "scores": scores}


def _logit_gaps(got, want) -> dict:
    """``got``'s last-position logits against ``want``'s: the largest
    absolute error, rel L2 over all of them, the rows whose ``want`` top-2
    margin exceeds 4x that error, and whether their argmax agrees."""
    err = (got - want).abs().max().item()
    top2 = want.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4 * err
    return {"max_abs_err": err,
            "rel_l2": ((got - want).norm() / want.norm()).item(),
            "clear_rows": int(clear.sum()),
            "argmax_equal": bool((got.argmax(-1)[clear]
                                  == want.argmax(-1)[clear]).all())}


def phase_serving_sharded_world(torch, ranks: list, ref: dict,
                                world_sec: float) -> dict:
    """Sharded serving in a world of 4: 4 processes share the card over
    gloo (NCCL takes one process a card), each an engine with
    ``use_mesh=True`` on the default 1 x 4 mesh (4 of the 16 heads a
    process), ``SERVING_SHARDED_MODEL`` (the serving widths at 2 layers,
    a depth cut). Each forward the engine ran on rank 0 (the followers
    ran it on their shards in the same collectives), and one score-shaped
    forward of seeded tokens, against the one-process engine's on the
    same trace on the card: the last-position logits within
    TOL_SERVING_LOGITS_REL_L2 and the argmax equal wherever the
    one-process top-2 margin exceeds 4x the largest logit error. The
    engine feeds zero tokens, so a serving forward's rows are one row
    repeated. The reports are checked too, but as structure: the lanes
    depend on the trace alone (every arrival at 0) and every rank returns
    rank 0's report. Its seconds go through the host's gloo: no rate.
    ``ranks``: each process's ``_serving_world_rank``."""
    cfg = SERVING_SHARDED_MODEL
    probe = _logit_gaps(ranks[0]["logits"].cuda().float(), ref["logits"])
    scores = [_logit_gaps(got.cuda(), want.cuda())
              for got, want in zip(ranks[0]["scores"], ref["scores"])]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    forwards = sum(r["forwards"] for r in ranks)
    row = {"phase": "serving_sharded_world", "config": cfg,
           "cut": "depth: the serving config's widths at n_layers 2",
           "mesh": ranks[0]["mesh"],
           "backend": "gloo on CUDA tensors (4 processes, one card)",
           "max_batch": MAX_BATCH, "local_heads": ranks[0]["local_heads"],
           "lanes": ranks[0]["lanes"],
           "structural": {
               "reports_equal_across_ranks": all(
                   r["lanes"] == ranks[0]["lanes"] for r in ranks),
               "report_equal_to_one_process":
                   ranks[0]["lanes"] == ref["lanes"]},
           "tol_rel_l2": TOL_SERVING_LOGITS_REL_L2,
           "scores": len(scores),
           "scores_expected": len(ref["scores"]),
           "scores_max_rel_l2": max(g["rel_l2"] for g in scores),
           "scores_max_abs_err": max(g["max_abs_err"] for g in scores),
           "scores_clear_rows": sum(g["clear_rows"] for g in scores),
           "scores_argmax_equal_where_clear": all(g["argmax_equal"]
                                                  for g in scores),
           "probe_rel_l2": probe["rel_l2"],
           "probe_max_abs_err": probe["max_abs_err"],
           "probe_clear_rows": probe["clear_rows"],
           "probe_argmax_equal_where_clear": probe["argmax_equal"],
           "launches": launches,
           "launches_expected": cfg["n_layers"] * forwards,
           "note": "host-clock seconds through gloo on the host, not NVLink: "
                   "not a rate",
           "serve_sec_by_rank": [r["serve_sec"] for r in ranks],
           "world_sec": world_sec}
    emit(row)
    gaps = [probe, *scores]
    if not (all(row["structural"].values())
            and len(scores) == len(ref["scores"]) > 0
            and all(math.isfinite(g["rel_l2"])
                    and g["rel_l2"] <= TOL_SERVING_LOGITS_REL_L2
                    and g["argmax_equal"] for g in gaps)
            and row["local_heads"] == cfg["n_heads"] // 4
            and launches["fwd"] == row["launches_expected"]):
        raise AssertionError(f"serving_sharded_world phase failed: {row}")
    return {"fwd": launches["fwd"]}


def train_step_flops(cfg, batch: int) -> float:
    """Analytic matmul FLOPs of one train step (forward + backward = 3x
    the forward), as bench.py's train_step_flops counts them: the dense
    products and the causal half of attention's score and context
    products, on the seq_len - 1 positions the loss trains."""
    s = cfg.seq_len - 1
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    per_token_layer = 2 * d * 3 * d + 2 * d * d + 2 * d * ff + 2 * ff * d
    per_layer_attn = 2 * batch * s * s * d
    fwd = (batch * s * (cfg.n_layers * per_token_layer + 2 * d * v)
           + cfg.n_layers * per_layer_attn)
    return 3.0 * fwd


def _leaf_names(tree, path="") -> list:
    if isinstance(tree, dict):
        return [n for key, value in tree.items()
                for n in _leaf_names(value, f"{path}.{key}".lstrip("."))]
    if isinstance(tree, list):
        return [n for i, value in enumerate(tree)
                for n in _leaf_names(value, f"{path}[{i}]")]
    return [path]


def _launch_counts(fa) -> dict:
    return {"fwd": fa.LAUNCHES, "dq": fa.BWD_DQ_LAUNCHES,
            "dkv": fa.BWD_DKV_LAUNCHES, "partial": fa.PARTIAL_LAUNCHES}


def _zero_launch_counts(fa) -> None:
    fa.LAUNCHES = fa.BWD_DQ_LAUNCHES = fa.BWD_DKV_LAUNCHES = 0
    fa.PARTIAL_LAUNCHES = fa.DO_COPIES = 0


def _burnin_counts(n: int) -> dict:
    """The launches of ``n`` burn-in forwards with their backwards."""
    return {"fwd": n, "dq": n, "dkv": n, "partial": 0}


def _train_inputs(torch, burnin, cfg, seed: int):
    params = burnin.init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len),
                           generator=gen, device="cuda")
    return params, tokens


def _grad_gaps(torch, params, grads, ref) -> tuple:
    """Per leaf: finite, rel L2 and cosine of ``grads`` against ``ref``;
    and the leaves with the largest rel L2 and the least cosine."""
    leaves = []
    for name, g, r in zip(_leaf_names(params), grads, ref):
        leaves.append({
            "leaf": name, "finite": bool(torch.isfinite(g).all()),
            "rel_l2": ((g - r).norm() / r.norm()).item(),
            "cosine": torch.nn.functional.cosine_similarity(
                g.flatten(), r.flatten(), dim=0).item()})
    return (leaves, max(leaves, key=lambda x: x["rel_l2"]),
            min(leaves, key=lambda x: x["cosine"]))


def phase_train_grads(torch, fa, burnin) -> None:
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    params, tokens = _train_inputs(torch, burnin, cfg, seed=0)
    before = _launch_counts(fa)
    loss, grads = burnin.value_and_grad(burnin.loss_fn, params, tokens, cfg)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts(fa).items()}
    ref_loss, ref = burnin.value_and_grad(
        burnin.loss_fn, params, tokens, replace(cfg, attention="xla"))
    leaves, worst, least = _grad_gaps(torch, params, grads, ref)
    row = {"phase": "train_grads", "config": TRAIN_MODEL,
           "batch": TRAIN_BATCH, "loss_flash": float(loss),
           "loss_dense": float(ref_loss),
           "loss_diff": float(loss) - float(ref_loss),
           "worst_rel_l2": worst["rel_l2"], "worst_rel_l2_leaf": worst["leaf"],
           "min_cosine": least["cosine"], "min_cosine_leaf": least["leaf"],
           "tol_loss": TOL_TRAIN_LOSS, "tol_rel_l2": TOL_GRAD_REL_L2,
           "min_cosine_bound": MIN_GRAD_COSINE, "launches": launches,
           "leaves": leaves}
    emit(row)
    if not (all(x["finite"] for x in leaves)
            and abs(row["loss_diff"]) <= TOL_TRAIN_LOSS
            and worst["rel_l2"] <= TOL_GRAD_REL_L2
            and least["cosine"] >= MIN_GRAD_COSINE
            and launches == _burnin_counts(cfg.n_layers)):
        raise AssertionError(f"flash and dense gradients disagree: {row}")
    del params, grads, ref
    torch.cuda.empty_cache()


def phase_train(torch, fa, burnin, card: str) -> dict:
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    params, tokens = _train_inputs(torch, burnin, cfg, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    step = burnin.make_train_step(cfg)
    timing = _timed_steps(torch, lambda: step(params, tokens)[1],
                          TRAIN_WARMUP, TRAIN_CHUNKS, TRAIN_CHUNK_STEPS)
    first_loss, last_loss = timing["loss_first"], timing["loss_last"]
    prof = profile_steps(torch, lambda: step(params, tokens),
                         TRAIN_PROFILED)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    copies = fa.DO_COPIES
    run = TRAIN_WARMUP + timing["steps"] + TRAIN_PROFILED
    flops = train_step_flops(cfg, TRAIN_BATCH)
    tflops = flops / (timing["step_ms"] / 1e3) / 1e12
    row = {"phase": "train", "config": TRAIN_MODEL, "batch": TRAIN_BATCH,
           "card": card, **timing,
           "flops_per_step": flops, "tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
           "tokens_per_sec": TRAIN_BATCH * (cfg.seq_len - 1)
           / (timing["step_ms"] / 1e3),
           "launches": launches, "launches_expected": cfg.n_layers * run,
           "do_copies": copies,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "profile": prof}
    emit(row)
    if not (math.isfinite(first_loss) and math.isfinite(last_loss)
            and last_loss < first_loss and copies == 0
            and launches == _burnin_counts(cfg.n_layers * run)):
        raise AssertionError(f"train phase failed: {row}")
    del params
    torch.cuda.empty_cache()
    return row


def phase_wide_heads(torch, fa, burnin, card: str) -> dict:
    """A training step at head_dim 256: WIDE_MODEL's loss and every
    gradient leaf with attention="flash" against "xla" on the same
    seeded params and tokens, then the step timed as bench.py times it and
    profiled, with launches counted from zero."""
    cfg = burnin.BurninConfig(**WIDE_MODEL)
    params, tokens = _train_inputs(torch, burnin, cfg, seed=5)
    loss, grads = burnin.value_and_grad(burnin.loss_fn, params, tokens, cfg)
    ref_loss, ref = burnin.value_and_grad(
        burnin.loss_fn, params, tokens, replace(cfg, attention="xla"))
    _, worst, least = _grad_gaps(torch, params, grads, ref)
    gaps = {"loss_flash": float(loss), "loss_dense": float(ref_loss),
            "loss_diff": float(loss) - float(ref_loss),
            "worst_rel_l2": worst["rel_l2"],
            "worst_rel_l2_leaf": worst["leaf"],
            "min_cosine": least["cosine"], "min_cosine_leaf": least["leaf"],
            "tol_loss": TOL_TRAIN_LOSS, "tol_rel_l2": TOL_GRAD_REL_L2,
            "min_cosine_bound": MIN_GRAD_COSINE}
    grads_ok = (abs(gaps["loss_diff"]) <= TOL_TRAIN_LOSS
                and worst["rel_l2"] <= TOL_GRAD_REL_L2
                and least["cosine"] >= MIN_GRAD_COSINE
                and all(bool(torch.isfinite(g).all()) for g in grads))
    del grads, ref
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    step = burnin.make_train_step(cfg)
    timing = _timed_steps(torch, lambda: step(params, tokens)[1],
                          WIDE_WARMUP, WIDE_CHUNKS, WIDE_CHUNK_STEPS)
    prof = profile_steps(torch, lambda: step(params, tokens), WIDE_PROFILED)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    copies = fa.DO_COPIES
    run = WIDE_WARMUP + timing["steps"] + WIDE_PROFILED
    flops = train_step_flops(cfg, TRAIN_BATCH)
    tflops = flops / (timing["step_ms"] / 1e3) / 1e12
    row = {"phase": "wide_heads", "config": WIDE_MODEL,
           "head_dim": cfg.head_dim, "batch": TRAIN_BATCH, "card": card,
           "grads": gaps, **timing, "flops_per_step": flops,
           "tflops": tflops, "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "tokens_per_sec": TRAIN_BATCH * (cfg.seq_len - 1)
           / (timing["step_ms"] / 1e3),
           "launches": launches, "launches_expected": cfg.n_layers * run,
           "do_copies": copies,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "profile": prof}
    emit(row)
    if not (grads_ok and math.isfinite(timing["loss_last"])
            and timing["loss_last"] < timing["loss_first"] and copies == 0
            and launches == _burnin_counts(cfg.n_layers * run)):
        raise AssertionError(f"wide_heads phase failed: {row}")
    del params
    torch.cuda.empty_cache()
    return launches


def phase_trainer(torch, fa, burnin, trainer, telemetry) -> dict:
    """``trainer.fit`` at full width with the telemetry hooks as the SDK
    wires them: a ``StepProfiler`` (the analytic step FLOPs, the dense
    bf16 peak) and a ``TelemetryPublisher`` whose patcher records the
    bodies. ``sync_every=1`` makes every step wait on its loss, as
    bench.py's ``_mc_family`` does; with a longer interval a step between
    window boundaries would time only the host's dispatch. The phase holds
    the profiler to its own clock: ``steps - 1`` measured steps, the p50
    within 5% of the steady median of the per-step marks, MFU = FLOPs /
    p50 / peak, the memory high-water equal to ``max_memory_allocated``,
    and the last published annotation decoding to the summary."""
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    params, _ = _train_inputs(torch, burnin, cfg, seed=2)
    tx = trainer.make_optimizer(trainer.TrainerConfig())
    state = trainer.init_state(params, tx)
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=cfg), tx,
                                   accum_steps=FIT_ACCUM)
    gen = torch.Generator(device="cuda").manual_seed(5)
    batches = (torch.randint(0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len),
                             generator=gen, device="cuda")
               for _ in range(FIT_STEPS))
    flops = train_step_flops(cfg, TRAIN_BATCH)
    profiler = telemetry.StepProfiler(
        "burnin", flops_per_step=flops,
        tokens_per_step=TRAIN_BATCH * (cfg.seq_len - 1),
        peak_flops=PEAK_BF16_FLOPS, sync_every=1)
    bodies = []
    publisher = telemetry.TelemetryPublisher(bodies.append)
    losses, marks = [], []

    def on_step(i, loss):               # float(loss) synced the step
        losses.append(loss)
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    t0 = time.perf_counter()
    state = trainer.fit(state, batches, steps=FIT_STEPS, step_fn=step,
                        on_step=on_step, profiler=profiler,
                        publisher=publisher)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launch_counts(fa)        # ---- the main path ends here
    peak = torch.cuda.max_memory_allocated()
    step_ms = [(b - a) * 1e3 for a, b in zip([t0] + marks[:-1], marks)]
    summary = profiler.summary()
    published = telemetry.publisher.decode(
        bodies[-1]["metadata"]["annotations"]) if bodies else None
    more = torch.randint(0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len),
                         generator=gen, device="cuda")
    prof = profile_steps(torch, lambda: step(state, more), TRAIN_PROFILED)
    expect = cfg.n_layers * FIT_ACCUM * FIT_STEPS
    steady = statistics.median(step_ms[1:])
    p50_ms = (summary["step_p50_sec"] or 0.0) * 1e3
    row = {"phase": "trainer", "trainer_config": "TrainerConfig()",
           "accum_steps": FIT_ACCUM, "steps": state["step"],
           "batch": TRAIN_BATCH, "losses": losses,
           "step_ms_with_sync": wall * 1e3 / FIT_STEPS,
           "first_step_ms": step_ms[0],
           "steady_step_ms_mean": statistics.mean(step_ms[1:]),
           "steady_step_ms_median": steady,
           "step_ms": step_ms,
           "telemetry": summary, "profiler_p50_ms": p50_ms,
           "profiler_p50_vs_steady_pct": 100.0 * (p50_ms - steady) / steady,
           "publishes": len(bodies), "published": published,
           "launches": launches, "launches_expected": expect,
           "max_memory_allocated_bytes": peak, "profile": prof}
    emit(row)
    telemetry_ok = (
        summary["steps_measured"] == FIT_STEPS - 1
        and summary["step"] == FIT_STEPS
        and abs(row["profiler_p50_vs_steady_pct"]) <= TOL_TELEMETRY_P50_PCT
        and summary["mfu"] == flops / summary["step_p50_sec"]
        / PEAK_BF16_FLOPS
        and summary["mfu_basis"] == "accelerator"
        and summary["hbm_high_water_bytes"] == peak
        and published is not None
        and published["family"] == summary["family"]
        and published["step"] == summary["step"]
        and published["mfu"] == round(summary["mfu"], 4))
    if not (state["step"] == FIT_STEPS and len(losses) == FIT_STEPS
            and all(math.isfinite(x) for x in losses)
            and launches == _burnin_counts(expect) and telemetry_ok):
        raise AssertionError(f"trainer phase failed: {row}")
    del state, params
    torch.cuda.empty_cache()
    return launches


@contextmanager
def world_of_one(torch):
    """A process group of this process alone over NCCL (a file store in
    a temporary directory), destroyed on the way out."""
    import tempfile

    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(f"{tmp}/store", 1), world_size=1,
            rank=0, device_id=torch.device("cuda", 0))
        try:
            yield
        finally:
            dist.destroy_process_group()


def phase_sharded(torch, fa, burnin, tree, pmesh) -> dict:
    """The sharded train step at one shard: world 1 over NCCL, mesh 1 x 1,
    TRAIN_MODEL at batch 8. Two steps of ``make_train_step(cfg, mesh)``
    (launches counted from zero) against two of ``make_train_step(cfg)``
    from the same params and tokens, the losses and every leaf bitwise
    equal. It is not timed: at one shard it runs ``train``'s ops, so its
    time could only echo ``train``'s until several cards give it
    collectives to time."""
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    mesh = pmesh.make_mesh(pmesh.MeshPlan(1, 1), "cuda")
    params, tokens = _train_inputs(torch, burnin, cfg, seed=0)
    plain = tree.map_params(torch.clone, params)
    params = burnin.shard_params(params, mesh, cfg)
    step = burnin.make_train_step(cfg, mesh)
    plain_step = burnin.make_train_step(cfg)
    torch.cuda.synchronize()
    _zero_launch_counts(fa)              # ---- the main path starts here
    losses = [step(params, tokens)[1] for _ in range(SHARDED_STEPS)]
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    equal = [torch.equal(loss, plain_step(plain, tokens)[1])
             for loss in losses]
    equal.append(all(torch.equal(a, b) for a, b in
                     zip(tree.leaves(params), tree.leaves(plain))))
    expect = cfg.n_layers * SHARDED_STEPS
    row = {"phase": "sharded", "config": TRAIN_MODEL, "batch": TRAIN_BATCH,
           "mesh": {"data": 1, "model": 1}, "backend": "nccl", "world": 1,
           "steps": SHARDED_STEPS, "losses": [float(x) for x in losses],
           "bitwise_equal_to_unsharded": equal,
           "launches": launches, "launches_expected": expect}
    emit(row)
    if not (all(equal) and all(math.isfinite(x) for x in row["losses"])
            and launches == _burnin_counts(expect)):
        raise AssertionError(f"sharded phase failed: {row}")
    del params, plain
    torch.cuda.empty_cache()
    return launches


def phase_dryrun(torch, entry) -> None:
    """``dryrun_multichip(1)`` on the card (the burn-in block, as the JAX
    package's gate at n = 1), inside the world of one; with 4 cards,
    ``dryrun_multichip(4)`` over NCCL too."""
    t0 = time.perf_counter()
    row = {"phase": "dryrun", "n_1": entry.dryrun_multichip(1),
           "n_1_sec": time.perf_counter() - t0,
           "device_count": torch.cuda.device_count()}
    if torch.cuda.device_count() >= 4:
        t0 = time.perf_counter()
        row["n_4"] = entry.dryrun_multichip(4)
        row["n_4_sec"] = time.perf_counter() - t0
    else:
        row["n_4"] = (f"not run: dryrun_multichip(4) needs 4 cards, one a "
                      f"process over NCCL, and this machine has "
                      f"{torch.cuda.device_count()}")
    emit(row)
    if not all(math.isfinite(v) for key in ("n_1", "n_4")
               if isinstance(row[key], dict) for v in row[key].values()):
        raise AssertionError(f"dryrun phase failed: {row}")


def _sharded_grads_rank(rank: int, model: dict, seed: int) -> dict:
    """One process of ``sharded_grads``: this rank's shard of the seeded
    params and tokens at SHARDED_MESH, one sharded SGD step at lr 1 on
    the card, and the update of every leaf gathered back to the global
    layout (rank 0 keeps it). Runs in a child process of the gloo world."""
    import torch

    from kubeflow_tpu_torch.models import burnin
    from kubeflow_tpu_torch.models.tree import leaves, map_params
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel.mesh import MeshPlan, make_mesh, shard

    cfg = burnin.BurninConfig(**model)
    mesh = make_mesh(MeshPlan(*SHARDED_MESH), "cuda")
    params, tokens = _train_inputs(torch, burnin, cfg, seed)
    params = burnin.shard_params(params, mesh, cfg)
    before = [t.clone() for t in leaves(params)]
    tokens = shard(tokens, ("data",), mesh)
    step = burnin.make_train_step(cfg, mesh, lr=1.0)
    torch.cuda.synchronize()
    _zero_launch_counts(fa)
    t0 = time.perf_counter()
    _, loss = step(params, tokens)
    loss = float(loss)
    step_sec = time.perf_counter() - t0
    launches = _launch_counts(fa)
    updates = iter([(b - a).cpu() for b, a in zip(before, leaves(params))])
    update = burnin.unshard_params(map_params(lambda _: next(updates),
                                              params), mesh, cfg)
    return {"loss": loss, "launches": launches, "step_sec": step_sec,
            "local_heads": params["layers"][0]["qkv"].shape[1]
            // (3 * cfg.head_dim), "local_batch": tokens.shape[0],
            "update": update if rank == 0 else None}


def _sharded_grads_reference(torch, burnin, tree) -> dict:
    """The one-process step on the card that ``sharded_grads`` is held
    to: the seeded params and tokens at SHARDED_MODEL, one SGD step at
    lr 1, each leaf's update (its gradient) and the loss."""
    cfg = burnin.BurninConfig(**SHARDED_MODEL)
    params, tokens = _train_inputs(torch, burnin, cfg, seed=7)
    skeleton = tree.map_params(lambda _: None, params)
    before = [t.clone() for t in tree.leaves(params)]
    _, loss = burnin.make_train_step(cfg, lr=1.0)(params, tokens)
    update = [b - a for b, a in zip(before, tree.leaves(params))]
    return {"skeleton": skeleton, "update": update, "loss": float(loss)}


def phase_sharded_grads(torch, tree, ranks: list, ref: dict,
                        world_sec: float) -> dict:
    """The sharded step's numbers at 2 x 2: 4 processes share the card
    over gloo (the card machine has one card, and NCCL takes one process a
    card), TRAIN_MODEL's widths at 2 layers (a depth cut), global batch 8,
    flash. After one step at lr 1 (each leaf's update is its gradient),
    rank 0's loss and every leaf's update, gathered to the global layout,
    against the one-process step's on the card at the train_grads
    bounds. ``ranks``: each process's ``_sharded_grads_rank``."""
    got = [t.cuda() for t in tree.leaves(ranks[0]["update"])]
    leaves, worst, least = _grad_gaps(torch, ref["skeleton"], got,
                                      ref["update"])
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    row = {"phase": "sharded_grads", "config": SHARDED_MODEL,
           "cut": "depth: TRAIN_MODEL's widths at n_layers 2",
           "mesh": dict(zip(("data", "model"), SHARDED_MESH)),
           "backend": "gloo on CUDA tensors (4 processes, one card)",
           "batch": TRAIN_BATCH, "local_batch": ranks[0]["local_batch"],
           "local_heads": ranks[0]["local_heads"], "lr": 1.0,
           "loss_sharded": ranks[0]["loss"],
           "loss_one_process": ref["loss"],
           "loss_diff": ranks[0]["loss"] - ref["loss"],
           "losses_by_rank": [r["loss"] for r in ranks],
           "worst_rel_l2": worst["rel_l2"], "worst_rel_l2_leaf": worst["leaf"],
           "min_cosine": least["cosine"], "min_cosine_leaf": least["leaf"],
           "tol_loss": TOL_TRAIN_LOSS, "tol_rel_l2": TOL_GRAD_REL_L2,
           "min_cosine_bound": MIN_GRAD_COSINE, "launches": launches,
           "note": "host-clock seconds through gloo on the host, not NVLink: "
                   "not a rate",
           "step_sec_by_rank": [r["step_sec"] for r in ranks],
           "world_sec": world_sec, "leaves": leaves}
    emit(row)
    if not (all(x["finite"] for x in leaves)
            and len(set(row["losses_by_rank"])) == 1
            and abs(row["loss_diff"]) <= TOL_TRAIN_LOSS
            and worst["rel_l2"] <= TOL_GRAD_REL_L2
            and least["cosine"] >= MIN_GRAD_COSINE
            and launches == _burnin_counts(4 * SHARDED_MODEL["n_layers"])):
        raise AssertionError(f"sharded_grads phase failed: {row}")
    return launches


def _world_rank(rank: int, grads_model: dict, seed: int,
                serving_model: dict) -> dict:
    """One process of the world of 4 that ``sharded_grads`` and
    ``serving_sharded_world`` share (one spawn: each process takes
    seconds to reach the card): the sharded step, then the sharded
    engine, each with its launches counted from zero."""
    import torch

    grads = _sharded_grads_rank(rank, grads_model, seed)
    torch.cuda.empty_cache()
    return {"sharded_grads": grads,
            "serving_sharded_world": _serving_world_rank(rank,
                                                         serving_model)}


def phase_worlds(torch, burnin, tree, engine_mod, launch) -> dict:
    """``sharded_grads`` and ``serving_sharded_world`` over one world of 4
    processes on the card: both references on the card first, then the
    world, then each phase's row and checks."""
    grads_ref = _sharded_grads_reference(torch, burnin, tree)
    serving_ref = _serving_world_reference(torch, burnin, engine_mod)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = launch.run_world(_world_rank, 4, SHARDED_MODEL, 7,
                             SERVING_SHARDED_MODEL, cuda=True, timeout=300)
    world_sec = time.perf_counter() - t0
    by_path = {
        "sharded_grads": phase_sharded_grads(
            torch, tree, [r["sharded_grads"] for r in ranks], grads_ref,
            world_sec),
        "serving_sharded_world": phase_serving_sharded_world(
            torch, [r["serving_sharded_world"] for r in ranks], serving_ref,
            world_sec)}
    del ranks, grads_ref, serving_ref
    torch.cuda.empty_cache()
    return by_path


def partial_bound_ms(shape, dtype: str, q_offset: int, k_offset: int):
    """Least time for one partial launch on these inputs: q, k, v read
    once, the f32 acc and the f32 m and l written once, against the QK^T
    and PV products of the query-key pairs that the global causal mask
    leaves visible at these offsets."""
    b, s, h, d = shape
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = 3 * b * s * h * d * elt + b * s * h * d * 4 + 2 * b * h * s * 4
    pairs = sum(max(0, min(s, q_offset + i - k_offset + 1)) for i in range(s))
    flops = 4 * b * h * pairs * d
    return _bound(nbytes, flops, dtype)


def _partial_errors(got, ref) -> dict:
    """acc error over the plain acc's largest magnitude, m's absolute
    error, l's error over the plain l's largest value (at least 1)."""
    (o, m, l), (ro, rm, rl) = got, ref
    top = ro.abs().max().item()
    err_o = (o - ro).abs().max().item()
    return {"rel_err_acc": err_o / top if top else err_o,
            "max_err_acc": err_o,
            "max_err_m": (m - rm).abs().max().item(),
            "rel_err_l": (l - rl).abs().max().item()
            / max(rl.max().item(), 1.0)}


def phase_partial_kernels(torch, fa) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(2468)
    out = {}
    for name, shape, dtype, q_off, k_off in PARTIAL_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(getattr(torch, dtype)) for _ in range(3))
        got = fa.flash_attention_partial(q, k, v, q_off, k_off)
        torch.cuda.synchronize()
        ref = fa.flash_attention_partial_reference(q, k, v, q_off, k_off)
        errs = _partial_errors(got, ref)
        o, m, l = got
        nothing = (bool((o == 0).all()) and bool((l == 0).all())
                   and bool((m == -1e30).all()))
        ok = (all(bool(torch.isfinite(t).all()) for t in (o, l))
              and errs["rel_err_acc"] <= TOL_PARTIAL_ACC[dtype]
              and errs["max_err_m"] <= TOL_PARTIAL_M
              and errs["rel_err_l"] <= TOL_PARTIAL_L
              and (nothing if name == "hop_above" else not nothing))
        row = {"phase": "partial_kernels", "case": name, "shape": list(shape),
               "dtype": dtype, "q_offset": q_off, "k_offset": k_off, **errs,
               "tol_acc": TOL_PARTIAL_ACC[dtype], "tol_m": TOL_PARTIAL_M,
               "tol_l": TOL_PARTIAL_L, "exactly_nothing": nothing, "ok": ok}
        del ref
        if name == "hop_diagonal":
            # As the model hands them over: column slices of one qkv tensor.
            b, s, h, d = shape
            qkv = torch.cat([t.reshape(b, s, h * d) for t in (q, k, v)], -1)
            sq, sk, sv = (t.reshape(b, s, h, d)
                          for t in qkv.split(h * d, dim=-1))
            strided = fa.flash_attention_partial(sq, sk, sv, q_off, k_off)
            row["strided_seq_stride"] = sq.stride(1)
            row["strided_bitwise_equal"] = all(
                torch.equal(a, c) for a, c in zip(strided, got))
            ok = row["ok"] = (ok and sq.stride(1) == 3 * h * d
                              and row["strided_bitwise_equal"])
            del qkv, sq, sk, sv, strided
        if name in TIMED_PARTIAL_CASES:
            def run():
                return fa.flash_attention_partial(q, k, v, q_off, k_off)

            def plain():
                return fa.flash_attention_partial_reference(q, k, v, q_off,
                                                            k_off)

            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            row["ms"] = time_ms(run)
            row["profiler_ms"] = profiled(run, torch)[0]
            # The plain version moves ~20 GB a call at 8192: fewer runs.
            row["plain_ms"] = time_ms(plain, warmup=1, runs=5,
                                      batch=2)
            # SDPA computes the same causal products and normalizes.
            row["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
            row["bound_ms"], row["bound_by"], row["flops"] = \
                partial_bound_ms(shape, dtype, q_off, k_off)
            _rates(row)
            del qt, kt, vt
        emit(row)
        if not ok:
            raise AssertionError(f"partial kernel disagrees with its plain "
                                 f"version at {name}: {row}")
        out[name] = row
        del q, k, v, got, o, m, l
        torch.cuda.empty_cache()
    return out


def phase_ring_hops(torch, fa, ring) -> dict:
    """A ring of RING_SHARDS blocks simulated in one process: each query
    block's hops in ring order through the partial kernel and the fold;
    the backward as the ring's second rotation, each block pair's partial
    gradients from the backward kernels with the final lse and delta."""
    shape = (1, LONGCTX_MODEL["seq_len"], LONGCTX_MODEL["n_heads"],
             LONGCTX_MODEL["d_model"] // LONGCTX_MODEL["n_heads"])
    gen = torch.Generator(device="cuda").manual_seed(1357)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    n, s_local = RING_SHARDS, shape[1] // RING_SHARDS

    def blk(t, i):
        return t[:, i * s_local:(i + 1) * s_local]

    torch.cuda.synchronize()
    _zero_launch_counts(fa)              # ---- the hop path starts here
    outs, lses = [], []
    for my in range(n):
        carry = None
        for t in range(n):
            src = (my - t) % n
            carry = ring.fold_hop(carry, *fa.flash_attention_partial(
                blk(q, my), blk(k, src), blk(v, src), my * s_local,
                src * s_local))
        o_my, lse_my = ring.finish(carry, q.dtype)
        outs.append(o_my)
        lses.append(lse_my)
    out, lse = torch.cat(outs, 1), torch.cat(lses, 2)
    delta = torch.einsum("bshd,bshd->bhs", do.float(), out.float())
    grads = [torch.zeros(shape, dtype=torch.float32, device="cuda")
             for _ in range(3)]
    for my in range(n):
        rows = slice(my * s_local, (my + 1) * s_local)
        for t in range(n):
            src = (my - t) % n
            dq, dk, dv = fa.flash_attention_partial_grads(
                blk(q, my), blk(k, src), blk(v, src), blk(do, my),
                lse[..., rows], delta[..., rows], my * s_local, src * s_local)
            blk(grads[0], my).add_(dq.float())
            blk(grads[1], src).add_(dk.float())
            blk(grads[2], src).add_(dv.float())
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the hop path ends here
    ref_o, ref_lse = fa.flash_attention_fwd(q, k, v)
    ref_grads = fa.flash_attention_bwd(q, k, v, ref_o, ref_lse, do)
    err_o = (out.float() - ref_o.float()).abs().max().item()
    err_lse = (lse.reshape(ref_lse.shape) - ref_lse).abs().max().item()
    errs = {name: _max_err(g, r)[1]
            for name, g, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
    pairs = n * n
    row = {"phase": "ring_hops", "shape": list(shape), "shards": n,
           "block_pairs": pairs, "max_err_o": err_o, "max_err_lse": err_lse,
           **{f"rel_err_{key}": e for key, e in errs.items()},
           "tol_o": TOL_O["bfloat16"], "tol_lse": TOL_LSE,
           "tol_grad_rel": TOL_RING_GRAD, "launches": launches}
    emit(row)
    if not (err_o <= TOL_O["bfloat16"] and err_lse <= TOL_LSE
            and all(e <= TOL_RING_GRAD for e in errs.values())
            and launches == {"fwd": 0, "dq": pairs, "dkv": pairs,
                             "partial": pairs}):
        raise AssertionError(f"ring hops disagree with the one-shot "
                             f"kernels: {row}")
    del q, k, v, do, out, grads, ref_o, ref_grads
    torch.cuda.empty_cache()
    return launches


def longctx_train_step_flops(cfg, batch: int) -> float:
    """Analytic matmul FLOPs of one long-context train step, as bench.py's
    longctx_train_step_flops counts them: the dense products and the
    causal half of attention's, on all S positions (the rolled loss
    trains every token), forward + backward = 3x the forward."""
    s = cfg.seq_len
    d, ff, v = cfg.d_model, cfg.d_ff, cfg.vocab
    per_token_layer = 2 * d * 3 * d + 2 * d * d + 2 * d * ff + 2 * ff * d
    per_layer_attn = 2 * batch * s * s * d
    fwd = (batch * s * (cfg.n_layers * per_token_layer + 2 * d * v)
           + cfg.n_layers * per_layer_attn)
    return 3.0 * fwd


def _longctx_inputs(torch, longctx, cfg, seed: int):
    params = longctx.init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (LONGCTX_BATCH, cfg.seq_len),
                           generator=gen, device="cuda")
    return params, tokens


def _ring_flash_counts(n: int) -> dict:
    """The launches of ``n`` one-shard ring_flash layers, forward and
    backward: one partial, one dQ and one dK/dV each, no forward."""
    return {"fwd": 0, "dq": n, "dkv": n, "partial": n}


def phase_longctx_grads(torch, fa, longctx, tree) -> None:
    cfg = longctx.LongContextConfig(**LONGCTX_MODEL)
    params, tokens = _longctx_inputs(torch, longctx, cfg, seed=0)
    before = _launch_counts(fa)
    loss, grads = tree.value_and_grad(longctx.loss_fn, params, tokens, cfg)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts(fa).items()}
    ref_loss, ref = tree.value_and_grad(
        longctx.loss_fn, params, tokens, replace(cfg, attention="ring"))
    leaves, worst, least = _grad_gaps(torch, params, grads, ref)
    row = {"phase": "longctx_grads", "config": LONGCTX_MODEL,
           "batch": LONGCTX_BATCH, "loss_flash": float(loss),
           "loss_dense": float(ref_loss),
           "loss_diff": float(loss) - float(ref_loss),
           "worst_rel_l2": worst["rel_l2"], "worst_rel_l2_leaf": worst["leaf"],
           "min_cosine": least["cosine"], "min_cosine_leaf": least["leaf"],
           "tol_loss": TOL_TRAIN_LOSS, "tol_rel_l2": TOL_GRAD_REL_L2,
           "min_cosine_bound": MIN_GRAD_COSINE, "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
           "leaves": leaves}
    emit(row)
    if not (all(x["finite"] for x in leaves)
            and abs(row["loss_diff"]) <= TOL_TRAIN_LOSS
            and worst["rel_l2"] <= TOL_GRAD_REL_L2
            and least["cosine"] >= MIN_GRAD_COSINE
            and launches == _ring_flash_counts(cfg.n_layers)):
        raise AssertionError(f"ring_flash and dense ring gradients "
                             f"disagree: {row}")
    del params, grads, ref
    torch.cuda.empty_cache()


def phase_longctx(torch, fa, longctx, card: str) -> dict:
    cfg = longctx.LongContextConfig(**LONGCTX_MODEL)
    params, tokens = _longctx_inputs(torch, longctx, cfg, seed=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    step = longctx.make_train_step(cfg)
    timing = _timed_steps(torch, lambda: step(params, tokens)[1],
                          LONGCTX_WARMUP, LONGCTX_CHUNKS, LONGCTX_CHUNK_STEPS)
    first_loss, last_loss = timing["loss_first"], timing["loss_last"]
    prof = profile_steps(torch, lambda: step(params, tokens),
                         LONGCTX_PROFILED)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    peak = torch.cuda.max_memory_allocated()
    run = LONGCTX_WARMUP + timing["steps"] + LONGCTX_PROFILED
    flops = longctx_train_step_flops(cfg, LONGCTX_BATCH)
    tflops = flops / (timing["step_ms"] / 1e3) / 1e12
    row = {"phase": "longctx", "config": LONGCTX_MODEL,
           "batch": LONGCTX_BATCH, "mesh": None, "card": card, **timing,
           "flops_per_step": flops, "tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
           "tokens_per_sec": LONGCTX_BATCH * cfg.seq_len
           / (timing["step_ms"] / 1e3),
           "launches": launches,
           "launches_expected": _ring_flash_counts(cfg.n_layers * run),
           "do_copies": fa.DO_COPIES,
           "max_memory_allocated_bytes": peak, "profile": prof}
    emit(row)
    if not (math.isfinite(first_loss) and math.isfinite(last_loss)
            and last_loss < first_loss
            and launches == _ring_flash_counts(cfg.n_layers * run)):
        raise AssertionError(f"longctx phase failed: {row}")

    # One step of each other strategy on the card, on the trained params.
    by_path = {"longctx": launches}
    expected = {"ulysses_flash": _burnin_counts(cfg.n_layers),
                "ring": _burnin_counts(0)}
    for attention, expect in expected.items():
        other = replace(cfg, attention=attention)
        torch.cuda.synchronize()
        _zero_launch_counts(fa)
        t0 = time.perf_counter()
        params, loss = longctx.make_train_step(other)(params, tokens)
        value = float(loss)
        ms = (time.perf_counter() - t0) * 1e3
        counts = _launch_counts(fa)
        row = {"phase": "longctx_strategy", "attention": attention,
               "loss": value, "step_ms_with_sync": ms, "launches": counts,
               "launches_expected": expect}
        emit(row)
        if not (math.isfinite(value) and counts == expect):
            raise AssertionError(f"longctx {attention} step failed: {row}")
        by_path[f"longctx_{attention}"] = counts
    del params
    torch.cuda.empty_cache()
    return by_path


def moe_train_step_flops(cfg, batch: int) -> float:
    """Analytic matmul FLOPs of one MoE train step, as bench.py's
    moe_train_step_flops counts them: the dense products, the router, the
    k routed experts a token is credited with (not the capacity-padded
    seats), the causal half of attention, on the seq_len - 1 positions
    the loss trains; forward + backward = 3x the forward."""
    s = cfg.seq_len - 1
    d, ff, v, k = cfg.d_model, cfg.d_ff, cfg.vocab, cfg.router_top_k
    per_token_layer = (2 * d * 3 * d + 2 * d * d + 2 * d * cfg.n_experts
                       + k * (2 * d * ff + 2 * ff * d))
    per_layer_attn = 2 * batch * s * s * d
    fwd = (batch * s * (cfg.n_layers * per_token_layer + 2 * d * v)
           + cfg.n_layers * per_layer_attn)
    return 3.0 * fwd


@contextmanager
def recorded_routing(pmoe):
    """Record the top-k choices of every MoE layer the block runs, in
    order (a list of [T, k] index tensors)."""
    top_k, calls = pmoe.top_k, []

    def recording(probs, k):
        values, idx = top_k(probs, k)
        calls.append(idx)
        return values, idx

    pmoe.top_k = recording
    try:
        yield calls
    finally:
        pmoe.top_k = top_k


@contextmanager
def pinned_routing(pmoe, calls):
    """Route every MoE layer the block runs by the recorded choices (the
    gates still come from this arm's own probabilities): a comparison of
    two attention paths without the routing flips between them."""
    top_k, replay = pmoe.top_k, iter(calls)

    def pinned(probs, k):
        idx = next(replay)
        return probs.gather(1, idx), idx

    pmoe.top_k = pinned
    try:
        yield
    finally:
        pmoe.top_k = top_k


def _moe_inputs(torch, moe, cfg, batch: int, seed: int):
    params = moe.init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                           device="cuda")
    return params, tokens


def _pinned_gaps(torch, params, grads, ref) -> dict:
    """The gradient gaps of a flash arm against a dense arm on the same
    routing: the least cosine of the non-expert and of the expert leaves,
    the largest rel L2, and whether each is in its bound."""
    leaves, worst, _ = _grad_gaps(torch, params, grads, ref)
    plain = [x for x in leaves if "expert" not in x["leaf"]]
    expert = [x for x in leaves if "expert" in x["leaf"]]
    least = min(plain, key=lambda x: x["cosine"])
    least_expert = min(expert, key=lambda x: x["cosine"])
    return {"min_cosine": least["cosine"], "min_cosine_leaf": least["leaf"],
            "min_expert_cosine": least_expert["cosine"],
            "min_expert_cosine_leaf": least_expert["leaf"],
            "worst_rel_l2": worst["rel_l2"],
            "worst_rel_l2_leaf": worst["leaf"],
            "ok": (all(x["finite"] for x in leaves)
                   and least["cosine"] >= MIN_GRAD_COSINE
                   and least_expert["cosine"] >= MIN_EXPERT_GRAD_COSINE
                   and worst["rel_l2"] <= TOL_GRAD_REL_L2)}


def phase_moe_grads(torch, fa, moe, pmoe, tree) -> None:
    """MOE_MODEL at batch 8: the loss and gradients with attention="flash"
    against the dense path. The free arms give the loss and the share of
    tokens whose top-1 expert differs; the gradients are held on a dense
    arm routed as the flash arm was (see MIN_EXPERT_GRAD_COSINE)."""
    cfg = moe.MoEConfig(**MOE_MODEL)
    dense = replace(cfg, attention="xla")
    params, tokens = _moe_inputs(torch, moe, cfg, MOE_BATCH, seed=0)
    before = _launch_counts(fa)
    with recorded_routing(pmoe) as flash_routes:
        loss, grads = tree.value_and_grad(moe.loss_fn, params, tokens, cfg)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts(fa).items()}
    with recorded_routing(pmoe) as dense_routes:
        free_loss, free = tree.value_and_grad(moe.loss_fn, params, tokens,
                                              dense)
    flips = [float((a[:, 0] != b[:, 0]).float().mean())
             for a, b in zip(flash_routes, dense_routes)]
    _, free_worst, free_least = _grad_gaps(torch, params, grads, free)
    del free
    with pinned_routing(pmoe, flash_routes):
        pinned_loss, pinned = tree.value_and_grad(moe.loss_fn, params,
                                                  tokens, dense)
    gaps = _pinned_gaps(torch, params, grads, pinned)
    row = {"phase": "moe_grads", "config": MOE_MODEL, "batch": MOE_BATCH,
           "loss_flash": float(loss), "loss_dense": float(free_loss),
           "loss_diff": float(loss) - float(free_loss),
           "loss_dense_pinned": float(pinned_loss),
           "top1_flip_share_by_layer": flips,
           "top1_flip_share": sum(flips) / len(flips),
           "free_min_cosine": free_least["cosine"],
           "free_min_cosine_leaf": free_least["leaf"],
           "free_worst_rel_l2": free_worst["rel_l2"],
           "pinned": gaps, "tol_loss": TOL_TRAIN_LOSS,
           "min_cosine_bound": MIN_GRAD_COSINE,
           "min_expert_cosine_bound": MIN_EXPERT_GRAD_COSINE,
           "tol_rel_l2": TOL_GRAD_REL_L2, "launches": launches,
           "max_memory_allocated_bytes": torch.cuda.max_memory_allocated()}
    emit(row)
    if not (math.isfinite(row["loss_flash"])
            and abs(row["loss_diff"]) <= TOL_TRAIN_LOSS and gaps["ok"]
            and launches == _burnin_counts(cfg.n_layers)):
        raise AssertionError(f"flash and dense MoE gradients disagree: "
                             f"{row}")
    del params, grads, pinned
    torch.cuda.empty_cache()


def phase_moe_default(torch, fa, moe, pmoe, tree) -> dict:
    """MoEConfig() as the JAX package defines it, at attention="flash"
    (head_dim 32) on the card: its loss and gradients against the dense
    path on the same routing, then one train step."""
    cfg = moe.MoEConfig(attention="flash")
    dense = replace(cfg, attention="xla")
    params, tokens = _moe_inputs(torch, moe, cfg, MOE_DEFAULT_BATCH, seed=4)
    torch.cuda.synchronize()
    _zero_launch_counts(fa)              # ---- the path starts here
    with recorded_routing(pmoe) as routes:
        loss, grads = tree.value_and_grad(moe.loss_fn, params, tokens, cfg)
    params, step_loss = moe.make_train_step(cfg)(params, tokens)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the path ends here
    with pinned_routing(pmoe, routes):
        ref_loss, ref = tree.value_and_grad(
            moe.loss_fn, moe.init_params(cfg, seed=4, device="cuda"),
            tokens, dense)
    gaps = _pinned_gaps(torch, params, grads, ref)
    row = {"phase": "moe_default", "config": "MoEConfig(attention='flash')",
           "head_dim": cfg.head_dim, "batch": MOE_DEFAULT_BATCH,
           "loss_flash": float(loss), "loss_dense_pinned": float(ref_loss),
           "loss_diff": float(loss) - float(ref_loss),
           "step_loss": float(step_loss), "pinned": gaps,
           "params_finite": all(bool(torch.isfinite(t).all())
                                for t in tree.leaves(params)),
           "launches": launches,
           "launches_expected": _burnin_counts(2 * cfg.n_layers)}
    emit(row)
    if not (abs(row["loss_diff"]) <= TOL_TRAIN_LOSS and gaps["ok"]
            and row["step_loss"] == row["loss_flash"]
            and row["params_finite"]
            and launches == _burnin_counts(2 * cfg.n_layers)):
        raise AssertionError(f"moe_default phase failed: {row}")
    del params, grads, ref
    torch.cuda.empty_cache()
    return launches


def phase_moe(torch, fa, moe, card: str) -> dict:
    """The MoE main path, as bench.py's _family_bench runs it on one chip:
    ``moe.make_train_step`` at MOE_MODEL, batch 8, mesh=None, timed as
    phase_train times its step, then 3 profiled steps with the MoE layer's
    stages booked apart."""
    cfg = moe.MoEConfig(**MOE_MODEL)
    params, tokens = _moe_inputs(torch, moe, cfg, MOE_BATCH, seed=5)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    step = moe.make_train_step(cfg)
    timing = _timed_steps(torch, lambda: step(params, tokens)[1],
                          MOE_WARMUP, MOE_CHUNKS, MOE_CHUNK_STEPS)
    first_loss, last_loss = timing["loss_first"], timing["loss_last"]
    peak = torch.cuda.max_memory_allocated()
    prof = profile_steps(torch, lambda: step(params, tokens), MOE_PROFILED,
                         moe_stages=True)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    run = MOE_WARMUP + timing["steps"] + MOE_PROFILED
    flops = moe_train_step_flops(cfg, MOE_BATCH)
    tflops = flops / (timing["step_ms"] / 1e3) / 1e12
    row = {"phase": "moe", "config": MOE_MODEL, "batch": MOE_BATCH,
           "mesh": None, "card": card, **timing,
           "flops_per_step": flops, "tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
           "tokens_per_sec": MOE_BATCH * (cfg.seq_len - 1)
           / (timing["step_ms"] / 1e3),
           "launches": launches,
           "launches_expected": _burnin_counts(cfg.n_layers * run),
           "do_copies": fa.DO_COPIES,
           "max_memory_allocated_bytes": peak, "profile": prof}
    emit(row)
    if not (math.isfinite(first_loss) and math.isfinite(last_loss)
            and last_loss < first_loss
            and launches == _burnin_counts(cfg.n_layers * run)):
        raise AssertionError(f"moe phase failed: {row}")
    del params
    torch.cuda.empty_cache()
    return launches


def _pp_inputs(torch, pipelined, cfg, seed: int):
    params = pipelined.init_params(cfg, seed=seed, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (PP_BATCH, cfg.seq_len),
                           generator=gen, device="cuda")
    return params, tokens


def phase_pipelined_grads(torch, fa, pipelined, tree) -> None:
    """PP_MODEL at batch 8, one card: the loss and every gradient leaf of
    attention="flash" against the dense path on the same seeded params
    and tokens; then the loss and every gradient leaf of the
    force_schedule path against the fused path's, beside a control: the
    fused gradients with the last microbatch's tokens swapped for the
    first's."""
    cfg = pipelined.PipelinedConfig(**PP_MODEL)
    params, tokens = _pp_inputs(torch, pipelined, cfg, seed=0)
    before = _launch_counts(fa)
    loss, grads = tree.value_and_grad(pipelined.loss_fn, params, tokens, cfg)
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in _launch_counts(fa).items()}
    ref_loss, ref = tree.value_and_grad(pipelined.loss_fn, params, tokens,
                                        replace(cfg, attention="xla"))
    leaves, worst, least = _grad_gaps(torch, params, grads, ref)
    del ref
    schedule_loss, schedule = tree.value_and_grad(
        partial(pipelined.loss_fn, force_schedule=True), params, tokens, cfg)
    schedule_leaves, schedule_worst, _ = _grad_gaps(torch, params, schedule,
                                                    grads)
    del schedule
    micro = PP_BATCH // cfg.n_micro
    swapped = tokens.clone()
    swapped[-micro:] = tokens[:micro]
    _, control = tree.value_and_grad(pipelined.loss_fn, params, swapped, cfg)
    control_leaves, _, _ = _grad_gaps(torch, params, control, grads)
    control_least = min(x["rel_l2"] for x in control_leaves)
    del grads, control
    row = {"phase": "pipelined_grads", "config": PP_MODEL,
           "batch": PP_BATCH, "mesh": None, "loss_flash": float(loss),
           "loss_dense": float(ref_loss),
           "loss_diff": float(loss) - float(ref_loss),
           "worst_rel_l2": worst["rel_l2"], "worst_rel_l2_leaf": worst["leaf"],
           "min_cosine": least["cosine"], "min_cosine_leaf": least["leaf"],
           "loss_schedule": float(schedule_loss),
           "schedule_loss_diff": float(schedule_loss) - float(loss),
           "schedule_worst_rel_l2": schedule_worst["rel_l2"],
           "schedule_worst_rel_l2_leaf": schedule_worst["leaf"],
           "control_least_rel_l2": control_least,
           "tol_loss": TOL_TRAIN_LOSS, "tol_rel_l2": TOL_GRAD_REL_L2,
           "min_cosine_bound": MIN_GRAD_COSINE,
           "tol_schedule_loss": TOL_SCHEDULE_LOSS,
           "tol_schedule_rel_l2": TOL_SCHEDULE_GRAD_REL_L2,
           "launches": launches, "leaves": leaves,
           "schedule_leaves": schedule_leaves}
    emit(row)
    if not (all(x["finite"] for x in leaves + schedule_leaves)
            and abs(row["loss_diff"]) <= TOL_TRAIN_LOSS
            and worst["rel_l2"] <= TOL_GRAD_REL_L2
            and least["cosine"] >= MIN_GRAD_COSINE
            and abs(row["schedule_loss_diff"]) <= TOL_SCHEDULE_LOSS
            and schedule_worst["rel_l2"] <= TOL_SCHEDULE_GRAD_REL_L2
            and control_least > TOL_SCHEDULE_GRAD_REL_L2
            and launches == _burnin_counts(cfg.n_layers)):
        raise AssertionError(f"pipelined_grads phase failed: {row}")
    del params
    torch.cuda.empty_cache()


def phase_pipelined(torch, fa, pipelined, card: str,
                    force_schedule: bool) -> dict:
    """A pipelined main path, as bench.py's _family_bench runs it on one
    chip: ``pipelined.make_train_step`` at PP_MODEL, batch 8, mesh=None,
    fused (``force_schedule=False``) or through the GPipe ticks; timed as
    phase_moe times its step, then 3 profiled steps."""
    name = "pipelined_schedule" if force_schedule else "pipelined"
    cfg = pipelined.PipelinedConfig(**PP_MODEL)
    params, tokens = _pp_inputs(torch, pipelined, cfg, seed=7)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    step = pipelined.make_train_step(cfg, force_schedule=force_schedule)
    timing = _timed_steps(torch, lambda: step(params, tokens)[1], PP_WARMUP,
                          PP_CHUNKS, PP_CHUNK_STEPS)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_steps(torch, lambda: step(params, tokens), PP_PROFILED)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    run = PP_WARMUP + timing["steps"] + PP_PROFILED
    per_step = cfg.n_layers * (cfg.n_micro if force_schedule else 1)
    flops = train_step_flops(cfg, PP_BATCH)
    tflops = flops / (timing["step_ms"] / 1e3) / 1e12
    row = {"phase": name, "config": PP_MODEL, "batch": PP_BATCH,
           "mesh": None, "force_schedule": force_schedule, "card": card,
           **timing, "flops_per_step": flops, "tflops": tflops,
           "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12,
           "tokens_per_sec": PP_BATCH * (cfg.seq_len - 1)
           / (timing["step_ms"] / 1e3),
           "launches": launches,
           "launches_expected": _burnin_counts(per_step * run),
           "do_copies": fa.DO_COPIES,
           "max_memory_allocated_bytes": peak, "profile": prof}
    emit(row)
    if not (math.isfinite(timing["loss_first"])
            and math.isfinite(timing["loss_last"])
            and timing["loss_last"] < timing["loss_first"]
            and fa.DO_COPIES == 0
            and launches == _burnin_counts(per_step * run)):
        raise AssertionError(f"{name} phase failed: {row}")
    del params
    torch.cuda.empty_cache()
    return launches


def _vision_logit_gaps(torch, vision, tree, cfg, params, images) -> dict:
    """Rel L2 (and largest gap over the largest logit) of the bf16
    forward's logits against an f32 forward's, and of two f32 forwards
    with a fault (a control each) against the same."""
    f32 = replace(cfg, dtype="float32")

    def gaps(logits):
        return ((logits - ref).norm() / ref.norm()).item(), (
            (logits - ref).abs().max() / ref.abs().max()).item()

    with torch.no_grad():
        ref = vision.forward(params, images, f32)
        bf16_l2, bf16_max = gaps(vision.forward(params, images, cfg))
        swapped = tree.map_params(
            lambda p: p.transpose(0, 1) if p.dim() == 4 else p, params)
        controls = {"conv_kernels_transposed": gaps(
            vision.forward(swapped, images, f32))[0]}
        same_pads = vision._same_pads
        vision._same_pads = lambda size, k, stride: (k // 2, k // 2)
        try:
            controls["symmetric_padding"] = gaps(
                vision.forward(params, images, f32))[0]
        finally:
            vision._same_pads = same_pads
    return {"bf16_rel_l2": bf16_l2, "bf16_max_gap_over_max_logit": bf16_max,
            "control_rel_l2": controls}


def phase_vision(torch, fa, vision, tree, card: str) -> dict:
    """The vision main path, as bench.py's _family_bench runs it:
    ``vision.make_train_step`` at VisionConfig(), batch 256, bf16; the
    bf16 logits against an f32 forward's on the same weights, beside two
    f32 forwards with a fault (see TOL_VISION_LOGITS_REL_L2); timed as
    phase_moe times its step, then 3 profiled steps; TFLOP/s from the
    port's analytic conv count. The path runs no attention kernel."""
    cfg = vision.VisionConfig()
    params = vision.init_params(cfg, seed=9, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(10)
    images = torch.randn(
        (VISION_BATCH, cfg.image_size, cfg.image_size, cfg.channels),
        generator=gen, device="cuda").to(torch.bfloat16)
    labels = torch.randint(0, cfg.num_classes, (VISION_BATCH,),
                           generator=gen, device="cuda")
    batch = (images, labels)
    logit_gaps = _vision_logit_gaps(torch, vision, tree, cfg, params, images)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts(fa)              # ---- the main path starts here
    step = vision.make_train_step(cfg)
    timing = _timed_steps(torch, lambda: step(params, batch)[1],
                          VISION_WARMUP, VISION_CHUNKS, VISION_CHUNK_STEPS)
    peak = torch.cuda.max_memory_allocated()
    prof = profile_steps(torch, lambda: step(params, batch), VISION_PROFILED)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    flops = 3.0 * vision.forward_flops(cfg) * VISION_BATCH
    tflops = flops / (timing["step_ms"] / 1e3) / 1e12
    row = {"phase": "vision", "config": "VisionConfig()",
           "batch": VISION_BATCH, "dtype": cfg.dtype, "card": card,
           **timing, **logit_gaps,
           "tol_logits_rel_l2": TOL_VISION_LOGITS_REL_L2,
           "images_per_sec": VISION_BATCH / (timing["step_ms"] / 1e3),
           "forward_flops_per_image": vision.forward_flops(cfg),
           "flops_per_step": flops, "flops_source": "analytic",
           "tflops": tflops, "mfu": tflops * 1e12 / PEAK_BF16_FLOPS,
           "peak_bf16_tflops": PEAK_BF16_FLOPS / 1e12, "launches": launches,
           "max_memory_allocated_bytes": peak, "profile": prof}
    emit(row)
    if not (math.isfinite(timing["loss_first"])
            and math.isfinite(timing["loss_last"])
            and timing["loss_last"] < timing["loss_first"]
            and logit_gaps["bf16_rel_l2"] <= TOL_VISION_LOGITS_REL_L2
            and min(logit_gaps["control_rel_l2"].values())
            > TOL_VISION_LOGITS_REL_L2
            and launches == _burnin_counts(0)):
        raise AssertionError(f"vision phase failed: {row}")
    del params, images, labels, batch   # free the card for the next family
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch import entry, telemetry
    from kubeflow_tpu_torch.models import (burnin, longctx, moe, pipelined,
                                           trainer, tree, vision)
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.parallel import launch
    from kubeflow_tpu_torch.parallel import mesh as pmesh
    from kubeflow_tpu_torch.parallel import moe as pmoe
    from kubeflow_tpu_torch.parallel import ring
    from kubeflow_tpu_torch.serving import engine as engine_mod
    from kubeflow_tpu_torch.serving import loadgen

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    t0 = time.perf_counter()
    compiled = _build.build()
    emit({"phase": "build", "sources": _build.sources(), "compiled": compiled,
          "build_sec": time.perf_counter() - t0,
          "sass": {src: sass_counts(_build.library_path(src))
                   for src in (fa.SOURCE, fa.BWD_SOURCE, fa.WIDE_SOURCE)},
          "sass_wide_by_kernel": sass_counts(
              _build.library_path(fa.WIDE_SOURCE), by_kernel=True),
          "ptxas": [line.strip() for log in _build.BUILD_LOG.values()
                    for line in log.splitlines()
                    if "registers" in line or "spill" in line
                    or "entry function" in line or "C75" in line]})

    kernels = phase_kernels(torch, fa)
    bwd_rows = phase_bwd_kernels(torch, fa)
    bwd = bwd_rows["train"]
    head_dims = phase_head_dims(torch, fa)
    other_dims, dims_timed = head_dims["max_abs_err"], head_dims["timed"]
    phase_model(torch, fa, burnin)
    phase_train_grads(torch, fa, burnin)
    train = phase_train(torch, fa, burnin, card)
    by_path = {"train": train["launches"]}
    with world_of_one(torch):
        by_path["serving"] = {"fwd": phase_serving(
            torch, fa, burnin, engine_mod, loadgen)["launches"]}
        by_path["sharded"] = phase_sharded(torch, fa, burnin, tree, pmesh)
        phase_dryrun(torch, entry)
    by_path["trainer"] = phase_trainer(torch, fa, burnin, trainer,
                                       telemetry)
    partial = phase_partial_kernels(torch, fa)
    by_path["ring_hops"] = phase_ring_hops(torch, fa, ring)
    phase_longctx_grads(torch, fa, longctx, tree)
    by_path.update(phase_longctx(torch, fa, longctx, card))
    phase_moe_grads(torch, fa, moe, pmoe, tree)
    by_path["moe_default"] = phase_moe_default(torch, fa, moe, pmoe, tree)
    by_path["moe"] = phase_moe(torch, fa, moe, card)
    by_path["vision"] = phase_vision(torch, fa, vision, tree, card)
    phase_pipelined_grads(torch, fa, pipelined, tree)
    by_path["pipelined"] = phase_pipelined(torch, fa, pipelined, card, False)
    by_path["pipelined_schedule"] = phase_pipelined(torch, fa, pipelined,
                                                    card, True)
    by_path["wide_heads"] = phase_wide_heads(torch, fa, burnin, card)
    by_path.update(phase_worlds(torch, burnin, tree, engine_mod, launch))

    def launches(kernel):
        return {path: counts.get(kernel, 0)
                for path, counts in by_path.items()}

    decode = kernels["decode"]
    hop = partial["one_card_hop"]
    timed = ("ms", "profiler_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "bound_share", "tflops")
    kernel_timed = ("ms", "profiler_ms", "plain_ms", "bound_ms", "bound_by",
                    "bound_share", "tflops")
    library_timed = ("library_ms", "library_profiler_ms", "library_backend")

    def device_kernels(name: str, wide: str) -> dict:
        """The CUDA kernels behind one entry, by head dim and dtype."""
        return {"d <= 128": name, "bf16 136-256": f"wide_{name}",
                "f32 > 128, bf16 > 256": wide,
                "wide_source": "kubeflow_tpu_torch/ops/csrc/"
                               "flash_attention_wide.cu"}

    emit({"kernels": [
        {"name": "flash_attention_fwd", "route": "cuda",
         "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
         "replaces": "kubeflow_tpu/ops/flash_attention.py:67",
         "launches": sum(launches("fwd").values()),
         "launches_by_path": launches("fwd"),
         "max_abs_err": max([row["max_err_o"] for row in kernels.values()]
                            + [other_dims["fwd"]]),
         "max_err_o": max(row["max_err_o"] for row in kernels.values()),
         "max_err_o_other_head_dims": other_dims["fwd"],
         "max_err_lse": max(row["max_err_lse"] for row in kernels.values()),
         **{key: decode[key] for key in timed},
         "at": {**{name: {key: kernels[name][key] for key in timed}
                   for name in TIMED_KERNEL_CASES},
                **{name: {key: row[f"fwd_{key}"] for key in timed}
                   for name, row in dims_timed.items()}},
         "tensor_map_encode_us": decode["tensor_map_encode_us"],
         "device_kernels": device_kernels("fwd_bf16_kernel",
                                          "wide_fwd_kernel")},
        *({"name": f"flash_attention_bwd_{key}", "route": "cuda",
           "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_bwd.cu",
           "replaces": f"kubeflow_tpu/ops/flash_attention.py:{line}",
           "launches": sum(launches(key).values()),
           "launches_by_path": launches(key),
           "max_abs_err": max([row[f"max_err_{out}"]
                               for row in bwd_rows.values() for out in outs]
                              + [other_dims[key]]),
           "max_abs_err_other_head_dims": other_dims[key],
           "max_rel_err": max(row[f"rel_err_{out}"]
                              for row in bwd_rows.values() for out in outs),
           **{k: bwd[f"{key}_{k}"] for k in kernel_timed},
           **{k: bwd[k] for k in library_timed},
           "at": {case: {**{k: row[f"{key}_{k}"] for k in kernel_timed},
                         **{k: row[k] for k in library_timed}}
                  for case, row in [*((c, bwd_rows[c])
                                      for c in TIMED_BWD_CASES),
                                    *dims_timed.items()]},
           "library_call": "F.scaled_dot_product_attention backward "
                           "(dq, dk, dv together)",
           "device_kernels": device_kernels(f"{key}_bf16_kernel",
                                            f"wide_{key}_kernel")}
          for key, line, outs in (("dq", 167, ("dq",)),
                                  ("dkv", 195, ("dk", "dv")))),
        {"name": "flash_attention_partial", "route": "cuda",
         "source": "kubeflow_tpu_torch/ops/csrc/flash_attention_fwd.cu",
         "replaces": "kubeflow_tpu/ops/flash_attention.py:375",
         "launches": sum(launches("partial").values()),
         "launches_by_path": launches("partial"),
         "max_abs_err": max([row["max_err_acc"] for row in partial.values()]
                            + [other_dims["partial"]]),
         "max_abs_err_other_head_dims": other_dims["partial"],
         "max_rel_err_acc": max(row["rel_err_acc"]
                                for row in partial.values()),
         "max_err_m": max(row["max_err_m"] for row in partial.values()),
         **{key: hop[key] for key in timed},
         "at": {**{name: {key: partial[name][key] for key in timed}
                   for name in TIMED_PARTIAL_CASES},
                **{name: {key: row[f"partial_{key}"] for key in timed}
                   for name, row in dims_timed.items()
                   if "partial_ms" in row}},
         "library_call": "F.scaled_dot_product_attention(is_causal=True): "
                         "the same products, normalized",
         "device_kernels": device_kernels("partial_bf16_kernel",
                                          "wide_fwd_kernel")}]})
    emit({"phase": "wall", "script_sec": time.perf_counter() - STARTED})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
