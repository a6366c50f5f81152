#!/usr/bin/env python3
"""Drive the PyTorch port's serving, sharded serving, training (with its
step telemetry, checkpoints, input pipeline and drain guard), sharded
training, long-context training, MoE, vision and pipelined training paths,
its slice burn-in (the probes and the kernel cache), its notebook
spawn path, its fleet scheduler and warm pods, its culling and serving
controllers, its controller manager and admission webhook as processes,
its web apps as a process, the control plane's chaos soak and load
test, the notebook's live profiler server and the conformance runner on
one NVIDIA GPU and hold its kernels against their plain versions.

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
   (``cuobjdump``), the wide library's also kernel by kernel; the library
   directory's entries before and after and ``note_compile``'s verdict.
   Then build_cache: a temporary kernel cache seeded from the build
   directory (``utils.compilecache``), ``_build`` pointed at it with
   ``nvcc`` made unreachable, ``build()`` compiling nothing (a hit), and
   the forward's library loaded from there and launched once at the
   decode shape against its plain version; the seed's seconds beside the
   cold build's. The build directory is restored.
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
   in bf16) and at 264, 832 and 1024 (256-column output slices: the
   sliced wgmma backward in bf16, the register-tiled pair in f32), bf16 and
   f32, causal and full, against their plain
   versions at the tolerances above, four cases also through qkv column
   slices (bitwise equal), and b*h = 66560 ([1040, 64, 64, 16]) in both
   dtypes; at d = 1024 the four column slices' outputs bitwise equal where the inputs' are
   (each slice computes the softmax statistics, slice 0 writes them); a
   bitwise repeat of the wgmma dQ and dK/dV at [8, 1024, 16, 256] and of
   the sliced pair at [8, 1024, 16, 320]; at
   training shapes of d = 32 [8, 1024, 64, 32], d = 20 [8, 1024, 64, 20]
   (with the padding copies timed apart) and d = 256 ([8, 1024, 16, 256],
   and the wide_heads step's [8, 1024, 8, 256]) the forward, dQ and dK/dV
   (at d = 256 also the partial, and the sliced dQ through the plan
   (0, 1) beside the wgmma one) timed beside their bounds, plain versions
   and SDPA; then the f32 route (the register-tiled forward and backward)
   at d = 32, 128 and 256 and the bf16 route above 256 at d = 320, each at
   [1, 1024, 8, d] and [8, 1024, 16, d], the forward, partial, dQ and
   dK/dV timed the same way.
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

28. checkpoint (run after trainer) — checkpoint, data and SDK:
   ``trainer.fit`` with ``TrainerConfig()`` (AdamW) at ``BENCH_MODEL``'s
   widths with 2 layers (a depth cut: 2.24 GB of params, mu and nu), batch
   8, fed by ``ShardedLoader -> prefetch -> global_batches``; each step's
   ``checkpoint_tree`` goes to a ``CheckpointGuard`` over a
   ``CheckpointFabric`` (remote and staging tiers) under a drain request
   and to a DCP ``CheckpointManager``, which both save at step 3 of 5.
   The ack must follow the snapshot and the commit mark the upload; each
   arm's restore onto ``abstract_state`` on the card, resumed to step 5,
   must be bitwise the straight run. Printed: the state's bytes, each
   arm's snapshot seconds and GB/s, commit and restore seconds and the
   tier that served the restore, the drain's ack latency and ack to
   commit mark, and the loader pipeline's step p50 beside pre-staged card
   batches; launches counted from zero over the straight run: one
   forward, one dQ and one dK/dV per layer and step. Then one step under
   ``sdk.trace`` must leave one ``torch.profiler`` trace file. The
   temporary directories are removed.

29. probe (inside the world of one, after dryrun) — the slice burn-in:
   ``run_ici_probe`` in the world of one over NCCL (no bytes cross a
   card: bandwidth None), ``python -m kubeflow_tpu_torch.probe
   --skip-dcn`` as a subprocess (an NCCL world of every card of the
   machine, which it starts itself; started with the script, beside the
   device line and the build, and waited for before the first timed
   phase), and the DCN ring of 2 ranks over loopback, scored against the
   A3 High estimate. Plumbing figures: no NVLink or NIC rate.
30. worlds_probe (the world of 4, after serving_sharded_world) — the
   all-reduce probe over the 4 processes that share the card over gloo
   on CUDA tensors, 64 MB, scored against a 4-card share: the same
   report on every rank, the fraction of peak equal to the bandwidth over
   the estimate. Through the host: no NVLink rate.
31. spawn (last) — the notebook spawn path on GPU nodes: the port's
   control plane (``testing.FakeKube``, ``webhooks.register_all``, the
   ``Manager`` with ``setup_notebook_controller`` and NetworkPolicies on,
   ``testing.PodSimulator``) renders three ``nvidia-h100-80gb``
   notebooks, ``1x1``, ``2x8`` and two slices of ``1x8``, each timed on
   the host's clock from its create to every pod Running, with its
   reconciles and API requests, its StatefulSets, selectors, card
   requests, node ranks and status held to ``gpu/topology.py``. Pod
   ``nb-0`` of the ``1x1`` notebook, its env as admission gave it (a
   one-node gang's ``PET_MASTER_ADDR`` is its own 127.0.0.1), runs
   ``python -m kubeflow_tpu_torch.probe --skip-dcn`` (an NCCL world of
   one, scored against the ``1x1`` estimate, inf) and a child that calls
   ``sdk.initialize_distributed()`` (at one card the SDK's no-op), forms
   the one-rank NCCL group at the env's rendezvous and all-reduces on
   the card; beside the probe, the ``2x8`` notebook's two pods' env
   (node 0's DNS name moved to 127.0.0.1: both run on this machine) runs
   two ``testing.distributed_worker`` processes over gloo, each of which
   must print ``PSUM_RESULT 3.0 NPROC 2``.
32. fleet (run right after checkpoint, whose straight run it reuses) —
   the fleet scheduler in GPU units, the profile controller's card quota
   and the warm pod pools. The control plane (``register_all``, the
   ``Manager`` with the notebook and profile controllers, a
   ``GpuFleetScheduler``, the ``PodSimulator``) runs on an event loop of
   its own thread; the card work stays on the main thread. (a)
   preempt-to-checkpoint on a fleet of one ``nvidia-h100-80gb:1x8`` node:
   a Profile with ``spec.gpuQuota: 8`` (its ResourceQuota must hold
   ``requests.nvidia.com/gpu: "8"``); notebook ``train`` (priority low)
   admitted, its pod's rendezvous its own 127.0.0.1; ``fit`` at
   ``CKPT_MODEL`` with a ``CheckpointGuard`` over a ``CheckpointFabric``
   whose ``fetch`` and ``patcher`` read and patch ``train``'s
   annotations; after step 1 notebook ``urgent`` (high) is created and
   must queue while the scheduler stamps a ``preempt:priority`` drain on
   ``train``; the guard saves at step 3 and acks; ``train`` must park
   (stop annotation, 0 replicas, cards released) and ``urgent`` admit
   with ``nvidia.com/gpu: "8"``; ``train`` restarted queues, ``urgent``
   deleted, ``train`` re-admitted with the restore path and step in its
   pod env, from which a restore onto ``abstract_state`` resumed to step
   5 must be bitwise the checkpoint phase's straight run. Host seconds
   from the waiter's creation to the drain request, the ack, the waiter's
   admission and the victim's re-admission; reconciles and API requests
   by verb. (b) the warm pod: ``KFTPU_WARM_POOLS`` with one ``1x1`` pod
   over a fleet of two ``1x1`` shares; the replenisher's slot pod's
   command and env (as the fake apiserver holds them) run as a process on
   the card, started beside the build with a fresh kernel cache seeded
   from the build directory; a ``1x1`` notebook of the pool's image must
   win the CAS claim on that pod; its annotations written to the
   process's downward-API file, the SDK's warm-idle shim must return the
   claim, and the same process launches the forward kernel at the decode
   shape against its plain version with no ``nvcc`` compile. Host
   seconds from the create to the claim and from the claim to the
   kernel's result. (c) on the host: a spot ``1x8`` node beside a
   reserved one, a revocation taint: the spot pool's gang drained with
   the spot-reclaim reason, released, re-queued at its priority and
   re-admitted when the taint clears, the ledger consistent after every
   arbitration pass. Launches: (a)'s one forward, dQ and dK/dV per layer
   and step, and (b)'s one forward.
33. serving_control (right after fleet) — the culling controller and the
   serving controller on the card, over the fake apiserver with the
   admission chain, a Profile with ``gpuQuota: 8``, and the notebook,
   profile, InferenceService and culling controllers sharing one GPU
   fleet scheduler (FLEET_SPEC, elastic on: the service's ``1x1``
   replica borrows the ``1x8`` node), their options read from the env
   (CULL_ENV: ``KFTPU_CULL_DRAIN`` on). (a) an InferenceService ``1x1``,
   ``minReplicas 0``, ``maxReplicas 2``, with the gateway's load stamped:
   replica 0 admitted through ``serving_admission``, ``svc-r0``
   requesting ``nvidia.com/gpu: "1"``, its pod Running; a process started
   with exactly that pod's env runs the ServingEngine at MODEL (cold start
   from a seed), scores one fixed prompt batch and serves a burst trace.
   (b) the last request backdated: the controller requests the park; the
   process parks its engine and snapshots the parked weights into a
   CheckpointFabric; the script acks with path, step and the request's
   echo; the controller keeps ``svc-r0`` at 0 replicas, releases the
   cards, stamps ``parked-at`` and a ``Parked`` Event with the step; the
   process commits and exits. (d) meanwhile, on the freed node, a
   ``1x8`` notebook whose in-pod CheckpointGuard runs ``fit`` at
   CULL_MODEL on the card; the scripted Jupyter server turns reachable
   with idle kernels an hour old: the culler must stamp
   ``last-activity``, request a ``cull`` drain, and on the guard's ack
   stop the notebook (0 replicas, cards released, checkpoint path and
   step kept, 8 cards on ``gpu_cards_idle_culled_total``), with no
   deadline fallback. (c) a new burst: replica 0 re-admitted with
   ``KFTPU_RESTORE_CHECKPOINT_PATH`` / ``KFTPU_RESTORE_STEP`` naming the
   fabric's directory and the acked step in its pod env; a second
   process started with that env alone restores the weights through the
   engine's parked state (no init): its fixed-batch logits must be
   bitwise the first process's, and it serves the same trace. The
   service is deleted and the ledger must be empty with 0 violations.
   Host seconds for every mark, the processes' cold start, restore and
   commit seconds, reconciles by controller and API requests by verb.
   Launches: each process's (read in the process: per layer, two warm-up
   scores, the fixed batch, every decode step and prefill chunk) and the
   trainer's forward, dQ and dK/dV per layer and step.
34. entrypoints (right after serving_control) — the port outside the
   tests: the fake apiserver (``FakeKube`` with ``register_all`` and the
   ``PodSimulator``, one ``a3`` node) served over HTTP on 127.0.0.1:8001,
   ``HttpKube``'s fallback, by ``ApiFacade`` (the script's scaffolding,
   not a module of the package; a port in use fails the phase), and both
   entry points started as processes: ``python -m
   kubeflow_tpu_torch.cmd.controller_manager`` (``KFTPU_FLEET`` =
   FLEET_SPEC) and ``python -m kubeflow_tpu_torch.cmd.webhook`` over TLS
   with a self-signed ``openssl`` pair for 127.0.0.1 (no plaintext
   fallback). (a) the manager's ``/readyz`` and every informer of
   ``/debug/informers`` synced; a Profile with ``gpuQuota: 8``, a
   ReadWriteOnce PVC ``logs``, a PodDefault setting
   ``KFTPU_TELEMETRY_LOGDIR`` to a run on the claim's mount, and a ``1x1``
   notebook ``nb`` mounting ``logs``: ``nb-0`` Running on the node with
   ``nvidia.com/gpu: "1"``. (b) ``make_train_step`` at TRAIN_MODEL, one
   warm-up step, then 2 steps under ``sdk.capture_profile`` into the
   pod's logdir mapped onto a temporary directory standing for the
   claim; a Tensorboard ``pvc://logs/run1`` with ``profilerPlugin`` (and
   one with an empty logspath, refused ``Invalid``): the manager's
   Deployment (``--logdir=/tensorboard_logs/run1``,
   ``--reload_multifile=true``, the claim read-only, pinned to ``nb-0``'s
   node), Service 80 → 6006 and status Available; the served directory
   holds one ``*.pt.trace.json`` whose kernel events name the forward,
   dQ and dK/dV kernels once per layer and traced step; a PVCViewer on
   ``logs`` defaulted, rendered and ready. (c) AdmissionReviews over
   HTTPS: ``nb-0``'s pod from its StatefulSet's template patched exactly
   as the in-process chain admitted it (the PodDefault's env,
   ``TPU_WORKER_ID``, ``PET_NODE_RANK``, the rendezvous), the PVCViewer
   defaulted as in (b), a Tensorboard allowed and one denied, a body
   that is no object refused (HTTP 400), a ``spec.tpu`` and an
   over-quota ``2x8`` notebook denied, a v1beta1 Notebook converted to
   v1, ``webhook_admission_total`` by path and outcome, one admission
   trace a review; then a process started with the patched pod's env
   calls ``sdk.initialize_distributed()`` (a no-op at one card) and
   launches the forward kernel at the decode shape against its plain
   version. Both entry points must run until the script stops them
   (SIGTERM). Host seconds: each process's start to its first answer,
   the notebook's create to Running, the Tensorboard's create to Ready,
   the wire admissions' p50 and maximum, the pod process's start to the
   kernel's result; the facade's requests by verb. Launches: (b)'s
   forward, dQ and dK/dV per layer and traced step, and the pod
   process's one forward.
35. webapps (right after entrypoints) — the web apps as a process: the
   facade, the manager and the webhook as in entrypoints, but the facade
   admits nothing itself: every admission of the kinds in
   manifests/base/webhook.yaml goes to the webhook process as an
   AdmissionReview over TLS (WEBHOOK_PATHS), and SubjectAccessReviews
   are answered from the RoleBindings (``testing.rbac``); ``python -m
   kubeflow_tpu_torch.cmd.webapp`` with ``WEBAPP=all`` on a free port,
   ``PROMETHEUS_URL`` at a Prometheus stub on 127.0.0.1, reached over
   HTTP as the Profile's owner with the CSRF cookie and header as the
   SPAs send them. (a) ``/healthz``; the JWA's ``/api/config`` and
   ``/api/gpus`` list ``nvidia-h100-80gb`` with ``1x1`` to ``64x8``. (b)
   the spawner form with ``gpu: {nvidia-h100-80gb, 1x1}`` and a
   ReadWriteOnce workspace: the webhook admits the Notebook and its pod,
   the manager renders it, ``nb-0`` Running; the JWA's row ready with
   the "Running" message ``process_status`` gives; ``gpu-usage`` 1 card
   against the quota of 8. (c) a process started with ``nb-0``'s env runs
   ``sdk.initialize_distributed()`` and one forward at MODEL through the
   flash forward kernel, held to the dense forward at the model phase's
   tolerances, then 40 more timed, while ``nvidia-smi`` reads the card's
   utilization every 0.1 s. (d) the stub answers the dashboard's
   ``gpu_duty`` query with those readings: the series must show one
   above 0. (e) a Tensorboard over the workspace claim through the
   Tensorboards app, Ready; the claim listed by the Volumes app and a
   PVCViewer on it, ready; a contributor added through KFAM, listed by
   the dashboard. (f) a ``2x8`` form (16 cards against 8): a 4xx whose
   message is the webhook's ``gpuQuota`` refusal, no Notebook and no
   claim left. All three processes must run until the script stops
   them. Host seconds: the web apps' start to ``/healthz``, the form's
   POST to ``nb-0`` Running and to the row listed ready, the list's p50
   over 20 requests, the pod process's start to the forward's result;
   the forward's ms (CUDA events); admissions by path and outcome.
   Launches: the pod process's forward, one per layer.
36. chaos (right after webapps) — the control plane's harnesses
   (``testing.chaos``, ``testing.loadtest``). (a) tests/test_chaos.py's
   seed 0 at its own shape (3 rounds, 0.5 s storms) with
   ``ChaosSoak(..., device="cuda")``: every drain ack's ``save_async``
   snapshots a step tree on the card under the API and storage fault
   storm, with the manager killed and rebuilt each round, and every
   restore the soak checks is compared bit for bit on the card; held to
   that test's assertions (ok, no ledger violation, 3 restarts, faults
   and storage faults injected, commits and checked restores, spot
   revocations, scale-up answers, every lifecycle timeline continuous)
   and to every save's tree and every checked restore's comparison being
   on the card. (b) the notebook load test over ``HttpKube`` against the
   facade, the manager and the webhook as processes as in webapps (every
   admission an AdmissionReview to the webhook process): a Profile
   ``loadtest`` with ``gpuQuota`` 64 over a fleet of eight simulated A3
   nodes as 64 ``1x1`` shares (LOAD_FLEET_SPEC), one ``1x1`` notebook a
   card, all Ready with no failure, the CRs deleted after; the report's
   p50, p95 and wall seconds on the host clock. Launches no kernel.
37. profiler_server (right after train) — the notebook's live profiler
   server, in a notebook process of its own (``profiler_notebook``), so
   that its first capture starts CUPTI as a user's first click does:
   ``sdk.start_profiler_server`` on a free port (the card's
   ``torch.profiler`` behind TensorBoard's capture button), then
   ``make_train_step`` at TRAIN_MODEL in the main thread, one host sync a
   step, PROFILER_BASELINE_STEPS of them timed, then two clicks: each
   time another thread captures PROFILER_CAPTURE_MS through
   ``testing.profiler_client`` (xprof's request, over the package's own
   HTTP/2 and gRPC) while the loop runs on, and in the second click a
   third thread sends a second ``Profile`` while the first records,
   which must be refused (INTERNAL, "Another profiling session
   active."). Each ``.xplane.pb`` is decoded with ``profiler.wire``: a
   ``/device:GPU:0`` plane with events of each of ``fwd_bf16_kernel``,
   ``dq_bf16_kernel`` and ``dkv_bf16_kernel``, whose counts agree within
   one step's launches a layer, every device event inside the session's
   window (its ``Task Environment`` plane), and each of those kernels'
   events correlated with a CUDA runtime launch on the host plane (the
   main thread's: recorded by CUPTI from the server's session).
   Launches: one forward, one dQ and one dK/dV a layer and step of the
   clicks. The row prints, a click, the call's seconds, the wait until
   the first device event, each kernel's events and device ms, the
   file's bytes, and the step ms (median, longest) inside the recording
   and in the rest of the call against the baseline's, with the
   recording's ratio; and the phase's seconds.
38. conformance (right after chaos) — the port's conformance runner as
   an operator runs it, ``python -m kubeflow_tpu_torch.conformance.run``
   in a child process: (a) hermetic (the in-process fake apiserver,
   controllers and kubelet simulator), every one of the 20 checks run and
   passed; (b) ``--live`` over ``HttpKube`` against the facade with the
   manager and the webhook as processes as in webapps (every admission
   an AdmissionReview to the webhook process; the runner's fixed 2.0 s
   settle), every check passed but the nine the reference's runner skips
   in live mode, which must be exactly those skipped. In both, the
   pipeline-parallel step runs the pipelined dp x pp x tp train step in
   a world of 8 processes on the card (over NCCL with 8 cards, else gloo
   with every process on the one card), its line printed on its own with
   its world, backend and device, which must be ``cuda``. Each leg's
   seconds and the phase's. Launches no kernel (the step's attention is
   the reference's default, the dense one).
Then the ``{"kernels": [...]}`` line (each kernel's times at the main
path's shape, with ``bound_share`` = bound_ms / ms and ``tflops``, ``at``
every timed shape, the d = 32 and d = 256 ones included,
``launches_by_path`` with ``moe``, ``vision``, ``pipelined``,
``pipelined_schedule``, ``wide_heads``, ``sharded``, ``checkpoint``,
``fleet``, ``serving_control``, ``entrypoints``, ``webapps``,
``profiler_server``, and ``sharded_grads`` and ``serving_sharded_world`` (each summed over
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
from types import SimpleNamespace

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

# The slice burn-in's probes: the node type they score against (A3 High),
# the all-reduce's and the loopback ring's size, and the probe in the world
# of 4 processes that share the card (scored against a 4-card share).
PROBE_ACCELERATOR = "nvidia-h100-80gb"
PROBE_MBYTES = 64.0
WORLD_PROBE_MBYTES = 64.0
WORLD_PROBE_ITERS = 5
WORLD_PROBE_SHAPE = "1x4"

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
# The checkpoint phase: TRAIN_MODEL's widths at 2 layers (a depth cut: the
# AdamW state is then ~186 M parameters, 2.2 GB of f32 params, mu and nu,
# written twice by the fabric and once by DCP), AdamW through fit, a save
# at step CKPT_AT of CKPT_STEPS, then CKPT_TIMED steps of the loader
# pipeline and CKPT_TIMED of pre-staged card batches.
CKPT_MODEL = dict(TRAIN_MODEL, n_layers=2)
CKPT_STEPS, CKPT_AT, CKPT_TIMED = 5, 3, 8
CKPT_EXAMPLES = 16 * TRAIN_BATCH
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
# slices), 832 and 1024 (four). (name, [b, s, h,
# d], dtype, causal), each through the forward, dQ and dK/dV, and (causal)
# the partial at a hop below and on the diagonal, at the tolerances above
# (TOL_O, TOL_LSE, TOL_GRAD, TOL_PARTIAL_*). Causal cases span 2.5 of the
# 128-row Q tiles (5 of the dK/dV kernels' 64-key tiles); full cases
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
# The wgmma dQ's and dK/dV's bitwise repeat at the wide training shape,
# and the sliced pair's at d = 320 (two 256-column slices).
WIDE_REPEAT = ((8, 1024, 16, 256), (8, 1024, 16, 320))
# More (batch, head) pairs than a grid's y dimension holds: b*h = 66560,
# each dtype through the four kernels.
MANY_HEADS = ("bh66560", (1040, 64, 64, 16))
# Timed: a d = 32 training shape (b*h = 512 heads of 1024 tokens), a
# d = 20 one (zero-padded to 24: the copies timed apart) and two d = 256
# ones (the wide library's wgmma kernels, also the partial and the sliced
# dQ): [8, 1024, 16, 256], and the wide_heads step's [8, 1024, 8, 256].
# Then the routes of f32 heads (every d: the CUDA-core forward of
# flash_attention_f32.cuh and the register-tiled backward pair of
# flash_attention_f32_bwd.cuh) and of bf16 heads wider than 256 (the sliced
# wgmma forward and backward): f32 at d = 32, 128
# and 256 and bf16 at d = 320, each at [1, 1024, 8, d] and at [8, 1024,
# 16, d], a batch that fills the card (also the partial).
HEAD_DIM_TIMED = [
    ("d32_train", (8, 1024, 64, 32), "bfloat16", True, 0, 0, False),
    ("d20_train", (8, 1024, 64, 20), "bfloat16", True, 0, 0, False),
    ("d256_train", (8, 1024, 16, 256), "bfloat16", True, 0, 0, False),
    # The shape the wide_heads step gives them: 8 heads of 256.
    ("wide_heads", (8, 1024, 8, 256), "bfloat16", True, 0, 0, False),
    ("d32_f32", (1, 1024, 8, 32), "float32", True, 0, 0, False),
    ("d128_f32", (1, 1024, 8, 128), "float32", True, 0, 0, False),
    ("d256_f32", (1, 1024, 8, 256), "float32", True, 0, 0, False),
    ("d320_bf16", (1, 1024, 8, 320), "bfloat16", True, 0, 0, False),
    ("d32_f32_b8h16", (8, 1024, 16, 32), "float32", True, 0, 0, False),
    ("d128_f32_b8h16", (8, 1024, 16, 128), "float32", True, 0, 0, False),
    ("d256_f32_b8h16", (8, 1024, 16, 256), "float32", True, 0, 0, False),
    ("d320_bf16_b8h16", (8, 1024, 16, 320), "bfloat16", True, 0, 0, False),
]

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
                                       "fwd_f32_tiled_kernel",
                                       "bf16_sliced_kernel",
                                       "dq_f32_tiled_kernel",
                                       "dkv_f32_tiled_kernel",
                                       "wide_dq_bf16_sliced_kernel",
                                       "wide_dkv_bf16_sliced_kernel",
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
    # The plain versions take 30-300 times the kernels' time (~20 GB a
    # call at 8192 tokens): 5 runs of 2 calls time them, as the forward's.
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
        row[f"{key}_plain_ms"] = time_ms(plain, warmup=1, runs=5, batch=2)
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
    partial, and the sliced dQ beside the wgmma one), and on the f32 and
    the bf16 > 256 routes (f32 at d = 32, 128 and 256, bf16 at d = 320)
    with the partial."""
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
               "kernels": _fwd_route(fa, shape[3], dtype)}

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
        row["fwd_library_backend"] = sdpa_backend(profiled(
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   is_causal=causal),
            torch, runs=2)[1])
        row["fwd_bound_ms"], row["fwd_bound_by"], row["fwd_flops"] = \
            attention_bound_ms(shape, dtype, causal)
        _rates(row, "fwd_")
        if shape[3] % 8:   # the padding copies inside those times
            row["pad_copy_fwd_ms"] = time_ms(lambda: fa._pad_heads(q, k, v))
            row["pad_copy_bwd_ms"] = time_ms(
                lambda: fa._pad_heads(q, k, v, o, do))
        if row["kernels"] != "hopper":   # the partial at offsets (0, 0)

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
        if row["kernels"] == "wide":   # the sliced dQ, the same build
            _time_sliced_dq(row, torch, fa, q, k, v, o, lse, do, causal)
        emit(row)
        timed[name] = row
        del q, k, v, do, o, lse, delta, qt, kt, vt
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "timed": timed}


def _fwd_route(fa, d: int, dtype: str) -> str:
    """Which forward kernels run head dim d in ``dtype``: the 128-column
    wgmma kernels (``hopper``), the wide library's wgmma kernels
    (``wide``), its sliced wgmma kernels above 256 columns
    (``wide_sliced``), or the f32 CUDA-core loop (``f32_tiled``)."""
    if dtype == "float32":
        return "f32_tiled"
    if d <= fa.TILE_MAX_HEAD_DIM:
        return "hopper"
    return "wide" if d <= fa.WIDE_WGMMA_WIDTHS[-1] else "wide_sliced"


def _time_sliced_dq(row, torch, fa, q, k, v, o, lse, do, causal) -> None:
    """The sliced dQ of the same library (the plan (0, slices)) timed
    beside the wgmma one, and how far its dq lies from the wgmma dq's."""
    d = q.shape[-1]
    plan = (0, -(-d // fa.WIDE_SLICE_COLS))

    def sliced():
        return fa._launch_dq(q, k, v, o, lse, do, None, causal, d ** -0.5,
                             0, 0, plan=plan)

    got = fa.flash_attention_bwd_dq(q, k, v, o, lse, do, causal=causal)[0]
    row["dq_sliced_plan"] = list(plan)
    row["dq_sliced_max_diff"] = _max_err(sliced()[0], got)[0]
    row["dq_sliced_ms"] = time_ms(sliced)
    row["dq_sliced_bound_share"] = row["dq_bound_ms"] / row["dq_sliced_ms"]
    row["dq_speedup_vs_sliced"] = row["dq_sliced_ms"] / row["dq_ms"]


def _head_dim_slices(torch, fa, gen) -> None:
    """At d = 1024 the sliced kernels run four 256-column output slices,
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
    """The wgmma dQ (delta computed) and dK/dV at the wide training shape,
    and the sliced pair at d = 320, twice on the same inputs: the same
    bits (no atomics; dK/dV's P^T handed over in shared memory)."""
    for shape in WIDE_REPEAT:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention_fwd(q, k, v)
        delta = fa.attention_delta(o, do)
        same = {}
        for key, run in (
                ("dq", lambda: fa.flash_attention_bwd_dq(q, k, v, o, lse,
                                                         do)),
                ("dkv", lambda: fa.flash_attention_bwd_dkv(q, k, v, lse, do,
                                                           delta))):
            first, again = run(), run()
            same[key] = all(torch.equal(a, c) for a, c in zip(first, again))
            del first, again
        ok = all(same.values())
        emit({"phase": "head_dims", "case": "wide_bwd_bitwise_repeat",
              "shape": list(shape), "bitwise_repeat": same, "ok": ok})
        if not ok:
            raise AssertionError(f"a wide backward kernel is not "
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


# The live profiler server's capture: long enough for ~12 TRAIN_MODEL
# steps, as a user's click on TensorBoard's capture button asks 1000 ms
# by default.
PROFILER_CAPTURE_MS = 1000
# The notebook's steps timed before its first click: what a capture's
# steps are held against.
PROFILER_BASELINE_STEPS = 16
PROFILER_CLICKS = ("first", "second")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _correlations(plane: dict, line: dict) -> list:
    """Each event's ``correlation_id`` stat on ``line`` (None without)."""
    stat = next((m["id"] for m in plane.get("stat_metadata", {}).values()
                 if m["name"] == "correlation_id"), None)
    return [next((s.get("int64_value") for s in event.get("stats", [])
                  if s["metadata_id"] == stat), None)
            for event in line.get("events", [])]


def _capture_counts(space: dict, kernels) -> dict:
    """Events, device ms and the window check of ``kernels`` in a decoded
    ``XSpace``: each kernel's events and device ms on ``/device:GPU:0``,
    every device event's span against the Task Environment plane's
    window, the span of the device events, the host plane's kernel
    launches (the CUDA runtime's, of every thread), the kernels' events
    launched outside the host's recorded launches (cut at the session's
    edges) and those whose correlation id names no launch between
    them."""
    import re

    planes = {plane["name"]: plane for plane in space.get("planes", [])}
    host = planes.get("/host:CPU", {})
    host_names = {m["id"]: m["name"]
                  for m in host.get("event_metadata", {}).values()}
    launched = set()
    for line in host.get("lines", []):
        for event, corr in zip(line.get("events", []),
                               _correlations(host, line)):
            if corr is not None and host_names.get(
                    event["metadata_id"], "").startswith(
                        ("cudaLaunch", "cuLaunch")):
                launched.add(corr)
    env = planes.get("Task Environment", {})
    env_names = {m["id"]: m["name"]
                 for m in env.get("stat_metadata", {}).values()}
    window = {env_names[stat["metadata_id"]]: stat["uint64_value"]
              for stat in env.get("stats", [])}
    gpu = planes.get("/device:GPU:0", {})
    names = {m["id"]: m["name"]
             for m in gpu.get("event_metadata", {}).values()}
    counts = dict.fromkeys(kernels, 0)
    device_ms = dict.fromkeys(kernels, 0.0)
    events = outside = 0
    # A kernel's launch is missing when the host plane recorded launches
    # on both sides of its id; an id outside them is a launch the session
    # cut at its start or stop.
    unlaunched, edges = [], 0
    low, high = min(launched, default=0), max(launched, default=-1)
    first = last = None
    for line in gpu.get("lines", []):
        for event, corr in zip(line.get("events", []),
                               _correlations(gpu, line)):
            events += 1
            start = line["timestamp_ns"] + event.get("offset_ps", 0) // 1000
            end = start + event.get("duration_ps", 0) // 1000
            first = start if first is None else min(first, start)
            last = end if last is None else max(last, end)
            if not (window.get("profile_start_time", 0) <= start
                    and end <= window.get("profile_stop_time", 0)):
                outside += 1
            name = names.get(event["metadata_id"], "")
            for kernel in kernels:
                if re.search(rf"(?<!\w){kernel}(?!\w)", name):
                    counts[kernel] += 1
                    device_ms[kernel] += event.get("duration_ps", 0) / 1e9
                    if corr is not None and not low <= corr <= high:
                        edges += 1
                    elif corr not in launched:
                        unlaunched.append({"correlation_id": corr,
                                           "start_ns": start})
    return {"planes": sorted(planes), "window_ns": window,
            "device_events": events, "device_events_outside": outside,
            "device_span_ns": [first, last],
            "kernel_events": counts, "kernel_device_ms": device_ms,
            "host_launches": len(launched),
            "host_launch_ids": [low, high],
            "kernel_events_at_edges": edges,
            "kernel_events_without_launch": len(unlaunched),
            "kernel_events_without_launch_first": unlaunched[:4],
            "host_threads": len(host.get("lines", []))}


def _step_ms(spans) -> dict:
    """The median and the longest of ``(start_ns, end_ns)`` step spans,
    in ms (None for no span)."""
    ms = [(end - start) / 1e6 for start, end in spans]
    return {"median": statistics.median(ms) if ms else None,
            "max": max(ms) if ms else None, "steps": len(ms)}


def profiler_notebook() -> dict:
    """The notebook of the profiler_server phase, in a process of its own
    as a user's is, so that its first click starts CUPTI: the sdk's server
    on a free port, TRAIN_MODEL steps in the main thread (one host sync a
    step), PROFILER_BASELINE_STEPS of them timed, then one capture a click
    of PROFILER_CLICKS from another thread while the loop runs on, the
    second click with a concurrent ``Profile`` that must be refused.
    Launches counted from zero over the clicks' steps. Each click's
    ``.xplane.pb`` is decoded with ``profiler.wire`` and its steps split
    into those inside the recording (from the first device event to the
    session's stop) and the call's others (the session's start, its
    export)."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from kubeflow_tpu_torch import sdk
    from kubeflow_tpu_torch.models import burnin
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.profiler import h2, server, wire
    from kubeflow_tpu_torch.testing import profiler_client

    port = _free_port()
    sdk.start_profiler_server(port)
    addr = f"localhost:{port}"
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    params, tokens = _train_inputs(torch, burnin, cfg, seed=0)
    step = burnin.make_train_step(cfg)
    step(params, tokens)
    torch.cuda.synchronize()
    spans: list = []
    losses: list = []

    def timed_step() -> None:
        t0 = time.time_ns()
        losses.append(float(step(params, tokens)[1]))   # one sync a step
        spans.append((t0, time.time_ns()))

    for _ in range(PROFILER_BASELINE_STEPS):
        timed_step()
    out = {"port": port, "baseline_step_ms": _step_ms(spans)}
    logdir = tempfile.mkdtemp(prefix="kftpu-capture-")
    got: dict = {}

    def capture(key: str) -> None:
        got[f"{key}_at_ns"] = time.time_ns()
        t0 = time.perf_counter()
        try:
            got[key] = profiler_client.capture(
                addr, os.path.join(logdir, key), PROFILER_CAPTURE_MS)
        except h2.GrpcError as exc:
            got[key] = (exc.code, exc.message)
        got[f"{key}_sec"] = time.perf_counter() - t0

    clicks = {}
    _zero_launch_counts(fa)              # ---- the main path starts here
    try:
        for click in PROFILER_CLICKS:
            first = len(spans)
            thread = threading.Thread(target=capture, args=(click,))
            second = threading.Thread(target=capture, args=("refused",))
            thread.start()
            while thread.is_alive():
                timed_step()
                if (click == PROFILER_CLICKS[-1] and not second.ident
                        and server._SESSION.locked()):
                    second.start()       # while the click's session runs
            if second.ident:
                second.join(60)
            path = got.get(click)
            raw = open(path, "rb").read() if isinstance(path, str) else b""
            seen = _capture_counts(wire.decode(wire.XSPACE, raw),
                                   ENTRY_KERNELS)
            window = seen["window_ns"]
            begin = (seen["device_span_ns"][0]
                     or window.get("profile_start_time", 0))
            stop = window.get("profile_stop_time", 0)
            inside = [(a, b) for a, b in spans[first:]
                      if begin <= a and b <= stop]
            clicks[click] = {
                "path_ok": isinstance(path, str), "xplane_bytes": len(raw),
                "capture_sec": got.get(f"{click}_sec"),
                "recording_after_sec": (begin - got[f"{click}_at_ns"]) / 1e9,
                "step_ms": _step_ms(spans[first:]),
                "step_ms_recording": _step_ms(inside),
                "step_ms_other": _step_ms(
                    [s for s in spans[first:] if s not in inside]),
                **seen}
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.synchronize()
    out["launches"] = _launch_counts(fa)  # ---- the main path ends here
    refused = got.get("refused")
    return {**out, "clicks": clicks,
            "steps": len(spans) - PROFILER_BASELINE_STEPS,
            "refused": list(refused) if isinstance(refused, tuple)
            else refused, "refused_sec": got.get("refused_sec"),
            "loss_first": losses[0], "loss_last": losses[-1]}


PROFILER_NOTEBOOK_CHILD = """
import json
import chip_smoke
print(json.dumps(chip_smoke.profiler_notebook()), flush=True)
"""


def phase_profiler_server(fa, burnin, card: str) -> dict:
    """The notebook's live profiler server (docstring, 37): a notebook
    process (``profiler_notebook``) captured twice from another thread
    while its main thread trains; the launches its clicks' steps made."""
    import os

    from kubeflow_tpu_torch.profiler import h2, server

    phase_t0 = time.perf_counter()
    notebook = json.loads(_run_children(
        [(["-c", PROFILER_NOTEBOOK_CHILD], dict(os.environ))])[0]
        .strip().splitlines()[-1])
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    steps = notebook["steps"]
    baseline = notebook["baseline_step_ms"]["median"]
    for click in notebook["clicks"].values():
        recording = click["step_ms_recording"]["median"]
        click["step_ms_recording_ratio"] = (
            recording / baseline if recording else None)
    row = {"phase": "profiler_server", "card": card,
           "capture_ms": PROFILER_CAPTURE_MS, **notebook,
           "launches_expected": cfg.n_layers * steps,
           "phase_sec": time.perf_counter() - phase_t0}
    emit(row)

    def click_ok(click: dict) -> bool:
        counts = list(click["kernel_events"].values())
        return (click["path_ok"] and click["xplane_bytes"] > 0
                and "/device:GPU:0" in click["planes"]
                and min(counts) > 0
                and max(counts) - min(counts) <= cfg.n_layers
                and click["device_events_outside"] == 0
                and click["kernel_events_without_launch"] == 0
                and click["step_ms_recording"]["steps"] > 0)

    if not (all(click_ok(c) for c in notebook["clicks"].values())
            and notebook["refused"] == [h2.INTERNAL, server.SESSION_ACTIVE]
            and notebook["launches"] == _burnin_counts(cfg.n_layers * steps)
            and math.isfinite(notebook["loss_last"])):
        raise AssertionError(f"profiler_server phase failed: {row}")
    return notebook["launches"]


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


def phase_checkpoint(torch, fa, burnin, trainer, data, checkpoint, sdk,
                     card: str) -> tuple:
    """Checkpoint, data and SDK on the card: ``fit`` at CKPT_MODEL, AdamW
    (``TrainerConfig()``), fed by ``ShardedLoader -> prefetch ->
    global_batches`` and handing each step's checkpoint tree to a
    ``CheckpointGuard`` over a ``CheckpointFabric`` (with a staging tier)
    under a drain request, and to a DCP ``CheckpointManager``: both save
    at step CKPT_AT (the guard's sync step; the manager's interval). The
    guard's ack must follow the snapshot, its commit mark the upload. For
    each arm a fresh state restored onto ``abstract_state`` on the card
    (``load_state``) and run to CKPT_STEPS must be bitwise the straight
    run (the fabric's resume skips the loader in O(1), the manager's
    through fit's fast-forward). Then the loader pipeline's steps against
    pre-staged card batches. The temporary directories are removed.
    Returns the straight run's launches, and what the fleet phase reuses:
    the model, optimizer, step, loader and initial params, and a copy of
    the straight run's state tensors to hold a resumed run to."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from kubeflow_tpu_torch.api import notebook
    from kubeflow_tpu_torch.models.tree import leaves, map_params

    cfg = burnin.BurninConfig(**CKPT_MODEL)
    tx = trainer.make_optimizer(trainer.TrainerConfig())
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=cfg), tx)
    tokens = np.random.default_rng(9).integers(
        0, cfg.vocab, (CKPT_EXAMPLES, cfg.seq_len), dtype=np.int64)
    params0 = burnin.init_params(cfg, seed=7, device="cuda")

    def fresh():
        return trainer.init_state(map_params(torch.clone, params0), tx)

    def loader(skip=0):
        ld = data.ShardedLoader(data.ArraySource(tokens), TRAIN_BATCH,
                                seed=4, transform=lambda b: b[0])
        ld.skip(skip)
        return data.global_batches(data.prefetch(ld))

    def tensors(tree) -> list:
        if isinstance(tree, dict):
            return [t for value in tree.values() for t in tensors(value)]
        if isinstance(tree, (list, tuple)):
            return [t for value in tree for t in tensors(value)]
        return [tree]

    def equal(a, b) -> bool:
        """Params, moments, counts and step bit for bit."""
        a, b = (tensors(trainer.checkpoint_tree(x)) for x in (a, b))
        return len(a) == len(b) and all(map(torch.equal, a, b))

    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    marks, clock = [], {}
    try:
        # A staging tier that holds the whole state (the default budget is
        # 1 GiB): a same-node restore is then served from it.
        staging = {"KFTPU_CKPT_STAGING_BYTES": str(8 << 30)}
        fabric = checkpoint.CheckpointFabric(
            f"{tmp}/remote", staging_dir=f"{tmp}/staging",
            save_interval_steps=10 ** 6, environ=staging)
        save_async = fabric.save_async

        def timed_save_async(step_no, tree, *, on_progress=None,
                             on_commit=None):
            def committed(step_done, secs):
                clock["fabric_commit_s"] = secs
                on_commit(step_done, secs)

            t0 = time.perf_counter()
            handle = save_async(step_no, tree, on_progress=on_progress,
                                on_commit=committed)
            clock["snapshot_end"] = time.perf_counter()
            clock["fabric_snapshot_s"] = clock["snapshot_end"] - t0
            return handle

        fabric.save_async = timed_save_async
        ann = {notebook.DRAIN_REQUESTED_ANNOTATION: "2026-01-01T00:00:00Z",
               notebook.DRAIN_REASON_ANNOTATION: "suspend"}

        def patcher(update):
            now = time.perf_counter()
            if notebook.CHECKPOINTED_AT_ANNOTATION in update:
                marks.append(("ack", now))
            elif notebook.CHECKPOINT_COMMITTED_AT_ANNOTATION in update:
                marks.append(("commit", now))
            for key, value in update.items():
                ann.pop(key, None) if value is None else \
                    ann.__setitem__(key, value)

        guard = sdk.CheckpointGuard(
            fabric, sdk.MaintenanceWatcher(fetch=lambda: dict(ann),
                                           interval=0.0),
            sync_every_steps=CKPT_AT, patcher=patcher)
        manager = checkpoint.CheckpointManager(f"{tmp}/dcp",
                                               save_interval_steps=CKPT_AT)

        class Saves:
            """fit's checkpoints: the guard every step, the manager on its
            interval."""

            def save(self, step_no, tree):
                clock.setdefault("guard_call", {})[step_no] = \
                    time.perf_counter()
                guard.step(step_no, tree)
                t0 = time.perf_counter()
                if manager.save(step_no, tree):
                    clock["dcp_snapshot_s"] = time.perf_counter() - t0

            def wait(self):
                manager.wait()
                fabric.wait()

        torch.cuda.synchronize()
        _zero_launch_counts(fa)          # ---- the main path starts here
        straight = trainer.fit(fresh(), loader(), steps=CKPT_STEPS,
                               step_fn=step, checkpoints=Saves(),
                               save_every=1)
        torch.cuda.synchronize()
        launches = _launch_counts(fa)    # ---- the main path ends here
        tree = trainer.checkpoint_tree(straight)
        # Before the timed steps below move the straight state on.
        straight_tensors = [t.clone() for t in tensors(tree)]
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tensors(tree))
        guard.close()
        abstract = trainer.abstract_state(params0, tx)

        t0 = time.perf_counter()
        reader = checkpoint.CheckpointFabric(
            f"{tmp}/remote", staging_dir=f"{tmp}/staging", environ=staging)
        restored = reader.restore(CKPT_AT, abstract=abstract)
        torch.cuda.synchronize()
        fabric_restore_s = time.perf_counter() - t0
        tier = reader.last_restore["tier"]
        reader.close()
        resumed = trainer.load_state(restored, tx)
        on_card = all(t.device.type == "cuda"
                      for t in leaves(resumed["params"]))
        resumed = trainer.fit(resumed, loader(skip=CKPT_AT),
                              steps=CKPT_STEPS, step_fn=step,
                              skip_batches=False)
        fabric_bitwise = equal(resumed, straight)
        del restored, resumed

        t0 = time.perf_counter()
        restored = manager.restore(CKPT_AT, abstract=abstract)
        torch.cuda.synchronize()
        dcp_restore_s = time.perf_counter() - t0
        dcp_commit_s = manager.last_save["commit_seconds"]
        manager.close()
        resumed = trainer.fit(trainer.load_state(restored, tx), loader(),
                              steps=CKPT_STEPS, step_fn=step)
        dcp_bitwise = equal(resumed, straight)
        del restored, resumed

        def timed_fit(state, batches) -> tuple:
            """CKPT_TIMED more steps, each ending in a sync on its loss;
            the step times after the first."""
            stamps = []
            state = trainer.fit(state, batches,
                                steps=state["step"] + CKPT_TIMED,
                                step_fn=step, skip_batches=False,
                                on_step=lambda i, loss: stamps.append(
                                    time.perf_counter()))
            return state, [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]

        state, piped = timed_fit(straight, loader(skip=CKPT_STEPS))
        gen = torch.Generator(device="cuda").manual_seed(11)
        staged = [torch.randint(0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len),
                                generator=gen, device="cuda")
                  for _ in range(CKPT_TIMED)]
        torch.cuda.synchronize()
        state, prestaged = timed_fit(state, iter(staged))
        with sdk.trace(f"{tmp}/trace"):      # the card's kernels and ops
            step(state, staged[0])
            torch.cuda.synchronize()
        traces = [os.path.getsize(f"{tmp}/trace/{name}")
                  for name in os.listdir(f"{tmp}/trace")
                  if name.endswith(".pt.trace.json")]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ack = next(t for kind, t in marks if kind == "ack")
    commit = next(t for kind, t in marks if kind == "commit")
    call = clock["guard_call"][CKPT_AT]
    gb = state_bytes / 1e9
    row = {"phase": "checkpoint", "model": CKPT_MODEL,
           "trainer_config": "TrainerConfig()", "batch": TRAIN_BATCH,
           "steps": CKPT_STEPS, "saved_at": CKPT_AT, "card": card,
           "state_bytes": state_bytes,
           "fabric": {"snapshot_s": clock["fabric_snapshot_s"],
                      "snapshot_gb_per_s": gb / clock["fabric_snapshot_s"],
                      "commit_s": clock["fabric_commit_s"],
                      "restore_s": fabric_restore_s, "restore_tier": tier,
                      "resume_bitwise": fabric_bitwise},
           "dcp": {"snapshot_s": clock["dcp_snapshot_s"],
                   "snapshot_gb_per_s": gb / clock["dcp_snapshot_s"],
                   "commit_s": dcp_commit_s, "restore_s": dcp_restore_s,
                   "restore_tier": "directory",
                   "resume_bitwise": dcp_bitwise},
           "drain": {"ack_latency_s": ack - call,
                     "ack_to_commit_mark_s": commit - ack,
                     "snapshot_before_ack": clock["snapshot_end"] <= ack,
                     "marks": [kind for kind, _ in marks]},
           "loader_step_p50_ms": statistics.median(piped),
           "prestaged_step_p50_ms": statistics.median(prestaged),
           "loader_step_ms": piped, "prestaged_step_ms": prestaged,
           "sdk_trace_bytes": traces, "launches": launches,
           "launches_expected": cfg.n_layers * CKPT_STEPS}
    emit(row)
    if not (fabric_bitwise and dcp_bitwise and on_card
            and state["step"] == CKPT_STEPS + 2 * CKPT_TIMED
            and len(traces) == 1 and traces[0] > 0
            and tier == "staging" and guard.drained
            and clock["snapshot_end"] <= ack < commit
            and launches == _burnin_counts(cfg.n_layers * CKPT_STEPS)):
        raise AssertionError(f"checkpoint phase failed: {row}")
    del straight, state
    torch.cuda.empty_cache()
    reuse = SimpleNamespace(
        cfg=cfg, tx=tx, step=step, fresh=fresh, loader=loader,
        tensors=tensors, abstract=trainer.abstract_state(params0, tx),
        staging=staging, straight=straight_tensors)
    return launches, reuse


# ---- the fleet phase: the scheduler, the profile quota and the warm pods ----

# Part (a): one H100 node in the fleet, a Profile whose card quota covers
# it, a low-priority training notebook the scheduler drains to a
# checkpoint for a high-priority one.
FLEET_SPEC = f"a3={PROBE_ACCELERATOR}:1x8:1"
FLEET_QUOTA = 8
# Part (b): a pool of one warm 1x1 pod, over a fleet of two 1x1 shares
# (the slot holds one of them in the scheduler's ledger).
WARM_IMAGE = "kubeflow-tpu-torch/notebook:smoke"
WARM_POOLS = f"ns/{WARM_IMAGE}@{PROBE_ACCELERATOR}:1x1:1"
WARM_FLEET_SPEC = f"w={PROBE_ACCELERATOR}:1x1:2"
# Part (c): a spot node beside a reserved one.
SPOT_FLEET_SPEC = (f"res={PROBE_ACCELERATOR}:1x8:1,"
                   f"cheap={PROBE_ACCELERATOR}:1x8:1:spot")
# Every wait on the control plane is bounded by this; none sleeps against
# a grace.
FLEET_TIMEOUT = 60.0

# The warm pod's process: the slot's container (its command and env as
# the fake apiserver holds them), started beside the build. It imports
# what the pod's interpreter would, waits for the word that the build
# directory (its kernel cache's seed) is complete, then runs the slot's
# ``python -m`` command in this process: the SDK's warm-idle shim seeds
# the cache, attaches the card, builds the kernels and returns the claim
# from the downward-API file. The same process then launches the forward
# kernel at the decode shape (a claimed notebook's first launch) and
# holds it against the plain version. Every nvcc compile goes through
# ``_build.build``, which this process records.
WARM_POD_CHILD = r"""
import json, os, runpy, sys, time
import torch
from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.utils import compilecache

sys.stdin.readline()
compiled, build = [], _build.build

def recorded(items=None):
    done = build(items)
    compiled.extend(done)
    return done

_build.build = recorded
argv = json.loads(os.environ["SMOKE_POD_COMMAND"])
assert argv[:2] == ["python", "-m"], argv
sys.argv = [argv[2], *argv[3:]]
runpy.run_module(argv[2], run_name="__main__", alter_sys=True)
claimed_at = time.time()
shape, dtype, causal = json.loads(os.environ["SMOKE_WARM_CASE"])
gen = torch.Generator(device="cuda").manual_seed(4321)
q, k, v = (torch.randn(shape, generator=gen, device="cuda")
           .to(getattr(torch, dtype)) for _ in range(3))
fa.LAUNCHES = 0
o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
torch.cuda.synchronize()
result_at = time.time()
launches = fa.LAUNCHES
ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
print(json.dumps({
    "shim_returned_at": claimed_at, "result_at": result_at,
    "launches": launches,
    "max_err_o": (o.float() - ro.float()).abs().max().item(),
    "max_err_lse": (lse - rlse).abs().max().item(),
    "finite": bool(torch.isfinite(o).all()),
    "compiled": compiled, "nvcc_compiles": len(_build.BUILD_LOG),
    "library_dir": str(_build.BUILD_DIR),
    "cache": compilecache.cache_stats(),
    "cache_entries": compilecache.cache_entries(str(_build.BUILD_DIR))}),
    flush=True)
"""


class LoopThread:
    """An event loop on a thread of its own. The card work stays on the
    main thread and reaches the loop through :meth:`call`; the loop never
    waits on the card."""

    def __init__(self, name: str):
        import asyncio
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       name=name, daemon=True)
        self.thread.start()

    def call(self, coro, timeout: float = FLEET_TIMEOUT):
        import asyncio

        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(
            timeout)

    def stop_loop(self) -> None:
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=FLEET_TIMEOUT)
        self.loop.close()

    async def wait_for(self, predicate, what: str):
        """Poll an async predicate until it returns a truthy value."""
        import asyncio

        deadline = time.monotonic() + FLEET_TIMEOUT
        while True:
            value = await predicate()
            if value:
                return value
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out: {what}")
            await asyncio.sleep(0.002)

    def mark_when(self, predicate, what: str):
        """Start waiting for ``predicate`` on the loop; the returned
        future gives the host time (``time.time``) it first held, so a
        mark is not delayed by the main thread's card work."""
        import asyncio

        async def mark():
            await self.wait_for(predicate, what)
            return time.time()

        return asyncio.run_coroutine_threadsafe(mark(), self.loop)


class ControlPlane(LoopThread):
    """The port's control plane (the fake apiserver with the admission
    chain, a manager running the notebook controller and optionally the
    profile controller, the InferenceService controller (``serving``)
    and the culler (``prober``), their options read from the env as the
    manager reads them, the kubelet simulator) on an event loop of its
    own thread."""

    def __init__(self, scheduler, *, profiles=False, environ=None,
                 serving=False, prober=None):
        super().__init__("control-plane")
        self.call(self._start(scheduler, profiles, environ or {}, serving,
                              prober))

    async def _start(self, scheduler, profiles, environ, serving,
                     prober) -> None:
        import os

        from kubeflow_tpu_torch.cmd import envconfig
        from kubeflow_tpu_torch.controllers.culling import (
            setup_culling_controller)
        from kubeflow_tpu_torch.controllers.notebook import (
            NotebookOptions, setup_notebook_controller)
        from kubeflow_tpu_torch.controllers.profile import (
            setup_profile_controller)
        from kubeflow_tpu_torch.runtime.manager import Manager
        from kubeflow_tpu_torch.runtime.metrics import Registry
        from kubeflow_tpu_torch.serving.controller import (
            setup_serving_controller)
        from kubeflow_tpu_torch.testing import FakeKube, PodSimulator
        from kubeflow_tpu_torch.webhooks import register_all

        self.kube = FakeKube()
        register_all(self.kube)
        self.mgr = Manager(self.kube, registry=Registry())
        self.sched = scheduler(self.kube, self.mgr.registry)
        saved = {key: os.environ.get(key) for key in environ}
        os.environ.update(environ)      # the setups read them, once
        try:
            self.rec = setup_notebook_controller(
                self.mgr, NotebookOptions(), scheduler=self.sched)
            self.serving = None if not serving else \
                setup_serving_controller(self.mgr,
                                         envconfig.serving_options(),
                                         scheduler=self.sched)
            self.culler = None if prober is None else \
                setup_culling_controller(self.mgr, prober,
                                         envconfig.culling_options())
        finally:
            for key, value in saved.items():
                if value is None:
                    os.environ.pop(key, None)
                else:
                    os.environ[key] = value
        if profiles:
            setup_profile_controller(self.mgr)
        self.sim = PodSimulator(self.kube)
        await self.mgr.start()
        await self.sim.start()

    async def _stop(self) -> None:
        if self.rec._warmpool is not None:
            self.rec._warmpool.stop()
        await self.sim.stop()
        await self.mgr.stop()
        self.kube.close_watches()

    def close(self) -> None:
        try:
            self.call(self._stop())
        finally:
            self.stop_loop()

    async def annotations(self, name: str) -> dict:
        nb = await self.kube.get("Notebook", name, "ns")
        return dict(nb["metadata"].get("annotations") or {})

    async def patch_annotations(self, name: str, update: dict) -> None:
        await self.kube.patch("Notebook", name,
                              {"metadata": {"annotations": update}}, "ns")

    async def state(self, name: str) -> str | None:
        nb = await self.kube.get_or_none("Notebook", name, "ns")
        return (((nb or {}).get("status") or {}).get("scheduler")
                or {}).get("state")

    async def settle(self) -> None:
        import asyncio

        for _ in range(4):
            await self.mgr.wait_idle(timeout=FLEET_TIMEOUT)
            await asyncio.sleep(0.01)

    def counts(self) -> dict:
        by_controller = {
            ctrl.name: self.mgr.reconcile_seconds.snapshot(
                controller=ctrl.name)["count"]
            for ctrl in self.mgr.controllers}
        return {"reconciles": by_controller["notebook"],
                "reconciles_by_controller": by_controller,
                "api_requests_by_verb": dict(sorted(
                    self.kube.requests.items()))}


def _gpu_notebook(name: str, topology: str, priority: str | None = None,
                  image: str | None = None) -> dict:
    from kubeflow_tpu_torch.api import notebook as nbapi

    nb = nbapi.new(name, "ns", accelerator=PROBE_ACCELERATOR,
                   topology=topology, **({"image": image} if image else {}))
    if priority:
        nb["metadata"].setdefault("annotations", {})[
            nbapi.PRIORITY_ANNOTATION] = priority
    return nb


def start_warm_pod() -> dict:
    """Part (b)'s first half, beside the build: a control plane whose
    notebook controller reads ``KFTPU_WARM_POOLS`` (a pool of one warm
    ``1x1`` pod) over a GPU fleet scheduler, the replenisher's one slot,
    and the slot pod's container started as a process on the card (its
    command and env as the fake apiserver holds them, a fresh kernel
    cache seeded from the build directory, the downward-API annotations
    in a temporary file). The process waits for the build; it is
    stopped at exit if it has not ended."""
    import atexit
    import os
    import tempfile

    from kubeflow_tpu_torch.api import keys
    from kubeflow_tpu_torch.ops import _build
    from kubeflow_tpu_torch.scheduler import (Fleet, GpuFleetScheduler,
                                              SchedulerOptions)
    from kubeflow_tpu_torch.utils import compilecache

    plane = ControlPlane(
        lambda kube, registry: GpuFleetScheduler(
            kube, SchedulerOptions(queued_requeue_seconds=0.05),
            fleet=Fleet.parse(WARM_FLEET_SPEC), registry=registry),
        environ={"KFTPU_WARM_POOLS": WARM_POOLS})

    async def slot_pod():
        pods = [p for p in await plane.kube.list("Pod", "ns")
                if keys.TPU_WARM_POOL_LABEL in (
                    p["metadata"].get("labels") or {})]
        return pods[0] if len(pods) == 1 and (pods[0].get("status") or {}) \
            .get("phase") == "Running" else None

    pod = plane.call(plane.wait_for(slot_pod, "the warm slot's pod"))
    slots = plane.call(plane.kube.list("StatefulSet", "ns"))
    reserved = [list(a.key)
                for a in plane.sched.policy.ledger.allocations.values()
                if a.workload == "warmpool"]
    ctr = pod["spec"]["containers"][0]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-warm-")
    claim_file = os.path.join(tmp, "annotations")
    open(claim_file, "w", encoding="utf-8").close()     # no claim yet
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PET_", "TPU_", "KFTPU_"))}
    env.update({e["name"]: e["value"] for e in ctr.get("env", [])
                if "value" in e})
    case, shape, dtype, causal = next(c for c in KERNEL_CASES
                                      if c[0] == "decode")
    env.update({
        compilecache.ENV_VAR: os.path.join(tmp, "kernel-cache"),
        compilecache.SEED_DIR_ENV: str(_build.BUILD_DIR),
        "KFTPU_WARM_CLAIM_FILE": claim_file,
        "SMOKE_POD_COMMAND": json.dumps(ctr["command"]),
        "SMOKE_WARM_CASE": json.dumps([list(shape), dtype, causal])})
    out = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", WARM_POD_CHILD], env=env,
        stdin=subprocess.PIPE, stdout=out, stderr=subprocess.STDOUT,
        text=True, start_new_session=True)
    atexit.register(_stop_group, proc)
    return {"plane": plane, "proc": proc, "out": out, "tmp": tmp,
            "claim_file": claim_file, "pod": pod["metadata"]["name"],
            "command": ctr["command"], "slot_env": sorted(
                e["name"] for e in ctr.get("env", [])),
            "slots": [s["metadata"]["name"] for s in slots],
            "reserved": reserved, "case": case, "dtype": dtype}


def warm_pod_go(warm: dict) -> None:
    """The build directory is complete: the warm pod may seed from it."""
    warm["proc"].stdin.write("go\n")
    warm["proc"].stdin.flush()


def _fleet_warm(warm: dict) -> dict:
    """Part (b)'s second half: a ``1x1`` notebook of the pool's image,
    the controller's CAS claim on the slot's pod, the pod's annotations
    written to the process's downward-API file, and the process's claim
    and first launch."""
    import os
    import shutil

    from kubeflow_tpu_torch.api import keys
    from kubeflow_tpu_torch.api import notebook as nbapi

    plane, proc = warm["plane"], warm["proc"]
    try:
        before = plane.counts()
        created = time.time()
        plane.call(plane.kube.create("Notebook", _gpu_notebook(
            "warm", "1x1", image=WARM_IMAGE)))

        async def claimed():
            ann = await plane.annotations("warm")
            return ann.get(nbapi.WARM_CLAIMED_ANNOTATION)

        pod_name = plane.call(plane.wait_for(claimed, "the warm claim"))
        claimed_at = time.time()
        pod = plane.call(plane.kube.get("Pod", pod_name, "ns"))
        ann = pod["metadata"].get("annotations") or {}
        staged = warm["claim_file"] + ".new"
        with open(staged, "w", encoding="utf-8") as fh:
            fh.writelines(f"{k}={json.dumps(v)}\n" for k, v in ann.items())
        os.replace(staged, warm["claim_file"])   # the kubelet's swap
        proc.wait(timeout=FLEET_TIMEOUT)
        warm["out"].seek(0)
        text = warm["out"].read()
        if proc.returncode:
            raise AssertionError(f"warm pod process failed:\n{text}")
        lines = [json.loads(line) for line in text.splitlines()
                 if line.startswith("{")]
        shim, child = lines[-2], lines[-1]
        plane.call(plane.settle())
        nb = plane.call(plane.kube.get("Notebook", "warm", "ns"))
        adopted = plane.call(plane.kube.get("Pod", pod_name, "ns"))
        ledger = plane.sched.policy.ledger
        ledger.assert_consistent()
        return {
            "slot_pod": warm["pod"], "claimed_pod": pod_name,
            "command": warm["command"], "slot_env": warm["slot_env"],
            "slots_before": warm["slots"],
            "reserved_before": warm["reserved"],
            "claim": ann.get(keys.TPU_WARM_CLAIM),
            "shim_claim": shim.get("claimed"),
            "owner": [r["kind"] for r in adopted["metadata"].get(
                "ownerReferences") or []],
            "warm_pool_status": ((nb.get("status") or {}).get("gpu")
                                 or {}).get("warmPool"),
            "admitted": [list(k) for k, a in ledger.allocations.items()
                         if a.workload == "notebook"],
            "create_to_claim_sec": claimed_at - created,
            "claim_to_shim_return_sec": child["shim_returned_at"]
            - claimed_at,
            "claim_to_kernel_result_sec": child["result_at"] - claimed_at,
            "case": warm["case"], "dtype": warm["dtype"], **child,
            "cache_hit": child["compiled"] == []
            and child["nvcc_compiles"] == 0 and child["cache"]["seeded"] > 0,
            "ledger_violations": ledger.violations,
            **_counts_since(before, plane.counts())}
    finally:
        _stop_group(proc)
        plane.close()
        shutil.rmtree(warm["tmp"], ignore_errors=True)


def _fleet_spot_reclaim() -> dict:
    """Part (c), on the host: a spot node beside a reserved one, a gang
    on each, then a revocation taint on the spot node. Every gang
    resident on the spot pool must be drained with the spot-reclaim
    reason, released and re-queued at its priority once it acks; the
    reserved pool's gang stays; the ledger must hold after every
    arbitration pass; clearing the taint re-admits the gang."""
    from kubeflow_tpu_torch.api import notebook as nbapi
    from kubeflow_tpu_torch.migration import protocol as migration
    from kubeflow_tpu_torch.scheduler import (Fleet, GpuFleetScheduler,
                                              SchedulerOptions, elastic)
    from kubeflow_tpu_torch.scheduler.fleet import (GKE_NODEPOOL_LABEL,
                                                    GKE_SPOT_LABEL)

    passes = [0]

    def scheduler(kube, registry):
        sched = GpuFleetScheduler(kube, SchedulerOptions(
            queued_requeue_seconds=0.05, enable_migration=True,
            drain_grace_seconds=FLEET_TIMEOUT,
            commit_grace_seconds=FLEET_TIMEOUT, enable_elastic=True,
            fleet_refresh_seconds=0.05),
            fleet=Fleet.parse(SPOT_FLEET_SPEC), registry=registry)
        schedule = sched.policy.schedule

        def checked(now):
            result = schedule(now)
            sched.policy.ledger.assert_consistent()
            passes[0] += 1
            return result

        sched.policy.schedule = checked
        return sched

    plane = ControlPlane(scheduler)

    async def run() -> dict:
        kube, sched = plane.kube, plane.sched
        ledger = sched.policy.ledger
        await kube.create("Node", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "cheap-0", "labels": {
                GKE_NODEPOOL_LABEL: "cheap", GKE_SPOT_LABEL: "true",
                "cloud.google.com/gke-accelerator": PROBE_ACCELERATOR}}})
        for name, priority in (("a", "low"), ("b", "high")):
            await kube.create("Notebook", _gpu_notebook(name, "1x8",
                                                        priority))
        await plane.settle()
        ledger.assert_consistent()
        resident = {k: a.priority for k, a in ledger.allocations.items()
                    if "cheap" in a.placements}
        stays = {k for k, a in ledger.allocations.items()
                 if "res" in a.placements}
        await kube.patch("Node", "cheap-0", {"spec": {"taints": [
            {"key": elastic.RECLAIM_TAINTS[0], "effect": "NoSchedule"}]}})
        reasons = {}
        for key in resident:
            async def drained(key=key):
                return (await plane.annotations(key[1])).get(
                    nbapi.DRAIN_REASON_ANNOTATION)

            reasons[key[1]] = await plane.wait_for(drained, "the drain")
            ledger.assert_consistent()
            ann = await plane.annotations(key[1])
            await plane.patch_annotations(key[1], migration.ack_patch(
                f"/checkpoints/{key[1]}", 1, time.time(),
                for_request=ann[nbapi.DRAIN_REQUESTED_ANNOTATION]))

        async def requeued():
            return all(k in sched.policy.pending for k in resident)

        await plane.wait_for(requeued, "the reclaimed gangs re-queued")
        await plane.settle()
        ledger.assert_consistent()
        priorities = {k: sched.policy.pending[k].priority for k in resident}
        released = not any(k in ledger.allocations for k in resident)
        closed = "cheap" in ledger.unavailable
        await kube.patch("Node", "cheap-0", {"spec": {"taints": None}})

        async def readmitted():
            return all(k in ledger.allocations
                       and not ledger.allocations[k].draining
                       for k in resident)

        await plane.wait_for(readmitted, "the reclaimed gangs re-admitted")
        await plane.settle()
        ledger.assert_consistent()
        return {
            "resident": {f"{k[0]}/{k[1]}": p for k, p in resident.items()},
            "drain_reasons": reasons,
            "requeued_priority": {f"{k[0]}/{k[1]}": p
                                  for k, p in priorities.items()},
            "priorities_kept": priorities == resident,
            "released": released, "pool_closed_while_signalled": closed,
            "stayed": sorted(f"{k[0]}/{k[1]}" for k in stays
                             if k in ledger.allocations
                             and not ledger.allocations[k].draining),
            "readmitted": True,
            "spot_reclaims": sched.m_spot_reclaims.labels().value,
            "drain_fallbacks": sched.m_drain_fallback.labels().value,
            "violations": ledger.violations, "passes_checked": passes[0]}

    try:
        return plane.call(run(), timeout=4 * FLEET_TIMEOUT)
    finally:
        plane.close()


def _fleet_preempt(torch, fa, trainer, checkpoint, sdk, reuse) -> dict:
    """Part (a): preempt-to-checkpoint through the control plane, the
    victim's trainer on the card (module docstring, item 32)."""
    import shutil
    import tempfile

    from kubeflow_tpu_torch.api import notebook as nbapi
    from kubeflow_tpu_torch.migration import protocol as migration
    from kubeflow_tpu_torch.scheduler import (Fleet, GpuFleetScheduler,
                                              SchedulerOptions)

    plane = ControlPlane(
        lambda kube, registry: GpuFleetScheduler(kube, SchedulerOptions(
            queued_requeue_seconds=0.05, enable_migration=True,
            drain_grace_seconds=FLEET_TIMEOUT,
            commit_grace_seconds=FLEET_TIMEOUT),
            fleet=Fleet.parse(FLEET_SPEC), registry=registry),
        profiles=True)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-fleet-")
    marks: dict = {}
    try:
        from kubeflow_tpu_torch.api import profile as profileapi

        async def quota():
            rq = await plane.kube.get_or_none(
                "ResourceQuota", "kf-resource-quota", "ns")
            return ((rq or {}).get("spec") or {}).get("hard")

        plane.call(plane.kube.create("Profile", profileapi.new(
            "ns", "owner@example.com", gpu_quota=FLEET_QUOTA)))
        hard = plane.call(plane.wait_for(quota, "the ResourceQuota"))
        plane.call(plane.kube.create("Notebook", _gpu_notebook(
            "train", "1x8", "low")))

        async def admitted(name):
            return await plane.state(name) == "Admitted"

        async def running(name):
            pod = await plane.kube.get_or_none("Pod", f"{name}-0", "ns")
            return ((pod or {}).get("status") or {}).get("phase") \
                == "Running"

        plane.call(plane.wait_for(lambda: admitted("train"), "train admitted"))
        plane.call(plane.wait_for(lambda: running("train"), "train running"))
        train_env = plane.call(_pod_env(plane, "train-0"))
        plane.call(plane.settle())
        before = plane.counts()

        fabric = checkpoint.CheckpointFabric(
            f"{tmp}/remote", staging_dir=f"{tmp}/staging",
            save_interval_steps=10 ** 6, environ=reuse.staging)

        def fetch():
            return plane.call(plane.annotations("train"))

        def patcher(update):
            if nbapi.CHECKPOINTED_AT_ANNOTATION in update:
                marks["ack"] = time.time()
                marks["ack_step"] = int(update[nbapi.CHECKPOINT_STEP_ANNOTATION])
            plane.call(plane.patch_annotations("train", update))

        guard = sdk.CheckpointGuard(
            fabric, sdk.MaintenanceWatcher(fetch=fetch, interval=0.0),
            sync_every_steps=CKPT_AT, patcher=patcher)

        class Saves:
            def save(self, step_no, tree):
                guard.step(step_no, tree)

            def wait(self):
                fabric.wait()

        def on_step(step_no, _loss):
            if step_no != 1:
                return
            # The waiter arrives while the victim trains.
            marks["waiter_created"] = time.time()
            plane.call(plane.kube.create("Notebook", _gpu_notebook(
                "urgent", "1x8", "high")))
            marks["waiter_admitted"] = plane.mark_when(
                lambda: admitted("urgent"), "urgent admitted")

            async def drain_requested():
                return (await plane.annotations("train")).get(
                    nbapi.DRAIN_REQUESTED_ANNOTATION)

            plane.call(plane.wait_for(drain_requested, "the drain request"))
            marks["drain_requested"] = time.time()

            async def waiter_state():
                return await plane.state("urgent")

            # The waiter's status lands at the end of the reconcile that
            # stamped the drain; no ack can come before step 3.
            marks["waiter_state_while_draining"] = plane.call(
                plane.wait_for(waiter_state, "the waiter's verdict"))

        torch.cuda.synchronize()
        _zero_launch_counts(fa)          # ---- the main path starts here
        trained = trainer.fit(reuse.fresh(), reuse.loader(), steps=CKPT_AT,
                              step_fn=reuse.step, checkpoints=Saves(),
                              save_every=1, on_step=on_step)
        torch.cuda.synchronize()
        guard.close()
        del trained
        marks["waiter_admitted"] = marks["waiter_admitted"].result(
            FLEET_TIMEOUT)
        plane.call(plane.settle())
        ann = plane.call(plane.annotations("train"))
        train_sts = plane.call(plane.kube.get("StatefulSet", "train", "ns"))
        urgent_sts = plane.call(plane.kube.get("StatefulSet", "urgent", "ns"))
        parked = {
            "stop_annotation": nbapi.STOP_ANNOTATION in ann,
            "replicas": train_sts["spec"]["replicas"],
            "cards_released": ("ns", "train")
            not in plane.sched.policy.ledger.allocations,
            "drain_reason": ann.get(nbapi.DRAIN_REASON_ANNOTATION),
            "checkpoint": [ann.get(nbapi.CHECKPOINT_PATH_ANNOTATION),
                           ann.get(nbapi.CHECKPOINT_STEP_ANNOTATION)]}
        urgent_requests = urgent_sts["spec"]["template"]["spec"][
            "containers"][0]["resources"]["requests"]
        # The user restarts the victim: it queues behind the waiter and
        # is re-admitted when the waiter is deleted.
        plane.call(plane.patch_annotations("train", {
            nbapi.STOP_ANNOTATION: None}))

        async def queued():
            return await plane.state("train") == "Queued"

        plane.call(plane.wait_for(queued, "train queued behind urgent"))
        readmitted = plane.mark_when(lambda: admitted("train"),
                                     "train re-admitted")
        plane.call(plane.kube.delete("Notebook", "urgent", "ns"))
        marks["victim_readmitted"] = readmitted.result(FLEET_TIMEOUT)
        plane.call(plane.wait_for(lambda: running("train"),
                                  "train running again"))
        plane.call(plane.settle())
        resumed_env = plane.call(_pod_env(plane, "train-0"))
        counts = _counts_since(before, plane.counts())
        plane.sched.policy.ledger.assert_consistent()

        path = resumed_env.get(migration.RESTORE_PATH_ENV)
        step_no = int(resumed_env.get(migration.RESTORE_STEP_ENV, -1))
        reader = checkpoint.CheckpointFabric(
            path, staging_dir=f"{tmp}/staging", environ=reuse.staging)
        restored = reader.restore(step_no, abstract=reuse.abstract)
        reader.close()
        resumed = trainer.fit(trainer.load_state(restored, reuse.tx),
                              reuse.loader(skip=step_no), steps=CKPT_STEPS,
                              step_fn=reuse.step, skip_batches=False)
        torch.cuda.synchronize()
        launches = _launch_counts(fa)    # ---- the main path ends here
        got = reuse.tensors(trainer.checkpoint_tree(resumed))
        bitwise = len(got) == len(reuse.straight) and all(
            map(torch.equal, got, reuse.straight))
        del restored, resumed, got
    finally:
        plane.close()
        shutil.rmtree(tmp, ignore_errors=True)
    t0 = marks["waiter_created"]
    return {
        "fleet": FLEET_SPEC, "quota_hard": hard,
        "train_pod_rendezvous": train_env.get("PET_MASTER_ADDR"),
        "host_sec": {"to_drain_request": marks["drain_requested"] - t0,
                     "to_ack": marks["ack"] - t0,
                     "to_waiter_admitted": marks["waiter_admitted"] - t0,
                     "to_victim_readmitted": marks["victim_readmitted"] - t0},
        "waiter_state_while_draining": marks["waiter_state_while_draining"],
        "parked": parked, "urgent_requests": urgent_requests,
        "restore_env": {migration.RESTORE_PATH_ENV: path,
                        migration.RESTORE_STEP_ENV: step_no},
        "fabric_directory": fabric.directory,
        "ack_step": marks["ack_step"], "bitwise": bitwise,
        **counts,
        "drain_fallbacks": plane.sched.m_drain_fallback.labels().value,
        "violations": plane.sched.policy.ledger.violations,
        "launches": launches}


def _counts_since(before: dict, after: dict) -> dict:
    """Reconciles (the notebook controller's, and each controller's) and
    API requests by verb between two ``counts()``."""
    was = before["api_requests_by_verb"]
    return {"reconciles": after["reconciles"] - before["reconciles"],
            "reconciles_by_controller": {
                name: n - before["reconciles_by_controller"].get(name, 0)
                for name, n in after["reconciles_by_controller"].items()},
            "api_requests_by_verb": {
                verb: n - was.get(verb, 0)
                for verb, n in after["api_requests_by_verb"].items()
                if n - was.get(verb, 0)}}


async def _pod_env(plane, name: str) -> dict:
    pod = await plane.kube.get("Pod", name, "ns")
    return {e["name"]: e.get("value")
            for e in pod["spec"]["containers"][0].get("env", [])}


def phase_fleet(torch, fa, trainer, checkpoint, sdk, reuse, warm: dict,
                card: str) -> dict:
    """The fleet scheduler, the profile quota and the warm pods on the
    card (module docstring, item 32): part (a) preempt-to-checkpoint,
    (b) the warm pod's claim and first launch, (c) a spot reclaim. Any
    failed check raises. Returns the launches of (a) and (b)."""
    from kubeflow_tpu_torch.gpu.topology import LOOPBACK_ADDR, GPU_RESOURCE
    from kubeflow_tpu_torch.scheduler import elastic

    t0 = time.perf_counter()
    preempt = _fleet_preempt(torch, fa, trainer, checkpoint, sdk, reuse)
    preempt_sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    warmed = _fleet_warm(warm)
    warm_sec = time.perf_counter() - t0
    t0 = time.perf_counter()
    spot = _fleet_spot_reclaim()
    spot_sec = time.perf_counter() - t0
    n = reuse.cfg.n_layers * CKPT_STEPS
    launches = {key: preempt["launches"].get(key, 0)
                + (warmed["launches"] if key == "fwd" else 0)
                for key in ("fwd", "dq", "dkv", "partial")}
    tol_o = TOL_O[warmed["dtype"]]
    row = {"phase": "fleet", "card": card,
           "clock": "host seconds (time.time) for the control plane's "
                    "marks; the card work between them is the trainer's",
           "preempt": preempt, "warm": warmed, "spot_reclaim": spot,
           "preempt_sec": preempt_sec, "warm_sec": warm_sec,
           "spot_sec": spot_sec, "launches": launches,
           "launches_expected": {"fwd": n + 1, "dq": n, "dkv": n,
                                 "partial": 0},
           "tol_o": tol_o, "tol_lse": TOL_LSE}
    emit(row)
    checks = {
        "quota": preempt["quota_hard"]
        == {f"requests.{GPU_RESOURCE}": str(FLEET_QUOTA)},
        "one_node_rendezvous": preempt["train_pod_rendezvous"]
        == LOOPBACK_ADDR,
        "waiter_queued": preempt["waiter_state_while_draining"] == "Queued",
        "drain_reason": preempt["parked"]["drain_reason"]
        == "preempt:priority",
        "parked": preempt["parked"]["stop_annotation"]
        and preempt["parked"]["replicas"] == 0
        and preempt["parked"]["cards_released"],
        "waiter_cards": preempt["urgent_requests"] == {GPU_RESOURCE: "8"},
        "restore_env": list(preempt["restore_env"].values())
        == [preempt["fabric_directory"], CKPT_AT],
        "ack_step": preempt["ack_step"] == CKPT_AT,
        "bitwise": preempt["bitwise"],
        "no_fallback": preempt["drain_fallbacks"] == 0
        and preempt["violations"] == 0,
        "order": 0 < preempt["host_sec"]["to_drain_request"]
        < preempt["host_sec"]["to_ack"]
        < preempt["host_sec"]["to_waiter_admitted"]
        < preempt["host_sec"]["to_victim_readmitted"],
        "warm_claim": warmed["claimed_pod"] == warmed["slot_pod"]
        and warmed["shim_claim"] == warmed["claim"]
        and (warmed["claim"] or "").startswith("ns/warm/")
        and warmed["owner"] == ["Notebook"]
        and warmed["reserved_before"] != []
        and ["ns", "warm"] in warmed["admitted"],
        "warm_command": warmed["command"] == [
            "python", "-m", "kubeflow_tpu_torch.sdk", "--warm-idle"],
        "warm_no_nvcc": warmed["cache_hit"],
        "warm_kernel": warmed["launches"] == 1 and warmed["finite"]
        and warmed["max_err_o"] <= tol_o
        and warmed["max_err_lse"] <= TOL_LSE,
        "spot": spot["resident"] != {} and spot["released"]
        and set(spot["drain_reasons"].values())
        == {elastic.SPOT_RECLAIM_REASON}
        and spot["priorities_kept"] and spot["pool_closed_while_signalled"]
        and spot["stayed"] != [] and spot["violations"] == 0
        and spot["drain_fallbacks"] == 0 and spot["passes_checked"] > 0,
        "launches": launches == row["launches_expected"],
    }
    if not all(checks.values()):
        raise AssertionError(f"fleet phase failed: {checks}")
    return launches


# ---- the serving_control phase: an InferenceService and the culler ----------

# One H100 node (FLEET_SPEC), the one card standing for its eight; the
# service's 1x1 replica borrows the node through the elastic flex
# placement (the fleet has no 1x1 pool), so elastic is on and the
# defragmenter off.
SERVING_IDLE_SEC = 1.0          # the service's scaleToZeroAfterSeconds
SERVING_TRACE = dict(seed=11, warm_rate=10.0, burst_rate=80.0, warm_sec=0.5,
                     burst_sec=0.5, cool_sec=0.5, tokens_out=8,
                     tokens_jitter=4, long_prompt_frac=0.05,
                     long_prompt_tokens=96)
SERVING_PROBE_SEED = 13
# Part (d): the culled notebook's trainer, CKPT_MODEL at one layer (its
# commit is then about half the checkpoint phase's), and the culler's env
# as a manager reads it.
CULL_MODEL = dict(CKPT_MODEL, n_layers=1)
CULL_STEPS = 2
CULL_ENV = {"ENABLE_CULLING": "true", "CULL_IDLE_TIME": "30",
            "IDLENESS_CHECK_PERIOD": "0.05", "KFTPU_MIGRATION": "on",
            "KFTPU_CULL_DRAIN": "on", "KFTPU_DRAIN_GRACE": str(FLEET_TIMEOUT),
            "KFTPU_SERVING_AUTOSCALE_PERIOD": "0.2",
            "KFTPU_SERVING_PARK_GRACE": str(FLEET_TIMEOUT),
            "KFTPU_SERVING_STABILIZATION": "0.1"}

# A serving replica's process: the replica pod's container, started with
# the pod's env after admission and nothing else of the replica's own.
# Without a restore hint in the env it cold-starts the engine from a seed;
# with one (KFTPU_RESTORE_CHECKPOINT_PATH / KFTPU_RESTORE_STEP) it reads
# the parked weights from that fabric directory and brings them in through
# the engine's parked state (a warm restore: no init). Either way it scores
# one fixed prompt batch (its last-position logits saved for the script),
# serves a seeded burst trace, and prints one JSON line. A cold replica
# then waits for "park" on stdin: the engine parks, the fabric snapshots
# the parked weights (one line: the ack's path and step) and commits them
# (one more line) before the process exits.
SERVING_REPLICA_CHILD = r"""
import json, os, sys, time
started = time.time()
import torch
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.checkpoint import CheckpointFabric
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.models import burnin
from kubeflow_tpu_torch.ops import flash_attention as fa
from kubeflow_tpu_torch.serving import engine as engine_mod
from kubeflow_tpu_torch.serving import loadgen

def say(obj):
    print(json.dumps(obj), flush=True)

spec = json.loads(os.environ["SMOKE_SERVING"])
cfg = burnin.BurninConfig(**spec["model"])
info = sdk.SliceInfo.from_env()
torch.zeros(1, device=spec["device"])
context_at = time.time()
for name in ("LAUNCHES", "BWD_DQ_LAUNCHES", "BWD_DKV_LAUNCHES",
             "PARTIAL_LAUNCHES"):
    setattr(fa, name, 0)
engine = engine_mod.ServingEngine(
    cfg, max_batch=spec["max_batch"], device=spec["device"],
    options=engine_mod.EngineOptions(prefill_chunk=spec["prefill_chunk"]))
path = os.environ.get(migration.RESTORE_PATH_ENV)
out = {"pid": os.getpid(), "restore_path": path,
       "slice": {"processes": info.num_processes,
                 "coordinator": info.coordinator_address,
                 "accelerator": os.environ.get("KFTPU_ACCELERATOR")}}
if path is None:
    out["cold_start_sec"] = engine.cold_start(seed=0)
else:
    t0 = time.perf_counter()
    fabric = CheckpointFabric(path)
    host = fabric.restore(int(os.environ[migration.RESTORE_STEP_ENV]))
    out["restore_tier"] = fabric.last_restore["tier"]
    fabric.close()
    out["fabric_read_sec"] = time.perf_counter() - t0
    entry = engine.models.entry(engine_mod.DEFAULT_MODEL)
    entry.host_params = host
    entry.decode_fn, entry.prefill_fn = engine.models._build_fns(
        cfg, engine.models.mesh)
    engine._host_params, engine.parked = host, True
    out["warm_restore_sec"] = engine.warm_restore()
    out["restore_sec"] = time.perf_counter() - t0
    out["cold_inits"] = engine.models.swaps_cold
out["ready_at"] = time.time()
gen = torch.Generator(device=spec["device"]).manual_seed(spec["probe_seed"])
probe = torch.randint(0, cfg.vocab, (spec["max_batch"], cfg.seq_len),
                      generator=gen, device=spec["device"])
with torch.inference_mode():
    logits = burnin.forward(engine._params, probe, cfg)[:, -1]
first = logits.argmax(-1).cpu()
out["first_token_at"] = time.time()
torch.save(logits.cpu(), os.path.join(
    spec["out"], "logits-%s.pt" % ("cold" if path is None else "warm")))
trace = loadgen.burst_trace(**spec["trace"])
report = engine.serve(trace)
engine.kv.assert_consistent()
if spec["device"] == "cuda":
    torch.cuda.synchronize()
out.update(
    started_at=started, context_at=context_at, served_at=time.time(),
    first_tokens=first.tolist(), requests=len(trace),
    completed=len(report.completions), tokens=report.tokens,
    steps=report.steps, prefill_chunks=report.prefill_chunks,
    model_swaps=report.model_swaps,
    p50_latency_sec=report.latency_percentile(0.5),
    p99_latency_sec=report.latency_percentile(0.99),
    kv_violations=engine.kv.violations,
    launches={"fwd": fa.LAUNCHES, "dq": fa.BWD_DQ_LAUNCHES,
              "dkv": fa.BWD_DKV_LAUNCHES, "partial": fa.PARTIAL_LAUNCHES},
    weight_bytes=sum(t.numel() * t.element_size() for t in
                     burnin.leaves(engine._params)))
say(out)
if path is None:
    if sys.stdin.readline().strip() != "park":
        raise SystemExit("expected the word park on stdin")
    t0 = time.perf_counter()
    parked = engine.park()
    park_sec = time.perf_counter() - t0
    fabric = CheckpointFabric(spec["park_dir"])
    t0 = time.perf_counter()
    handle = fabric.save_async(parked["step"], engine._host_params)
    say({"path": fabric.directory, "step": parked["step"],
         "park_sec": park_sec, "snapshot_sec": time.perf_counter() - t0})
    say({"committed": handle.result(timeout=600),
         "commit_sec": time.perf_counter() - t0})
    fabric.close()
"""


class ReplicaProcess:
    """One serving replica's process, its stdout lines read on a thread
    of their own so that every wait has a deadline."""

    def __init__(self, pod_env: dict, spec: dict):
        import atexit
        import queue
        import tempfile
        import threading
        from pathlib import Path

        env = _pod_process_env(pod_env)
        env["SMOKE_SERVING"] = json.dumps(spec)
        self.err = tempfile.TemporaryFile(mode="w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", SERVING_REPLICA_CHILD], env=env,
            cwd=Path(__file__).parent, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.err, text=True,
            start_new_session=True)
        atexit.register(_stop_group, self.proc)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("{"):
                self.lines.put(json.loads(line))
        self.lines.put(None)

    def line(self) -> dict:
        import queue

        try:
            got = self.lines.get(timeout=SPAWN_TIMEOUT)
        except queue.Empty:
            got = None
        if got is None:
            _stop_group(self.proc)
            self.err.seek(0)
            raise AssertionError(f"serving replica process gave no line "
                                 f"({self.proc.poll()}):\n{self.err.read()}")
        return got

    def tell(self, word: str) -> None:
        self.proc.stdin.write(word + "\n")
        self.proc.stdin.flush()

    def wait(self) -> int:
        try:
            return self.proc.wait(timeout=SPAWN_TIMEOUT)
        finally:
            _stop_group(self.proc)


def _serving_expected(cfg, child: dict) -> dict:
    """A replica's launches: per layer, its engine's two warm-up scores
    (decode and prefill shapes), the fixed batch, and every decode step
    and prefill chunk it served."""
    n = cfg.n_layers * (3 + child["steps"] + child["prefill_chunks"]
                        + 2 * child["model_swaps"])
    return {"fwd": n, "dq": 0, "dkv": 0, "partial": 0}


def _cull_drain(torch, fa, burnin, trainer, data, checkpoint, sdk, plane,
                jupyter: dict, tmp: str) -> dict:
    """Part (d): a 1x8 notebook on the node the parked service freed; its
    in-pod guard runs ``fit`` on the card; the scripted Jupyter server
    turns reachable with idle kernels an hour old; the culler must stamp
    the idle signal, request a ``cull`` drain, and stop the notebook on
    the guard's ack."""
    import numpy as np

    from kubeflow_tpu_torch.api import notebook as nbapi
    from kubeflow_tpu_torch.models.tree import map_params

    marks: dict = {}
    plane.call(plane.kube.create("Notebook", _gpu_notebook("idle", "1x8")))

    async def running():
        pod = await plane.kube.get_or_none("Pod", "idle-0", "ns")
        nb = await plane.kube.get_or_none("Notebook", "idle", "ns")
        return ((pod or {}).get("status") or {}).get("phase") == "Running" \
            and (((nb or {}).get("status") or {}).get("gpu") or {}).get(
                "chips") == 8

    plane.call(plane.wait_for(running, "the notebook running"))
    cfg = burnin.BurninConfig(**CULL_MODEL)
    tx = trainer.make_optimizer(trainer.TrainerConfig())
    step = trainer.make_train_step(partial(burnin.loss_fn, cfg=cfg), tx)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (CULL_STEPS * TRAIN_BATCH, cfg.seq_len), dtype=np.int64)
    state = trainer.init_state(map_params(torch.clone, burnin.init_params(
        cfg, seed=7, device="cuda")), tx)
    loader = data.global_batches(data.prefetch(data.ShardedLoader(
        data.ArraySource(tokens), TRAIN_BATCH, seed=4,
        transform=lambda b: b[0])))
    fabric = checkpoint.CheckpointFabric(
        f"{tmp}/idle", save_interval_steps=10 ** 6)

    def fetch():
        return plane.call(plane.annotations("idle"))

    def patcher(update):
        if nbapi.CHECKPOINTED_AT_ANNOTATION in update:
            marks["ack"] = time.time()
            marks["ack_step"] = int(update[nbapi.CHECKPOINT_STEP_ANNOTATION])
        plane.call(plane.patch_annotations("idle", update))

    guard = sdk.CheckpointGuard(
        fabric, sdk.MaintenanceWatcher(fetch=fetch, interval=0.0),
        sync_every_steps=1, patcher=patcher)

    class Saves:
        def save(self, step_no, tree):
            guard.step(step_no, tree)

        def wait(self):
            fabric.wait()

    async def annotation(key):
        return (await plane.annotations("idle")).get(key)

    def on_step(step_no, _loss):
        if step_no != 1:
            return
        marks["stopped"] = plane.mark_when(
            lambda: annotation(nbapi.STOP_ANNOTATION), "the notebook stopped")
        marks["released"] = plane.mark_when(
            lambda: _released(plane, ("ns", "idle")), "its cards released")
        # The Jupyter server answers from now on; the culler probes it.
        marks["probe"] = time.time()
        jupyter["up"] = True
        plane.mgr.enqueue("culling", ("ns", "idle"))
        plane.call(plane.wait_for(
            lambda: annotation(nbapi.DRAIN_REQUESTED_ANNOTATION),
            "the cull drain request"))
        marks["drain_requested"] = time.time()

    torch.cuda.synchronize()
    _zero_launch_counts(fa)              # ---- the main path starts here
    state = trainer.fit(state, loader, steps=CULL_STEPS, step_fn=step,
                        checkpoints=Saves(), save_every=1, on_step=on_step)
    torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- the main path ends here
    t0 = time.perf_counter()
    guard.close()                        # blocks on the commit
    commit_wait = time.perf_counter() - t0
    del state
    for key in ("stopped", "released"):
        marks[key] = marks[key].result(FLEET_TIMEOUT)
    plane.call(plane.settle())
    ann = plane.call(plane.annotations("idle"))
    sts = plane.call(plane.kube.get("StatefulSet", "idle", "ns"))
    t0 = marks["probe"]
    return {
        "model": CULL_MODEL, "steps": CULL_STEPS,
        "host_sec": {"to_drain_request": marks["drain_requested"] - t0,
                     "to_ack": marks["ack"] - t0,
                     "to_stopped": marks["stopped"] - t0,
                     "to_cards_released": marks["released"] - t0},
        "commit_wait_after_fit_sec": commit_wait,
        "last_activity": ann.get(nbapi.LAST_ACTIVITY_ANNOTATION),
        "drain_reason": ann.get(nbapi.DRAIN_REASON_ANNOTATION),
        "stopped": nbapi.STOP_ANNOTATION in ann,
        "replicas": sts["spec"]["replicas"],
        "checkpoint": [ann.get(nbapi.CHECKPOINT_PATH_ANNOTATION),
                       ann.get(nbapi.CHECKPOINT_STEP_ANNOTATION)],
        "fabric_directory": fabric.directory, "ack_step": marks["ack_step"],
        "cards_culled": plane.culler.m_chips_culled.labels().value,
        "probes": jupyter["probes"], "launches": launches,
        "launches_expected": {"fwd": cfg.n_layers * CULL_STEPS,
                              "dq": cfg.n_layers * CULL_STEPS,
                              "dkv": cfg.n_layers * CULL_STEPS,
                              "partial": 0}}


async def _released(plane, key) -> bool:
    return tuple(key) not in plane.sched.policy.ledger.allocations


def phase_serving_control(torch, fa, burnin, trainer, data, checkpoint, sdk,
                          card: str) -> dict:
    """The InferenceService and the culler on the card (module docstring,
    item 33): (a) scale from zero, (b) park to a checkpoint, (d) the cull
    drain on the node the park freed, (c) the warm restore from the
    replica's env; then the service is deleted. Any failed check raises.
    Returns the phase's launches (both replicas' and the trainer's)."""
    import shutil
    import tempfile

    from kubeflow_tpu_torch.api import inferenceservice as isvcapi
    from kubeflow_tpu_torch.api import profile as profileapi
    from kubeflow_tpu_torch.gpu.topology import GPU_RESOURCE, LOOPBACK_ADDR
    from kubeflow_tpu_torch.migration import protocol as migration
    from kubeflow_tpu_torch.runtime.objects import fmt_iso
    from kubeflow_tpu_torch.scheduler import (Fleet, GpuFleetScheduler,
                                              SchedulerOptions)

    phase_t0 = time.perf_counter()
    jupyter = {"up": False, "probes": 0}

    async def prober(url):
        if not jupyter["up"]:
            return None              # not reachable: never culled
        jupyter["probes"] += 1
        if url.endswith("/kernels"):
            return [{"execution_state": "idle",
                     "last_activity": fmt_iso(time.time() - 3600)}]
        return []

    plane = ControlPlane(
        lambda kube, registry: GpuFleetScheduler(kube, SchedulerOptions(
            queued_requeue_seconds=0.05, enable_migration=True,
            drain_grace_seconds=FLEET_TIMEOUT,
            commit_grace_seconds=FLEET_TIMEOUT, enable_elastic=True,
            enable_defrag=False),
            fleet=Fleet.parse(FLEET_SPEC), registry=registry),
        profiles=True, environ=CULL_ENV, serving=True, prober=prober)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-serving-")
    key = isvcapi.replica_key("ns", "svc", 0)
    marks: dict = {}
    children: list = []
    try:
        plane.call(plane.kube.create("Profile", profileapi.new(
            "ns", "owner@example.com", gpu_quota=FLEET_QUOTA)))
        before = plane.counts()
        spec = {"model": MODEL, "max_batch": MAX_BATCH,
                "prefill_chunk": PREFILL_CHUNK, "trace": SERVING_TRACE,
                "probe_seed": SERVING_PROBE_SEED, "device": "cuda",
                "out": tmp}

        async def isvc_annotations():
            live = await plane.kube.get("InferenceService", "svc", "ns")
            return dict(live["metadata"].get("annotations") or {})

        async def stamp_load(rate, fresh):
            await plane.kube.patch("InferenceService", "svc", {"metadata": {
                "annotations": {
                    isvcapi.OBSERVED_RATE_ANNOTATION: str(rate),
                    isvcapi.LAST_REQUEST_AT_ANNOTATION: fmt_iso(
                        time.time() if fresh else time.time() - 3600)}}},
                "ns")

        async def admitted():
            alloc = plane.sched.policy.ledger.allocations.get(key)
            return alloc is not None and alloc.workload == "serving"

        async def pod_running():
            pod = await plane.kube.get_or_none("Pod", "svc-r0-0", "ns")
            return ((pod or {}).get("status") or {}).get("phase") \
                == "Running" and pod

        # (a) scale from zero: the gateway's load on a fresh service.
        marks["create"] = time.time()
        plane.call(plane.kube.create("InferenceService", isvcapi.new(
            "svc", "ns", accelerator=PROBE_ACCELERATOR, topology="1x1",
            min_replicas=0, max_replicas=2,
            scale_to_zero_after=SERVING_IDLE_SEC)))
        is_admitted = plane.mark_when(admitted, "replica 0 admitted")
        is_running = plane.mark_when(pod_running, "replica 0 running")
        plane.call(stamp_load(4.0, True))
        marks["admitted"] = is_admitted.result(FLEET_TIMEOUT)
        marks["running"] = is_running.result(FLEET_TIMEOUT)
        sts = plane.call(plane.kube.get("StatefulSet", "svc-r0", "ns"))
        pod_env = plane.call(_pod_env(plane, "svc-r0-0"))
        cold = ReplicaProcess(pod_env, {**spec, "park_dir": f"{tmp}/svc"})
        children.append(cold)
        cold_out = cold.line()

        # (b) park: the gateway's last request an hour old.
        async def park_requested():
            return (await isvc_annotations()).get(
                isvcapi.PARK_REQUESTED_ANNOTATION)

        requested = plane.mark_when(park_requested, "the park request")
        marks["park_load_stamped"] = time.time()
        plane.call(stamp_load(0.0, False))
        marks["park_request"] = requested.result(FLEET_TIMEOUT)
        park_value = plane.call(park_requested())

        async def parked():
            return isvcapi.PARKED_AT_ANNOTATION in await isvc_annotations()

        is_parked = plane.mark_when(parked, "the park")
        is_released = plane.mark_when(lambda: _released(plane, key),
                                      "the replica's cards released")
        cold.tell("park")
        ack = cold.line()
        marks["ack"] = time.time()
        plane.call(plane.kube.patch("InferenceService", "svc", {"metadata": {
            "annotations": {
                isvcapi.PARK_CHECKPOINT_PATH_ANNOTATION: ack["path"],
                isvcapi.PARK_CHECKPOINT_STEP_ANNOTATION: str(ack["step"]),
                isvcapi.PARK_CHECKPOINT_FOR_ANNOTATION: park_value}}}, "ns"))
        marks["parked"] = is_parked.result(FLEET_TIMEOUT)
        marks["cards_released"] = is_released.result(FLEET_TIMEOUT)
        plane.call(plane.settle())
        park_state = {
            "sts_replicas": plane.call(plane.kube.get(
                "StatefulSet", "svc-r0", "ns"))["spec"]["replicas"],
            "higher_sts": [s["metadata"]["name"] for s in plane.call(
                plane.kube.list("StatefulSet", "ns"))
                if s["metadata"]["name"].startswith("svc-r")
                and s["metadata"]["name"] != "svc-r0"],
            "parked_events": [e["message"] for e in plane.call(
                plane.kube.list("Event", "ns")) if e["reason"] == "Parked"]}

        # (d) the cull drain, while the parked replica's process commits.
        cull = _cull_drain(torch, fa, burnin, trainer, data, checkpoint, sdk,
                           plane, jupyter, tmp)
        commit = cold.line()
        cold_rc = cold.wait()

        # (c) warm restore: a new burst on the parked service.
        marks["burst"] = time.time()
        is_admitted = plane.mark_when(admitted, "replica 0 re-admitted")
        is_running = plane.mark_when(pod_running, "replica 0 running again")
        plane.call(stamp_load(4.0, True))
        marks["readmitted"] = is_admitted.result(FLEET_TIMEOUT)
        marks["running_again"] = is_running.result(FLEET_TIMEOUT)
        restore_env = plane.call(_pod_env(plane, "svc-r0-0"))
        warm = ReplicaProcess(restore_env, spec)
        children.append(warm)
        warm_out = warm.line()
        warm_rc = warm.wait()
        plane.call(plane.settle())
        ann = plane.call(isvc_annotations())
        reasons = sorted({e["reason"] for e in plane.call(
            plane.kube.list("Event", "ns"))})

        # The service goes: every replica's cards come back.
        plane.call(plane.kube.delete("InferenceService", "svc", "ns"))
        plane.call(plane.wait_for(lambda: _released(plane, key),
                                  "the deleted service released"))
        plane.call(plane.settle())
        counts = _counts_since(before, plane.counts())
        ledger = plane.sched.policy.ledger
        ledger.assert_consistent()
        logits = [torch.load(f"{tmp}/logits-{arm}.pt")
                  for arm in ("cold", "warm")]
        main = sts["spec"]["template"]["spec"]["containers"][0]
        row = {
            "phase": "serving_control", "card": card, "fleet": FLEET_SPEC,
            "clock": "host seconds (time.time) for the control plane's "
                     "marks; the replicas' card work runs in their own "
                     "processes, the culled notebook's trainer on the main "
                     "thread",
            "replica_requests": main["resources"]["requests"],
            "replica_env": {k: v for k, v in pod_env.items()
                            if k.startswith(("PET_", "TPU_", "KFTPU_"))},
            "host_sec": {
                "create_to_admitted": marks["admitted"] - marks["create"],
                "create_to_running": marks["running"] - marks["create"],
                "create_to_ready": cold_out["ready_at"] - marks["create"],
                "create_to_first_token": cold_out["first_token_at"]
                - marks["create"],
                "process_start_to_first_token": cold_out["first_token_at"]
                - cold_out["started_at"],
                "park_request_to_ack": marks["ack"] - marks["park_request"],
                "ack_to_parked": marks["parked"] - marks["ack"],
                "ack_to_cards_released": marks["cards_released"]
                - marks["ack"],
                "load_stamp_to_park_request": marks["park_request"]
                - marks["park_load_stamped"],
                "burst_to_readmitted": marks["readmitted"] - marks["burst"],
                "burst_to_running": marks["running_again"] - marks["burst"],
                "burst_to_restored": warm_out["ready_at"] - marks["burst"],
                "burst_to_restored_first_token": warm_out["first_token_at"]
                - marks["burst"]},
            "cold_child": cold_out, "park": ack, "commit": commit,
            "warm_child": warm_out, "park_state": park_state,
            "restore_env": {k: restore_env.get(k) for k in (
                migration.RESTORE_PATH_ENV, migration.RESTORE_STEP_ENV)},
            "annotations_after_restore": {
                k: ann.get(k) for k in (isvcapi.PARKED_AT_ANNOTATION,
                                        isvcapi.PARK_REQUESTED_ANNOTATION)},
            "event_reasons": reasons,
            "logits_bitwise": torch.equal(*logits),
            "logits_shape": list(logits[0].shape),
            "cull": cull, **counts,
            "drain_fallbacks": plane.sched.m_drain_fallback.labels().value,
            "violations": ledger.violations,
            "allocations_after_delete": [list(k) for k in ledger.allocations],
            "phase_sec": time.perf_counter() - phase_t0}
    finally:
        for child in children:
            _stop_group(child.proc)
        plane.close()
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = burnin.BurninConfig(**MODEL)
    expected = {name: [_serving_expected(cfg, row[name]), row[name][
        "launches"]] for name in ("cold_child", "warm_child")}
    launches = {k: row["cold_child"]["launches"][k]
                + row["warm_child"]["launches"][k] + cull["launches"][k]
                for k in ("fwd", "dq", "dkv", "partial")}
    row["launches"] = launches
    row["launches_expected"] = {
        k: expected["cold_child"][0][k] + expected["warm_child"][0][k]
        + cull["launches_expected"][k] for k in launches}
    emit(row)
    cold_out, warm_out = row["cold_child"], row["warm_child"]
    checks = {
        # (a)
        "admitted_one_card": row["replica_requests"] == {GPU_RESOURCE: "1"},
        "loopback": row["replica_env"].get("PET_MASTER_ADDR")
        == LOOPBACK_ADDR and cold_out["slice"]["processes"] == 1,
        "served_cold": cold_out["completed"] == cold_out["requests"] > 0
        and cold_out["kv_violations"] == 0
        and cold_out["restore_path"] is None,
        # (b)
        "park_ack": row["park"]["path"] == f"{tmp}/svc"
        and row["commit"]["committed"] and cold_rc == 0,
        "parked": park_state["sts_replicas"] == 0
        and park_state["higher_sts"] == []
        and park_state["parked_events"] == [
            "Scaled to zero; replica 0 kept as a parked warm standby "
            f"(checkpoint @ step {row['park']['step']})"],
        # (c)
        "restore_env": list(row["restore_env"].values())
        == [row["park"]["path"], str(row["park"]["step"])]
        and warm_out["restore_path"] == row["park"]["path"],
        "warm_no_init": warm_out["cold_inits"] == 0 and warm_rc == 0,
        "served_warm": warm_out["completed"] == warm_out["requests"]
        == cold_out["requests"] and warm_out["kv_violations"] == 0,
        "bitwise": row["logits_bitwise"]
        and warm_out["first_tokens"] == cold_out["first_tokens"],
        "park_consumed": set(row["annotations_after_restore"].values())
        == {None} and "WarmRestored" in reasons,
        # (d)
        "cull": cull["drain_reason"] == "cull" and cull["stopped"]
        and cull["replicas"] == 0 and cull["last_activity"] is not None
        and cull["checkpoint"] == [cull["fabric_directory"],
                                   str(cull["ack_step"])]
        and cull["cards_culled"] == 8.0
        and "CullDrainDeadlineExceeded" not in reasons
        and "NotebookCulled" in reasons,
        "order": 0 < cull["host_sec"]["to_drain_request"]
        < cull["host_sec"]["to_ack"] < cull["host_sec"]["to_stopped"],
        "ledger": row["violations"] == 0 and row["drain_fallbacks"] == 0
        and row["allocations_after_delete"] == [],
        "launches": launches == row["launches_expected"]
        and all(got == want for want, got in expected.values())
        and cull["launches"] == cull["launches_expected"],
    }
    if not all(checks.values()):
        raise AssertionError(f"serving_control phase failed: {checks}")
    return launches


# ---- the entrypoints phase: the controller manager and the webhook as processes

# The fake apiserver's address: HttpKube's fallback where no in-cluster
# ServiceAccount is mounted (runtime/httpclient.py), so both entry points
# reach it with no flag.
FACADE_HOST, FACADE_PORT = "127.0.0.1", 8001
# Events the facade keeps for watches that resume from a list's version.
FACADE_HISTORY = 100_000
ENTRY_TIMEOUT = 60.0
# The admission webhooks of manifests/base/webhook.yaml: each kind's path
# on the webhook server and the operations sent there.
WEBHOOK_PATHS = {
    "Notebook": ("/mutate-notebooks", ("CREATE", "UPDATE")),
    "PVCViewer": ("/mutate-pvcviewers", ("CREATE", "UPDATE")),
    "Pod": ("/apply-poddefault", ("CREATE",)),
    "PodDefault": ("/validate-poddefaults", ("CREATE", "UPDATE")),
    "Profile": ("/validate-profiles", ("CREATE", "UPDATE")),
    "Tensorboard": ("/validate-tensorboards", ("CREATE", "UPDATE")),
}
# The fleet's one node (FLEET_SPEC's pool ``a3``), for the kubelet
# simulator's node assignment.
ENTRY_NODE = {"apiVersion": "v1", "kind": "Node", "metadata": {
    "name": "a3-0", "labels": {"cloud.google.com/gke-accelerator":
                               PROBE_ACCELERATOR,
                               "cloud.google.com/gke-nodepool": "a3"}}}
# The notebook mounts the claim ``logs`` where the images keep their
# TensorBoard logs; a PodDefault points the SDK's profiler at a run there.
ENTRY_MOUNT = "/home/jovyan/logs"
ENTRY_RUN = "run1"
ENTRY_TRACED_STEPS = 2
ENTRY_KERNELS = ("fwd_bf16_kernel", "dq_bf16_kernel", "dkv_bf16_kernel")

# The admitted pod's process: started with the env the wire webhook gave
# the pod, it joins the SDK's world (a no-op at one card) and launches the
# forward kernel at the decode shape against its plain version.
ENTRY_POD_CHILD = r"""
import json, os, time
import torch
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.ops import flash_attention as fa

joined = sdk.initialize_distributed()
shape, dtype, causal = json.loads(os.environ["SMOKE_ENTRY_CASE"])
gen = torch.Generator(device="cuda").manual_seed(4321)
q, k, v = (torch.randn(shape, generator=gen, device="cuda")
           .to(getattr(torch, dtype)) for _ in range(3))
fa.LAUNCHES = 0
o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
torch.cuda.synchronize()
result_at = time.time()
launches = fa.LAUNCHES
ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
print(json.dumps({
    "sdk_joined": joined, "result_at": result_at, "launches": launches,
    "max_err_o": (o.float() - ro.float()).abs().max().item(),
    "max_err_lse": (lse - rlse).abs().max().item(),
    "finite": bool(torch.isfinite(o).all())}), flush=True)
"""


class ApiFacade(LoopThread):
    """The port's fake apiserver (``testing.FakeKube`` with
    ``register_all``, the kubelet simulator ``PodSimulator``) served over
    HTTP in the Kubernetes REST conventions ``runtime.httpclient.HttpKube``
    speaks: get, list with the collection's ``resourceVersion``,
    ``?watch=true`` as chunked JSON lines, create, update, merge patch and
    the ``status`` subresource, delete; paths from the scheme's
    kinds, core and grouped, namespaced and cluster-scoped. Scaffolding
    for the entrypoints phase and its CPU test, on an event loop of its
    own thread; not a module of the package.

    A list's ``resourceVersion`` is the facade's event number: every event
    the fake apiserver sends its watchers is kept with its number, and a
    watch from version N first replays the kept events after N, so an
    informer misses nothing between its list and its watch.

    SubjectAccessReviews are answered from the RoleBindings and Profiles
    it holds (``testing.rbac``). Admission runs in-process
    (``register_all``), or with ``in_process_admission=False`` nowhere
    until :meth:`admit_through` sends it to the webhook process, as a
    cluster's webhook configurations do."""

    def __init__(self, host: str = FACADE_HOST, port: int = FACADE_PORT,
                 nodes: tuple = (), in_process_admission: bool = True):
        super().__init__("api-facade")
        self.requests: dict = {}
        self.admissions: list = []
        self.session = None
        try:
            self.call(self._start(host, port, nodes, in_process_admission))
        except OSError as e:
            self.stop_loop()
            raise AssertionError(f"the fake apiserver cannot listen on "
                                 f"{host}:{port}: {e}") from None

    async def _start(self, host: str, port: int, nodes: tuple,
                     in_process_admission: bool) -> None:
        import collections

        from aiohttp import web

        from kubeflow_tpu_torch.testing import FakeKube, PodSimulator
        from kubeflow_tpu_torch.testing.rbac import register_sar_evaluator
        from kubeflow_tpu_torch.webhooks import register_all

        self.kube = FakeKube()
        if in_process_admission:
            register_all(self.kube)
        register_sar_evaluator(self.kube)
        self.seq = 0
        self.history: collections.deque = collections.deque(
            maxlen=FACADE_HISTORY)
        notify = self.kube._notify

        def kept(event: str, obj: dict) -> None:
            import copy

            self.seq += 1
            self.history.append((self.seq, event, copy.deepcopy(obj)))
            notify(event, obj)

        self.kube._notify = kept
        self.kinds = {(gvk.group, gvk.plural): gvk
                      for gvk in self.kube.scheme.kinds()}
        for node in nodes:
            await self.kube.create("Node", node)
        self.sim = PodSimulator(self.kube)
        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self.runner = web.AppRunner(app, shutdown_timeout=1.0)
        await self.runner.setup()
        try:
            await web.TCPSite(self.runner, host, port).start()
        except OSError:
            await self.runner.cleanup()
            raise
        await self.sim.start()

    async def _stop(self) -> None:
        await self.sim.stop()
        self.kube.close_watches()
        await self.runner.cleanup()
        if self.session is not None:
            await self.session.close()

    def admit_through(self, hook: str, cafile: str) -> None:
        """Send every admission of WEBHOOK_PATHS' kinds to the webhook
        server at ``hook`` (HTTPS, its certificate in ``cafile``) as an
        AdmissionReview, apply the JSONPatch it answers, and refuse the
        request with its status where it denies; each review is kept in
        ``admissions`` as (kind, path, allowed, host seconds)."""
        self.call(self._admit_through(hook, cafile))

    async def _admit_through(self, hook: str, cafile: str) -> None:
        import base64
        import ssl
        import uuid

        import aiohttp

        from kubeflow_tpu_torch.runtime.errors import error_for_code
        from kubeflow_tpu_torch.webhooks import jsonpatch

        tls = ssl.create_default_context(cafile=cafile)
        self.session = aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=ENTRY_TIMEOUT))

        def forwarder(kind: str, path: str, operations: tuple):
            async def review(obj: dict, info: dict) -> None:
                if info.get("operation") not in operations:
                    return
                meta = obj.get("metadata") or {}
                body = {"apiVersion": "admission.k8s.io/v1",
                        "kind": "AdmissionReview", "request": {
                            "uid": str(uuid.uuid4()),
                            "operation": info["operation"],
                            "namespace": meta.get("namespace"),
                            "object": obj, "oldObject": info.get("old")}}
                t0 = time.perf_counter()
                async with self.session.post(hook + path, json=body,
                                             ssl=tls) as resp:
                    answer = (await resp.json())["response"]
                self.admissions.append((kind, path, answer["allowed"],
                                        time.perf_counter() - t0))
                if not answer["allowed"]:
                    status = answer.get("status") or {}
                    raise error_for_code(
                        status.get("code", 400),
                        f"admission webhook {path} denied the request: "
                        f"{status.get('message', '')}")
                if answer.get("patch"):
                    patched = jsonpatch.apply(obj, json.loads(
                        base64.b64decode(answer["patch"])))
                    obj.clear()
                    obj.update(patched)

            return review

        for kind, (path, operations) in WEBHOOK_PATHS.items():
            self.kube.add_mutator(kind, forwarder(kind, path, operations))

    def close(self) -> None:
        try:
            self.call(self._stop())
        finally:
            self.stop_loop()

    def _route(self, path: str) -> tuple:
        """``/api/v1/...`` or ``/apis/<group>/<version>/...`` → (GVK,
        namespace, name, subresource)."""
        parts = [p for p in path.split("/") if p]
        if parts[:1] == ["api"]:
            group, rest = "", parts[2:]
        elif parts[:1] == ["apis"]:
            group, rest = parts[1], parts[3:]
        else:
            raise KeyError(path)
        namespace = None
        if rest[:1] == ["namespaces"] and len(rest) >= 3:
            namespace, rest = rest[1], rest[2:]
        gvk = self.kinds[(group, rest[0])]
        return (gvk, namespace, rest[1] if len(rest) > 1 else None,
                rest[2] if len(rest) > 2 else None)

    async def _handle(self, request):
        from aiohttp import web

        from kubeflow_tpu_torch.runtime.errors import ApiError, NotFound

        try:
            gvk, ns, name, sub = self._route(request.path)
        except (KeyError, IndexError):
            return self._status(NotFound(f"no route {request.path}"))
        kind, query, method = gvk.kind, request.query, request.method
        if method == "GET" and name is None:
            verb = "watch" if query.get("watch") == "true" else "list"
        else:
            verb = {"GET": "get", "POST": "create", "PUT": "update",
                    "PATCH": "patch", "DELETE": "delete"}.get(method, method)
        self.requests[verb] = self.requests.get(verb, 0) + 1
        try:
            if verb == "watch":
                return await self._watch(request, kind, ns, query)
            if verb == "list":
                items, _ = await self.kube.list_with_rv(
                    kind, ns, query.get("labelSelector") or None)
                return web.json_response({
                    "apiVersion": gvk.api_version, "kind": f"{kind}List",
                    "metadata": {"resourceVersion": str(self.seq)},
                    "items": items})
            if verb == "get":
                return web.json_response(await self.kube.get(kind, name, ns))
            body = await request.json() if request.can_read_body else {}
            if verb == "create":
                return web.json_response(
                    await self.kube.create(kind, body, ns), status=201)
            if verb == "update":
                return web.json_response(await self.kube.update(kind, body))
            if verb == "patch":
                return web.json_response(await self.kube.patch(
                    kind, name, body, ns, subresource=sub))
            if verb == "delete":
                await self.kube.delete(kind, name, ns)
                return web.json_response({"kind": "Status",
                                          "status": "Success"})
            return self._status(ApiError(f"{method} is not served"))
        except ApiError as e:
            return self._status(e)

    @staticmethod
    def _status(error):
        from aiohttp import web

        return web.json_response(
            {"kind": "Status", "apiVersion": "v1", "status": "Failure",
             "reason": error.reason, "message": error.message,
             "code": error.code}, status=error.code)

    async def _watch(self, request, kind: str, ns, query):
        from aiohttp import web

        from kubeflow_tpu_torch.runtime.objects import (
            get_meta, matches_selector, namespace_of, parse_label_selector)

        selector = query.get("labelSelector") or None
        since = int(query.get("resourceVersion") or self.seq)
        # The watch registers and the backlog is taken at one instant of
        # the loop: nothing falls between them.
        stream = self.kube.watch(kind, ns, selector, send_initial=False)
        wanted = parse_label_selector(selector)
        gone = bool(self.history) and since < self.history[0][0] - 1
        backlog = [] if gone else [
            (event, obj) for n, event, obj in self.history
            if n > since and obj.get("kind") == kind
            and (not ns or namespace_of(obj) == ns)
            and matches_selector(get_meta(obj).get("labels"), wanted)]
        resp = web.StreamResponse()
        resp.content_type = "application/json"
        await resp.prepare(request)
        try:
            if gone:
                await resp.write(json.dumps({"type": "ERROR", "object": {
                    "kind": "Status", "code": 410,
                    "message": "too old resource version"}}).encode() + b"\n")
                return resp
            for event, obj in backlog:
                await resp.write(json.dumps(
                    {"type": event, "object": obj}).encode() + b"\n")
            async for event, obj in stream:
                await resp.write(json.dumps(
                    {"type": event, "object": obj}).encode() + b"\n")
        except ConnectionError:
            pass                    # the client went away
        finally:
            await stream.aclose()
        return resp


def openssl_pair(directory: str) -> tuple:
    """A self-signed certificate and key for 127.0.0.1, made with
    ``openssl`` as the webhook server's tests make theirs. Without
    ``openssl`` it raises: the webhook is never served in plaintext."""
    import shutil

    if shutil.which("openssl") is None:
        raise AssertionError("no openssl to make the admission webhook's "
                             "TLS pair (it is never served in plaintext)")
    cert, key = f"{directory}/tls.crt", f"{directory}/tls.key"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-days", "1", "-keyout", key, "-out", cert, "-subj",
         "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    return cert, key


class EntryProcess:
    """``python -m <module>``, one of the port's entry points, started in
    a session of its own with this process's env (no apiserver address:
    HttpKube falls back to the facade) and ``environ`` on top; its output
    goes to temporary files. It must run until :meth:`stop` ends it with
    SIGTERM, as a kubelet stops a pod."""

    def __init__(self, module: str, environ: dict):
        import atexit
        import tempfile
        from pathlib import Path

        env = {k: v for k, v in _pod_process_env({}).items()
               if not k.startswith("KUBERNETES_")}
        env.update(environ)
        self.module = module
        self.out = tempfile.TemporaryFile(mode="w+")
        self.started = time.time()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module], env=env,
            cwd=Path(__file__).parent, stdout=self.out,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        atexit.register(_stop_group, self.proc)

    def output(self) -> str:
        self.out.seek(0)
        return self.out.read()[-4000:]

    def get(self, url: str, context=None, data: bytes | None = None,
            headers: dict | None = None) -> tuple:
        """One request to the process; raises if the process has ended."""
        import urllib.error
        import urllib.request

        if self.proc.poll() is not None:
            raise AssertionError(f"{self.module} exited "
                                 f"{self.proc.returncode}:\n{self.output()}")
        req = urllib.request.Request(url, data=data, headers=headers or {})
        try:
            with urllib.request.urlopen(req, timeout=10,
                                        context=context) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def answers(self, url: str, context=None) -> bool:
        """Whether ``url`` answers 200 now."""
        import urllib.error

        try:
            return self.get(url, context)[0] == 200
        except (urllib.error.URLError, ConnectionError, OSError):
            return False

    def stop(self) -> dict:
        """SIGTERM the process (it must still be running) and its group."""
        import os
        import signal

        alive = self.proc.poll() is None
        if alive:
            os.killpg(self.proc.pid, signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=ENTRY_TIMEOUT)
        finally:
            _stop_group(self.proc)
        return {"ran_until_stopped": alive,
                "stopped_by_sigterm": alive and code == -signal.SIGTERM,
                "returncode": code}


class Entrypoints:
    """The facade and both entry points as processes against it: the
    controller manager (``METRICS_PORT`` free, the fleet scheduler on
    ``fleet``) and the admission webhook over TLS with a fresh
    ``openssl`` pair in ``tmp``. Both start together. With
    ``webhook_admission`` the facade admits nothing in-process: once the
    webhook answers (:meth:`wait_synced`), every admission goes to it."""

    def __init__(self, tmp: str, fleet: str, nodes: tuple = (),
                 webhook_admission: bool = False):
        import ssl

        from kubeflow_tpu_torch.probe.dcn import free_base_port

        self.facade = ApiFacade(nodes=nodes,
                                in_process_admission=not webhook_admission)
        self.webhook_admission = webhook_admission
        self.manager = self.webhook = None
        try:
            cert, key = openssl_pair(tmp)
            metrics = free_base_port(2)
            port = metrics + 1
            self.manager = EntryProcess(
                "kubeflow_tpu_torch.cmd.controller_manager", {
                    "METRICS_PORT": str(metrics), "KFTPU_SCHEDULER": "on",
                    "KFTPU_FLEET": fleet})
            self.webhook = EntryProcess("kubeflow_tpu_torch.cmd.webhook", {
                "TLS_CERT_FILE": cert, "TLS_KEY_FILE": key,
                "WEBHOOK_PORT": str(port)})
        except BaseException:
            self.stop()
            raise
        self.cert = cert
        self.tls = ssl.create_default_context(cafile=cert)
        self.base = f"http://127.0.0.1:{metrics}"
        self.hook = f"https://127.0.0.1:{port}"

    def manager_json(self, path: str) -> dict:
        return json.loads(self.manager.get(self.base + path)[1])

    def wait_synced(self) -> dict:
        """Poll the manager's /readyz and the webhook's /healthz over TLS
        together until both answer, then the manager's /debug/informers
        until every informer is synced: the host time of each mark and
        the informers' kinds."""
        marks: dict = {}
        probes = (("readyz", self.manager, f"{self.base}/readyz", None),
                  ("first_tls", self.webhook, f"{self.hook}/healthz",
                   self.tls))
        deadline = time.monotonic() + ENTRY_TIMEOUT
        while True:
            for name, proc, url, context in probes:
                if name not in marks and proc.answers(url, context):
                    marks[name] = time.time()
            if len(marks) == len(probes):
                informers = self.manager_json("/debug/informers")[
                    "informers"]
                if informers and all(i["synced"]
                                     for i in informers.values()):
                    if self.webhook_admission and self.facade.session is None:
                        self.facade.admit_through(self.hook, self.cert)
                    return {**marks, "synced": time.time(),
                            "kinds": sorted(informers)}
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"the entry points never came up ({marks}):\n"
                    f"{self.manager.output()}\n{self.webhook.output()}")
            time.sleep(0.02)

    def review(self, path: str, body) -> tuple:
        """POST ``body`` (JSON, or raw bytes) to the webhook: (HTTP status,
        decoded answer, host seconds)."""
        data = body if isinstance(body, bytes) else json.dumps(body).encode()
        t0 = time.perf_counter()
        status, raw = self.webhook.get(
            self.hook + path, self.tls, data=data,
            headers={"Content-Type": "application/json"})
        return status, json.loads(raw), time.perf_counter() - t0

    def stop(self) -> dict:
        """Stop both processes and the facade: how each process ended."""
        ended = {}
        try:
            for name in ("manager", "webhook"):
                proc = getattr(self, name)
                if proc is not None:
                    ended[name] = proc.stop()
                    setattr(self, name, None)
        finally:
            self.facade.close()
        return ended


def admission_review(obj: dict, uid: str, namespace: str = "ns") -> dict:
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": "CREATE",
                        "namespace": namespace, "object": obj}}


def decoded_patch(answer: dict) -> list:
    import base64

    patch = answer["response"].get("patch")
    return json.loads(base64.b64decode(patch)) if patch else []


def admissions_by_path(admissions: list) -> dict:
    """The facade's wire admissions counted by kind, path and outcome."""
    by_path: dict = {}
    for kind, path, allowed, _ in admissions:
        key = f"{kind} {path} {'allowed' if allowed else 'denied'}"
        by_path[key] = by_path.get(key, 0) + 1
    return by_path


def admission_counts(text: str) -> dict:
    """``webhook_admission_total`` from /metrics, by "<path> <allowed>"."""
    import re

    return {f"{m['path']} {m['allowed']}": float(m["n"]) for m in re.finditer(
        r'webhook_admission_total\{allowed="(?P<allowed>\w+)",'
        r'path="(?P<path>[^"]+)"\} (?P<n>[0-9.]+)', text)}


def entry_notebook(name: str, topology: str | None) -> dict:
    """A notebook mounting the claim ``logs`` at ENTRY_MOUNT; on GPU
    nodes of ``topology`` where one is given, else on the CPU."""
    from kubeflow_tpu_torch.api import notebook as nbapi

    nb = (_gpu_notebook(name, topology) if topology
          else nbapi.new(name, "ns"))
    pod = nb["spec"]["template"]["spec"]
    pod["containers"][0]["volumeMounts"] = [
        {"name": "logs", "mountPath": ENTRY_MOUNT}]
    pod["volumes"] = [{"name": "logs",
                       "persistentVolumeClaim": {"claimName": "logs"}}]
    return nb


async def entry_objects(kube) -> None:
    """What the user creates before the notebook: a PVC ``logs``
    (ReadWriteOnce) and a PodDefault that points the SDK's profiler at a
    run on it for every pod of notebook ``nb``."""
    from kubeflow_tpu_torch.sdk import TELEMETRY_LOGDIR_ENV

    await kube.create("PersistentVolumeClaim", {
        "apiVersion": "v1", "kind": "PersistentVolumeClaim",
        "metadata": {"name": "logs", "namespace": "ns"},
        "spec": {"accessModes": ["ReadWriteOnce"]}})
    await kube.create("PodDefault", {
        "apiVersion": "kubeflow.org/v1alpha1", "kind": "PodDefault",
        "metadata": {"name": "profiler-logs", "namespace": "ns"},
        "spec": {"selector": {"matchLabels": {"notebook-name": "nb"}},
                 "desc": "the SDK's profiler traces to the logs claim",
                 "env": [{"name": TELEMETRY_LOGDIR_ENV,
                          "value": f"{ENTRY_MOUNT}/{ENTRY_RUN}"}]}})


async def running_pod(kube, name: str):
    pod = await kube.get_or_none("Pod", name, "ns")
    return pod if ((pod or {}).get("status") or {}).get("phase") \
        == "Running" else None


async def tensorboard_ready(kube, name: str):
    tb = await kube.get_or_none("Tensorboard", name, "ns")
    status = (tb or {}).get("status") or {}
    return status if status.get("readyReplicas") == 1 and any(
        c.get("deploymentState") == "Available"
        for c in status.get("conditions", [])) else None


async def pvcviewer_ready(kube, name: str):
    viewer = await kube.get_or_none("PVCViewer", name, "ns")
    return viewer if ((viewer or {}).get("status") or {}).get("ready") \
        else None


def pod_from_template(sts: dict, name: str) -> dict:
    """The pod a StatefulSet's controller creates, before admission."""
    import copy

    meta = sts["spec"]["template"].get("metadata") or {}
    return {"apiVersion": "v1", "kind": "Pod", "metadata": {
        "name": name, "namespace": "ns",
        "labels": dict(meta.get("labels") or {}),
        "annotations": dict(meta.get("annotations") or {})},
        "spec": copy.deepcopy(sts["spec"]["template"]["spec"])}


def container_env(pod: dict) -> list:
    return pod["spec"]["containers"][0].get("env", [])


def _kernel_events(trace: dict) -> dict:
    """Each ENTRY_KERNELS kernel's events in a ``torch.profiler`` trace
    (the wide library's ``wide_*`` kernels are others)."""
    import re

    counts = dict.fromkeys(ENTRY_KERNELS, 0)
    for event in trace.get("traceEvents", []):
        if event.get("cat") == "kernel":
            for name in ENTRY_KERNELS:
                if re.search(rf"(?<!\w){name}(?!\w)", event.get("name", "")):
                    counts[name] += 1
    return counts


def _entry_traced_steps(torch, fa, burnin, sdk, logdir: str) -> dict:
    """(b)'s card work: ``make_train_step`` at TRAIN_MODEL, one warm-up
    step, then ENTRY_TRACED_STEPS under ``sdk.capture_profile`` with the
    logdir from ``KFTPU_TELEMETRY_LOGDIR``; launches counted from zero
    over the traced steps."""
    cfg = burnin.BurninConfig(**TRAIN_MODEL)
    params, tokens = _train_inputs(torch, burnin, cfg, seed=0)
    step = burnin.make_train_step(cfg)
    step(params, tokens)
    torch.cuda.synchronize()
    _zero_launch_counts(fa)              # ---- the main path starts here
    with sdk.capture_profile(environ={sdk.TELEMETRY_LOGDIR_ENV: logdir}):
        losses = [step(params, tokens)[1] for _ in range(ENTRY_TRACED_STEPS)]
        torch.cuda.synchronize()
    launches = _launch_counts(fa)        # ---- (b)'s part ends here
    del params, tokens
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "launches": launches,
            "losses": [float(x) for x in losses]}


def _wire_admissions(ep: Entrypoints, wire_pod: dict) -> dict:
    """(c)'s AdmissionReviews over TLS, each checked by the caller."""
    from kubeflow_tpu_torch.api import notebook as nbapi
    from kubeflow_tpu_torch.api import pvcviewer as pvcapi
    from kubeflow_tpu_torch.api import tensorboard as tbapi
    from kubeflow_tpu_torch.webhooks import jsonpatch

    seconds = []

    def review(path, obj, uid):
        status, answer, sec = ep.review(path, admission_review(obj, uid))
        seconds.append(sec)
        assert status == 200 and answer["response"]["uid"] == uid, answer
        return answer["response"], decoded_patch(answer)

    pod, pod_patch = review("/apply-poddefault", wire_pod, "pod")
    viewer, viewer_patch = review("/mutate-pvcviewers",
                                  pvcapi.new("view", "ns", "logs"), "view")
    tb_ok, _ = review("/validate-tensorboards", tbapi.new(
        "tb", "ns", f"pvc://logs/{ENTRY_RUN}", profiler=True), "tb")
    tb_bad, _ = review("/validate-tensorboards",
                       tbapi.new("empty", "ns", ""), "empty")
    malformed, _, _ = ep.review("/validate-tensorboards", b"[1]")
    tpu_nb = nbapi.new("tpu", "ns")
    tpu_nb["spec"]["tpu"] = {"accelerator": "v5e", "topology": "2x2"}
    tpu, _ = review("/mutate-notebooks", tpu_nb, "tpu")
    big, _ = review("/mutate-notebooks", _gpu_notebook("big", "2x8"), "big")
    old = nbapi.new("old", "ns")
    old["apiVersion"] = "kubeflow.org/v1beta1"
    _, converted, _ = ep.review("/convert", {
        "apiVersion": "apiextensions.k8s.io/v1", "kind": "ConversionReview",
        "request": {"uid": "convert", "desiredAPIVersion": nbapi.API_VERSION,
                    "objects": [old]}})
    return {
        "pod_allowed": pod["allowed"],
        "pod": jsonpatch.apply(wire_pod, pod_patch),
        "viewer_allowed": viewer["allowed"],
        "viewer": jsonpatch.apply(pvcapi.new("view", "ns", "logs"),
                                  viewer_patch),
        "tb_allowed": tb_ok["allowed"],
        "tb_denied": {k: tb_bad.get(k) for k in ("allowed", "status")},
        "malformed_http_status": malformed,
        "tpu_denied": {k: tpu.get(k) for k in ("allowed", "status")},
        "over_quota_denied": {k: big.get(k) for k in ("allowed", "status")},
        "converted": converted["response"],
        "metrics": admission_counts(ep.webhook.get(
            f"{ep.hook}/metrics", ep.tls)[1].decode()),
        "traces": [[t["key"], t["outcome"]] for t in json.loads(
            ep.webhook.get(f"{ep.hook}/debug/traces", ep.tls)[1])["traces"]],
        "seconds": seconds}


def phase_entrypoints(torch, fa, burnin, sdk, card: str) -> dict:
    """The controller manager and the admission webhook as processes on
    the facade (module docstring, item 34): (a) the manager renders a GPU
    notebook, (b) a traced train step on the card, the Tensorboard that
    serves its trace and a PVCViewer on the same claim, (c) the webhook's
    AdmissionReviews over TLS and a process started with the env it gave
    the pod. Any failed check raises. Returns (b)'s and (c)'s launches."""
    import glob
    import shutil
    import tempfile

    from kubeflow_tpu_torch.api import profile as profileapi
    from kubeflow_tpu_torch.api import pvcviewer as pvcapi
    from kubeflow_tpu_torch.api import tensorboard as tbapi
    from kubeflow_tpu_torch.gpu.topology import GPU_RESOURCE
    from kubeflow_tpu_torch.runtime.errors import Invalid

    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-entry-")
    claim_root = f"{tmp}/logs"
    ep = Entrypoints(tmp, FLEET_SPEC, nodes=(ENTRY_NODE,))
    kube, call = ep.facade.kube, ep.facade.call
    manager_started, webhook_started = ep.manager.started, ep.webhook.started
    try:
        # (a) both processes' first answers, the manager's caches, the
        # Profile's quota, a GPU notebook.
        synced = ep.wait_synced()

        async def quota():
            rq = await kube.get_or_none("ResourceQuota", "kf-resource-quota",
                                        "ns")
            return ((rq or {}).get("spec") or {}).get("hard")

        call(kube.create("Profile", profileapi.new(
            "ns", "owner@example.com", gpu_quota=FLEET_QUOTA)))
        hard = call(ep.facade.wait_for(quota, "the ResourceQuota"))
        call(entry_objects(kube))
        nb_created = time.time()
        is_running = ep.facade.mark_when(lambda: running_pod(kube, "nb-0"),
                                         "nb-0 running")
        call(kube.create("Notebook", entry_notebook("nb", "1x1")))
        nb_running = is_running.result(ENTRY_TIMEOUT)
        pod = call(running_pod(kube, "nb-0"))
        pod_env = {e["name"]: e.get("value") for e in container_env(pod)}
        admitted = [a["key"] for a in ep.manager_json(
            "/debug/scheduler")["scheduler"]["admitted"]]

        # (b) two traced steps on the card, where the claim stands for the
        # pod's mount; then the Tensorboard over that run, and a PVCViewer.
        logdir = pod_env[sdk.TELEMETRY_LOGDIR_ENV].replace(
            ENTRY_MOUNT, claim_root, 1)
        traced = _entry_traced_steps(torch, fa, burnin, sdk, logdir)
        refused = None
        try:
            call(kube.create("Tensorboard", tbapi.new("empty", "ns", "")))
        except Invalid as e:
            refused = e.message
        tb_created = time.time()
        is_ready = ep.facade.mark_when(lambda: tensorboard_ready(kube, "tb"),
                                       "the Tensorboard ready")
        call(kube.create("Tensorboard", tbapi.new(
            "tb", "ns", f"pvc://logs/{ENTRY_RUN}", profiler=True)))
        tb_ready = is_ready.result(ENTRY_TIMEOUT)
        tb_status = call(tensorboard_ready(kube, "tb"))
        tb_pod = call(kube.get("Deployment", "tb", "ns"))["spec"][
            "template"]["spec"]
        tb_ports = call(kube.get("Service", "tb", "ns"))["spec"]["ports"]
        command = tb_pod["containers"][0]["command"]
        served = next(a for a in command if a.startswith("--logdir="))[
            len("--logdir="):]
        traces = sorted(glob.glob(
            served.replace("/tensorboard_logs", claim_root, 1)
            + "/*.pt.trace.json"))
        with open(traces[0]) as f:
            kernel_events = _kernel_events(json.load(f))
        affinity = tb_pod.get("affinity", {}).get("nodeAffinity", {}).get(
            "requiredDuringSchedulingIgnoredDuringExecution", {})
        call(kube.create("PVCViewer", pvcapi.new("view", "ns", "logs")))
        viewer = call(ep.facade.wait_for(lambda: pvcviewer_ready(kube, "view"),
                                         "the PVCViewer ready"))
        viewer_children = [
            call(kube.get_or_none(kind, "view-pvcviewer", "ns")) is not None
            for kind in ("Deployment", "Service")]

        # (c) the webhook over TLS, then the pod's process under the env
        # the wire gave it.
        wire = _wire_admissions(ep, pod_from_template(
            call(kube.get("StatefulSet", "nb", "ns")), "nb-0"))
        case = next(c for c in KERNEL_CASES if c[0] == "decode")
        env = _pod_process_env({e["name"]: e.get("value")
                                for e in container_env(wire["pod"])})
        env["SMOKE_ENTRY_CASE"] = json.dumps([list(case[1]), case[2],
                                              case[3]])
        child_started = time.time()
        child = json.loads(_run_children(
            [(["-c", ENTRY_POD_CHILD], env)])[0].strip().splitlines()[-1])
        facade_requests = dict(sorted(ep.facade.requests.items()))
    finally:
        ended = ep.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    n = traced["layers"] * ENTRY_TRACED_STEPS
    launches = {k: v + (child["launches"] if k == "fwd" else 0)
                for k, v in traced["launches"].items()}
    tol_o = TOL_O[case[2]]
    seconds = wire.pop("seconds")
    row = {"phase": "entrypoints", "card": card,
           "clock": "host seconds (time.time) for the marks",
           "host_sec": {
               "manager_start_to_readyz": synced["readyz"] - manager_started,
               "manager_start_to_informers_synced": synced["synced"]
               - manager_started,
               "nb_create_to_running": nb_running - nb_created,
               "tb_create_to_ready": tb_ready - tb_created,
               "webhook_start_to_first_tls": synced["first_tls"]
               - webhook_started,
               "admission_p50": statistics.median(seconds),
               "admission_max": max(seconds),
               "pod_process_start_to_kernel_result":
                   child["result_at"] - child_started},
           "admissions": len(seconds), "informers": synced["kinds"],
           "quota_hard": hard, "node": pod["spec"].get("nodeName"),
           "pod_requests": pod["spec"]["containers"][0]["resources"],
           "scheduler_admitted": admitted, "losses": traced["losses"],
           "traces": [t[len(tmp):] for t in traces],
           "kernel_events": kernel_events, "tensorboard": {
               "command": command, "volumes": tb_pod.get("volumes"),
               "mounts": tb_pod["containers"][0].get("volumeMounts"),
               "affinity": affinity, "service_ports": tb_ports,
               "status": tb_status, "empty_logspath_refused": refused},
           "pvcviewer": {"spec": viewer["spec"], "status": viewer["status"],
                         "children": viewer_children},
           "wire": {k: v for k, v in wire.items() if k not in ("pod",
                                                               "viewer")},
           "wire_env_equals_in_process": container_env(wire["pod"])
           == container_env(pod),
           "wire_viewer_equals_in_process": wire["viewer"]["spec"]
           == viewer["spec"],
           "pod_process": child, "facade_requests_by_verb": facade_requests,
           "processes": ended, "launches": launches,
           "launches_expected": {"fwd": n + 1, "dq": n, "dkv": n,
                                 "partial": 0},
           "tol_o": tol_o, "tol_lse": TOL_LSE,
           "phase_sec": time.perf_counter() - phase_t0}
    emit(row)
    wire_env = {e["name"] for e in container_env(wire["pod"])}
    checks = {
        "processes_stopped": all(e["ran_until_stopped"]
                                 and e["stopped_by_sigterm"]
                                 for e in ended.values())
        and set(ended) == {"manager", "webhook"},
        "informers": {"Notebook", "Tensorboard", "PVCViewer", "Deployment",
                      "Profile", "Pod"} <= set(synced["kinds"]),
        "quota": hard == {f"requests.{GPU_RESOURCE}": str(FLEET_QUOTA)},
        "nb_on_node": pod["spec"].get("nodeName") == "a3-0"
        and ["ns", "nb"] in admitted,
        "nb_card": row["pod_requests"].get("limits", {}).get(GPU_RESOURCE)
        == "1",
        "logdir": f"--logdir=/tensorboard_logs/{ENTRY_RUN}" in command
        and "--reload_multifile=true" in command,
        "mount": {"name": "logs", "mountPath": "/tensorboard_logs",
                  "readOnly": True} in row["tensorboard"]["mounts"]
        and {"name": "logs", "persistentVolumeClaim": {"claimName": "logs"}}
        in row["tensorboard"]["volumes"],
        "rwo_pin": affinity.get("nodeSelectorTerms", [{}])[0].get(
            "matchFields", [{}])[0].get("values") == ["a3-0"],
        "service": [(p["port"], p["targetPort"]) for p in tb_ports]
        == [(80, 6006)],
        "tb_refused": refused is not None
        and "spec.logspath is required" in refused,
        "one_trace": len(traces) == 1,
        "trace_kernels": kernel_events == dict.fromkeys(ENTRY_KERNELS, n),
        "pvcviewer": viewer["spec"]["podSpec"]["containers"][0]["image"]
        == "filebrowser/filebrowser:latest"
        and {"name": "viewer-volume",
             "persistentVolumeClaim": {"claimName": "logs"}}
        in viewer["spec"]["podSpec"]["volumes"] and all(viewer_children),
        "wire_pod": wire["pod_allowed"] and row["wire_env_equals_in_process"]
        and {"TPU_WORKER_ID", "PET_NODE_RANK", "PET_MASTER_ADDR",
             sdk.TELEMETRY_LOGDIR_ENV} <= wire_env,
        "wire_viewer": wire["viewer_allowed"]
        and row["wire_viewer_equals_in_process"],
        "wire_tensorboards": wire["tb_allowed"]
        and wire["tb_denied"]["allowed"] is False
        and wire["tb_denied"]["status"]["code"] == Invalid.code
        and wire["malformed_http_status"] == 400,
        "wire_notebooks": wire["tpu_denied"]["allowed"] is False
        and "spec.gpu" in wire["tpu_denied"]["status"]["message"]
        and wire["over_quota_denied"]["allowed"] is False
        and "gpuQuota" in wire["over_quota_denied"]["status"]["message"],
        "wire_convert": wire["converted"]["result"]["status"] == "Success"
        and wire["converted"]["convertedObjects"][0]["apiVersion"]
        == "kubeflow.org/v1",
        "wire_metrics": wire["metrics"] == {
            "/apply-poddefault true": 1.0, "/mutate-pvcviewers true": 1.0,
            "/validate-tensorboards true": 1.0,
            "/validate-tensorboards false": 2.0,
            "/mutate-notebooks false": 2.0},
        "wire_traces": len(wire["traces"]) == len(seconds),
        "pod_kernel": child["launches"] == 1 and child["finite"]
        and child["max_err_o"] <= tol_o and child["max_err_lse"] <= TOL_LSE,
        "launches": launches == row["launches_expected"],
    }
    if not all(checks.values()):
        raise AssertionError(f"entrypoints phase failed: {checks}")
    return launches


# The web apps as one process (``WEBAPP=all``: each app under its prefix,
# as the dashboard links them), reached over HTTP as the Profile's owner.
WEB_USER = "owner@example.com"
WEB_CONTRIBUTOR = "contributor@example.com"
WEB_LIST_REQUESTS = 20
# The spawner forms: a one-card share with a ReadWriteOnce workspace, and
# a two-node 2x8 (16 cards) against the Profile's 8, which the webhook
# must refuse.
WEB_SHAPE, WEB_OVER_QUOTA_SHAPE = "1x1", "2x8"
WEB_WORKSPACE = "nb-workspace"
# The pod's process: one forward at MODEL (BENCH_MODEL's widths at the
# serving length) held to the dense forward, then WEB_FORWARD_TIMED more
# timed back to back (the card busy while nvidia-smi samples it).
WEB_FORWARD_TIMED = 40
UTIL_SAMPLE_SEC = 0.1

WEBAPP_POD_CHILD = r"""
import dataclasses, json, os, time
import torch
from kubeflow_tpu_torch import sdk
from kubeflow_tpu_torch.models import burnin
from kubeflow_tpu_torch.ops import flash_attention as fa

joined = sdk.initialize_distributed()
model, batch, timed = json.loads(os.environ["SMOKE_WEBAPP_FORWARD"])
cfg = burnin.BurninConfig(**model)
params = burnin.init_params(cfg, seed=0, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(7)
tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq_len), generator=gen,
                       device="cuda")
with torch.inference_mode():
    torch.cuda.synchronize()
    started_at = time.time()
    fa.LAUNCHES = 0
    logits = burnin.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    result_at = time.time()
    launches = fa.LAUNCHES
    dense = burnin.forward(params, tokens,
                           dataclasses.replace(cfg, attention="xla"))
    diff = (logits.float() - dense.float()).abs()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(timed):
        burnin.forward(params, tokens, cfg)
    end.record()
    torch.cuda.synchronize()
print(json.dumps({
    "sdk_joined": joined, "started_at": started_at, "result_at": result_at,
    "launches": launches, "n_layers": cfg.n_layers,
    "shape": list(logits.shape), "finite": bool(torch.isfinite(logits).all()),
    "max_abs_diff": diff.max().item(), "mean_abs_diff": diff.mean().item(),
    "forward_ms": start.elapsed_time(end) / timed}), flush=True)
"""


class WebClient:
    """HTTP to the web-app process as ``user``, as the SPAs' ``KF.api``
    speaks to it: the ``XSRF-TOKEN`` cookie a safe request sets goes back
    as a cookie and in ``X-XSRF-TOKEN`` with every mutating request. The
    host seconds of each request are kept by method and path."""

    def __init__(self, proc: "EntryProcess", base: str, user: str):
        self.proc, self.base, self.user = proc, base, user
        self.token = None
        self.seconds: dict = {}

    def request(self, method: str, path: str, body=None) -> tuple:
        """(HTTP status, decoded JSON answer)."""
        import urllib.error
        import urllib.request

        if self.proc.proc.poll() is not None:
            raise AssertionError(f"the web apps exited "
                                 f"{self.proc.proc.returncode}:\n"
                                 f"{self.proc.output()}")
        headers = {"kubeflow-userid": self.user}
        if self.token is not None:
            headers["Cookie"] = f"XSRF-TOKEN={self.token}"
        data = None
        if method != "GET":
            headers["X-XSRF-TOKEN"] = self.token or ""
            headers["Content-Type"] = "application/json"
            data = json.dumps(body or {}).encode()
        req = urllib.request.Request(self.base + path, data=data,
                                     headers=headers, method=method)
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=ENTRY_TIMEOUT) as resp:
                status, raw, cookies = (resp.status, resp.read(),
                                        resp.headers.get_all("Set-Cookie"))
        except urllib.error.HTTPError as e:
            status, raw, cookies = (e.code, e.read(),
                                    e.headers.get_all("Set-Cookie"))
        self.seconds.setdefault(f"{method} {path}", []).append(
            time.perf_counter() - t0)
        for cookie in cookies or []:
            name, _, rest = cookie.partition("=")
            if name.strip() == "XSRF-TOKEN":
                self.token = rest.split(";", 1)[0]
        return status, json.loads(raw) if raw else {}

    def get(self, path: str) -> dict:
        status, body = self.request("GET", path)
        if status != 200:
            raise AssertionError(f"GET {path}: {status} {body}")
        return body

    def post(self, path: str, body) -> dict:
        status, answer = self.request("POST", path, body)
        if status != 200:
            raise AssertionError(f"POST {path}: {status} {answer}")
        return answer

    def until(self, path: str, predicate, what: str):
        """GET ``path`` until ``predicate(answer)`` is truthy; its value."""
        deadline = time.monotonic() + ENTRY_TIMEOUT
        while True:
            value = predicate(self.get(path))
            if value:
                return value
            if time.monotonic() > deadline:
                raise AssertionError(f"timed out: {what}")
            time.sleep(0.02)


class PrometheusStub(LoopThread):
    """A Prometheus HTTP API on 127.0.0.1 (scaffolding, as ApiFacade):
    ``/api/v1/query_range`` answers the dashboard's ``gpu_duty`` PromQL
    with ``samples``, (host time, percent) pairs that ``nvidia-smi`` read,
    as dcgm-exporter's series for ENTRY_NODE, within the range asked; any
    other query has no series. Every query asked is kept in ``queries``."""

    def __init__(self):
        from kubeflow_tpu_torch.probe.dcn import free_base_port

        super().__init__("prometheus-stub")
        self.samples: list = []
        self.queries: list = []
        self.port = free_base_port(1)
        self.url = f"http://127.0.0.1:{self.port}"
        try:
            self.call(self._start())
        except BaseException:
            self.stop_loop()
            raise

    async def _start(self) -> None:
        from aiohttp import web

        from kubeflow_tpu_torch.web.dashboard.metrics import QUERIES

        async def query_range(request):
            query = dict(request.query)
            self.queries.append(query)
            result = []
            if query.get("query") == QUERIES["gpu_duty"]:
                start, end = float(query["start"]), float(query["end"])
                result = [{"metric": {
                    "Hostname": ENTRY_NODE["metadata"]["name"]},
                    "values": [[t, str(v)] for t, v in self.samples
                               if start <= t <= end]}]
            return web.json_response({"status": "success", "data": {
                "resultType": "matrix", "result": result}})

        app = web.Application()
        app.router.add_get("/api/v1/query_range", query_range)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        await web.TCPSite(self.runner, "127.0.0.1", self.port).start()

    def close(self) -> None:
        try:
            self.call(self.runner.cleanup())
        finally:
            self.stop_loop()


class UtilSampler:
    """``nvidia-smi --query-gpu=utilization.gpu`` read every
    UTIL_SAMPLE_SEC on a thread of its own: (host time, percent) pairs."""

    def __init__(self):
        import threading

        self.samples: list = []
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, name="util",
                                       daemon=True)
        self.thread.start()

    def _run(self) -> None:
        while not self.done.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=utilization.gpu",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True, timeout=ENTRY_TIMEOUT)
            if out.returncode == 0 and out.stdout.strip():
                self.samples.append(
                    (time.time(), float(out.stdout.splitlines()[0])))
            self.done.wait(UTIL_SAMPLE_SEC)

    def stop(self) -> list:
        self.done.set()
        self.thread.join(timeout=ENTRY_TIMEOUT)
        return list(self.samples)


def _web_form(name: str, topology: str) -> dict:
    """The spawner form the JWA frontend posts for a GPU slice, with a
    ReadWriteOnce workspace."""
    return {"name": name, "serverType": "jupyter",
            "gpu": {"accelerator": PROBE_ACCELERATOR, "topology": topology},
            "workspaceVolume": {"mount": "/home/jovyan", "newPvc": {
                "metadata": {"name": "{notebook-name}-workspace"},
                "spec": {"accessModes": ["ReadWriteOnce"],
                         "resources": {"requests": {"storage": "10Gi"}}}}}}


def _until_up(proc: "EntryProcess", url: str) -> float:
    deadline = time.monotonic() + ENTRY_TIMEOUT
    while not proc.answers(url):
        if time.monotonic() > deadline:
            raise AssertionError(f"{url} never answered:\n{proc.output()}")
        time.sleep(0.02)
    return time.time()


def phase_webapps(card: str) -> dict:
    """The web apps as a process on the facade (module docstring, item
    35), with the manager and the webhook as processes and every
    admission sent to the webhook: (a) the JWA's catalog, (b) a GPU
    notebook spawned through the form, (c) its pod's forward on the card,
    (d) the dashboard's gpu_duty series from a Prometheus stub, (e) the
    Tensorboards, Volumes and KFAM apps, (f) an over-quota form refused.
    Any failed check raises. Returns (c)'s launches."""
    import shutil
    import tempfile

    from kubeflow_tpu_torch.api import profile as profileapi
    from kubeflow_tpu_torch.gpu.topology import ACCELERATORS, GPU_RESOURCE
    from kubeflow_tpu_torch.probe.dcn import free_base_port
    from kubeflow_tpu_torch.web.common.status import process_status

    phase_t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-web-")
    ep = Entrypoints(tmp, FLEET_SPEC, nodes=(ENTRY_NODE,),
                     webhook_admission=True)
    manager_started = ep.manager.started
    prom = web = None
    ended = {}
    try:
        prom = PrometheusStub()
        port = free_base_port(1)
        web = EntryProcess("kubeflow_tpu_torch.cmd.webapp", {
            "WEBAPP": "all", "PORT": str(port),
            "APP_SECURE_COOKIES": "false", "PROMETHEUS_URL": prom.url})
        client = WebClient(web, f"http://127.0.0.1:{port}", WEB_USER)
        kube, call = ep.facade.kube, ep.facade.call
        synced = ep.wait_synced()
        healthz_at = _until_up(web, f"{client.base}/healthz")

        async def quota():
            rq = await kube.get_or_none("ResourceQuota", "kf-resource-quota",
                                        "ns")
            return ((rq or {}).get("spec") or {}).get("hard")

        call(kube.create("Profile", profileapi.new(
            "ns", WEB_USER, gpu_quota=FLEET_QUOTA)))
        hard = call(ep.facade.wait_for(quota, "the ResourceQuota"))

        # (a) the spawner's catalog.
        config = client.get("/jupyter/api/config")["config"]
        gpus = client.get("/jupyter/api/gpus")["gpus"]
        h100 = next(g for g in gpus if g["accelerator"] == PROBE_ACCELERATOR)

        # (b) the form, admitted by the webhook process, rendered by the
        # manager process, Running; the JWA's row and the card panel.
        nb_list = "/jupyter/api/namespaces/ns/notebooks"
        is_running = ep.facade.mark_when(lambda: running_pod(kube, "nb-0"),
                                         "nb-0 running")
        posted_at = time.time()
        created = client.post(nb_list, _web_form("nb", WEB_SHAPE))
        running_at = is_running.result(ENTRY_TIMEOUT)
        row = client.until(nb_list, lambda body: next(
            (r for r in body["notebooks"] if r["name"] == "nb"
             and r["status"]["phase"] == "ready"), None), "nb ready")
        listed_ready_at = time.time()
        for _ in range(WEB_LIST_REQUESTS):
            client.get(nb_list)
        stored = call(kube.get("Notebook", "nb", "ns"))
        expected_status = process_status(stored)
        usage = client.get("/dashboard/api/namespaces/ns/gpu-usage")
        pod = call(running_pod(kube, "nb-0"))
        pod_env = {e["name"]: e.get("value") for e in container_env(pod)}

        # (c) the pod's process: its env as the webhook gave it, one
        # forward at MODEL through the kernel, the card sampled meanwhile.
        env = _pod_process_env(pod_env)
        env["SMOKE_WEBAPP_FORWARD"] = json.dumps(
            [MODEL, MAX_BATCH, WEB_FORWARD_TIMED])
        sampler = UtilSampler()
        child_started = time.time()
        try:
            child = json.loads(_run_children(
                [(["-c", WEBAPP_POD_CHILD], env)])[0].strip()
                .splitlines()[-1])
        finally:
            samples = sampler.stop()

        # (d) the dashboard's gpu_duty series, through the stub.
        prom.samples = samples
        duty = client.get("/dashboard/api/metrics?type=gpu_duty"
                          "&interval=Last5m")

        # (e) a Tensorboard over the workspace claim, a PVCViewer on it,
        # a contributor.
        client.post("/tensorboards/api/namespaces/ns/tensorboards", {
            "name": "tb", "logspath": f"pvc://{WEB_WORKSPACE}/logs",
            "profilerPlugin": True})
        tb_row = client.until(
            "/tensorboards/api/namespaces/ns/tensorboards",
            lambda body: next((t for t in body["tensorboards"]
                               if t["name"] == "tb" and t["ready"]), None),
            "the Tensorboard ready")
        pvcs = client.get("/volumes/api/namespaces/ns/pvcs")["pvcs"]
        claim = next(p for p in pvcs if p["name"] == WEB_WORKSPACE)
        client.post("/volumes/api/namespaces/ns/viewers",
                    {"pvc": WEB_WORKSPACE})
        viewer = client.until(
            "/volumes/api/namespaces/ns/pvcs",
            lambda body: next((p["viewer"] for p in body["pvcs"]
                               if p["name"] == WEB_WORKSPACE and p["viewer"]
                               and p["viewer"]["ready"]), None),
            "the PVCViewer ready")
        before = client.get(
            "/dashboard/api/workgroup/get-contributors/ns")["contributors"]
        client.post("/kfam/kfam/v1/bindings", {
            "user": {"kind": "User", "name": WEB_CONTRIBUTOR},
            "referredNamespace": "ns",
            "roleRef": {"kind": "ClusterRole", "name": "edit"}})
        contributors = client.get(
            "/dashboard/api/workgroup/get-contributors/ns")["contributors"]

        # (f) 16 cards against the Profile's 8.
        refused_status, refused = client.request(
            "POST", nb_list, _web_form("big", WEB_OVER_QUOTA_SHAPE))
        big = call(kube.get_or_none("Notebook", "big", "ns"))
        big_claim = call(kube.get_or_none("PersistentVolumeClaim",
                                          "big-workspace", "ns"))
        admissions = list(ep.facade.admissions)
        facade_requests = dict(sorted(ep.facade.requests.items()))
    finally:
        try:
            if web is not None:
                ended["webapp"] = web.stop()
            ended.update(ep.stop())
        finally:
            if prom is not None:
                prom.close()
            shutil.rmtree(tmp, ignore_errors=True)
    list_sec = client.seconds[f"GET {nb_list}"][-WEB_LIST_REQUESTS:]
    points = duty["points"]
    by_path = admissions_by_path(admissions)
    n = MODEL["n_layers"]
    row_out = {
        "phase": "webapps", "card": card,
        "clock": "host seconds (time.time) for the marks",
        "host_sec": {
            "webapp_start_to_healthz": healthz_at - web.started,
            "form_post_to_pod_running": running_at - posted_at,
            "form_post_to_listed_ready": listed_ready_at - posted_at,
            "list_p50": statistics.median(list_sec),
            "list_max": max(list_sec),
            "pod_process_start_to_forward_result":
                child["result_at"] - child_started,
            "forward": child["result_at"] - child["started_at"],
            "admission_p50": statistics.median(a[3] for a in admissions)},
        "forward_ms": child["forward_ms"],
        "manager_start_to_informers_synced":
            synced["synced"] - manager_started,
        "quota_hard": hard, "gpus_topologies": [
            t["topology"] for t in h100["topologies"]],
        "config_gpus_readonly": config["gpus"]["readOnly"],
        "created": created.get("message"), "row": row,
        "process_status": expected_status.__dict__, "gpu_usage": usage,
        "pod_requests": pod["spec"]["containers"][0]["resources"],
        "pod_process": child, "util_samples": len(samples),
        "util_max": max((v for _, v in samples), default=None),
        "gpu_duty_points": len(points),
        "gpu_duty_max": max((p["value"] for p in points), default=None),
        "prometheus_queries": [q.get("query") for q in prom.queries],
        "tensorboard": tb_row, "claim": claim, "viewer": viewer,
        "contributors_before": before, "contributors": contributors,
        "over_quota": {"status": refused_status, "answer": refused},
        "admissions_by_path": by_path,
        "facade_requests_by_verb": facade_requests, "processes": ended,
        "launches": {"fwd": child["launches"]},
        "launches_expected": {"fwd": n},
        "tol_max": TOL_LOGITS_MAX, "tol_mean": TOL_LOGITS_MEAN,
        "phase_sec": time.perf_counter() - phase_t0}
    emit(row_out)
    checks = {
        "processes_stopped": set(ended) == {"webapp", "manager", "webhook"}
        and all(e["ran_until_stopped"] and e["stopped_by_sigterm"]
                for e in ended.values()),
        "quota": hard == {f"requests.{GPU_RESOURCE}": str(FLEET_QUOTA)},
        "catalog": [t["topology"] for t in h100["topologies"]]
        == list(ACCELERATORS[PROBE_ACCELERATOR].topologies)
        and row_out["gpus_topologies"][0] == "1x1"
        and row_out["gpus_topologies"][-1] == "64x8"
        and config["gpus"]["options"] == gpus,
        "notebook": stored["spec"].get("gpu") == {
            "accelerator": PROBE_ACCELERATOR, "topology": WEB_SHAPE}
        and "tpu" not in stored["spec"],
        "admitted_by_webhook": by_path.get(
            "Notebook /mutate-notebooks allowed", 0) >= 1
        and by_path.get("Pod /apply-poddefault allowed", 0) >= 1,
        "row": row["status"] == {"phase": "ready", "message": "Running"}
        and row["status"] == expected_status.__dict__
        and row["gpu"] == stored["spec"]["gpu"]
        and row["gpuStatus"]["readyHosts"] == 1,
        "pod": pod["spec"].get("nodeName") == ENTRY_NODE["metadata"]["name"]
        and row_out["pod_requests"].get("limits", {}).get(GPU_RESOURCE)
        == "1" and {"TPU_WORKER_ID", "PET_NODE_RANK", "PET_MASTER_ADDR"}
        <= set(pod_env),
        "gpu_usage": (usage["chipsRequested"], usage["chipsQuota"])
        == (1, FLEET_QUOTA) and usage["pods"] == [{"pod": "nb-0",
                                                   "chips": 1}],
        "pod_forward": child["finite"] and child["launches"] == n
        and child["shape"] == [MAX_BATCH, MODEL["seq_len"], MODEL["vocab"]]
        and child["max_abs_diff"] <= TOL_LOGITS_MAX
        and child["mean_abs_diff"] <= TOL_LOGITS_MEAN,
        "gpu_duty": duty["type"] == "gpu_duty" and points
        and row_out["gpu_duty_max"] > 0
        and len(points) == len(samples),
        "tensorboard": tb_row["logspath"] == f"pvc://{WEB_WORKSPACE}/logs",
        "volumes": "nb-0" in claim["usedBy"]
        and claim["modes"] == ["ReadWriteOnce"] and viewer["ready"],
        "kfam": WEB_CONTRIBUTOR not in before
        and WEB_CONTRIBUTOR in contributors,
        "over_quota": 400 <= refused_status < 500
        and "gpuQuota" in refused.get("log", "")
        and "/mutate-notebooks" in refused.get("log", "")
        and big is None and big_claim is None
        and by_path.get("Notebook /mutate-notebooks denied") == 1,
        "launches": row_out["launches"] == row_out["launches_expected"],
    }
    if not all(checks.values()):
        raise AssertionError(f"webapps phase failed: {checks}")
    return row_out["launches"]


# ---- the chaos phase: the control plane's harnesses on the card's machine

# (a) tests/test_chaos.py's seed 0 at its own shape, the step trees of
# the drain acks' checkpoints on the card.
CHAOS_SEED, CHAOS_ROUNDS, CHAOS_STORM_SEC = 0, 3, 0.5
# (b) a fleet of eight simulated A3 nodes (eight H100s each) as 64
# one-card shares, one 1x1 notebook a card (more than the reference's
# default of 50), in a namespace whose Profile quota holds them all. The
# simulated pods never touch the card.
LOAD_NODE_COUNT = 8
LOAD_NODES = tuple(
    {**ENTRY_NODE, "metadata": {**ENTRY_NODE["metadata"], "name": f"a3-{i}"}}
    for i in range(LOAD_NODE_COUNT))
LOAD_FLEET_SPEC = f"a3={PROBE_ACCELERATOR}:1x1:{8 * LOAD_NODE_COUNT}"
LOAD_NAMESPACE, LOAD_SHAPE = "loadtest", "1x1"
LOAD_TIMEOUT = 120.0


def _chaos_soak() -> dict:
    """(a): one seeded soak with its step trees on the card, held to
    tests/test_chaos.py's assertions for seed 0."""
    import asyncio

    from kubeflow_tpu_torch.runtime import timeline as timeline_mod
    from kubeflow_tpu_torch.runtime.objects import annotations_of
    from kubeflow_tpu_torch.testing.chaos import ChaosSoak, SoakConfig

    soak = ChaosSoak(SoakConfig(seed=CHAOS_SEED, rounds=CHAOS_ROUNDS,
                                storm_seconds=CHAOS_STORM_SEC),
                     device="cuda")
    t0 = time.perf_counter()
    report = asyncio.run(soak.run()).to_dict()
    soak_sec = time.perf_counter() - t0
    journals = [timeline_mod.decode(annotations_of(nb)) for nb in
                asyncio.run(soak.kube.list("Notebook"))]
    storage = sum(v for k, v in report["injected"].items()
                  if k.startswith("storage_"))
    checks = {
        "ok": report["ok"] and report["problems"] == [],
        "ledger": report["ledger_violations"] == 0,
        "restarts": report["manager_restarts"] >= 3
        and report["rounds"] == CHAOS_ROUNDS,
        "stormed": sum(report["injected"].values()) > 0,
        "checkpoints": report["checkpoint_commits"] > 0
        and report["restores_checked"] > 0 and storage > 0,
        "elastic": report["spot_revocations"] > 0
        and report["scale_up_grants"] + report["scale_up_denials"] > 0,
        "timelines": bool(journals) and all(journals)
        and not any(timeline_mod.continuity_problems(j) for j in journals)
        and any(len(j) >= 3 for j in journals),
        "on_card": report["device"].startswith("cuda")
        and report["saves_on_device"] > 0
        and report["compared_on_device"] >= report["restores_checked"],
    }
    return {"report": report, "storage_faults": storage,
            "journals": len(journals),
            "longest_journal": max(map(len, journals), default=0),
            "host_sec": soak_sec, "checks": checks}


def _chaos_load() -> dict:
    """(b): the notebook load test over ``HttpKube`` against the facade,
    with the manager and the webhook as processes and every admission
    sent to the webhook."""
    import asyncio
    import shutil
    import tempfile

    from kubeflow_tpu_torch.api import profile as profileapi
    from kubeflow_tpu_torch.gpu.topology import GPU_RESOURCE
    from kubeflow_tpu_torch.runtime.httpclient import HttpKube
    from kubeflow_tpu_torch.scheduler import Fleet
    from kubeflow_tpu_torch.testing.loadtest import run_load_test

    count = Fleet.parse(LOAD_FLEET_SPEC).total_chips
    tmp = tempfile.mkdtemp(prefix="chip-smoke-load-")
    ep = Entrypoints(tmp, LOAD_FLEET_SPEC, nodes=LOAD_NODES,
                     webhook_admission=True)
    manager_started = ep.manager.started
    ended = {}
    try:
        kube, call = ep.facade.kube, ep.facade.call
        synced = ep.wait_synced()

        async def quota():
            rq = await kube.get_or_none("ResourceQuota", "kf-resource-quota",
                                        LOAD_NAMESPACE)
            return ((rq or {}).get("spec") or {}).get("hard")

        async def cleaned():
            return not await kube.list("Notebook", LOAD_NAMESPACE)

        call(kube.create("Profile", profileapi.new(
            LOAD_NAMESPACE, WEB_USER, gpu_quota=count)))
        hard = call(ep.facade.wait_for(quota, "the ResourceQuota"))

        async def load():
            wire = HttpKube(f"http://{FACADE_HOST}:{FACADE_PORT}")
            try:
                return await run_load_test(
                    wire, count=count, namespace=LOAD_NAMESPACE,
                    accelerator=PROBE_ACCELERATOR, topology=LOAD_SHAPE,
                    timeout=LOAD_TIMEOUT)
            finally:
                await wire.close()

        report = asyncio.run(load()).to_dict()
        call(ep.facade.wait_for(cleaned, "the load test's CRs deleted"))
        by_path = admissions_by_path(ep.facade.admissions)
        facade_requests = dict(sorted(ep.facade.requests.items()))
    finally:
        try:
            ended = ep.stop()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    checks = {
        "processes_stopped": set(ended) == {"manager", "webhook"}
        and all(e["ran_until_stopped"] and e["stopped_by_sigterm"]
                for e in ended.values()),
        "quota": hard == {f"requests.{GPU_RESOURCE}": str(count)},
        "all_ready": report["notebooks"] == report["ready"] == count
        and report["failures"] == []
        and 0 < report["p50_ready_seconds"] <= report["p95_ready_seconds"]
        <= report["wall_seconds"],
        "admitted_by_webhook": by_path.get(
            "Notebook /mutate-notebooks allowed", 0) >= count
        and by_path.get("Pod /apply-poddefault allowed", 0) >= count
        and not any(k.endswith("denied") for k in by_path),
    }
    return {"report": report, "notebooks": count, "shape": LOAD_SHAPE,
            "fleet": LOAD_FLEET_SPEC, "nodes": LOAD_NODE_COUNT,
            "quota_hard": hard,
            "clock": "host seconds (time.perf_counter) from the first "
                     "create",
            "manager_start_to_informers_synced":
                synced["synced"] - manager_started,
            "admissions_by_path": by_path,
            "facade_requests_by_verb": facade_requests,
            "processes": ended, "checks": checks}


def phase_chaos(card: str) -> None:
    """The control plane's harnesses on the card's machine (module
    docstring, item 36): (a) one chaos soak seed with its checkpoints'
    step trees on the card, (b) the notebook load test through the
    manager and webhook processes. Launches no kernel. Any failed check
    raises."""
    phase_t0 = time.perf_counter()
    soak = _chaos_soak()
    load = _chaos_load()
    emit({"phase": "chaos", "card": card, "soak": soak, "load": load,
          "phase_sec": time.perf_counter() - phase_t0})
    failed = {part: [k for k, ok in row["checks"].items() if not ok]
              for part, row in (("soak", soak), ("load", load))}
    if any(failed.values()):
        raise AssertionError(f"chaos phase failed: {failed}")


CONFORMANCE_MODULE = "kubeflow_tpu_torch.conformance.run"
CONFORMANCE_CHECKS = 20
CONFORMANCE_TIMEOUT = 900
# The checks the reference's runner skips in --live mode: they need the
# kubelet simulator, the in-process culler or the in-process manager.
CONFORMANCE_LIVE_SKIPS = (
    "culling", "slice-atomic-restart", "preemption-recovery",
    "queued-provisioning", "maintenance-mirror", "version-conversion",
    "contributor-authz", "sidecar-restart-isolation", "profile-v1beta1")
CONFORMANCE_PP = "pipeline-parallel-step"


def conformance_run(argv: list, env: dict) -> dict:
    """``python -m kubeflow_tpu_torch.conformance.run <argv>`` as a child
    process, as an operator runs it: its exit code, wall seconds, check
    lines and summary (and its stderr's tail when it failed)."""
    from pathlib import Path

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", CONFORMANCE_MODULE, *argv], env=env,
        cwd=Path(__file__).parent, capture_output=True, text=True,
        timeout=CONFORMANCE_TIMEOUT)
    sec = time.perf_counter() - t0
    lines = [json.loads(line) for line in proc.stdout.splitlines()
             if line.startswith("{")]
    return {"returncode": proc.returncode, "sec": sec,
            "checks": [line for line in lines if "check" in line],
            "summary": next((line["summary"] for line in lines
                             if "summary" in line), None),
            "stderr_tail": proc.stderr[-3000:] if proc.returncode else ""}


def _conformance_pp(leg: str, ran: dict, card: str) -> dict:
    """The pipeline-parallel step's line of one leg, printed on its own:
    it must have run on the card, in the world ``pp_world`` picks for this
    machine's cards."""
    from kubeflow_tpu_torch.conformance.run import PP_WORLD, pp_world

    line = next((c for c in ran["checks"] if c["check"] == CONFORMANCE_PP),
                {})
    device, backend, _ = pp_world(None)
    row = {"phase": "conformance_pp_step", "leg": leg, "card": card,
           **{key: line.get(key) for key in ("pass", "world", "backend",
                                             "device", "seconds")}}
    emit(row)
    row["ok"] = (line.get("pass") is True and line.get("device") == device
                 and line.get("world") == PP_WORLD
                 and line.get("backend") == backend)
    return row


def _conformance_live() -> dict:
    """(b): ``--live`` in a child process over ``HttpKube`` against the
    facade (127.0.0.1:8001, where HttpKube looks with no in-cluster
    apiserver) with the manager and the webhook as processes and every
    admission sent to the webhook."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip-smoke-conformance-")
    t0 = time.perf_counter()
    ep = Entrypoints(tmp, fleet="", webhook_admission=True)
    ended = {}
    try:
        ep.wait_synced()
        up_sec = time.perf_counter() - t0
        env = {k: v for k, v in _pod_process_env({}).items()
               if not k.startswith("KUBERNETES_")}
        ran = conformance_run(["--live"], env)
        by_path = admissions_by_path(ep.facade.admissions)
        facade_requests = dict(sorted(ep.facade.requests.items()))
    finally:
        try:
            ended = ep.stop()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    skipped = [c["check"] for c in ran["checks"] if "skipped" in c]
    return {**ran, "processes_up_sec": up_sec, "skipped": skipped,
            "admissions_by_path": by_path,
            "facade_requests_by_verb": facade_requests, "processes": ended}


def phase_conformance(card: str) -> None:
    """The conformance runner on the port (module docstring, item 38):
    (a) the hermetic suite, (b) ``--live`` against the facade and the
    entry points as processes; the pipeline-parallel step on the card in
    both. Any failed check raises."""
    phase_t0 = time.perf_counter()
    hermetic = conformance_run([], _pod_process_env({}))
    hermetic_pp = _conformance_pp("hermetic", hermetic, card)
    live = _conformance_live()
    live_pp = _conformance_pp("live", live, card)
    total = CONFORMANCE_CHECKS
    checks = {
        "hermetic_all_pass": hermetic["returncode"] == 0
        and len(hermetic["checks"]) == total
        and all(c["pass"] and "skipped" not in c for c in hermetic["checks"])
        and hermetic["summary"] == f"{total}/{total} checks passed",
        "hermetic_pp_on_card": hermetic_pp["ok"],
        "live_all_pass": live["returncode"] == 0
        and len(live["checks"]) == total
        and all(c["pass"] for c in live["checks"])
        and live["summary"] == f"{total}/{total} checks passed",
        "live_skips_are_the_references": tuple(live["skipped"])
        == CONFORMANCE_LIVE_SKIPS,
        "live_pp_on_card": live_pp["ok"],
        "live_admitted_by_webhook": live["admissions_by_path"].get(
            "Notebook /mutate-notebooks allowed", 0) > 0
        and live["admissions_by_path"].get(
            "Pod /apply-poddefault allowed", 0) > 0,
        "processes_stopped": set(live["processes"]) == {"manager", "webhook"}
        and all(e["ran_until_stopped"] and e["stopped_by_sigterm"]
                for e in live["processes"].values()),
    }
    emit({"phase": "conformance", "card": card,
          "hermetic": {k: hermetic[k] for k in ("returncode", "sec",
                                                "summary", "checks",
                                                "stderr_tail")},
          "live": live,
          "phase_sec": time.perf_counter() - phase_t0, "checks": checks})
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"conformance phase failed: {failed}")


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
    # Each block's loss (the probes' reports, at n >= 2, are dicts).
    if not all(math.isfinite(v) for key in ("n_1", "n_4")
               if isinstance(row[key], dict) for v in row[key].values()
               if not isinstance(v, dict)):
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
    """One process of the world of 4 that ``sharded_grads``,
    ``serving_sharded_world`` and ``worlds_probe`` share (one spawn: each
    process takes seconds to reach the card): the sharded step, then the
    sharded engine, each with its launches counted from zero, then the
    all-reduce probe over the world."""
    import torch

    from kubeflow_tpu_torch.probe.ici import run_ici_probe

    grads = _sharded_grads_rank(rank, grads_model, seed)
    torch.cuda.empty_cache()
    serving = _serving_world_rank(rank, serving_model)
    torch.cuda.empty_cache()
    probe = run_ici_probe(mbytes=WORLD_PROBE_MBYTES, iters=WORLD_PROBE_ITERS,
                          accelerator=PROBE_ACCELERATOR,
                          topology=WORLD_PROBE_SHAPE)
    return {"sharded_grads": grads, "serving_sharded_world": serving,
            "probe": probe.to_dict()}


def phase_worlds(torch, burnin, tree, engine_mod, launch) -> dict:
    """``sharded_grads``, ``serving_sharded_world`` and ``worlds_probe``
    over one world of 4 processes on the card: both references on the card
    first, then the world, then each phase's row and checks."""
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
    phase_worlds_probe([r["probe"] for r in ranks])
    del ranks, grads_ref, serving_ref
    torch.cuda.empty_cache()
    return by_path


def phase_worlds_probe(reports: list) -> None:
    """The all-reduce probe in the world of 4 processes that share the
    card over gloo on CUDA tensors: every rank's report the same (the
    slowest rank's mean), a positive bus bandwidth, and the fraction of
    peak equal to it over the ``1x4`` share's estimate. The GB/s go
    through the host: no NVLink rate."""
    from kubeflow_tpu_torch.gpu.topology import GpuSlice

    got = reports[0]
    peak = GpuSlice.parse(PROBE_ACCELERATOR,
                          WORLD_PROBE_SHAPE).allreduce_algo_bandwidth_gbps()
    row = {"phase": "worlds_probe", "report": got,
           "backend": "gloo on CUDA tensors (4 processes, one card)",
           "shape": WORLD_PROBE_SHAPE, "peak_estimate_gbps": peak,
           "note": "gloo through the host, no NVLink rate"}
    emit(row)
    if not (all(r == got for r in reports) and got["devices"] == 4
            and got["backend"] == "gloo" and got["algo_bandwidth_gbps"] > 0
            and got["peak_estimate_gbps"] == peak
            and math.isclose(got["fraction_of_peak"],
                             got["algo_bandwidth_gbps"] / peak,
                             abs_tol=1e-4)):
        raise AssertionError(f"worlds_probe phase failed: {row}")


# The spawn phase: the port's notebook control plane in the fake apiserver
# (admission, the manager with the notebook controller, the kubelet
# simulator), three GPU notebooks (namespace, topology, slices): one card,
# two whole nodes, and two slices of one node. Pod nb-0 of the one-card
# notebook and the two pods of the 2x8 one run on this machine under the
# env admission gave them, the rendezvous moved to 127.0.0.1 (cluster DNS
# does not resolve here).
SPAWN_NOTEBOOKS = (("card", "1x1", 1), ("ns", "2x8", 1), ("multi", "1x8", 2))
# The 2x8 notebook's two nodes run here as two processes of one machine,
# where its node 0's cluster DNS name does not resolve: they meet on the
# loopback instead. (A one-node pod's env names the loopback itself.)
PAIR_RENDEZVOUS = "127.0.0.1"
SPAWN_TIMEOUT = 180
# The child that joins the one-card pod's world on the card: the SDK's
# initialize_distributed() from the env, which at a world of one process
# is the SDK's single-process no-op (it returns False), then a one-rank
# NCCL group at the same env's rendezvous, and an all-reduce on the card.
SPAWN_NCCL_CHILD = """
import json, torch, torch.distributed as dist
from kubeflow_tpu_torch import sdk
info = sdk.SliceInfo.from_env()
joined = sdk.initialize_distributed()
if not joined:
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method="tcp://" + info.coordinator_address,
        world_size=info.num_processes, rank=info.process_id,
        device_id=torch.device("cuda", 0))
x = torch.full((1 << 20,), float(dist.get_rank() + 1), device="cuda")
dist.all_reduce(x)
torch.cuda.synchronize()
print(json.dumps({"sdk_joined": joined, "backend": dist.get_backend(),
                  "world": dist.get_world_size(), "rank": dist.get_rank(),
                  "coordinator": info.coordinator_address,
                  "sum": float(x[0]), "elements": x.numel()}))
dist.destroy_process_group()
"""


async def _spawn_notebooks() -> dict:
    """Create each SPAWN_NOTEBOOKS notebook in the port's harness, time it
    from the create to every pod Running (the host's clock), count the
    reconciles and API requests it took, and read back its children, its
    status and its pods' env after admission."""
    import asyncio

    from kubeflow_tpu_torch.api import notebook as nbapi
    from kubeflow_tpu_torch.controllers.notebook import (
        NotebookOptions, setup_notebook_controller)
    from kubeflow_tpu_torch.gpu.topology import MultiSlice
    from kubeflow_tpu_torch.runtime.manager import Manager
    from kubeflow_tpu_torch.runtime.metrics import Registry
    from kubeflow_tpu_torch.testing import FakeKube, PodSimulator
    from kubeflow_tpu_torch.webhooks import register_all

    kube = FakeKube()
    register_all(kube)
    mgr = Manager(kube, registry=Registry())
    setup_notebook_controller(mgr, NotebookOptions(
        create_network_policies=True))
    sim = PodSimulator(kube)
    await mgr.start()
    await sim.start()

    def counts():
        return (mgr.reconcile_seconds.snapshot(controller="notebook")["count"],
                sum(kube.requests.values()))

    out = {}
    try:
        for ns, topology, slices in SPAWN_NOTEBOOKS:
            ms = MultiSlice.parse(PROBE_ACCELERATOR, topology, slices)
            reconciles, requests = counts()
            t0 = time.perf_counter()
            await kube.create("Notebook", nbapi.new(
                "nb", ns, accelerator=PROBE_ACCELERATOR, topology=topology,
                num_slices=slices))
            while True:
                pods = await kube.list("Pod", ns)
                if len(pods) == ms.total_hosts and all(
                        p.get("status", {}).get("phase") == "Running"
                        for p in pods):
                    break
                if time.perf_counter() - t0 > SPAWN_TIMEOUT:
                    raise AssertionError(f"spawn of {ns}/nb timed out")
                await asyncio.sleep(0.001)
            running_sec = time.perf_counter() - t0
            for _ in range(6):   # the status write after the pods ran
                await mgr.wait_idle(timeout=20)
                await asyncio.sleep(0.02)
            reconciles_after, requests_after = counts()
            out[ns] = {
                "topology": topology, "slices": slices,
                "create_to_running_sec": running_sec,
                "reconciles": reconciles_after - reconciles,
                "api_requests": requests_after - requests,
                "children": {kind: [o["metadata"]["name"]
                                    for o in await kube.list(kind, ns)]
                             for kind in ("StatefulSet", "Service",
                                          "NetworkPolicy")},
                "sts": await kube.list("StatefulSet", ns),
                "services": await kube.list("Service", ns),
                "policy": await kube.list("NetworkPolicy", ns),
                "status": (await kube.get("Notebook", "nb", ns))["status"],
                "env": {p["metadata"]["name"]: {
                    e["name"]: e.get("value")
                    for e in p["spec"]["containers"][0]["env"]}
                    for p in await kube.list("Pod", ns)}}
        out["api_requests_by_verb"] = dict(kube.requests)
    finally:
        await sim.stop()
        await mgr.stop()
        kube.close_watches()
    return out


def _pod_process_env(pod_env: dict, master_addr: str | None = None) -> dict:
    """This process's env without any rank or slice wiring of its own,
    under a pod's env, its rendezvous moved to ``master_addr`` where one
    is given."""
    import os

    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PET_", "TPU_", "JAX_", "MEGASCALE_",
                                "KFTPU_"))
           and k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                         "MASTER_PORT")}
    env.update({k: v for k, v in pod_env.items() if v is not None})
    if master_addr is not None:
        env["PET_MASTER_ADDR"] = master_addr
    return env


def _run_children(argvs_envs: list) -> list:
    """Run the children together; every one must exit 0. Each starts in a
    session of its own and is stopped at exit if it has not ended."""
    import atexit
    from pathlib import Path

    procs = []
    for argv, env in argvs_envs:
        proc = subprocess.Popen(
            [sys.executable, *argv], env=env, cwd=Path(__file__).parent,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            start_new_session=True)
        atexit.register(_stop_group, proc)
        procs.append(proc)
    outs = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=SPAWN_TIMEOUT)
        finally:
            _stop_group(proc)
        if proc.returncode:
            raise AssertionError(f"spawned pod process {proc.args} failed "
                                 f"({proc.returncode}):\n{out}\n{err}")
        outs.append(out)
    return outs


def phase_spawn(card: str) -> None:
    """The notebook spawn path on GPU nodes (module docstring, item 31):
    the three notebooks rendered in the fake apiserver and checked
    against gpu/topology, the one-card pod's env running the probe CLI
    and the NCCL child on the card, and the 2x8 pair's env forming a
    world of 2 over gloo."""
    import asyncio

    from kubeflow_tpu_torch.gpu.topology import (LOOPBACK_ADDR, GpuSlice,
                                                 MultiSlice)

    t0 = time.perf_counter()
    spawned = asyncio.run(_spawn_notebooks())
    render_sec = time.perf_counter() - t0
    checks = {}
    for ns, topology, slices in SPAWN_NOTEBOOKS:
        got = spawned[ns]
        ms = MultiSlice.parse(PROBE_ACCELERATOR, topology, slices)
        gpu = ms.slice
        names = [ms.slice_sts_name("nb", j) for j in range(slices)]
        tmpl = [sts["spec"]["template"]["spec"] for sts in got["sts"]]
        ranks = sorted(env.get("PET_NODE_RANK") for env in got["env"].values())
        checks[ns] = (
            [s["metadata"]["name"] for s in got["sts"]] == names
            and all(s["spec"]["replicas"] == gpu.num_hosts for s in got["sts"])
            and all(t["nodeSelector"] == gpu.node_selectors() for t in tmpl)
            and all(t["containers"][0]["resources"]["requests"]
                    == gpu.resource_requests() for t in tmpl)
            and ranks == [str(r) for r in range(ms.total_hosts)]
            and all(env["PET_NNODES"] == str(ms.total_hosts)
                    and env["PET_NPROC_PER_NODE"] == str(gpu.chips_per_host)
                    for env in got["env"].values())
            and got["status"]["gpu"]["hosts"] == ms.total_hosts
            and got["status"]["readyReplicas"] == ms.total_hosts)
    pair = spawned["ns"]
    pair_env = pair["env"]["nb-1"]
    checks["ns_main_path"] = (
        [s["spec"]["replicas"] for s in pair["sts"]] == [2]
        and pair["sts"][0]["spec"]["template"]["spec"]["containers"][0][
            "resources"]["requests"] == {"nvidia.com/gpu": "8"}
        and sorted(pair["children"]["Service"]) == ["nb", "nb-workers"]
        and next(s for s in pair["services"] if s["metadata"]["name"] == "nb")[
            "spec"]["selector"]["statefulset.kubernetes.io/pod-name"] == "nb-0"
        and {"from": [{"podSelector": {"matchLabels": {
            "notebook-name": "nb"}}}]} in pair["policy"][0]["spec"]["ingress"]
        and pair_env["PET_NODE_RANK"] == "1" and pair_env["PET_NNODES"] == "2"
        and pair_env["PET_NPROC_PER_NODE"] == "8"
        and pair_env["PET_MASTER_ADDR"]
        == "nb-0.nb-workers.ns.svc.cluster.local")

    card_env = _pod_process_env(spawned["card"]["env"]["nb-0"])
    pair_envs = [_pod_process_env(pair["env"][f"nb-{i}"], PAIR_RENDEZVOUS)
                 for i in range(2)]
    t0 = time.perf_counter()
    outs = _run_children(
        [(["-m", "kubeflow_tpu_torch.probe", "--skip-dcn"], card_env)]
        + [(["-m", "kubeflow_tpu_torch.testing.distributed_worker"], env)
           for env in pair_envs])
    probe_and_gloo_sec = time.perf_counter() - t0
    probe = json.loads(outs[0].strip().splitlines()[-1])
    gloo = [[line for line in out.splitlines()
             if line.startswith(("PSUM_RESULT", "RANK "))] for out in outs[1:]]
    t0 = time.perf_counter()
    nccl = json.loads(_run_children([(["-c", SPAWN_NCCL_CHILD], card_env)])[0]
                      .strip().splitlines()[-1])
    nccl_sec = time.perf_counter() - t0
    # The pod env's shape, which the probe CLI scores against: one card,
    # whose estimate is inf (a world of one moves no bytes between cards),
    # and which the report writes as null (JSON has no Infinity).
    estimate = GpuSlice.parse(card_env["KFTPU_ACCELERATOR"],
                              card_env["TPU_TOPOLOGY"]) \
        .allreduce_algo_bandwidth_gbps()
    ici = probe["ici"]
    row = {"phase": "spawn", "card": card,
           "clock": "host seconds (the fake apiserver and the kubelet "
                    "simulator in this process; no card work)",
           "notebooks": {ns: {k: spawned[ns][k] for k in (
               "topology", "slices", "create_to_running_sec", "reconciles",
               "api_requests", "children")} for ns, _, _ in SPAWN_NOTEBOOKS},
           "api_requests_by_verb": spawned["api_requests_by_verb"],
           "render_sec": render_sec,
           "card_pod_rendezvous": card_env["PET_MASTER_ADDR"],
           "pair_rendezvous": {"PET_MASTER_ADDR": PAIR_RENDEZVOUS,
                               "was": pair["env"]["nb-0"][
                                   "PET_MASTER_ADDR"]},
           "probe_estimate_gbps": str(estimate),
           "card_pod_env": {k: v for k, v in card_env.items()
                            if k.startswith(("PET_", "TPU_", "KFTPU_"))},
           "probe": probe, "nccl_child": nccl, "gloo_pair": gloo,
           "probe_and_gloo_sec": probe_and_gloo_sec, "nccl_sec": nccl_sec,
           "checks": checks}
    emit(row)
    if not (all(checks.values())
            and set(probe) == {"ici"} and ici["backend"] == "nccl"
            and ici["devices"] == 1 and ici["mean_seconds"] > 0
            and estimate == float("inf") and ici["peak_estimate_gbps"] is None
            and ici["algo_bandwidth_gbps"] is None
            and ici["fraction_of_peak"] is None
            and nccl["backend"] == "nccl" and nccl["world"] == 1
            and nccl["sdk_joined"] is False and nccl["sum"] == 1.0
            and card_env["PET_MASTER_ADDR"] == LOOPBACK_ADDR
            and nccl["coordinator"] == f"{LOOPBACK_ADDR}:29500"
            and all(lines[0] == "PSUM_RESULT 3.0 NPROC 2" for lines in gloo)
            and sorted(lines[1] for lines in gloo)
            == ["RANK 0 OF 2", "RANK 1 OF 2"]):
        raise AssertionError(f"spawn phase failed: {row}")


def _stop_group(proc) -> None:
    """Kill a process started in a session of its own, and everything it
    started, unless it has ended."""
    import os
    import signal

    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def start_probe_cli(torch) -> tuple:
    """Start ``python -m kubeflow_tpu_torch.probe --skip-dcn`` (the probe
    CLI as a user runs it: one NCCL process a local card, which it starts
    itself) beside the device line and the build, where no timed work
    runs: each of its two processes takes seconds to reach the card. Its
    output goes to temporary files; it is stopped at exit if it has not
    ended."""
    import atexit
    import tempfile

    out, err = (tempfile.TemporaryFile(mode="w+") for _ in range(2))
    proc = subprocess.Popen(
        [sys.executable, "-m", "kubeflow_tpu_torch.probe", "--skip-dcn",
         "--mbytes", str(PROBE_MBYTES), "--accelerator", PROBE_ACCELERATOR,
         "--topology", f"1x{torch.cuda.device_count()}"],
        stdout=out, stderr=err, text=True, start_new_session=True)
    atexit.register(_stop_group, proc)
    return proc, out, err, time.perf_counter()


def finish_probe_cli(cli: tuple) -> dict:
    """Wait for the probe CLI (before the first timed phase) and parse its
    JSON; ``cli_sec`` is its wall time, ``waited_sec`` what the script
    waited for it after the build."""
    proc, out, err, started = cli
    t0 = time.perf_counter()
    proc.wait(timeout=300)
    waited = time.perf_counter() - t0
    out.seek(0)
    err.seek(0)
    text, errors = out.read(), err.read()
    if proc.returncode:
        raise AssertionError(f"probe CLI failed:\n{text}\n{errors}")
    return {"report": json.loads(text.strip().splitlines()[-1]),
            "cli_sec": time.perf_counter() - started, "waited_sec": waited}


def phase_probe(torch, cli: dict) -> dict:
    """The slice burn-in on the card, inside the world of one over NCCL:
    ``run_ici_probe`` there (world 1: no bytes cross a card, bandwidth
    None, as the reference gives at one chip); the probe CLI's report
    (``start_probe_cli``), whose ``ici`` must come from an NCCL world of
    ``torch.cuda.device_count()`` processes; and the DCN loopback ring of
    2 ranks scored against the A3 High estimate (loopback is no
    network)."""
    import torch.distributed as dist

    from kubeflow_tpu_torch.gpu.topology import MultiSlice
    from kubeflow_tpu_torch.probe import dcn
    from kubeflow_tpu_torch.probe.ici import run_ici_probe

    t0 = time.perf_counter()
    here = run_ici_probe(mbytes=PROBE_MBYTES, accelerator=PROBE_ACCELERATOR,
                         topology="1x1").to_dict()
    here_sec = time.perf_counter() - t0
    cli_report = cli["report"]
    t0 = time.perf_counter()
    ring = dcn.run_local_ring(world=2, mbytes=PROBE_MBYTES, iters=4,
                              base_port=dcn.free_base_port(2))
    ring_sec = time.perf_counter() - t0
    scored = dcn.score_reports(ring, multi=MultiSlice.parse(
        PROBE_ACCELERATOR, "1x8", num_slices=2)).to_dict()
    row = {"phase": "probe", "world_of_one": here,
           "world_of_one_backend": dist.get_backend(),
           "world_of_one_sec": here_sec, "cli": cli_report,
           "cli_sec": cli["cli_sec"], "cli_waited_sec": cli["waited_sec"],
           "dcn_loopback": scored,
           "dcn_loopback_ranks": ring, "dcn_sec": ring_sec,
           "note": "world 1 moves no bytes between cards; the DCN ring runs "
                   "over loopback, which is no network: neither is an "
                   "NVLink or NIC rate"}
    emit(row)
    ici = cli_report["ici"]
    if not (here["devices"] == 1 and here["backend"] == "nccl"
            and here["algo_bandwidth_gbps"] is None and here["mean_seconds"] > 0
            and set(cli_report) == {"ici"}
            and ici["devices"] == torch.cuda.device_count()
            and ici["backend"] == "nccl" and ici["mean_seconds"] > 0
            and (ici["devices"] == 1) == (ici["algo_bandwidth_gbps"] is None)
            and scored["world"] == 2 and scored["min_gbps"] > 0
            and scored["peak_estimate_gbps"] == 100.0
            and scored["fraction_of_peak"] > 0):
        raise AssertionError(f"probe phase failed: {row}")
    return row


def phase_build_cache(torch, fa, build, compilecache, build_sec: float,
                      entries: dict) -> None:
    """The kernel cache's seed round trip on the card, with no ``nvcc``: a
    temporary cache seeded from the build directory, ``_build`` pointed
    at it, ``build()`` compiling nothing (a hit), and the forward's
    library loaded from there and launched once at the decode shape,
    held against the plain version at TOL_O / TOL_LSE. The build
    directory is restored and the temporary one removed."""
    import shutil
    import tempfile
    from pathlib import Path

    name, shape, dtype, causal = next(c for c in KERNEL_CASES
                                      if c[0] == "decode")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(getattr(torch, dtype)) for _ in range(3))
    home, real_nvcc = build.BUILD_DIR, build._nvcc
    tmp = tempfile.mkdtemp(prefix="chip-smoke-cache-")

    def no_nvcc():
        raise RuntimeError("a seeded cache must not run nvcc")

    build._nvcc = no_nvcc
    try:
        t0 = time.perf_counter()
        seeded = compilecache.seed_cache(str(home), tmp)
        enabled = compilecache.enable_persistent_cache(tmp)
        before = compilecache.cache_entries(tmp)
        compiled = build.build()
        verdict = compilecache.note_compile(
            before, compilecache.cache_entries(tmp))
        seed_sec = time.perf_counter() - t0
        t0 = time.perf_counter()
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        torch.cuda.synchronize()
        first_launch_sec = time.perf_counter() - t0
        loaded_from = str(Path(build.load(fa.SOURCE)._name).parent)
    finally:
        build._nvcc = real_nvcc
        build.set_library_dir(home)
        shutil.rmtree(tmp, ignore_errors=True)
    ro, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
    err_o = (o.float() - ro.float()).abs().max().item()
    err_lse = (lse - rlse).abs().max().item()
    row = {"phase": "build_cache", "case": name, "shape": list(shape),
           "dtype": dtype, "entries": entries, "seeded": seeded,
           "enabled": enabled == tmp, "compiled": compiled,
           "verdict": verdict, "counters": compilecache.cache_stats(),
           "loaded_from_seeded_dir": loaded_from == tmp,
           "build_sec": build_sec, "seed_sec": seed_sec,
           "first_launch_sec": first_launch_sec,
           "max_err_o": err_o, "max_err_lse": err_lse,
           "tol_o": TOL_O[dtype], "tol_lse": TOL_LSE,
           "restored": build.BUILD_DIR == home}
    emit(row)
    if not (seeded["seeded"] >= len(build.sources()) and seeded["ready"]
            and row["enabled"] and compiled == [] and verdict == "hit"
            and row["loaded_from_seeded_dir"] and row["restored"]
            and bool(torch.isfinite(o).all()) and err_o <= TOL_O[dtype]
            and err_lse <= TOL_LSE):
        raise AssertionError(f"build_cache phase failed: {row}")


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
    from kubeflow_tpu_torch import checkpoint, data, entry, sdk, telemetry
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
    from kubeflow_tpu_torch.utils import compilecache

    probe_cli = start_probe_cli(torch)
    warm = start_warm_pod()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "device", "card": card,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "allow_tf32": False})

    t0 = time.perf_counter()
    entries = {"before": compilecache.cache_entries(str(_build.BUILD_DIR))}
    compiled = _build.build()
    build_sec = time.perf_counter() - t0
    entries["after"] = compilecache.cache_entries(str(_build.BUILD_DIR))
    entries["verdict"] = compilecache.note_compile(entries["before"],
                                                   entries["after"])
    emit({"phase": "build", "sources": _build.sources(), "compiled": compiled,
          "build_sec": build_sec, "cache_entries": entries,
          "sass": {src: sass_counts(_build.library_path(src))
                   for src in (fa.SOURCE, fa.BWD_SOURCE, fa.WIDE_SOURCE)},
          "sass_wide_by_kernel": sass_counts(
              _build.library_path(fa.WIDE_SOURCE), by_kernel=True),
          "sass_fwd_by_kernel": sass_counts(
              _build.library_path(fa.SOURCE), by_kernel=True),
          "ptxas": [line.strip() for log in _build.BUILD_LOG.values()
                    for line in log.splitlines()
                    if "registers" in line or "spill" in line
                    or "entry function" in line or "C75" in line]})
    warm_pod_go(warm)
    phase_build_cache(torch, fa, _build, compilecache, build_sec, entries)
    probe_cli = finish_probe_cli(probe_cli)

    kernels = phase_kernels(torch, fa)
    bwd_rows = phase_bwd_kernels(torch, fa)
    bwd = bwd_rows["train"]
    head_dims = phase_head_dims(torch, fa)
    other_dims, dims_timed = head_dims["max_abs_err"], head_dims["timed"]
    phase_model(torch, fa, burnin)
    phase_train_grads(torch, fa, burnin)
    train = phase_train(torch, fa, burnin, card)
    by_path = {"train": train["launches"],
               "profiler_server": phase_profiler_server(fa, burnin, card)}
    with world_of_one(torch):
        by_path["serving"] = {"fwd": phase_serving(
            torch, fa, burnin, engine_mod, loadgen)["launches"]}
        by_path["sharded"] = phase_sharded(torch, fa, burnin, tree, pmesh)
        phase_dryrun(torch, entry)
        phase_probe(torch, probe_cli)
    by_path["trainer"] = phase_trainer(torch, fa, burnin, trainer,
                                       telemetry)
    by_path["checkpoint"], reuse = phase_checkpoint(
        torch, fa, burnin, trainer, data, checkpoint, sdk, card)
    by_path["fleet"] = phase_fleet(torch, fa, trainer, checkpoint, sdk,
                                   reuse, warm, card)
    del reuse
    torch.cuda.empty_cache()
    by_path["serving_control"] = phase_serving_control(
        torch, fa, burnin, trainer, data, checkpoint, sdk, card)
    by_path["entrypoints"] = phase_entrypoints(torch, fa, burnin, sdk, card)
    by_path["webapps"] = phase_webapps(card)
    phase_chaos(card)
    phase_conformance(card)
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
    phase_spawn(card)

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

    def device_kernels(name: str, f32: str, wide: str) -> dict:
        """The CUDA kernels behind one entry, by head dim and dtype."""
        return {"bf16 d <= 128": name, "bf16 136-256": f"wide_{name}",
                "bf16 > 256": wide, "f32": f32,
                "wide_source": "kubeflow_tpu_torch/ops/csrc/"
                               "flash_attention_wide.cu"}

    f32_fwd = ("fwd_f32_tiled_kernel (kubeflow_tpu_torch/ops/csrc/"
               "flash_attention_f32.cuh)")

    def f32_bwd(key: str) -> str:
        return (f"{key}_f32_tiled_kernel (kubeflow_tpu_torch/ops/csrc/"
                "flash_attention_f32_bwd.cuh)")

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
         "device_kernels": device_kernels("fwd_bf16_kernel", f32_fwd,
                                          "wide_fwd_bf16_sliced_kernel")},
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
           "device_kernels": device_kernels(
               f"{key}_bf16_kernel", f32_bwd(key),
               f"wide_{key}_bf16_sliced_kernel")}
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
         "device_kernels": device_kernels(
             "partial_bf16_kernel", f32_fwd,
             "wide_partial_bf16_sliced_kernel")}]})
    emit({"phase": "wall", "script_sec": time.perf_counter() - STARTED})
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
