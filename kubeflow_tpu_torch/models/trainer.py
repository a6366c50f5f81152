"""Training harness: optimizer, gradient accumulation and ``fit``.

The port of ``kubeflow_tpu/models/trainer.py``, on one device or on a
mesh. The optax chain becomes torch objects with optax's numbers:

- ``clip_by_global_norm``: ``g / ‖g‖ * max`` only when ``‖g‖ ≥ max``,
  with no epsilon (``torch.nn.utils.clip_grad_norm_`` divides by
  ``‖g‖ + 1e-6`` and scales below the threshold too, so it is not used);
- ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the square root, decoupled
  weight decay scaled by the scheduled lr, on every leaf) is
  ``torch.optim.AdamW``, whose update is the same arithmetic;
- ``warmup_cosine_decay_schedule(init_value=0)`` is a ``LambdaLR`` that
  counts from 0 as optax does, so the first update runs at lr 0;
- ``sgd`` is ``torch.optim.SGD`` without momentum.

The train state is a dict as in the JAX package, ``{"params",
"opt_state", "step"}``; the step updates params and optimizer state in
place (the counterpart of donating the state to a jitted step).

Sharded, the state follows the params' rules: ``state_sharding_rules``
gives the AdamW moments their params' rules leaf for leaf, as optax's
moments inherit them in JAX, and ``shard_state`` builds the optimizer on
the param shards, so the moments it makes are shards too. The sharded
step sums the gradients as the model's step does and clips by the global
norm of the global leaves. AdamW, its decoupled weight decay and the
schedule are elementwise and run on the shards unchanged.

``fit`` takes the telemetry hooks (``telemetry.StepProfiler``,
``telemetry.TelemetryPublisher``) as the JAX ``fit`` does. The step runs
inside registered spans (``telemetry.sections.span``): ``train_step``,
with the step count as its args, around ``accumulate``, ``update`` and
the ``clip`` inside it; ``kftpu.*`` ranges while a torch profiler
collects, nothing otherwise.

Checkpoints. The live state holds torch optimizer objects, which no
checkpoint stores. ``checkpoint_tree`` gives the state in the JAX
package's layout, leaf for leaf: optax's state tuples with int32 counts
(Adam's and the schedule's), f32 moments in the params' tree, an int32
step. Either package's fabric writes the same manifest for the same
numbers, and a step saved by one resumes in the other.
``abstract_state`` describes that tree without a live optimizer (the
counterpart of ``jax.eval_shape`` for a restore), and ``load_state``
turns a restored tree back into a live state: AdamW's per-parameter state
made at once (torch makes it lazily at the first ``step()``), its float
``step``, the moments, ``LambdaLR``'s ``last_epoch`` and each group's
scheduled ``lr`` (without which a resume would run at the warmup's first
lr, 0). ``fit`` hands its ``checkpoints`` this tree.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from itertools import islice
from typing import Callable, Iterator

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.checkpoint.abstract import LeafSpec
from kubeflow_tpu_torch.models.tree import (leaves, map_params, map_with,
                                            value_and_grad)
from kubeflow_tpu_torch.parallel.mesh import (axis, cuts, grad_groups,
                                              reduce_grads, shard, world_size)
from kubeflow_tpu_torch.telemetry.sections import span


@dataclass(frozen=True)
class TrainerConfig:
    optimizer: str = "adamw"          # "adamw" | "sgd"
    lr: float = 3e-4
    weight_decay: float = 0.01
    warmup_steps: int = 100
    decay_steps: int = 10_000         # cosine horizon (adamw)
    grad_clip: float = 1.0            # global-norm clip; 0 disables


def warmup_cosine(cfg: TrainerConfig) -> Callable[[int], float]:
    """The lr multiplier at update ``count`` (from 0): linear from 0 to 1
    over ``warmup_steps``, then a cosine to 0 at ``decay_steps`` (at least
    ``warmup_steps + 1``), as optax's ``warmup_cosine_decay_schedule``."""
    warmup = cfg.warmup_steps
    span = max(cfg.decay_steps, warmup + 1) - warmup

    def factor(count: int) -> float:
        if count < warmup:
            return count / warmup
        done = min(count - warmup, span) / span
        return 0.5 * (1.0 + math.cos(math.pi * done))

    return factor


def clip_by_global_norm_(grads: list, max_norm: float,
                         split: list | None = None) -> torch.Tensor:
    """Scale ``grads`` in place by ``max_norm / ‖g‖`` when the global norm
    ``‖g‖ ≥ max_norm``, as ``optax.clip_by_global_norm``: ``g / ‖g‖ *
    max_norm``, no epsilon, untouched below the threshold. Returns the
    norm (on the device; nothing synchronises).

    ``split``, for the shards of a sharded state: one list a leaf of the
    process groups its shards are cut over (``[]``: whole on every
    process). The norm is then the global leaves': each cut leaf's
    squared norm summed over its groups, each whole one counted once."""
    with span("clip"):
        norms = torch.stack(torch._foreach_norm(grads))
        if split and any(split):
            parts = {}
            for i, groups in enumerate(split):
                parts.setdefault(tuple(groups), []).append(i)
            squares = norms * norms
            total = torch.zeros_like(norms[0])
            for groups, rows in parts.items():
                part = squares[rows].sum()
                for group in groups:
                    dist.all_reduce(part, group=group)
                total = total + part
            norm = total.sqrt()
        else:
            norm = torch.linalg.vector_norm(norms)
        below = norm < max_norm
        divisor = torch.where(below, torch.ones_like(norm), norm)
        factor = torch.where(below, torch.ones_like(norm),
                             torch.full_like(norm, max_norm))
        for g in grads:
            g.div_(divisor).mul_(factor)
        return norm


class Optimizer:
    """The optimizer chain of a :class:`TrainerConfig`: ``init(params)``
    gives its state, ``update(grads, opt_state, params)`` clips the grads
    and applies one update to the params in place."""

    def __init__(self, cfg: TrainerConfig):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.cfg = cfg

    def init(self, params) -> dict:
        """The optimizer state: the torch optimizer, its schedule (None
        for SGD) and the config (which ``checkpoint_tree`` reads)."""
        cfg = self.cfg
        tensors = leaves(params)
        if cfg.optimizer == "sgd":
            return {"optimizer": torch.optim.SGD(tensors, lr=cfg.lr),
                    "schedule": None, "config": cfg}
        opt = torch.optim.AdamW(tensors, lr=cfg.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=cfg.weight_decay)
        return {"optimizer": opt,
                "schedule": torch.optim.lr_scheduler.LambdaLR(
                    opt, warmup_cosine(cfg)),
                "config": cfg}

    def update(self, grads: list, opt_state: dict, params,
               split: list | None = None) -> None:
        with span("update"):
            if self.cfg.grad_clip:
                clip_by_global_norm_(grads, self.cfg.grad_clip, split)
            tensors = leaves(params)
            for p, g in zip(tensors, grads):
                p.grad = g
            opt_state["optimizer"].step()
            for p in tensors:
                p.grad = None
            if opt_state["schedule"] is not None:
                opt_state["schedule"].step()


def make_optimizer(cfg: TrainerConfig) -> Optimizer:
    return Optimizer(cfg)


def init_state(params, optimizer: Optimizer) -> dict:
    """The train state: params, optimizer state and the step count."""
    return {"params": params, "opt_state": optimizer.init(params), "step": 0}


def state_sharding_rules(params_rules, params, optimizer: Optimizer) -> dict:
    """The state's sharding rules: the params' rules; under "opt_state",
    the optimizer's per-parameter moments by their state keys (AdamW's
    ``exp_avg`` and ``exp_avg_sq``) with the params' rules leaf for leaf,
    its update count and the schedule replicated (``()``); the step
    replicated."""
    if len(leaves(params_rules)) != len(leaves(params)):
        raise ValueError("the rules do not have the params' leaves")
    moments = ("exp_avg", "exp_avg_sq") if optimizer.cfg.optimizer == "adamw" \
        else ()
    return {"params": params_rules,
            "opt_state": {**{name: params_rules for name in moments},
                          "count": (), "schedule": ()},
            "step": ()}


def shard_state(state: dict, mesh, rules: dict) -> dict:
    """This process's state on ``mesh``: its shard of every param, and the
    optimizer and schedule rebuilt on those shards with their
    hyperparameters and counts, any moments already made cut as their
    params (so AdamW's lazily made moments are shards too)."""
    specs = leaves(rules["params"])
    old_params = leaves(state["params"])
    params = map_with(lambda p, spec: shard(p, spec, mesh), state["params"],
                      rules["params"])
    shard_of = {id(p): new for p, new in zip(old_params, leaves(params))}
    old = state["opt_state"]["optimizer"]
    opt = type(old)([{**group, "params": [shard_of[id(p)]
                                          for p in group["params"]]}
                     for group in old.param_groups])
    schedule = state["opt_state"]["schedule"]
    if schedule is not None:
        fresh = torch.optim.lr_scheduler.LambdaLR(opt, schedule.lr_lambdas)
        fresh.load_state_dict(schedule.state_dict())
        schedule = fresh
    # After the schedule's first step, which sets the lr of its count 0.
    for group, old_group in zip(opt.param_groups, old.param_groups):
        group.update({k: v for k, v in old_group.items() if k != "params"})
    for p, new, spec in zip(old_params, leaves(params), specs):
        opt.state[new] = {
            key: shard(v, spec, mesh) if torch.is_tensor(v)
            and v.shape == p.shape else v
            for key, v in old.state.get(p, {}).items()}
    return {"params": params,
            "opt_state": {"optimizer": opt, "schedule": schedule,
                          "config": state["opt_state"]["config"]},
            "step": state["step"]}


def _chain(cfg: TrainerConfig, inner: tuple) -> tuple:
    """optax's state tuple around the optimizer's own: the clip's empty
    state first where ``grad_clip`` chains it in."""
    return ((), inner) if cfg.grad_clip else inner


def _unchain(cfg: TrainerConfig, opt_state: tuple) -> tuple:
    return opt_state[1] if cfg.grad_clip else opt_state


def _count(n: int, device=None) -> torch.Tensor:
    return torch.tensor(int(n), dtype=torch.int32, device=device)


def checkpoint_tree(state: dict) -> dict:
    """The train state in the JAX package's checkpoint layout:
    ``{"params", "opt_state", "step"}`` with ``opt_state`` optax's tuples.
    AdamW (with the clip) is ``((), ((count, mu, nu), (), (schedule
    count,)))``, SGD ``((), ((), ()))``; without the clip the outer pair
    is dropped. Counts and the step are int32 scalars; mu and nu are the
    optimizer's own moment tensors in the params' tree (zeros before the
    first step, as optax's init gives). Leaves are the live tensors: a
    checkpointer copies them before the next step."""
    cfg = state["opt_state"]["config"]
    params = state["params"]
    if cfg.optimizer == "sgd":
        inner = ((), ())
    else:
        opt = state["opt_state"]["optimizer"]
        first = opt.state.get(leaves(params)[0])
        count = int(first["step"]) if first else 0

        def moment(name):
            return map_params(lambda p: opt.state[p][name] if first
                              else torch.zeros_like(p), params)

        inner = ((_count(count), moment("exp_avg"), moment("exp_avg_sq")),
                 (), (_count(state["opt_state"]["schedule"].last_epoch),))
    return {"params": params, "opt_state": _chain(cfg, inner),
            "step": _count(state["step"])}


def abstract_state(params, optimizer: Optimizer, *, rules=None,
                   mesh=None) -> dict:
    """What ``checkpoint_tree`` of a state over ``params`` holds, as
    ``checkpoint.LeafSpec`` leaves (the counterpart of the JAX package's
    ``jax.eval_shape`` of ``init_state``): the params' shapes, dtypes and
    devices, with the params' dict order, so a restore rebuilds them in
    the order the live state uses. With ``rules`` (the params' sharding
    rules) and ``mesh``, the params and moments carry their params' rules,
    as ``state_sharding_rules`` gives them, and a restore cuts each to this
    process's shard; counts and the step stay replicated. ``params`` are
    the global (unsharded) leaves."""
    cfg = optimizer.cfg
    if rules is None:
        like = map_params(LeafSpec.of, params)
    else:
        like = map_with(lambda p, rule: LeafSpec.of(p, rule, mesh), params,
                        rules)
    device = leaves(params)[0].device
    scalar = LeafSpec((), torch.int32, torch.device("cpu")
                      if device.type == "cpu" else device)
    if cfg.optimizer == "sgd":
        inner = ((), ())
    else:
        inner = ((scalar, like, like), (), (scalar,))
    return {"params": like, "opt_state": _chain(cfg, inner), "step": scalar}


def load_state(tree: dict, optimizer: Optimizer) -> dict:
    """A live train state from a checkpoint tree (``checkpoint_tree``'s
    layout, e.g. a restore onto ``abstract_state``): its params are the
    tree's tensors, the optimizer is built on them, AdamW's per-parameter
    state is set from the counts and moments (its float ``step`` on the
    CPU, as torch keeps it), and the schedule's ``last_epoch`` and every
    group's ``lr`` are those of the schedule count."""
    cfg = optimizer.cfg
    params = tree["params"]
    opt_state = optimizer.init(params)
    if cfg.optimizer == "adamw":
        (count, mu, nu), _, (scheduled,) = _unchain(cfg, tree["opt_state"])
        opt = opt_state["optimizer"]
        step = float(int(count))
        scalar = (torch.float64 if torch.get_default_dtype() == torch.float64
                  else torch.float32)
        for p, m, v in zip(leaves(params), leaves(mu), leaves(nu)):
            opt.state[p] = {"step": torch.tensor(step, dtype=scalar),
                            "exp_avg": m, "exp_avg_sq": v}
        schedule = opt_state["schedule"]
        schedule.last_epoch = int(scheduled)
        lrs = [base * fn(schedule.last_epoch)
               for base, fn in zip(schedule.base_lrs, schedule.lr_lambdas)]
        for group, lr in zip(opt.param_groups, lrs):
            group["lr"] = lr
        schedule._last_lr = lrs
    return {"params": params, "opt_state": opt_state,
            "step": int(tree["step"])}


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    accum_steps: int = 1, mesh=None,
                    rules: dict | None = None):
    """``(state, batch) -> (state, loss)``, updating the state in place.

    ``loss_fn(params, batch) -> scalar``: close over the model config (and
    the mesh) at the call site (``functools.partial(burnin.loss_fn,
    cfg=cfg, mesh=mesh)``).

    ``accum_steps > 1`` splits the batch's leading dim into that many
    microbatches, one after another (the activations of one microbatch
    live at a time), sums ``loss / accum_steps`` and ``grads /
    accum_steps`` over them, and applies the optimizer once.

    With a ``mesh`` of more than one process, the state is this process's
    (``shard_state``), ``rules`` the state's (``state_sharding_rules``),
    ``batch`` this process's data shard and ``loss_fn`` its loss share:
    after the accumulation, each gradient is summed once over the mesh
    axes its leaf is replicated on and the loss over the world, and the
    clip takes the global norm of the global leaves.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    world = world_size(mesh)
    split = groups = None
    if world > 1:
        if rules is None:
            raise ValueError("a step on a mesh needs the state's rules "
                             "(state_sharding_rules)")
        specs = leaves(rules["params"])
        groups = [grad_groups(spec, mesh) for spec in specs]
        split = [[axis(mesh, name).group for name in cuts(spec, mesh)
                  if name is not None] for spec in specs]

    def grads_of(params, batch):
        if accum_steps == 1:
            return value_and_grad(loss_fn, params, batch)
        if batch.shape[0] % accum_steps:
            raise ValueError(f"batch size {batch.shape[0]} not divisible by "
                             f"accum_steps={accum_steps}")
        loss = torch.zeros((), dtype=torch.float32, device=batch.device)
        total = None
        for micro in batch.chunk(accum_steps):
            part, grads = value_and_grad(loss_fn, params, micro)
            with span("accumulate"):
                loss = loss + (part / accum_steps).float()
                torch._foreach_div_(grads, accum_steps)
                if total is None:
                    total = grads
                else:
                    torch._foreach_add_(total, grads)
        return loss, total

    def step(state, batch):
        with span("train_step", state["step"]):
            loss, grads = grads_of(state["params"], batch)
            if world > 1:
                reduce_grads(grads, groups)
                dist.all_reduce(loss)
            optimizer.update(grads, state["opt_state"], state["params"],
                             split)
        return {"params": state["params"], "opt_state": state["opt_state"],
                "step": state["step"] + 1}, loss

    return step


def fit(state: dict, batches: Iterator, *, steps: int, step_fn: Callable,
        checkpoints=None, save_every: int = 100,
        on_step: Callable | None = None, skip_batches: bool = True,
        profiler=None, publisher=None) -> dict:
    """Run ``step_fn`` until ``state["step"] == steps``, checkpointing.

    Resume: pass a state restored at step k (``load_state``). The loop
    continues from its step counter and fast-forwards ``batches`` past the
    first k elements, so interrupt-at-k and a rerun over the same
    deterministic batch sequence equal an uninterrupted run.

    The fast-forward pulls every skipped batch (host work, and card copies
    if the stream is placed there). A stream that can reposition itself in
    O(1) (``kubeflow_tpu_torch.data.ShardedLoader.skip``) should do so and
    pass ``skip_batches=False``::

        loader.skip(state["step"])
        batches = data.global_batches(data.prefetch(loader), mesh)
        trainer.fit(state, batches, ..., skip_batches=False)

    ``checkpoints`` is any object with ``save(step, tree)`` and
    ``wait()`` (``checkpoint.CheckpointFabric``,
    ``checkpoint.CheckpointManager``): ``save`` every ``save_every`` steps
    with ``checkpoint_tree(state)``, ``wait`` at the end. (The JAX ``fit``
    passes its live pytree; here the live state holds optimizer objects.)

    Telemetry: pass a :class:`kubeflow_tpu_torch.telemetry.StepProfiler`
    as ``profiler`` to record each step's wall time (the first step is
    kept apart as the one that allocates and builds; at every window
    boundary the profiler waits on the loss's card, so queued work drains
    into a measured step), and a
    :class:`kubeflow_tpu_torch.telemetry.TelemetryPublisher` as
    ``publisher`` to export rolling-window summaries (rate-limited in the
    loop, a forced flush at the end). Both are no-ops when
    ``KFTPU_TELEMETRY`` is off.
    """
    start = int(state["step"])
    if start and skip_batches:
        batches = islice(batches, start, None)
    for i in range(start, steps):
        t0 = time.perf_counter() if profiler is not None else 0.0
        state, loss = step_fn(state, next(batches))
        if profiler is not None:
            profiler.observe(i + 1, time.perf_counter() - t0,
                             sync_value=loss)
            if publisher is not None:
                publisher.publish(profiler.summary())
        if on_step is not None:
            on_step(i + 1, float(loss))
        if checkpoints is not None and (i + 1) % save_every == 0:
            checkpoints.save(i + 1, checkpoint_tree(state))
    if checkpoints is not None:
        checkpoints.wait()
    if profiler is not None:
        profiler.note_hbm(loss.device if steps > start else None)
        if publisher is not None:
            publisher.publish(profiler.summary(), force=True)
    return state
