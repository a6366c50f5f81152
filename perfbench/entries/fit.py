"""Entry ``fit``: the notebook user's training loop,
``kubeflow_tpu_torch.models.trainer.fit`` over the trainer's
``make_train_step`` (AdamW or SGD, the global-norm clip, accumulation)
and the burn-in model's loss.

Each call of :meth:`Job.step` runs ``fit`` for one more step on the same
state and the same batch iterator (``skip_batches=False``: the iterator
is already where the state is). The optimizer handed to
``make_train_step`` is the trainer's own, inside a host range
``perfbench.optimizer`` that the trace reads.

A cell with a ``mesh`` runs the sharded path, one rank a card: the
program's mesh of that plan over the ranks' process group
(``parallel.mesh.make_mesh``), the state cut to this rank's shards by
``trainer.shard_state`` under ``trainer.state_sharding_rules`` of the
model's ``burnin.param_sharding_rules``, the loss and the step given the
mesh. Every rank gets the same batch (the data axis is 1).
"""

from __future__ import annotations

from functools import partial

import torch
from torch.profiler import record_function

from kubeflow_tpu_torch.models import burnin, trainer
from kubeflow_tpu_torch.models.tree import leaves
from kubeflow_tpu_torch.parallel.mesh import MeshPlan, cuts, make_mesh, shard

from perfbench.trace import OPTIMIZER_RANGE


class RangedOptimizer:
    """The trainer's optimizer with each update inside a host range."""

    def __init__(self, inner: trainer.Optimizer):
        self.inner = inner

    def update(self, *args, **kwargs):
        with record_function(OPTIMIZER_RANGE):
            return self.inner.update(*args, **kwargs)


class Job:
    def __init__(self, cell, params: dict, feed):
        opt = dict(cell.optimizer)
        inner = trainer.make_optimizer(trainer.TrainerConfig(**opt))
        cfg = burnin.BurninConfig(**cell.model)
        self.beta1 = 0.9 if opt["optimizer"] == "adamw" else None
        self.lr = opt["lr"]
        self.state = trainer.init_state(params, inner)
        self.mesh = rules = None
        if cell.mesh:
            self.mesh = make_mesh(MeshPlan(**cell.mesh),
                                  leaves(params)[0].device.type)
            rules = trainer.state_sharding_rules(
                burnin.param_sharding_rules(cfg), params, inner)
            self.state = trainer.shard_state(self.state, self.mesh, rules)
            self.specs = leaves(rules["params"])
            # Whether each leaf is cut over the mesh, by leaf.
            self.cut = [any(cuts(spec, self.mesh)) for spec in self.specs]
        self.tensors = leaves(self.state["params"])
        self.feed = feed
        self.losses: list = []
        inner_step = trainer.make_train_step(
            partial(burnin.loss_fn, cfg=cfg, mesh=self.mesh),
            RangedOptimizer(inner), accum_steps=cell.accum_steps,
            mesh=self.mesh, rules=rules)

        def recorded(state, batch):
            state, loss = inner_step(state, batch)
            self.losses.append(loss)
            return state, loss

        self.step_fn = recorded

    def step(self) -> None:
        self.state = trainer.fit(self.state, self.feed,
                                 steps=self.state["step"] + 1,
                                 step_fn=self.step_fn, skip_batches=False)

    def block(self, i: int, leaf: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global leaf ``i`` (``leaf`` itself
        without a mesh)."""
        return leaf if self.mesh is None else shard(leaf, self.specs[i],
                                                    self.mesh)

    def first_gradient(self, i: int, initial: torch.Tensor) -> torch.Tensor:
        """After the first step: leaf ``i``'s gradient as the optimizer
        took it, from its state (AdamW's first moment is ``(1 - b1) g``;
        SGD's change from the leaf's ``initial`` weights is ``-lr g``);
        on a mesh, this rank's block of it, ``initial`` this rank's block
        too."""
        p = self.tensors[i]
        if self.beta1 is not None:
            # Moments are zeros before a first update (torch makes them
            # at the first step; optax's init gives zeros).
            state = self.state["opt_state"]["optimizer"].state.get(p, {})
            return state.get("exp_avg", torch.zeros_like(p)) / (1 - self.beta1)
        return (initial - p) / self.lr


def build(cell, params: dict, feed) -> Job:
    return Job(cell, params, feed)
