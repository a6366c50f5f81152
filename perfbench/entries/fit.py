"""Entry ``fit``: the notebook user's training loop,
``kubeflow_tpu_torch.models.trainer.fit`` over the trainer's
``make_train_step`` (AdamW or SGD, the global-norm clip, accumulation)
and the burn-in model's loss.

Each call of :meth:`Job.step` runs ``fit`` for one more step on the same
state and the same batch iterator (``skip_batches=False``: the iterator
is already where the state is). The optimizer handed to
``make_train_step`` is the trainer's own, inside a host range
``perfbench.optimizer`` that the trace reads.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.profiler import record_function

from kubeflow_tpu_torch.models import burnin, trainer
from kubeflow_tpu_torch.models.tree import leaves

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
        self.beta1 = 0.9 if opt["optimizer"] == "adamw" else None
        self.lr = opt["lr"]
        self.state = trainer.init_state(params, inner)
        self.tensors = leaves(params)
        self.feed = feed
        self.losses: list = []
        inner_step = trainer.make_train_step(
            partial(burnin.loss_fn, cfg=burnin.BurninConfig(**cell.model)),
            RangedOptimizer(inner), accum_steps=cell.accum_steps)

        def recorded(state, batch):
            state, loss = inner_step(state, batch)
            self.losses.append(loss)
            return state, loss

        self.step_fn = recorded

    def step(self) -> None:
        self.state = trainer.fit(self.state, self.feed,
                                 steps=self.state["step"] + 1,
                                 step_fn=self.step_fn, skip_batches=False)

    def first_gradient(self, i: int, initial: torch.Tensor) -> torch.Tensor:
        """After the first step: leaf ``i``'s gradient as the optimizer
        took it, from its state (AdamW's first moment is ``(1 - b1) g``;
        SGD's change from the leaf's ``initial`` weights is ``-lr g``)."""
        p = self.tensors[i]
        if self.beta1 is not None:
            # Moments are zeros before a first update (torch makes them
            # at the first step; optax's init gives zeros).
            state = self.state["opt_state"]["optimizer"].state.get(p, {})
            return state.get("exp_avg", torch.zeros_like(p)) / (1 - self.beta1)
        return (initial - p) / self.lr


def build(cell, params: dict, feed) -> Job:
    return Job(cell, params, feed)
