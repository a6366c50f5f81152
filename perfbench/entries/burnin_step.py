"""Entry ``burnin_step``: the slice burn-in's train step,
``kubeflow_tpu_torch.models.burnin.make_train_step`` (the burn-in loss,
its gradient and an SGD update ``p - lr g`` on every leaf, in place),
called once a step on the next batch of the feed."""

from __future__ import annotations

import torch

from kubeflow_tpu_torch.models import burnin
from kubeflow_tpu_torch.models.tree import leaves


class Job:
    def __init__(self, cell, params: dict, feed):
        opt = cell.optimizer
        if opt["optimizer"] != "sgd":
            raise ValueError("the burn-in step updates by SGD alone")
        self.lr = opt["lr"]
        self.params = params
        self.tensors = leaves(params)
        self.feed = feed
        self.losses: list = []
        self.inner = burnin.make_train_step(burnin.BurninConfig(**cell.model),
                                            lr=self.lr)

    def step(self) -> None:
        self.params, loss = self.inner(self.params, next(self.feed))
        self.losses.append(loss)

    def first_gradient(self, i: int, initial: torch.Tensor) -> torch.Tensor:
        """After the first step: leaf ``i``'s gradient, from its change
        ``-lr g`` since its ``initial`` weights."""
        return (initial - self.tensors[i]) / self.lr


def build(cell, params: dict, feed) -> Job:
    return Job(cell, params, feed)
