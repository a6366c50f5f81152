"""Device ms a step of the collectives between the cards: NCCL's kernels
in rank 0's trace (the model axis's sums after each row-parallel
product, forward and backward; the replicated leaves' gradient sums; the
clip's and the loss's sums). Silent where no NCCL kernel ran."""

from perfbench.trace import is_collective


def read(run):
    us = sum(k.dur for k in run.trace.kernels if is_collective(k.name))
    return us / 1e3 / run.steps if us else None
