"""Device ms a step of the optimizer's kernels (``trace.optimizer_kernels``:
the trainer's update and clip inside the benchmark's range, or the
burn-in step's SGD after its last dK/dV kernel)."""

from perfbench.trace import optimizer_kernels


def read(run):
    us = sum(k.dur for k in optimizer_kernels(run.trace))
    return us / 1e3 / run.steps if us else None
