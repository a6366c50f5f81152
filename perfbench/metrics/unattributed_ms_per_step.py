"""Device ms a step that no finer span of the program holds
(``perfbench.spans``): booked to ``train_step``'s own time or to no
``kftpu.*`` range at all. Silent where the trace has no ``train_step``
span (a program without spans)."""

from perfbench.spans import book


def read(run):
    b = book(run.trace)
    if "train_step" not in b.names:
        return None
    us = b.device_us.get("train_step", 0.0) + b.device_us.get(None, 0.0)
    return us / 1e3 / run.steps
