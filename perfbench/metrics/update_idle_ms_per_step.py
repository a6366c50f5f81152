"""Device-idle ms a step while the step thread's innermost span is the
program's ``update`` or ``clip`` (``perfbench.spans``): the host's time
in the optimizer that the card waits out."""

from perfbench.spans import idle_ms


def read(run):
    return idle_ms(run, "update", "clip")
