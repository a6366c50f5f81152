"""Device-idle ms a step while the step thread's innermost span is the
program's ``data_wait`` or ``data_stage`` (``perfbench.spans``): the
input pipeline's queue wait and pinned copy, as the card waits them
out."""

from perfbench.spans import idle_ms


def read(run):
    return idle_ms(run, "data_wait", "data_stage")
