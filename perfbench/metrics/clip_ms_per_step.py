"""Device ms a step booked to the program's ``clip`` span
(``perfbench.spans``): the trainer's global-norm clip of the
gradients."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "clip")
