"""Device ms a step booked to the program's ``accumulate`` span
(``perfbench.spans``): each microbatch's gradients scaled and summed,
and its loss."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "accumulate")
