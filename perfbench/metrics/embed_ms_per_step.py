"""Device ms a step booked to the program's ``embed`` span
(``perfbench.spans``): the embedding gather and the position add, and
their backward."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "embed")
