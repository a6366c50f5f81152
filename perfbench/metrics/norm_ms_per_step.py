"""Device ms a step booked to the program's ``norm`` spans
(``perfbench.spans``): every RMSNorm, forward and backward, the ones
inside the attention and MLP layers included."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "norm")
