"""Device ms a step booked to the program's ``attention_layer`` spans'
own time (``perfbench.spans``), forward and backward: the qkv and out
GEMMs, the weight casts, the flash (or dense) attention, the model-axis
sum and the residual add; the layer's norm is ``norm``'s."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "attention_layer")
