"""Device ms a step booked to the program's ``mlp_layer`` spans' own time
(``perfbench.spans``), forward and backward: the two GEMMs, the weight
casts, GELU, the model-axis sum and the residual add; the layer's norm
is ``norm``'s."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "mlp_layer")
