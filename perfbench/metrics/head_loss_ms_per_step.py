"""Device ms a step booked to the program's ``head`` and ``loss`` spans
(``perfbench.spans``), forward and backward: the tied head's product and
its f32 cast, and the cross entropy over the f32 logits."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "head", "loss")
