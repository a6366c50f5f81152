"""Device ms a step booked to the program's ``update`` span's own time
(``perfbench.spans``): AdamW or SGD, the clip inside it left out (it is
``clip``'s)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "update")
