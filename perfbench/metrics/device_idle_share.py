"""The share of the traced stretch's host time in which no operation ran
on the device: 1 - the union of the kernels', copies' and sets'
intervals over the stretch."""


def read(run):
    if run.wall_s <= 0 or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / 1e6 / run.wall_s)
