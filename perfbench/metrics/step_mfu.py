"""The whole train step's share of the card's bf16 peak: the step's
analytic matmul operations (``flops.train_step_flops``) times the traced
steps, over their host time ending in a device sync, over the peak of
the card by its name."""

from perfbench import flops


def read(run):
    if run.peaks is None or run.wall_s <= 0:
        return None
    work = flops.train_step_flops(run.cell.model, run.cell.batch) * run.steps
    return 100.0 * work / run.wall_s / run.peaks.bf16_flops
