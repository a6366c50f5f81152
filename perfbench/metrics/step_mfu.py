"""The whole train step's share of the cards' bf16 peak: the step's
analytic matmul operations (``flops.train_step_flops``, the whole job's)
times the traced steps, over their host time ending in a device sync,
over the peak of the card by its name times the cell's cards. Work that
every card repeats (the head of a tensor-parallel cell) is no useful work
here: the share shows it lost."""

from perfbench import flops


def read(run):
    if run.peaks is None or run.wall_s <= 0:
        return None
    work = flops.train_step_flops(run.cell.model, run.cell.batch) * run.steps
    peak = run.cell.chips * run.peaks.bf16_flops
    return 100.0 * work / run.wall_s / peak
