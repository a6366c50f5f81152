"""Readings of the correctness check at a cell's own size, for setting
its limits: the program's, the control's and the faults' gaps to the
reference, several seeds in one process.

    python3 -m perfbench.control --workload <cell> --arm <arm> --seeds 1,2,3

Arms:

- ``program``: the cell's job, as a run drives it;
- ``control``: the reference put in the program's place with every
  product in float8 e4m3 (the precision below the configurations' bf16);
- ``half_batch``: the program fed half of each batch (the mean taken over
  the rest);
- ``frozen``: a step that returns the state unchanged (the program's
  loss on the batch, no update).

Each seed prints one JSON line: the arm, the seed, the gaps, whether the
run's own comparison (``harness.checks`` against the cell's committed
limits) would call it correct, and the seconds it took. The benchmark's
runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from kubeflow_tpu_torch.models import burnin

from perfbench import cells, harness
from perfbench.reference import gpt

ARMS = ("program", "control", "half_batch", "frozen")


def _halved(batches):
    for batch in batches:
        yield tuple(t[: len(t) // 2] for t in batch)


def _frozen(job, cell, feed):
    """A step of ``job`` that leaves its state unchanged: the loss of the
    weights as they are on the next batch."""
    cfg = burnin.BurninConfig(**cell.model)
    params = job.state["params"] if hasattr(job, "state") else job.params

    def step():
        with torch.no_grad():
            job.losses.append(burnin.loss_fn(params, next(feed), cfg))
    return step


def readings(cell: cells.Cell, seed: int, arm: str, device) -> dict:
    """(the arm's readings, the reference's) for one seed."""
    device = torch.device(device)
    if arm == "control":
        rows, feed, job = harness.build(cell, seed, device)
        feed.close()
        del job, feed
        prog = harness.reference_readings(cell, rows, seed, device,
                                          matmul=gpt.fp8_matmul)
    else:
        rows, feed, job = harness.build(cell, seed, device)
        if arm == "half_batch":
            if cell.batch < 2:
                raise ValueError(f"{cell.name}: a batch of {cell.batch} has "
                                 f"no half to leave out")
            feed.batches = _halved(feed.batches)
        elif arm == "frozen":
            job.step = _frozen(job, cell, feed)
        prog = harness.program_readings(job, cell, seed, device)
        feed.close()
        del job, feed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return prog, harness.reference_readings(cell, rows, seed, device)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="perfbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--arm", choices=ARMS, required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("perfbench.control: no CUDA card", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        prog, ref = readings(cell, seed, args.arm, "cuda:0")
        check = harness.checks(prog, ref, cell.limits)
        print(json.dumps({"workload": cell.name, "arm": args.arm,
                          "seed": seed, "gaps": harness.gaps(prog, ref),
                          "correct": harness.passed(check),
                          "limits": cell.limits,
                          "losses": prog["losses"],
                          "ref_losses": ref["losses"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
