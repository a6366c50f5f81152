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
  loss on the batch, no update);
- ``no_exchange`` (a cell of several cards): the gradients' exchange
  between the cards left out (``trainer.reduce_grads`` a no-op), so each
  replicated leaf keeps its rank's share.

Each seed prints one JSON line: the arm, the seed, the gaps, whether the
run's own comparison (``harness.checks`` against the cell's committed
limits) would call it correct, and the seconds it took. The benchmark's
runs do not run this. A cell of several cards drives the program arms
over one rank a card (``perfbench.launch``), and the control's reference
over the cell's cards in this process.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from datetime import timedelta

import torch
import torch.distributed as dist

from kubeflow_tpu_torch.models import burnin, trainer

from perfbench import cells, harness, launch
from perfbench.reference import gpt

ARMS = ("program", "control", "half_batch", "frozen", "no_exchange")


def _halved(batches):
    for batch in batches:
        yield tuple(t[: len(t) // 2] for t in batch)


def _frozen(job, cell, feed):
    """A step of ``job`` that leaves its state unchanged: the loss of the
    weights as they are on the next batch (on a mesh, the ranks' shares
    summed)."""
    cfg = burnin.BurninConfig(**cell.model)
    params = job.state["params"] if hasattr(job, "state") else job.params
    mesh = getattr(job, "mesh", None)

    def step():
        with torch.no_grad():
            loss = burnin.loss_fn(params, next(feed), cfg, mesh)
            if mesh is not None:
                dist.all_reduce(loss)
            job.losses.append(loss)
    return step


def _no_exchange(grads, groups):
    """``reduce_grads`` with the exchange left out."""


def readings(cell: cells.Cell, seed: int, arm: str, device,
             ranks=None) -> tuple | None:
    """(the arm's readings, the reference's) for one seed. Over ``ranks``
    (a cell of several cards; not for the ``control`` arm, which runs the
    reference alone over the cell's cards) every rank drives its share of
    the program; rank 0 gets the pair, once the others have freed their
    state, and the others None."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    devices = [torch.device("cuda", i) for i in range(cell.chips)] \
        if cuda and cell.chips > 1 else None
    if arm == "control":
        rows = harness.token_rows(cell, seed)
        prog = harness.reference_readings(cell, rows, seed, device,
                                          matmul=gpt.fp8_matmul,
                                          devices=devices)
    else:
        exchange = trainer.reduce_grads
        if arm == "no_exchange":
            trainer.reduce_grads = _no_exchange
        rows, feed, job = harness.build(cell, seed, device)
        if arm == "half_batch":
            if cell.batch < 2:
                raise ValueError(f"{cell.name}: a batch of {cell.batch} has "
                                 f"no half to leave out")
            feed.batches = _halved(feed.batches)
        elif arm == "frozen":
            job.step = _frozen(job, cell, feed)
        prog = harness.program_readings(job, cell, seed, device, ranks)
        trainer.reduce_grads = exchange
        feed.close()
        del job, feed
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if ranks is not None:
        # The others wait on the store, off the cards, while rank 0 runs
        # the reference over them.
        key = f"reference-{seed}"
        if ranks.rank:
            ranks.store.wait([key], timedelta(seconds=1200))
            return None
        ref = harness.reference_readings(cell, rows, seed, device,
                                         devices=ranks.devices)
        # Hand the other cards back before their ranks' next seed.
        gc.collect()
        for d in ranks.devices if cuda else ():
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        ranks.store.set(key, "done")
        return prog, ref
    return prog, harness.reference_readings(cell, rows, seed, device,
                                            devices=devices)


def _line(cell, arm: str, seed: int, prog: dict, ref: dict,
          seconds: float) -> str:
    check = harness.checks(prog, ref, cell.limits)
    return json.dumps({"workload": cell.name, "arm": arm, "seed": seed,
                       "gaps": harness.gaps(prog, ref),
                       "correct": harness.passed(check),
                       "limits": cell.limits, "losses": prog["losses"],
                       "ref_losses": ref["losses"], "seconds": seconds})


def rank_readings(ranks, cell, arm: str, seeds: list) -> int:
    """One rank's share of the readings of a cell of several cards; rank
    0 prints a line a seed."""
    for seed in seeds:
        t0 = time.perf_counter()
        pair = readings(cell, seed, arm, ranks.device, ranks)
        if pair is not None:
            print(_line(cell, arm, seed, *pair, time.perf_counter() - t0),
                  flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="perfbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--arm", choices=ARMS, required=True)
    parser.add_argument("--seeds", required=True)
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench.control: {cell.name} needs {cell.chips} CUDA "
              f"card(s)", file=sys.stderr)
        return 2
    if cell.chips > 1 and args.arm != "control":
        # Several seeds in one call: the deadline allows ten minutes a seed.
        return launch.spawn(rank_readings, cell.chips,
                            (cell, args.arm, seeds), time.perf_counter(),
                            deadline_s=600.0 * len(seeds))
    for seed in seeds:
        t0 = time.perf_counter()
        prog, ref = readings(cell, seed, args.arm, "cuda:0")
        print(_line(cell, args.arm, seed, prog, ref,
                    time.perf_counter() - t0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
