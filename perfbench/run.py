"""The port's benchmark: one run of one cell.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as one JSON object, the
last line of standard output, and each compared number beside its limit
as the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA cards or when a forbidden module (JAX or the JAX
package) was loaded.

A cell of one card runs in this process on ``cuda:0``. A cell of N > 1
cards runs in N rank processes, one a card (``perfbench.launch``), which
this process supervises without touching a card: rank 0 prints the
result, once every other rank has ended with 0; a rank that fails or
passes the deadline ends the run with a non-zero exit and no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def report(result: dict) -> int:
    """Print ``result`` unless a forbidden module is loaded in this
    process: each compared number beside its limit on standard error,
    then the result line on standard output."""
    from perfbench import harness

    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def rank_run(ranks, cell, seed: int, seconds: float, trace: bool,
             started: float) -> int:
    """One rank of a run over several cards; rank 0 reports."""
    from perfbench import harness

    result = harness.run(cell, seed, seconds, trace, ranks.device, started,
                         ranks)
    if result is None:
        found = harness.forbidden_modules()
        if found:
            print(f"perfbench: rank {ranks.rank}: forbidden modules "
                  f"loaded: {found}", file=sys.stderr)
            return 3
        return 0
    return report(result)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="perfbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import cells

    cell = cells.load_cell(args.workload)
    if cell.chips > 1:
        from perfbench import launch

        return launch.spawn(rank_run, cell.chips,
                            (cell, args.seed, args.seconds, bool(args.trace),
                             STARTED), STARTED)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", STARTED)
    return report(result)


if __name__ == "__main__":
    sys.exit(main())
