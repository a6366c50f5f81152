"""Time builds of the flash forward's CUDA source against one another on
one card, in turns.

The builds: this checkout's ``csrc/flash_attention_fwd.cu`` (label
``this``) and, with ``--build LABEL=DIR``, the same file from another
checkout (for example an older commit unpacked with ``git archive``),
which must keep the C interface. Each build runs through the wrapper's
own launch code. The cases are the forward at the serving decode shape
and at the long-context length, and the ring hop's partial at both (the
one-card hop at the longer).

Run from the root of a checkout, on a machine with one card::

    python -m kubeflow_tpu_torch.ops.compare_fwd [--build LABEL=DIR ...] \
        [--out FILE]

Every case prints one JSON line: per build the median ms over rounds run
in turns (A B C C B A ...), its largest difference from the first build's
output, and SDPA's time on the same inputs as the yardstick.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa

CASES = (
    # name, [b, s, h, d], partial offsets (None: the causal forward)
    ("fwd_decode", (8, 1024, 16, 128), None),
    ("fwd_8192", (1, 8192, 16, 128), None),
    ("partial_decode", (8, 1024, 16, 128), (0, 0)),
    ("partial_8192", (1, 8192, 16, 128), (0, 0)),
)


def _time_ms(fn, warmup=3, runs=10, batch=10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / batch)
    return statistics.median(times)


def builds(others: dict) -> dict:
    """Label -> (loaded library, nvcc's output), compiled together;
    ``others`` maps labels to other checkouts' roots."""
    items = {label: (fa.SOURCE,
                     Path(root) / "kubeflow_tpu_torch" / "ops" / "csrc")
             for label, root in others.items()}
    items["this"] = (fa.SOURCE, _build.CSRC)
    _build.build(list(items.values()))
    return {label: (_build.load(*item),
                    _build.BUILD_LOG.get(
                        fa.SOURCE if item[1] == _build.CSRC
                        else str(item[1] / fa.SOURCE), ""))
            for label, item in items.items()}


def run_case(name, shape, offsets, libs, rounds: int) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(97)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    scale = shape[-1] ** -0.5

    def call(lib):
        if offsets is None:
            return fa._launch(q, k, v, True, scale, lib=lib)
        return fa._launch_partial(q, k, v, *offsets, scale, lib=lib)

    outs = {label: call(lib) for label, lib in libs.items()}
    torch.cuda.synchronize()
    first = next(iter(outs.values()))
    diff = {label: max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(out, first))
            for label, out in outs.items()}
    times = {label: [] for label in libs}
    order = list(libs)
    for r in range(rounds):
        for label in (order if r % 2 == 0 else order[::-1]):
            times[label].append(_time_ms(lambda: call(libs[label])))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    return {"case": name, "shape": list(shape), "offsets": offsets,
            "ms": {label: statistics.median(t) for label, t in times.items()},
            "ms_rounds": times, "max_diff_vs_first": diff,
            "sdpa_ms": sdpa}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="another checkout whose forward source is timed "
                         "beside this one's (repeatable)")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_fwd: no CUDA device", file=sys.stderr)
        return 1
    built = builds(dict(item.split("=", 1) for item in args.build))
    libs = {label: lib for label, (lib, _) in built.items()}
    # ptxas's spill counts and performance notes (C75xx) of each build.
    notes = {label: [line.strip() for line in log.splitlines()
                     if "spill" in line or "C75" in line]
             for label, (_, log) in built.items()}
    lines = [{"card": torch.cuda.get_device_name(0),
              "builds": list(libs), "ptxas": notes}]
    print(json.dumps(lines[0]), flush=True)
    for name, shape, offsets in CASES:
        lines.append(run_case(name, shape, offsets, libs, args.rounds))
        print(json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
