"""Time builds of the port's attention kernels against one another on one
card, in turns.

The builds: this checkout's ``csrc/`` sources (label ``this``) and, with
``--build LABEL=DIR``, the same sources from another checkout (for example
an older commit unpacked with ``git archive``), which must keep the C
interfaces: every wide entry point, ``kftpu_wide_bwd_dq`` included, takes
the caller's plan (width, then slices), so a build older than the wgmma
dQ's cannot be loaded beside this one. ``--simple-dq`` adds the label
``this_simple_dq`` instead: the wide cases' dQ of this build through the
simple kernel's plan ``(0, slices)``, timed in turns with the wgmma dQ.
Each build runs through the wrappers' own launch code. The
cases: the forward at the serving decode shape and at the long-context
length, the ring hop's partial at both (the one-card hop at the longer),
and the backward's dQ and dK/dV kernels at the train step's shape (dQ
computing delta) and at the long-context one-card hop (delta given, as
the ring's backward calls them); and the wide library's forward, partial,
dQ and dK/dV at the train shape with 256-column heads (``*_d256``), the
backward also at the wide_heads step's 8 heads (``bwd_wide_heads``).

Run from the root of a checkout, on a machine with one card::

    python -m kubeflow_tpu_torch.ops.compare [--build LABEL=DIR ...] \
        [--simple-dq] [--cases NAME,...] [--rounds N] [--out FILE]

The first line names the card and, per build, ptxas's registers, spills
and performance notes (C75xx) for each bf16 kernel and the wgmma (HGMMA),
TMA load (UTMALDG) and mma.sync (HMMA) instructions of each kernel in
the libraries' SASS. Every case prints one JSON line: per kernel and
build the median ms over rounds run in turns (A B C C B A ...), the
largest difference of the build's outputs from the first build's, and
one PyTorch call's time on the same inputs as the yardstick (SDPA's
causal forward, or its backward for dq, dk and dv together).
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import torch

from kubeflow_tpu_torch.ops import _build
from kubeflow_tpu_torch.ops import flash_attention as fa

CASES = (
    # name, kernel, [b, s, h, d], (q_offset, k_offset) or None: the causal
    # forward, or the backward computing delta
    ("fwd_decode", "fwd", (8, 1024, 16, 128), None),
    ("fwd_8192", "fwd", (1, 8192, 16, 128), None),
    ("partial_decode", "partial", (8, 1024, 16, 128), (0, 0)),
    ("partial_8192", "partial", (1, 8192, 16, 128), (0, 0)),
    ("bwd_train", "bwd", (8, 1024, 16, 128), None),
    ("bwd_8192_hop", "bwd", (1, 8192, 16, 128), (0, 0)),
    ("fwd_d256", "fwd", (8, 1024, 16, 256), None),
    ("partial_d256", "partial", (8, 1024, 16, 256), (0, 0)),
    ("bwd_d256", "bwd", (8, 1024, 16, 256), None),
    ("bwd_wide_heads", "bwd", (8, 1024, 8, 256), None),
)
SIMPLE_DQ = "this_simple_dq"


def time_ms(fn, *, warmup=5, runs=30, batch=10) -> float:
    """Device time of one call of ``fn``: the median over ``runs`` of
    ``batch`` calls enqueued back to back between two CUDA events,
    divided by ``batch``, after ``warmup`` calls. Back to back, the host
    enqueues the next call while the card runs this one, so the
    wrapper's host time stays out of the reading while the card is the
    slower of the two."""
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


def ptxas_notes(log: str) -> list[str]:
    """Each bf16 kernel's register and spill lines and ptxas's performance
    notes (C75xx) from one nvcc log."""
    notes, kernel = [], None
    for line in log.splitlines():
        found = re.search(r"([a-z_]+_bf16_kernel)ILi(\d+)E", line)
        if "entry function" in line:
            kernel = f"{found[1]}<{found[2]}>" if found else None
        elif kernel and ("spill" in line or "registers" in line):
            notes.append(f"{kernel}: {line.strip()}")
        if "C75" in line:
            notes.append(line.strip())
    return notes


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")


def sass_counts(library, by_kernel: bool = False) -> dict | str:
    """How many wgmma (HGMMA), TMA load (UTMALDG) and mma.sync (HMMA)
    instructions the library's SASS holds, by ``cuobjdump``: in all, or
    per kernel (its mangled name) with ``by_kernel``; "not measured"
    where the toolkit has none."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).is_file():
        return "not measured"
    return count_sass(subprocess.run(
        [tool, "-sass", str(library)], capture_output=True, text=True,
        check=True, timeout=300).stdout, by_kernel)


def count_sass(sass: str, by_kernel: bool = False) -> dict:
    """:func:`sass_counts` of ``cuobjdump -sass``'s text."""
    ops, kernel = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            kernel = line.split("Function :", 1)[1].strip()
            continue
        words = [w for w in line.split()[1:] if not w.startswith("@")]
        if line.strip().startswith("/*") and words:
            # the opcode, predicate aside
            ops.setdefault(kernel, []).append(words[0].split(".")[0])
    if by_kernel:
        return {name: {op: found.count(op) for op in SASS_OPS}
                for name, found in ops.items()
                if any(op in found for op in SASS_OPS)}
    every = [op for found in ops.values() for op in found]
    return {op: every.count(op) for op in SASS_OPS}


def builds(others: dict) -> dict:
    """Label -> ({"fwd": library, "bwd": library, "wide": library},
    ptxas notes), compiled together; ``others`` maps labels to other
    checkouts' roots."""
    dirs = {label: Path(root) / "kubeflow_tpu_torch" / "ops" / "csrc"
            for label, root in others.items()}
    dirs["this"] = _build.CSRC
    sources = {"fwd": fa.SOURCE, "bwd": fa.BWD_SOURCE,
               "wide": fa.WIDE_SOURCE}
    _build.build([(src, d) for d in dirs.values() for src in sources.values()])

    def log(src, d):
        return _build.BUILD_LOG.get(src if d == _build.CSRC else str(d / src),
                                    "")

    return {label: ({key: _build.load(src, d) for key, src in sources.items()},
                    [n for src in sources.values() for n in ptxas_notes(
                        log(src, d))])
            for label, d in dirs.items()}


def _kernel_calls(kernel, shape, offsets, libs, simple_dq=False):
    """Inputs for one case and, per kernel timed, the call of each build
    and SDPA's call on the same inputs. Heads above 128 columns run each
    build's wide library; with ``simple_dq`` their dQ also runs this
    build's simple kernel (label ``SIMPLE_DQ``)."""
    import torch.nn.functional as F

    wide = shape[-1] > fa.TILE_MAX_HEAD_DIM
    libs = {label: {"fwd": lib["wide" if wide else "fwd"],
                    "bwd": lib["wide" if wide else "bwd"]}
            for label, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(97)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = shape[-1] ** -0.5
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    if kernel == "fwd":
        return ({"fwd": {label: (lambda lib=lib["fwd"]: fa._launch(
                    q, k, v, True, scale, lib=lib))
                         for label, lib in libs.items()}},
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    if kernel == "partial":
        return ({"partial": {label: (lambda lib=lib["fwd"]: fa._launch_partial(
                    q, k, v, *offsets, scale, lib=lib))
                             for label, lib in libs.items()}},
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    o, lse = fa._launch(q, k, v, True, scale)
    delta = fa.attention_delta(o, do)
    q_off, k_off = offsets or (0, 0)
    # A hop is handed delta; the train step's dQ launch computes it.
    given, o_in = (delta, None) if offsets else (None, o)
    ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    dq = {label: (lambda lib=lib["bwd"]: fa._launch_dq(
        q, k, v, o_in, lse, do, given, True, scale, q_off, k_off, lib=lib))
        for label, lib in libs.items()}
    if wide and simple_dq:
        simple = (0, -(-shape[-1] // fa.WIDE_SLICE_COLS))
        dq[SIMPLE_DQ] = lambda: fa._launch_dq(
            q, k, v, o_in, lse, do, given, True, scale, q_off, k_off,
            lib=libs["this"]["bwd"], plan=simple)
    return ({"dq": dq,
             "dkv": {label: (lambda lib=lib["bwd"]: fa._launch_dkv(
                 q, k, v, lse, do, delta, True, scale, q_off, k_off,
                 lib=lib)) for label, lib in libs.items()}},
            lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                        retain_graph=True))


def run_case(name, kernel, shape, offsets, libs, rounds: int,
             simple_dq: bool = False) -> dict:
    calls, library = _kernel_calls(kernel, shape, offsets, libs, simple_dq)
    row = {"case": name, "shape": list(shape), "offsets": offsets,
           "ms": {}, "ms_rounds": {}, "max_diff_vs_first": {}}
    for key, by_build in calls.items():
        outs = {label: call() for label, call in by_build.items()}
        torch.cuda.synchronize()
        first = next(iter(outs.values()))
        row["max_diff_vs_first"][key] = {
            label: max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(out, first))
            for label, out in outs.items()}
        times = {label: [] for label in by_build}
        order = list(by_build)
        for r in range(rounds):
            for label in (order if r % 2 == 0 else order[::-1]):
                times[label].append(time_ms(by_build[label], warmup=3,
                                            runs=10))
        row["ms"][key] = {label: statistics.median(t)
                          for label, t in times.items()}
        row["ms_rounds"][key] = times
    row["library_ms"] = time_ms(library, warmup=3, runs=10)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", action="append", default=[],
                    metavar="LABEL=DIR",
                    help="another checkout whose kernel sources are timed "
                         "beside this one's (repeatable)")
    ap.add_argument("--simple-dq", action="store_true",
                    help=f"also time the wide cases' dQ of this build on "
                         f"the simple kernel (label {SIMPLE_DQ})")
    ap.add_argument("--cases", default=None,
                    help="comma-separated case names (default: all of "
                         + ", ".join(c[0] for c in CASES) + ")")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare: no CUDA device", file=sys.stderr)
        return 1
    wanted = None if args.cases is None else set(args.cases.split(","))
    cases = [c for c in CASES if wanted is None or c[0] in wanted]
    if not cases:
        print(f"compare: no case named {args.cases}", file=sys.stderr)
        return 2
    built = builds(dict(item.split("=", 1) for item in args.build))
    libs = {label: lib for label, (lib, _) in built.items()}
    lines = [{"card": torch.cuda.get_device_name(0), "builds": list(libs),
              "ptxas": {label: notes for label, (_, notes) in built.items()},
              "sass": {label: {key: sass_counts(lib._name, by_kernel=True)
                               for key, lib in lib_set.items()}
                       for label, lib_set in libs.items()}}]
    print(json.dumps(lines[0]), flush=True)
    for case in cases:
        lines.append(run_case(*case, libs, args.rounds, args.simple_dq))
        print(json.dumps(lines[-1]), flush=True)
        torch.cuda.empty_cache()
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
