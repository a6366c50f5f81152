"""One run of a cell: set-up, the measured window, the traced stretch and
the check against the plain reference.

Set-up makes the weights on the device and the token rows on the host
from the seed, builds the cell's job (one object: the program's train
step with its model and optimizer state) and drives it through its first
checked steps (the cell's ``checked_steps``, 3 unless the reference's
time asks for fewer) through the window's own call and feed. Those
steps are the warm-up (every kernel the window runs is built and every
shape is seen) and are the steps the reference follows: their losses,
the first gradient as the optimizer took it and each leaf's change over
them are read before the window goes on from there.

The window runs steps back to back for the given seconds, the host one
step ahead of the device, and ends in a device sync: every step in it
counts, over all of its time. With a trace, a stretch of steps inside the
window runs under ``torch.profiler`` (after one step with the profiler
warm) and the per-layer metrics are read from it.

After the window, the program's state is freed and the reference runs the
same first steps from the same weights and rows in f32; the readings are
compared leaf by leaf against the cell's limits.

A cell of more than one card runs here once a rank (``perfbench.launch``),
each on its own card, every rank building the same job from the same seed
and taking the same batches. The readings are the global leaves': a leaf
cut over the mesh reads the square root of the sum over the ranks of its
blocks' squared norms, a whole leaf rank 0's norm. The window ends at a
step that rank 0 fixes by its clock (``Ranks.step_due``); each rank traces
the same stretch, and rank 0's trace gives the per-layer metrics. The
memory peak is the largest rank's. After the window every rank frees its
state and all but rank 0 end; rank 0 then runs the reference over all the
cell's cards, layer by layer (:func:`placement`), and reports.
"""

from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import torch
from torch.profiler import record_function

from kubeflow_tpu_torch import data
from kubeflow_tpu_torch.ops import _build, flash_attention

from perfbench import cells, flops, inputs
from perfbench.reference import gpt, order
from perfbench.trace import INPUT_RANGE, STEP_RANGE, Trace

# Top-level module names no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeflow_tpu")
# Leaves whose reference gradient is under this share of the median
# leaf's are left out of the change comparison: they move by round-off.
UNMOVED_SHARE = 1e-3
# Steps in the traced stretch of a ``--trace 1`` run, in every cell.
TRACE_STEPS = 3


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: this
    process's), compared whole: ``kubeflow_tpu_torch`` is not
    ``kubeflow_tpu``."""
    names = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


class Feed:
    """The program's input pipeline over the cell's token rows (the
    loader, its prefetch thread, the placement on the device), each pull
    timed on the host clock inside the host range ``perfbench.input``."""

    def __init__(self, batch: int, rows, seed: int, device):
        loader = data.ShardedLoader(data.ArraySource(rows), batch, seed=seed,
                                    process_id=0, num_processes=1)
        self.prefetcher = data.prefetch(loader)
        self.batches = data.global_batches(self.prefetcher, device=device)
        self.wait_s = 0.0
        self.pulls = 0

    def __iter__(self):
        return self

    def __next__(self):
        with record_function(INPUT_RANGE):
            t0 = time.perf_counter()
            (batch,) = next(self.batches)
            self.wait_s += time.perf_counter() - t0
        self.pulls += 1
        return batch

    def close(self) -> None:
        self.prefetcher.close()


def log(started: float, what: str) -> None:
    """A progress line on standard error, with the run's seconds."""
    print(f"perfbench: {time.perf_counter() - started:9.3f} s  {what}",
          file=sys.stderr, flush=True)


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def _whole(i: int, leaf: torch.Tensor) -> torch.Tensor:
    return leaf


def global_norms(norms: dict, cut: dict, ranks) -> dict:
    """The global leaves' norms from each rank's norms of its blocks: a
    leaf ``cut`` over the mesh, the square root of the sum over the ranks
    of its blocks' squared norms; a whole leaf, rank 0's."""
    names = list(norms)
    squares = ranks.sum([norms[n] ** 2 if cut[n] else 0.0 for n in names])
    return {n: math.sqrt(sq) if cut[n] else norms[n]
            for n, sq in zip(names, squares)}


def program_readings(job, cell, seed: int, device, ranks=None) -> dict:
    """Run the job's first steps and read them: the losses, the first
    gradient's norms and the norms of each leaf's change, by leaf name.
    The starting weights are drawn again a group at a time. A job on a
    mesh reads its blocks (``job.block``) and, over ``ranks``, the global
    leaves' norms (:func:`global_norms`)."""
    model, steps = cell.model, cell.checked_steps
    index = {name: i for i, name in enumerate(inputs.leaf_names(model))}
    block = getattr(job, "block", _whole)
    job.step()
    grads, change = {}, {}
    for g in range(inputs.n_groups(model)):
        for name, w in inputs.make_group(model, seed, g, device).items():
            i = index[name]
            grads[name] = _norm(job.first_gradient(i, block(i, w)))
    for _ in range(steps - 1):
        job.step()
    for g in range(inputs.n_groups(model)):
        for name, w in inputs.make_group(model, seed, g, device).items():
            i = index[name]
            change[name] = _norm(job.tensors[i] - block(i, w))
    if ranks is not None:
        cut = {name: job.cut[i] for name, i in index.items()}
        grads = global_norms(grads, cut, ranks)
        change = global_norms(change, cut, ranks)
    return {"losses": [float(v) for v in job.losses[:steps]],
            "grad_norms": grads, "change_norms": change}


def placement(n_layers: int, devices: list) -> list:
    """The reference's device of each weight group: the embeddings, the
    final norm and so the head on the first; layer ``i`` on device
    ``i * len(devices) // n_layers``. One device holds everything."""
    return [devices[0]] + [devices[i * len(devices) // n_layers]
                           for i in range(n_layers)]


def reference_readings(cell, rows, seed: int, device,
                       matmul=gpt.plain_matmul, devices=None) -> dict:
    """The plain reference's readings of the same first steps, from the
    same weights and the rows the loader hands out first. ``devices``
    (default: ``device`` alone) hold its weight groups by
    :func:`placement`; activations move between them as tensors."""
    model = cell.model
    batches = order.first_batches(rows, cell.batch, seed,
                                 cell.checked_steps)
    where = placement(model["n_layers"], devices or [device])
    with gpt.f32_exact():
        weights = {}
        for g in range(inputs.n_groups(model)):
            weights.update(inputs.make_group(model, seed, g, where[g]))
        tokens = [torch.from_numpy(b).to(where[0]) for b in batches]
        return gpt.train(weights, tokens, model, cell.optimizer, matmul)


def gaps(prog: dict, ref: dict) -> dict:
    """The compared numbers: the worst step's loss gap over the
    reference's loss; the worst leaf's gap between the first gradient's
    norms, and between the changes' norms, each over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    loss = max(abs(p - r) / abs(r)
               for p, r in zip(prog["losses"], ref["losses"]))
    ref_grads = ref["grad_norms"]
    median = statistics.median(ref_grads.values())
    grad = max(abs(prog["grad_norms"][n] - r) / max(r, median)
               for n, r in ref_grads.items())
    moved = {n: ref["change_norms"][n] for n, r in ref_grads.items()
             if r >= UNMOVED_SHARE * median}
    median_change = statistics.median(moved.values())
    change = max(abs(prog["change_norms"][n] - r) / max(r, median_change)
                 for n, r in moved.items())
    return {"loss": loss, "grad": grad, "change": change}


def checks(prog: dict, ref: dict, limits: dict) -> dict:
    return {name: {"value": value, "limit": limits[name]}
            for name, value in gaps(prog, ref).items()}


def passed(check: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in check.values())


def _launches() -> dict:
    return {"fwd": flash_attention.LAUNCHES,
            "dq": flash_attention.BWD_DQ_LAUNCHES,
            "dkv": flash_attention.BWD_DKV_LAUNCHES}


@dataclass
class TracedRun:
    """What a per-layer metric's reader reads."""
    cell: cells.Cell
    trace: Trace
    steps: int                # steps in the traced stretch
    wall_s: float             # host clock over them, ending in a sync
    launches: dict            # the flash kernels' launch counts over them
    peaks: flops.Peaks | None
    input_wait_s: float       # host seconds in the feed over the window
    window_pulls: int         # batches the window took from the feed


def capture(job, steps: int) -> tuple:
    """``steps`` steps of the job under ``torch.profiler`` (CPU and CUDA),
    after one step with the profiler already on and a device sync: (the
    trace, their host seconds ending in a sync, the flash launches)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps,
                                       repeat=1),
                     on_trace_ready=lambda p: p.export_chrome_trace(
                         str(path))) as prof:
            job.step()
            torch.cuda.synchronize()
            prof.step()
            before = _launches()
            t0 = time.perf_counter()
            for i in range(steps):
                with record_function(STEP_RANGE):
                    job.step()
                if i < steps - 1:
                    prof.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k: v - before[k] for k, v in _launches().items()}
            prof.step()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return Trace(events), wall, launches


def window(job, seconds: float, device, trace: bool = False,
           ranks=None) -> dict:
    """Steps back to back for ``seconds`` (the host waits for the step
    before the one it just queued), ending in a device sync; with
    ``trace``, a traced stretch of :data:`TRACE_STEPS` a third of the way
    in. Over ``ranks``, both points are steps that rank 0 fixes by its
    clock and every rank reaches (``Ranks.step_due``): a host read of the
    ranks' store before each step, no device sync and no collective."""
    cuda = device.type == "cuda"
    traced = None
    steps, prev = 0, None
    t0 = time.perf_counter()

    def due(key: str, part: float) -> bool:
        reached = time.perf_counter() - t0 >= seconds / part
        return reached if ranks is None else ranks.step_due(key, steps,
                                                             reached)

    while True:
        if trace and traced is None and due("trace", 3):
            traced = capture(job, TRACE_STEPS)
            steps += TRACE_STEPS + 1
            prev = None
        job.step()
        steps += 1
        if cuda:
            event = torch.cuda.Event()
            event.record()
            if prev is not None:
                prev.synchronize()
            prev = event
        if due("stop", 1):
            break
    if trace and traced is None:
        traced = capture(job, TRACE_STEPS)
        steps += TRACE_STEPS + 1
    if cuda:
        torch.cuda.synchronize()
    return {"seconds": time.perf_counter() - t0, "steps": steps,
            "traced": traced}


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def token_rows(cell: cells.Cell, seed: int):
    """The cell's token rows from the seed (on the host)."""
    model = cell.model
    return inputs.token_rows(cell.workload["tokens"], model["vocab"],
                             model["seq_len"], seed)


def build(cell: cells.Cell, seed: int, device) -> tuple:
    """The cell's inputs from the seed and its job over them: (the token
    rows, the feed, the job)."""
    model = cell.model
    rows = token_rows(cell, seed)
    params = inputs.as_tree(inputs.make_weights(model, seed, device), model)
    feed = Feed(cell.batch, rows, seed, device)
    return rows, feed, cells.entry_module(cell.entry).build(cell, params, feed)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool, device,
        started: float, ranks=None) -> dict | None:
    """One run of ``cell``; ``started`` is the run's start on the host
    clock. On the CPU (the tests) the metrics stay empty: a CPU run gives
    no device number. Over ``ranks`` (a cell of several cards), every
    rank calls this with its own device; rank 0 returns the result, the
    others None."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    lead = ranks is None or ranks.rank == 0

    def say(what: str) -> None:
        if lead:
            log(started, what)

    say(f"{cell.name} seed {seed}: torch and the harness imported")
    rows, feed, job = build(cell, seed, device)
    say("inputs made, job built")
    prog = program_readings(job, cell, seed, device, ranks)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - started
    # A checkout's first run builds the kernels with nvcc inside its
    # set-up; every later run loads them. The line names what was built,
    # so that run's set-up can be told apart.
    built = sorted(_build.BUILD_LOG)
    say(f"set-up done, losses {prog['losses']}; "
        f"kernels built in this run: {built or 'none'}")

    wait0, pulls0 = feed.wait_s, feed.pulls
    done = window(job, seconds, device, trace and cuda, ranks)
    input_wait_s = feed.wait_s - wait0
    say(f"window done: {done['steps']} steps in {done['seconds']:.3f} s")
    window_losses = job.losses[cell.checked_steps:]
    failed = int((~torch.isfinite(torch.stack(window_losses))).sum())
    count = 1 if ranks is None else ranks.world
    metrics, dev, breakdown = {}, {"platform": "cpu", "count": count}, None
    if cuda:
        window_peak = torch.cuda.max_memory_allocated()
        peak = max(setup_peak, window_peak)
        if ranks is not None:
            window_peak, peak = ranks.max([window_peak, peak])
        name = torch.cuda.get_device_name(device)
        dev = {"platform": "gpu", "kind": name, "count": count,
               "memory_peak_bytes": int(peak), "power": power_limit()}
        if trace:
            traced_trace, wall, launches = done["traced"]
            busy = traced_trace.busy_us() / 1e6
            if ranks is not None:
                busy = ranks.sum([busy])[0] / ranks.world
            dev.update(busy_s=busy, window_s=wall)
            if lead:
                view = TracedRun(cell, traced_trace, TRACE_STEPS, wall,
                                 launches, flops.peaks_for(name),
                                 input_wait_s, feed.pulls - pulls0)
                for m in cell.per_layer:
                    value = cells.metric_reader(m["name"])(view)
                    if value is not None:
                        metrics[m["name"]] = {"value": value,
                                              "unit": m["unit"]}
                step_starts = traced_trace.ranges(STEP_RANGE)
                breakdown = {"device_ops": traced_trace.top_ops(),
                             "idle_gaps": traced_trace.idle_gaps(
                                 step_starts[0].ts if step_starts else 0.0)}
        else:
            e2e = {"train_tokens_per_s":
                   done["steps"] * cell.trained_positions / done["seconds"],
                   "peak_mem_gib": window_peak / 2 ** 30,
                   "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}

    attempted = done["steps"]
    feed.close()
    del job, feed, window_losses, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if not lead:
        return None
    devices = None
    if ranks is not None:
        ranks.wait_others()
        devices = ranks.devices
    say("program freed; reference")
    ref = reference_readings(cell, rows, seed, device, devices=devices)
    check = checks(prog, ref, cell.limits)
    say(f"reference done, losses {ref['losses']}")
    result = {"correct": passed(check) and failed == 0,
              "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["kernels_built"] = built
    result["checks"] = check
    return result
