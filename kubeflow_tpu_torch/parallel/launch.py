"""Run a function in several processes joined by ``torch.distributed``.

``run_world(fn, world, *args)`` spawns ``world`` processes; process
``rank`` joins one process group through a file store in a temporary
directory (no TCP port, so concurrent worlds never collide), calls
``fn(rank, *args)`` and saves what it returns, which the caller gets back
as a list by rank. ``fn`` must be a top-level function of a module the
children can import, and return tensors, numbers and containers of them.
Every process is joined against one deadline and killed on overrun, so a
hung collective fails the call instead of stalling it. A process whose
``fn`` raises saves its traceback and exits at once, without shutting its
group down, so the others' pending collectives with it fail too.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, world: int, out: str, backend: str, cuda: bool, fn,
           args) -> None:
    out_dir = Path(out)
    if cuda:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    store = dist.FileStore(str(out_dir / "store"), world)
    dist.init_process_group(backend, store=store, world_size=world,
                            rank=rank)
    try:
        result = fn(rank, *args)
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        traceback.print_exc()
        sys.stderr.flush()
        # Leave at once: the other processes may be inside a collective
        # this one will never join, and shutting the group down (here or
        # at the interpreter's exit) waits for them. The exit closes this
        # process's connections, which ends their collective.
        os._exit(1)
    torch.save(result, out_dir / f"rank{rank}.pt")
    dist.destroy_process_group()


def run_world(fn, world: int, *args, backend: str = "gloo",
              cuda: bool = False, timeout: float = 600.0) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each computed in its
    own process of one ``backend`` process group. ``cuda``: each process
    takes card ``rank % torch.cuda.device_count()`` as its current device
    (else it runs one intra-op thread, the CPU's share). Raises
    ``RuntimeError`` with the processes' tracebacks when one fails or
    they overrun ``timeout`` seconds."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="kftpu-world-") as tmp:
        out = Path(tmp)
        procs = [ctx.Process(target=_child,
                             args=(rank, world, tmp, backend, cuda, fn, args))
                 for rank in range(world)]
        for proc in procs:
            proc.start()
        deadline = time.monotonic() + timeout
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
        overran = [proc for proc in procs if proc.is_alive()]
        for proc in overran:
            proc.kill()
            proc.join(10)
        errors = [(out / f"rank{r}.err").read_text() for r in range(world)
                  if (out / f"rank{r}.err").exists()]
        if overran:
            raise RuntimeError(f"{len(overran)} of {world} processes overran "
                               f"{timeout} s\n" + "\n".join(errors))
        codes = [proc.exitcode for proc in procs]
        if errors or any(codes):
            raise RuntimeError(f"exit codes {codes}\n" + "\n".join(errors))
        return [torch.load(out / f"rank{r}.pt") for r in range(world)]
