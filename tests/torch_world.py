"""Run a function in several CPU processes joined by ``torch.distributed``
(gloo), for the tests of the port's sequence parallelism.

``run_world(fn, tmp_path, *args)`` spawns ``world`` processes; process
``rank`` joins a gloo group through a file store under ``tmp_path`` (no
TCP port, so parallel test workers never collide), calls
``fn(rank, *args)`` and saves what it returns. ``fn`` must be a top-level
function of a module the children can import: they load torch and the
port, and no JAX. Every process is joined against one deadline and killed
on overrun, so a hung collective fails its test instead of stalling the
suite.
"""

from __future__ import annotations

import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, world: int, out: str, fn, args) -> None:
    out_dir = Path(out)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            world_size=world, rank=rank)
    try:
        torch.save(fn(rank, *args), out_dir / f"rank{rank}.pt")
    except BaseException:
        (out_dir / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_world(fn, tmp_path: Path, *args, world: int = 4,
              timeout: float = 240.0) -> list:
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each computed in its
    own process of one gloo world."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(rank, world, str(tmp_path), fn, args))
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
    errors = [(tmp_path / f"rank{r}.err").read_text() for r in range(world)
              if (tmp_path / f"rank{r}.err").exists()]
    if overran:
        raise AssertionError(f"{len(overran)} of {world} processes overran "
                             f"{timeout} s\n" + "\n".join(errors))
    codes = [proc.exitcode for proc in procs]
    if errors or any(codes):
        raise AssertionError(f"exit codes {codes}\n" + "\n".join(errors))
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]
