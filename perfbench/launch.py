"""The benchmark's own launcher: one process a card for a cell of more
than one card, joined into one ``torch.distributed`` process group.

``spawn(fn, world, args, started, deadline_s)`` starts ``world`` rank
processes (the standard library's ``multiprocessing``, start method
``spawn``) and supervises them from the process that called it, which
touches no card and imports no torch. Rank ``r`` takes ``cuda:r`` (gloo
on the CPU, in the tests), joins the group through a file store in a
temporary directory (no TCP port), and calls ``fn(ranks, *args)`` with a
:class:`Ranks`; what ``fn`` returns is the rank's exit code.

- A rank that raises prints its traceback and leaves at once, without
  shutting its group down (the others may wait in a collective it will
  never join). The supervisor sees its non-zero exit code, kills every
  other rank and returns that code.
- Every rank is held to one deadline, ``deadline_s`` after ``started``
  (the supervisor's start on the host's monotonic clock): past it, the
  supervisor kills every rank and returns 124. A hung collective ends the
  run instead of stalling it.
- Each rank dies with the supervisor (``PR_SET_PDEATHSIG``), so no rank
  outlives a supervisor that is killed.
- Rank 0 alone may need the other cards once the others are done (the
  reference, after the window): :meth:`Ranks.wait_others` returns once
  every other rank has exited with 0, which the supervisor signals.

This launcher is the benchmark's, not the program's
(``kubeflow_tpu_torch.parallel.launch``), so how a cell starts does not
move when the code under test moves.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import time
import traceback

# Seconds from the supervisor's start by which every rank of a run has
# ended: under the 360 s a run may take.
DEADLINE_S = 340.0
# Steps ahead of its own count at which rank 0 fixes a step the ranks
# agree on (the traced stretch's start, the window's end): a rank's host
# runs at most two steps ahead of rank 0's, as it waits for the step
# before the one it queued and every step holds a collective.
MARGIN = 3
POLL_S = 0.1


class Ranks:
    """What a rank knows of its world: its rank, the world's size, its
    device, the file store the group was joined through, and the
    supervisor's signal that the other ranks are done."""

    def __init__(self, rank: int, world: int, device, store, others_done):
        self.rank, self.world, self.device = rank, world, device
        self.store, self.others_done = store, others_done
        self.fixed: dict = {}

    @property
    def devices(self) -> list:
        """Every rank's device, by rank."""
        import torch

        if self.device.type == "cuda":
            return [torch.device("cuda", r) for r in range(self.world)]
        return [self.device] * self.world

    def _reduce(self, values: list, op) -> list:
        import torch
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=op)
        return t.tolist()

    def sum(self, values: list) -> list:
        """Each value summed over the ranks."""
        import torch.distributed as dist

        return self._reduce(values, dist.ReduceOp.SUM)

    def max(self, values: list) -> list:
        """Each value's largest over the ranks."""
        import torch.distributed as dist

        return self._reduce(values, dist.ReduceOp.MAX)

    def step_due(self, key: str, steps: int, due: bool) -> bool:
        """Whether the ranks' agreed step ``key`` is reached at ``steps``.
        Rank 0 fixes it, :data:`MARGIN` steps ahead, the first time its
        own ``due`` is true, and writes it to the store; the other ranks
        read it there (a host read, no device sync) and ignore ``due``. A
        rank that first reads it past that step is out of step with rank
        0: that raises."""
        at = self.fixed.get(key)
        if at is None:
            if self.rank == 0:
                if due:
                    at = self.fixed[key] = steps + MARGIN
                    self.store.set(key, str(at))
            elif self.store.check([key]):
                at = self.fixed[key] = int(self.store.get(key))
                if steps > at:
                    raise RuntimeError(f"rank {self.rank} read step {key!r} "
                                       f"= {at} at step {steps}")
        return at is not None and steps >= at

    def wait_others(self, timeout: float = DEADLINE_S) -> None:
        """Rank 0: return once every other rank has exited with 0."""
        if not self.others_done.wait(timeout):
            raise RuntimeError("the other ranks did not end")


def _die_with_parent() -> None:
    try:
        import ctypes
        import signal

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass


def _rank_main(rank: int, world: int, device_type: str, tmp: str,
               others_done, fn, args) -> None:
    _die_with_parent()
    code = 1
    try:
        import torch
        import torch.distributed as dist

        if device_type == "cuda":
            if torch.cuda.device_count() < world:
                print(f"perfbench: rank {rank}: {world} CUDA cards needed, "
                      f"{torch.cuda.device_count()} found", file=sys.stderr)
                sys.stderr.flush()
                os._exit(2)
            torch.cuda.set_device(rank)
            device = torch.device("cuda", rank)
            backend = "nccl"
            # NCCL's bootstrap between the ranks stays on this host.
            os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        else:
            torch.set_num_threads(1)
            device = torch.device("cpu")
            backend = "gloo"
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world)
        code = fn(Ranks(rank, world, device, store, others_done), *args)
    except BaseException:
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # Leave without shutting the group down: the other ranks may have left
    # already, or wait in a collective this one will never join. The
    # exit frees the card.
    os._exit(code)


def _end(procs) -> None:
    for p in procs:
        if p.exitcode is None:
            p.kill()
    for p in procs:
        p.join()


def spawn(fn, world: int, args: tuple, started: float,
          deadline_s: float = DEADLINE_S, device_type: str = "cuda") -> int:
    """Run ``fn(ranks, *args)`` in ``world`` rank processes and supervise
    them (module docstring); returns rank 0's exit code, or the first
    failing rank's, or 124 past the deadline. ``fn`` is a top-level
    function of a module the ranks can import."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="perfbench-ranks-") as tmp:
        others_done = ctx.Event()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, device_type, tmp, others_done,
                                   fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [(r, c) for r, c in enumerate(codes) if c]
                if bad:
                    rank, code = bad[0]
                    print(f"perfbench: rank {rank} exited with {code}; "
                          f"ending the run", file=sys.stderr, flush=True)
                    return code if code > 0 else 1
                if all(c == 0 for c in codes[1:]):
                    others_done.set()
                    if codes[0] == 0:
                        return 0
                if time.perf_counter() - started > deadline_s:
                    print(f"perfbench: ranks {[r for r, c in enumerate(codes) if c is None]} "
                          f"still running {deadline_s:.0f} s after the "
                          f"start; ending the run", file=sys.stderr,
                          flush=True)
                    return 124
                time.sleep(POLL_S)
        finally:
            _end(procs)
