"""Input pipeline: deterministic sharded loading with device prefetch.

The port of ``kubeflow_tpu/data.py``. ``ArraySource``, ``ShardedLoader``
(its seeded per-epoch order, per-process shards, O(1) ``skip``, rewind
and ``state_dict``), ``prefetch`` and its consumer ``_Prefetcher`` (the
read-ahead handed back to the loader on close) are copies: a given
``(seed, step)`` names the same examples in both packages.

``global_batches`` differs, as the device layout does. JAX assembles one
global ``jax.Array`` from each host's local batch. In the port a process
owns one card and each sharded step takes this process's block of the
global batch on its card (as ``vision.shard_batch`` cuts it): the local
batch *is* that block. Each leaf goes through a pinned host buffer and a
``non_blocking`` copy, so the copy overlaps the card's queued work; a
buffer is reused only once the card has finished copying out of it.
Processes that differ only on a mesh axis the batch is not cut over (the
model axis of a data x model mesh) must train on the same block, so the
first batch is compared across them, and a loader placed by process rank
instead of by ``mesh_place`` raises there instead of quietly training each
model peer on another batch.

The consumer's queue wait and each leaf's staging run inside the
registered spans ``data_wait`` and ``data_stage``
(``telemetry.sections.span``): ``kftpu.*`` ranges while a torch profiler
collects, nothing otherwise.
"""

from __future__ import annotations

import queue
import sys
import threading
import warnings
import weakref
from dataclasses import dataclass
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from kubeflow_tpu_torch.device import resolve_device
from kubeflow_tpu_torch.parallel.mesh import axis, world_size
from kubeflow_tpu_torch.telemetry.sections import span

__all__ = [
    "ArraySource",
    "ShardedLoader",
    "global_batches",
    "mesh_place",
    "prefetch",
]


class ArraySource:
    """Index-addressable source over aligned arrays (numpy or memmap —
    a memmapped .npy on the workspace PVC streams without loading).

    ``source(idx)`` returns a tuple of ``arr[idx]`` per array."""

    def __init__(self, *arrays: np.ndarray):
        if not arrays:
            raise ValueError("need at least one array")
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError("arrays must be index-aligned")
        self.arrays = arrays

    def __len__(self) -> int:
        return len(self.arrays[0])

    def __call__(self, idx: np.ndarray) -> tuple:
        return tuple(a[idx] for a in self.arrays)


@dataclass(frozen=True)
class _Position:
    epoch: int
    batch_in_epoch: int


class ShardedLoader:
    """Deterministic, per-process-sharded, infinitely-repeating batches.

    ``source``: ``len()`` + ``(indices ndarray) -> batch`` (ArraySource or
    any callable with those two). ``process_id``/``num_processes`` default
    to this worker's place in the slice (sdk.SliceInfo). In the port a
    process owns one card, so on a mesh with a model axis that place is
    wrong: pass ``mesh_place(mesh)``, the process's place on the axes that
    cut the batch (``global_batches`` refuses peers whose blocks differ).

    Iteration order is a pure function of ``(seed, epoch)`` — resuming by
    skipping ``step`` batches (trainer.fit's contract) reproduces the
    exact stream. ``state_dict()``/``load_state_dict()`` snapshot the
    position for loaders driven outside fit().
    """

    def __init__(self, source, batch_size: int, *, seed: int = 0,
                 shuffle: bool = True, process_id: int | None = None,
                 num_processes: int | None = None, transform: Callable | None = None):
        if process_id is None or num_processes is None:
            from kubeflow_tpu_torch.sdk import SliceInfo

            info = SliceInfo.from_env()
            process_id = info.process_id if process_id is None else process_id
            num_processes = (info.num_processes if num_processes is None
                             else num_processes)
        if not (0 <= process_id < num_processes):
            raise ValueError(
                f"process_id {process_id} not in [0, {num_processes})")
        self.source = source
        self.batch_size = batch_size
        self.seed = seed
        self.shuffle = shuffle
        self.process_id = process_id
        self.num_processes = num_processes
        self.transform = transform
        # Whole batches per epoch, then whole batches per process: both
        # remainders dropped so shapes are static and shards symmetric
        # (every process runs the same number of steps — a ragged shard
        # would desync the collective in the train step).
        self.batches_per_epoch = len(source) // batch_size
        self.batches_per_process = self.batches_per_epoch // num_processes
        if self.batches_per_process == 0:
            raise ValueError(
                f"{len(source)} examples < one batch per process "
                f"({batch_size} × {num_processes})")
        self._pos = _Position(0, 0)
        self._order_cache: tuple[int, np.ndarray] | None = None
        # Bumped by every explicit repositioning (skip/load_state_dict).
        # A prefetcher's deferred rewind is only valid against the cursor
        # state it observed; a user skip() in between must win.
        self._cursor_moves = 0
        # Serializes cursor claims across concurrent generators; counts
        # every batch ever pulled (monotonic — never rewound), so a
        # prefetcher can tell whether pulls other than its own happened.
        self._iter_lock = threading.Lock()
        self._total_pulls = 0
        # The prefetcher currently wrapping this loader (weakref). A new
        # prefetch() over the same loader closes the old one FIRST — the
        # re-run-cell rebind `pf = prefetch(ld)` evaluates the RHS before
        # the old pf's __del__, so relying on GC alone would start the new
        # producer on the un-rewound cursor and then yank it back.
        self._active_prefetch: weakref.ref | None = None

    # -- deterministic order -----------------------------------------------------

    def _epoch_order(self, epoch: int) -> np.ndarray:
        if self._order_cache is not None and self._order_cache[0] == epoch:
            return self._order_cache[1]
        n = self.batches_per_epoch * self.batch_size
        if not self.shuffle:
            order = np.arange(n)
        else:
            rng = np.random.default_rng((self.seed, epoch))
            order = rng.permutation(len(self.source))[:n]
        self._order_cache = (epoch, order)
        return order

    def _batch_indices(self, epoch: int, batch_in_epoch: int) -> np.ndarray:
        order = self._epoch_order(epoch)
        start = batch_in_epoch * self.batch_size
        return order[start:start + self.batch_size]

    # -- iteration ----------------------------------------------------------------

    def __iter__(self) -> Iterator:
        while True:
            # Claim the position and advance the cursor atomically, BEFORE
            # the heavy work: concurrent generators (a prefetch producer
            # plus anything else iterating the same loader) must each get
            # a distinct batch — unlocked read-modify-write of _pos loses
            # updates, silently re-yielding or skipping batches. Indexing
            # and transform stay outside the lock so pulls overlap.
            with self._iter_lock:
                claimed = self._pos
                epoch, b = claimed.epoch, claimed.batch_in_epoch
                # Process p takes batches p, p+P, p+2P, … of the global order.
                global_batch = self.process_id + b * self.num_processes
                idx = self._batch_indices(epoch, global_batch)
                if b + 1 >= self.batches_per_process:
                    self._pos = _Position(epoch + 1, 0)
                else:
                    self._pos = _Position(epoch, b + 1)
                self._total_pulls += 1
                my_serial = self._total_pulls
                moves_at_claim = self._cursor_moves
            try:
                batch = self.source(idx)
                if self.transform is not None:
                    batch = self.transform(batch)
            except BaseException:
                # Hand the claim back when nothing else touched the
                # cursor since: a direct reader that catches a transient
                # source/transform error and re-iterates must retry this
                # batch, not silently skip it. With interleaved pulls or
                # an explicit reposition the claim stands (rolling back
                # out of order would corrupt the other reader's stream).
                with self._iter_lock:
                    if (self._total_pulls == my_serial
                            and self._cursor_moves == moves_at_claim):
                        self._pos = claimed
                        self._total_pulls -= 1
                raise
            yield batch

    # -- resume -------------------------------------------------------------------

    def skip(self, n_batches: int, *, detach_wait: float = 60.0) -> None:
        """O(1) fast-forward: position this loader exactly where a fresh
        loader would be after yielding ``n_batches``. The resume path
        that composes with ``prefetch`` — count the steps the *consumer*
        ran (the trainer's step counter) and skip that many; the wrapped
        loader's own cursor runs ahead by the prefetch depth and must not
        be snapshotted.

        ``detach_wait`` bounds the synchronous stall while a live
        prefetch producer wedged in a slow source/transform is waited
        out (default 60s — a checkpoint restore that must not block can
        pass a small value and accept the RuntimeWarning instead)."""
        self._detach_prefetcher(wait=detach_wait)
        epoch, b = divmod(int(n_batches), self.batches_per_process)
        with self._iter_lock:
            # Same lock as the iterator's cursor claim: a foreign
            # reader's read-modify-write must not overwrite this.
            self._pos = _Position(epoch, b)
            self._cursor_moves += 1

    def _detach_prefetcher(self, wait: float = 60.0) -> None:
        """Stop any prefetcher currently producing from this loader. An
        explicit reposition under a live producer is otherwise a race —
        the producer could pull one more batch *after* the new position
        lands, silently shifting the stream by one. Waits out a producer
        wedged in a slow transform (up to ``wait`` seconds past close()'s
        own short join) and retries the deferred rewind it skipped; only
        a producer still running after that gets a RuntimeWarning."""
        prev = (self._active_prefetch()
                if self._active_prefetch is not None else None)
        if prev is None:
            return
        prev.close()
        t = prev._thread
        if t is not None and t.is_alive():
            t.join(timeout=wait)
            if t.is_alive():
                warnings.warn(
                    "a prefetch() over this ShardedLoader is still "
                    "producing after {:.0f}s; the stream may shift — "
                    "close() it explicitly first".format(wait),
                    RuntimeWarning, stacklevel=3)
                return
        # Unconditional: an earlier close() may have skipped the rewind
        # while the producer was still wedged, even if that thread has
        # exited on its own by now. _try_rewind self-guards (once, only
        # with the producer stopped and the cursor untouched).
        prev._try_rewind()
        self._active_prefetch = None

    def _linear(self) -> int:
        """Cursor as a monotonic batch count (epochs never rewind)."""
        return (self._pos.epoch * self.batches_per_process
                + self._pos.batch_in_epoch)

    def rewind(self, n_batches: int, *, detach_wait: float = 60.0) -> None:
        """Move the cursor back ``n_batches`` (floored at the start).
        Used by ``prefetch``'s close path to hand back read-ahead batches
        the consumer never saw, so re-wrapping the same loader resumes
        where the *consumer* stopped — not ``depth+1`` batches later."""
        self.skip(max(0, self._linear() - int(n_batches)),
                  detach_wait=detach_wait)

    def state_dict(self) -> dict:
        """Cursor snapshot — valid only for a directly-iterated loader
        (under ``prefetch`` the cursor includes the producer's read-ahead;
        use ``skip`` with the consumed-step count instead)."""
        pos = self._pos  # single atomic read — no torn epoch/batch pair
        return {"epoch": pos.epoch, "batch_in_epoch": pos.batch_in_epoch}

    def load_state_dict(self, state: dict, *,
                        detach_wait: float = 60.0) -> None:
        self._detach_prefetcher(wait=detach_wait)
        with self._iter_lock:
            self._pos = _Position(int(state["epoch"]),
                                  int(state["batch_in_epoch"]))
            self._cursor_moves += 1


def prefetch(batches: Iterator, *, depth: int = 2,
             to_device: Callable | None = None) -> Iterator:
    """Run the upstream iterator ``depth`` elements ahead on a daemon
    thread, optionally pushing each element to device (``to_device``)
    so the transfer overlaps the current step. An upstream exception
    re-raises at the consumer's ``next()``. Closing (or garbage-collecting) the returned
    iterator stops the producer — an abandoned pipeline (re-run notebook
    cell) releases its thread and buffered batches instead of pinning
    them for process lifetime.

    Note: the producer reads ahead, so the *upstream* iterator's position
    runs up to ``depth + 1`` elements past what the consumer has seen.
    When ``batches`` is a ``ShardedLoader`` directly, closing (or GC'ing)
    the prefetcher **rewinds** its cursor by the read-ahead the consumer
    never received — so the re-run-a-notebook-cell pattern (re-wrap the
    same loader in a fresh ``prefetch``) resumes exactly where training
    stopped instead of silently dropping ``depth+1`` batches. For any
    other iterator, snapshot resume state from consumed-step counts
    (``ShardedLoader.skip``), not from the wrapped loader's cursor."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    q: queue.Queue = queue.Queue(maxsize=depth)
    _END = object()
    stop = threading.Event()

    # Rewind support: count every batch pulled from a ShardedLoader (each
    # pull advances its cursor by exactly one) so close() can hand back
    # the produced-but-unconsumed difference.
    rewindable = batches if isinstance(batches, ShardedLoader) else None
    produced = [0]
    if rewindable is not None:
        # Hand off from any previous prefetcher over this loader: detach
        # (close + rewind) it BEFORE our producer starts pulling, so the
        # new stream continues exactly where the old consumer stopped
        # even when the old prefetcher is only dropped by the rebind
        # itself (`pf = prefetch(ld)` evaluates the RHS first).
        rewindable._detach_prefetcher()
        src = iter(batches)

        def counting():
            # Counts SUCCESSFUL pulls only: a failed pull rolls its own
            # cursor claim back inside ShardedLoader.__iter__ (when no
            # other reader interleaved), so it must not count toward the
            # close-time rewind either — the pair keeps
            # `_total_pulls == _start_pulls + produced` exactly.
            while not stop.is_set():
                item = next(src)
                produced[0] += 1
                yield item

        batches = counting()

    def put(item) -> bool:
        """Bounded put that gives up when the consumer is gone."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in batches:
                if to_device is not None:
                    item = to_device(item)
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            put((_END, e))
            return
        put((_END, None))

    thread = threading.Thread(target=producer, daemon=True,
                              name="kftpu-data-prefetch")
    pf = _Prefetcher(q, stop, _END, thread=thread,
                     rewindable=rewindable, produced=produced)
    if rewindable is not None:
        # Snapshots must precede thread.start(): the producer pulls (and
        # moves the cursor) the moment it runs.
        pf._cursor_moves_seen = rewindable._cursor_moves
        pf._start_pulls = rewindable._total_pulls
        rewindable._active_prefetch = weakref.ref(pf)
    thread.start()
    return pf


class _Prefetcher:
    """Consumer half of prefetch(). A real object (not a generator) so
    abandoning the pipeline before the first ``next()`` still releases
    the producer — a never-started generator's ``finally`` never runs,
    but ``__del__``/``close()`` here always do."""

    def __init__(self, q, stop, end, *, thread=None, rewindable=None,
                 produced=None):
        self._q = q
        self._stop = stop
        self._end = end
        self._thread = thread
        self._rewindable = rewindable
        self._produced = produced or [0]
        self._consumed = 0
        self._cursor_moves_seen = 0
        self._start_pulls = 0
        self._rewound = False
        self._closed = False
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        with span("data_wait"):
            item = self._q.get()
        if (isinstance(item, tuple) and len(item) == 2
                and item[0] is self._end):
            self._done = True
            self._stop.set()
            if item[1] is not None:
                raise item[1]
            raise StopIteration
        self._consumed += 1
        return item

    def close(self):
        if self._closed:
            return
        self._closed = True
        self._done = True
        self._stop.set()
        if self._rewindable is None:
            return
        if sys is None or sys.is_finalizing():
            # Interpreter teardown (final GC runs __del__): threading
            # internals are already gone — joining would raise inside
            # teardown, and a rewind is pointless with the process dying.
            return
        # Hand the read-ahead back: the producer stops within one put
        # timeout of the stop flag; once it has, produced-consumed is
        # exactly the batches the loader's cursor ran past the consumer.
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            if self._thread.is_alive():
                # _try_rewind will refuse below; say so — a user who next
                # iterates the loader DIRECTLY (no re-wrap, so no detach
                # retry) would otherwise silently lose the read-ahead.
                warnings.warn(
                    "prefetch producer still running after close(); the "
                    "loader cursor stays ahead by the read-ahead until a "
                    "re-wrap in prefetch() retries the hand-back",
                    RuntimeWarning, stacklevel=2)
        self._try_rewind()

    def _try_rewind(self):
        """Rewind the loader by the read-ahead, once, and only while it
        is safe: the producer must be stopped (a live one could still
        pull) and the cursor untouched since this prefetcher started
        (skip/load_state_dict — a checkpoint resume — wins over a
        relative rewind). Retried by _detach_prefetcher after it waits
        out a producer close() gave up on."""
        if self._rewound:
            return
        if self._thread is not None and self._thread.is_alive():
            return
        if self._rewindable._cursor_moves != self._cursor_moves_seen:
            return
        if (self._rewindable._total_pulls
                != self._start_pulls + self._produced[0]):
            # Pulls beyond our own happened: something else has been
            # iterating the loader (e.g. it was re-wrapped as
            # prefetch(iter(ld)) — an iterator, so the handoff couldn't
            # see it). Rewinding under a foreign reader would re-deliver
            # batches it already produced.
            return
        self._rewound = True
        over = self._produced[0] - self._consumed
        if over > 0:
            self._rewindable.rewind(over)

    def __del__(self):
        try:
            self.close()
        except Exception:  # kftpu: ignore[exception-swallow] destructor during interpreter teardown — logging/metrics may already be torn down and raising is fatal
            pass


def _batch_axes(spec) -> list:
    """The mesh axis names in a batch rule (a name, None, or a tuple of
    names by dim)."""
    names = []
    for entry in (spec if isinstance(spec, (tuple, list)) else (spec,)):
        for name in (entry if isinstance(entry, (tuple, list)) else (entry,)):
            if name is not None:
                names.append(name)
    return names


def mesh_place(mesh, spec=("data",)) -> tuple[int, int]:
    """``(process_id, num_processes)`` for a ``ShardedLoader`` on ``mesh``:
    this process's index over the mesh axes that ``spec`` cuts the batch
    over (row-major), and their number of blocks. ``(0, 1)`` without a
    mesh."""
    index, count = 0, 1
    for name in _batch_axes(spec) if mesh is not None else ():
        ax = axis(mesh, name)
        index, count = index * ax.size + ax.index, count * ax.size
    return index, count


def _map(fn, batch):
    if isinstance(batch, dict):
        return {key: _map(fn, value) for key, value in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_map(fn, value) for value in batch)
    return fn(batch)


class _Staging:
    """Host-to-card copies through pinned buffers: ``depth`` buffers for
    each leaf shape and dtype, taken in turn, each reused only after the
    event recorded behind its last copy has passed."""

    depth = 2

    def __init__(self, device: torch.device):
        self.device = device
        self._rings: dict = {}

    def __call__(self, x) -> torch.Tensor:
        with span("data_stage"):
            return self._stage(torch.as_tensor(x))

    def _stage(self, host: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return host.to(self.device, copy=True)
        key = (tuple(host.shape), host.dtype)
        ring, turn = self._rings.setdefault(key, ([], [0]))
        i = turn[0]
        turn[0] = (i + 1) % self.depth
        if len(ring) <= i:
            ring.append([torch.empty(host.shape, dtype=host.dtype,
                                     pin_memory=True), None])
        buf, done = ring[i]
        if done is not None:
            done.synchronize()       # the card has copied out of buf
        buf.copy_(host)
        out = buf.to(self.device, non_blocking=True)
        ring[i][1] = torch.cuda.Event()
        ring[i][1].record()
        return out


def _check_peers(batch, peers: list) -> None:
    """Raise unless every process on each axis in ``peers`` holds this
    process's block of every leaf."""
    for ax in peers:
        for leaf in _flat(batch):
            blocks = [torch.empty_like(leaf) for _ in range(ax.size)]
            dist.all_gather(blocks, leaf.contiguous(), group=ax.group)
            if not all(torch.equal(b, blocks[0]) for b in blocks):
                raise ValueError(
                    "processes that differ only on mesh axis(es) the batch "
                    "is not cut over hold different blocks: place each "
                    "loader with data.mesh_place(mesh) (its data-axis "
                    "index), not its process rank")


def _flat(batch) -> list:
    if isinstance(batch, dict):
        return [t for value in batch.values() for t in _flat(value)]
    if isinstance(batch, (list, tuple)):
        return [t for value in batch for t in _flat(value)]
    return [batch]


def global_batches(batches: Iterator, mesh=None, spec=("data",), *,
                   device=None) -> Iterator:
    """Each process's local batch as its block of the global batch on its
    card: every leaf (numpy or CPU tensor, in any tree of dicts, lists and
    tuples) copied through a pinned buffer, ``non_blocking``. ``spec``
    names the mesh axes that cut the batch's leading dim (the reference's
    ``PartitionSpec``); on every other mesh axis of size > 1 the first
    batch is compared across the processes and a difference raises
    ``ValueError``. Without a mesh (a world of one) it is the whole batch
    on the card. ``device`` as ``resolve_device`` (``"cpu"`` for the CPU
    tests; no pinning there). Without a card, and unless asked for the
    CPU, it raises at the call."""
    dev = resolve_device(device)
    world_size(mesh)                 # a mesh spans the whole world
    names = _batch_axes(spec)
    peers = [ax for ax in (axis(mesh, name) for name in
                           (mesh.mesh_dim_names if mesh is not None else ())
                           if name not in names) if ax.size > 1]
    return _placed(batches, _Staging(dev), peers)


def _placed(batches: Iterator, staging: _Staging, peers: list) -> Iterator:
    for batch in batches:
        out = _map(staging, batch)
        if peers:
            _check_peers(out, peers)
            peers = []
        yield out
