"""Checkpoint/resume for in-notebook training over
``torch.distributed.checkpoint``.

The port of ``kubeflow_tpu/checkpoint/manager.py``, whose Orbax manager
becomes DCP with the same surface: ``save(step, tree, force)`` (async),
``wait``, ``latest_step``, ``all_steps``, ``restore(step, abstract=)``,
``close``, ``keep`` and ``save_interval_steps``.

- **Async:** ``save`` copies every leaf to host memory before it returns
  (the train step updates its tensors in place) and hands the copies to
  one writer thread; saves commit in save order. ``wait`` blocks until
  they have and raises the first failure.
- **Atomic steps:** every process writes into a hidden ``.tmp-<step>``
  directory; once DCP has written the metadata, process 0 adds the tree's
  skeleton (``tree.json``) and renames the directory to ``<step>``. Only
  such directories are steps, so a half-written step is never listed.
- **Every process saves its shards**, as with Orbax. DCP's planner keeps
  one process's copy of plain tensors that share a key, so a leaf cut
  over the mesh is keyed by its shard's coordinates on the axes that cut
  it (``<path>#model=1``); replicas of one shard share a key and are
  written once, as replicated leaves are. The cuts come from the
  ``abstract`` (:mod:`kubeflow_tpu_torch.checkpoint.abstract`) given to
  the manager or to ``save``.
- **Restore** with an ``abstract`` places each leaf as its spec says: a
  leaf saved whole is read and cut to this process's shard, a leaf saved
  in shards is read from this process's own key (the same cuts, or
  ``ValueError``). Without one, leaves come back whole as CPU tensors.

In a process group, the manager makes a gloo group of its own (a
collective: every process constructs the manager) for DCP's planning
traffic and its barriers, so the writer thread never shares a group with
the train step's collectives. Local paths only: ``torch.distributed.
checkpoint`` writes files, so an object store is used through its mount.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from kubeflow_tpu_torch.parallel.mesh import axis, cuts

from .abstract import leaf_specs as abstract_leaves
from .abstract import place, place_leaf, target_device
from .fabric import _flatten, _unflatten

TREE_FILE = "tree.json"


def _cut(spec) -> dict:
    """The mesh axes that cut a leaf under ``spec`` and their sizes."""
    if spec is None or not spec.sharded:
        return {}
    return {name: axis(spec.mesh, name).size
            for name in cuts(spec.rule, spec.mesh) if name is not None}


def _key(path: str, spec) -> str:
    """The DCP key of this process's copy of a leaf: its path, and for a
    cut leaf its shard's coordinates on the axes that cut it."""
    cut = _cut(spec)
    if not cut:
        return path
    return path + "#" + ",".join(
        f"{name}={axis(spec.mesh, name).index}" for name in cut)


def _host_copy(x) -> torch.Tensor:
    """A CPU tensor holding ``x``'s values, never a view of ``x``."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    return torch.as_tensor(x).clone()


class CheckpointManager:
    """DCP checkpoints of a tree of tensors, one directory a step."""

    def __init__(self, directory: str, *, keep: int = 3,
                 save_interval_steps: int = 1, abstract=None):
        if "://" in directory:
            raise ValueError(
                f"{directory!r}: torch.distributed.checkpoint writes files; "
                "use the object store's mount path")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = keep
        self.interval = max(1, save_interval_steps)
        self.abstract = abstract
        self._group = (dist.new_group(backend="gloo")
                       if dist.is_initialized() else None)
        self._writer = self._group is None or dist.get_rank() == 0
        self.last_save: dict | None = None
        self._pending: set[int] = set()
        self._errors: list[Exception] = []
        self._lock = threading.Lock()
        self._closed = False
        self._queue: queue.Queue = queue.Queue()
        self._worker = threading.Thread(
            target=self._drain_queue, name="ckpt-dcp-writer", daemon=True)
        self._worker.start()

    # ---- save --------------------------------------------------------------

    def save(self, step: int, tree, *, force: bool = False) -> bool:
        """Save (async). Every process of a world must call this with its
        shard of the tree, in the same order; the manager's ``abstract``
        says which leaves are cut over the mesh. A step that is saved or in
        flight already is not saved again (False)."""
        if self._closed:
            raise RuntimeError("checkpoint manager is closed")
        if not force and step % self.interval != 0:
            return False
        with self._lock:
            if step in self._pending or step in self.all_steps():
                return False
            self._pending.add(step)
        t0 = time.perf_counter()
        specs = dict(_flatten(self.abstract)[0]) \
            if self.abstract is not None else {}
        leaves, skeleton = _flatten(tree)
        flat, table = {}, []
        for path, leaf in leaves:
            spec = specs.get(path)
            key = _key(path, spec)
            flat[key] = _host_copy(leaf)
            table.append({"key": path, "cut": _cut(spec)})
        staged = time.perf_counter() - t0
        self._queue.put((step, flat, {"step": step, "leaves": table,
                                      "tree": skeleton}, staged))
        return True

    def _drain_queue(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, flat, manifest, staged = item
                t0 = time.perf_counter()
                self._commit(step, flat, manifest)
                self.last_save = {"step": step, "stage_seconds": staged,
                                  "commit_seconds": time.perf_counter() - t0}
            except Exception as exc:  # reported by wait(), never lost
                with self._lock:
                    self._errors.append(exc)
            finally:
                if item is not None:
                    with self._lock:
                        self._pending.discard(item[0])
                self._queue.task_done()

    def _barrier(self) -> None:
        if self._group is not None:
            dist.barrier(group=self._group)

    def _commit(self, step: int, flat: dict, manifest: dict) -> None:
        tmp = os.path.join(self.directory, f".tmp-{step}")
        if self._writer:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
        self._barrier()
        dcp.save(flat, storage_writer=dcp.FileSystemWriter(tmp),
                 process_group=self._group, no_dist=self._group is None)
        if self._writer:
            path = os.path.join(tmp, TREE_FILE)
            with open(path, "w") as fh:
                json.dump(manifest, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, os.path.join(self.directory, str(step)))
            self._retain()
        self._barrier()

    def _retain(self) -> None:
        if self.keep <= 0:
            return
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)),
                          ignore_errors=True)

    def wait(self) -> None:
        """Block until every queued save has committed; raise the first
        failure."""
        self._queue.join()
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise RuntimeError(
                f"checkpoint save failed under {self.directory}") \
                from errors[0]

    # ---- restore -----------------------------------------------------------

    def all_steps(self) -> list[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit() and os.path.exists(
            os.path.join(self.directory, n, TREE_FILE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, *, abstract=None):
        """Restore ``step`` (default latest). With ``abstract`` (default:
        the manager's), leaves are placed per its specs and the tree takes
        its containers; without, leaves come back whole on the CPU."""
        abstract = self.abstract if abstract is None else abstract
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        else:
            available = self.all_steps()
            if step not in available:
                raise FileNotFoundError(
                    f"no checkpoint for step {step} under "
                    f"{self.directory}; available steps: "
                    f"{available or 'none'}")
        specs = {}
        if abstract is not None:
            for spec in abstract_leaves(abstract):
                target_device(spec)
            specs = dict(_flatten(abstract)[0])
        path = os.path.join(self.directory, str(step))
        with open(os.path.join(path, TREE_FILE)) as fh:
            manifest = json.load(fh)
        reader = dcp.FileSystemReader(path)
        stored = reader.read_metadata().state_dict_metadata
        dest, leaves, placed = {}, [], set()
        for entry in manifest["leaves"]:
            spec = specs.get(entry["key"])
            if entry["cut"] and entry["cut"] != _cut(spec):
                raise ValueError(
                    f"{entry['key']} was saved cut over {entry['cut']}; "
                    f"the abstract cuts it over {_cut(spec)} (a sharded "
                    "checkpoint restores onto the mesh it was saved on)")
            key = _key(entry["key"], spec) if entry["cut"] else entry["key"]
            meta = stored[key]
            whole_on_device = spec is not None and not spec.sharded \
                and spec.dtype == meta.properties.dtype
            if whole_on_device and tuple(meta.size) != tuple(spec.shape):
                raise ValueError(
                    f"{entry['key']}: checkpoint leaf of shape "
                    f"{tuple(meta.size)}, the abstract wants "
                    f"{tuple(spec.shape)}")
            device = target_device(spec) if entry["cut"] or whole_on_device \
                else "cpu"
            dest[key] = torch.empty(tuple(meta.size),
                                    dtype=meta.properties.dtype, device=device)
            if device != "cpu":
                placed.add(id(dest[key]))
            leaves.append(dest[key])
        dcp.load(dest, storage_reader=reader, process_group=self._group,
                 no_dist=self._group is None)
        tree = _unflatten(manifest["tree"], leaves)
        if abstract is None:
            return tree
        return place(tree, abstract, lambda x, spec: x.to(spec.dtype)
                     if id(x) in placed else place_leaf(x, spec))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            self.wait()
        finally:
            self._queue.put(None)
            self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
