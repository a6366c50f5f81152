"""CheckpointFabric — snapshot-then-ack async checkpointing over the
tiered chunk store.

The fabric splits a checkpoint into the two phases that matter to a
drain deadline:

1. **Snapshot (synchronous, fast):** :meth:`CheckpointFabric.save_async`
   copies every tensor (on the card or the CPU) to host memory before it
   returns. Once it returns, the training state is safe from the pod's
   demise *as data* — this is the point :class:`kubeflow_tpu_torch.sdk.
   CheckpointGuard` acks the drain, and what the ``drain_roundtrip``
   SLI clocks.
2. **Commit (background, durable):** a single uploader thread chunks
   the snapshot, writes content-addressed chunks to the staging tier
   and then the remote tier (bounded retry + exponential backoff),
   lands the manifest with a two-phase rename, and finally advances the
   remote ``COMMITTED`` pointer — the only instant at which the step
   becomes restorable. ``checkpoint_commit`` clocks snapshot→commit.

Restore inverts the tiers: the remote committed pointer is
authoritative (a stale staging pointer can never win), chunks are
served from staging when their hashes verify and fall through to the
remote tier otherwise, and any torn manifest or corrupt chunk causes a
fall-back to the *previous* committed step with
``tpu_checkpoint_integrity_failures_total`` incremented — never a
partial pytree and never an exception into the training loop while an
older committed step exists.

Saves are strictly ordered through one worker queue, so commit order is
save order and retention GC can never race an in-flight delta upload.

The port of ``kubeflow_tpu/checkpoint/fabric.py``, which it copies but for
the leaves' encoding. A torch tensor is snapshot as its bytes, a bf16 one
as its raw 16-bit pattern under the manifest dtype ``"bfloat16"`` (what
the JAX fabric writes for an ``ml_dtypes`` bf16 array), so both packages
give the same manifest, chunk for chunk, for the same numbers, and each
restores the other's steps. Restore returns CPU tensors (a ``"bfloat16"``
leaf as a bf16 tensor, read through its bits with torch alone); with an
``abstract`` (:mod:`kubeflow_tpu_torch.checkpoint.abstract`) each leaf is
placed on its spec's device, and cut to this process's shard where the
spec has a sharding rule.
"""

from __future__ import annotations

import os
import queue
import threading
import time

import numpy as np
import torch

from ..runtime import slo
from ..runtime.metrics import Registry, global_registry
from .abstract import leaf_specs as abstract_leaves
from .abstract import place, target_device
from .store import (
    ChunkCorruptionError,
    DirectoryTier,
    StagingTier,
    TornManifestError,
    chunk_hash,
    split_chunks,
)

# Env knobs (all documented in docs/operations.md, "Checkpoint fabric").
STAGING_DIR_ENV = "KFTPU_CKPT_STAGING_DIR"
STAGING_BYTES_ENV = "KFTPU_CKPT_STAGING_BYTES"
CHUNK_BYTES_ENV = "KFTPU_CKPT_CHUNK_BYTES"
FULL_INTERVAL_ENV = "KFTPU_CKPT_FULL_INTERVAL"
UPLOAD_RETRIES_ENV = "KFTPU_CKPT_UPLOAD_RETRIES"
BACKOFF_ENV = "KFTPU_CKPT_BACKOFF_SECONDS"

_DEFAULT_CHUNK_BYTES = 4 << 20
_DEFAULT_FULL_INTERVAL = 4
_DEFAULT_RETRIES = 3
_DEFAULT_BACKOFF = 0.05


class CheckpointIntegrityError(Exception):
    """No committed step could be restored intact — every candidate was
    torn or corrupt. Only raised when fallback is exhausted."""


class _UploadCrash(Exception):
    """Injected crash-mid-upload: the uploading process died. Not
    retried — the step simply never commits."""


class SaveHandle:
    """Tracks one async save from snapshot to durable commit."""

    def __init__(self, step: int):
        self.step = step
        self.committed = False
        self.error: Exception | None = None
        self.bytes_written = 0
        self.chunks_total = 0
        self.chunks_done = 0
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: float | None = None) -> bool:
        return self._done.wait(timeout)

    def result(self, timeout: float | None = None) -> bool:
        """Block until the background commit finishes; True iff the step
        durably committed."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"save of step {self.step} still in flight")
        return self.committed

    def _finish(self, committed: bool, error: Exception | None = None):
        self.committed = committed
        self.error = error
        self._done.set()


def _flatten(tree, prefix=""):
    """Pure-python pytree flatten: (keypath, leaf) pairs + a rebuildable
    skeleton. Works on dict/list/tuple containers and anything
    ``np.asarray`` accepts as a leaf (tensors, numpy arrays, scalars)."""
    leaves: list[tuple[str, object]] = []

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in sorted(node.items())}
        if isinstance(node, (list, tuple)):
            kind = "list" if isinstance(node, list) else "tuple"
            return {"__seq__": kind,
                    "items": [walk(v, f"{path}[{i}]")
                              for i, v in enumerate(node)]}
        leaves.append((path or "/", node))
        return {"__leaf__": len(leaves) - 1}

    skeleton = walk(tree, prefix)
    return leaves, skeleton


def _unflatten(skeleton, leaves):
    if isinstance(skeleton, dict):
        if "__leaf__" in skeleton:
            return leaves[skeleton["__leaf__"]]
        if "__seq__" in skeleton:
            items = [_unflatten(s, leaves) for s in skeleton["items"]]
            return items if skeleton["__seq__"] == "list" else tuple(items)
        return {k: _unflatten(v, leaves) for k, v in skeleton.items()}
    raise TornManifestError(f"bad skeleton node: {skeleton!r}")


# A bf16 leaf travels as its raw bits; the manifest names it "bfloat16".
BF16 = "bfloat16"


def _snapshot_leaf(x) -> tuple[np.ndarray, str]:
    """A host copy of one leaf and its manifest dtype, made before
    ``save_async`` returns: the train step updates its tensors in place, so
    a view would let the next step rewrite the snapshot after the ack. A
    tensor's copy is its bytes (a card's tensor through ``.cpu()``, which
    waits for the card), a bf16 tensor's its raw ``uint16`` bits under the
    dtype ``"bfloat16"``; numpy arrays and Python scalars are copied as the
    JAX fabric copies them."""
    if torch.is_tensor(x):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            arr = t.view(torch.int16).to("cpu", copy=True).numpy()
            return arr.view(np.uint16), BF16
        arr = t.to("cpu", copy=True).numpy()
        return arr, str(arr.dtype)
    arr = np.array(np.asarray(x))
    return arr, str(arr.dtype)


def _decode_leaf(data: bytearray, dtype: str, shape) -> torch.Tensor:
    """One stored leaf as a CPU tensor: a ``"bfloat16"`` leaf from its raw
    bits (no ``ml_dtypes``), any other through numpy's dtype of that
    name."""
    if dtype == BF16:
        arr = np.frombuffer(data, dtype=np.int16)
        return torch.from_numpy(arr.reshape(tuple(shape))).view(
            torch.bfloat16)
    arr = np.frombuffer(data, dtype=np.dtype(dtype))
    return torch.from_numpy(arr.reshape(tuple(shape)))


class CheckpointFabric:
    """Async multi-tier checkpoint fabric. Drop-in for the
    ``CheckpointManager`` surface the SDK guard uses (``directory`` /
    ``save`` / ``wait`` / ``restore`` / ``latest_step`` / ``close``)
    plus the async path (:meth:`save_async`) that makes
    snapshot-then-ack possible."""

    def __init__(
        self,
        directory: str,
        *,
        staging_dir: str | None = None,
        keep: int = 3,
        save_interval_steps: int = 1,
        chunk_bytes: int | None = None,
        full_interval: int | None = None,
        upload_retries: int | None = None,
        backoff_seconds: float | None = None,
        remote_op_delay: float = 0.0,
        registry: Registry | None = None,
        faults=None,
        environ=os.environ,
    ):
        self.directory = directory
        self.keep = keep
        self.interval = max(1, save_interval_steps)
        self.chunk_bytes = int(
            chunk_bytes if chunk_bytes is not None
            else environ.get(CHUNK_BYTES_ENV, _DEFAULT_CHUNK_BYTES))
        self.full_interval = max(1, int(
            full_interval if full_interval is not None
            else environ.get(FULL_INTERVAL_ENV, _DEFAULT_FULL_INTERVAL)))
        self.upload_retries = int(
            upload_retries if upload_retries is not None
            else environ.get(UPLOAD_RETRIES_ENV, _DEFAULT_RETRIES))
        self.backoff_seconds = float(
            backoff_seconds if backoff_seconds is not None
            else environ.get(BACKOFF_ENV, _DEFAULT_BACKOFF))
        self.faults = faults

        self.remote = DirectoryTier(directory, op_delay=remote_op_delay,
                                    faults=faults)
        staging_dir = staging_dir or environ.get(STAGING_DIR_ENV) or None
        self.staging: StagingTier | None = None
        if staging_dir:
            self.staging = StagingTier(
                staging_dir,
                max_bytes=int(environ.get(STAGING_BYTES_ENV, 1 << 30)),
                faults=faults)

        reg = registry or global_registry
        self._m_commits = reg.counter(
            "tpu_checkpoint_commits_total",
            "Durably committed checkpoint steps", ["kind"])
        self._m_bytes = reg.counter(
            "tpu_checkpoint_bytes_total",
            "Bytes written to checkpoint storage", ["tier"])
        self._m_tier_hits = reg.counter(
            "tpu_checkpoint_tier_hits_total",
            "Restore reads served per tier", ["tier"])
        self._m_integrity = reg.counter(
            "tpu_checkpoint_integrity_failures_total",
            "Torn manifests / corrupt chunks detected on restore")

        self.last_restore: dict | None = None
        self._save_count = 0
        self._closed = False
        self._lock = threading.Lock()
        self._inflight: list[SaveHandle] = []
        self._queue: queue.Queue = queue.Queue()
        self._worker = threading.Thread(
            target=self._drain_queue, name="ckpt-uploader", daemon=True)
        self._worker.start()

    # ---- save path ---------------------------------------------------------

    def save(self, step: int, pytree, force: bool = False) -> bool:
        """CheckpointManager-compatible save: snapshot now, commit in the
        background (pair with :meth:`wait` for synchronous semantics)."""
        if not force and step % self.interval != 0:
            return False
        self.save_async(step, pytree)
        return True

    def save_async(self, step: int, pytree, *, on_progress=None,
                   on_commit=None) -> SaveHandle:
        """Snapshot ``pytree`` to host memory synchronously, then return;
        the uploader thread owns chunking, tiered upload, manifest commit,
        retention, and the callbacks. The returned handle resolves when
        the step is durably committed (or the upload died)."""
        if self._closed:
            raise RuntimeError("fabric is closed")
        leaves, skeleton = _flatten(pytree)
        snapshot = [(path, *_snapshot_leaf(x)) for path, x in leaves]
        handle = SaveHandle(step)
        with self._lock:
            self._save_count += 1
            full = (self._save_count - 1) % self.full_interval == 0
            self._inflight.append(handle)
        self._queue.put((handle, snapshot, skeleton, full,
                         time.monotonic(), on_progress, on_commit))
        return handle

    def _drain_queue(self) -> None:
        while True:
            item = self._queue.get()
            if item is None:
                return
            handle, snapshot, skeleton, full, t0, on_progress, on_commit = item
            try:
                self._upload(handle, snapshot, skeleton, full, t0,
                             on_progress, on_commit)
            except _UploadCrash as exc:
                handle._finish(False, exc)
            except Exception as exc:  # never kill the uploader thread
                handle._finish(False, exc)
            finally:
                with self._lock:
                    if handle in self._inflight:
                        self._inflight.remove(handle)

    def _upload(self, handle: SaveHandle, snapshot, skeleton, full: bool,
                t0: float, on_progress, on_commit) -> None:
        # Serialize + chunk on the worker (keeps the ack path lean).
        leaf_specs = []
        plan: list[tuple[str, bytes]] = []   # (digest, data) in order
        for path, arr, dtype in snapshot:
            data = arr.tobytes()
            hashes = []
            for piece in split_chunks(data, self.chunk_bytes):
                digest = chunk_hash(piece)
                hashes.append(digest)
                plan.append((digest, piece))
            leaf_specs.append({"key": path, "dtype": dtype,
                               "shape": list(arr.shape), "chunks": hashes})
        manifest = {"step": handle.step, "kind": "full" if full else "delta",
                    "leaves": leaf_specs, "tree": skeleton}
        handle.chunks_total = len(plan)

        # Staging first: cheap, local, and what a same-node restore hits.
        if self.staging is not None:
            for digest, piece in plan:
                written = self.staging.put_chunk(digest, piece)
                if written:
                    self._m_bytes.labels(tier="staging").inc(written)

        # Remote upload with bounded retry/backoff. A full checkpoint
        # re-verifies every chunk's presence by rewriting it through the
        # idempotent put; a delta trusts has_chunk for dedup.
        attempt = 0
        while True:
            try:
                done = 0
                for digest, piece in plan:
                    if self._probe("should_crash_upload"):
                        raise _UploadCrash(
                            f"crash mid-upload at chunk {done}/{len(plan)}")
                    if self._probe("should_fail_upload"):
                        raise OSError("injected transient upload failure")
                    if full or not self.remote.has_chunk(digest):
                        written = self.remote.put_chunk(digest, piece)
                        handle.bytes_written += written
                        if written:
                            self._m_bytes.labels(tier="remote").inc(written)
                    done += 1
                    handle.chunks_done = done
                    if on_progress is not None:
                        on_progress(done, len(plan))
                self.remote.put_manifest(handle.step, manifest)
                self.remote.commit(handle.step)
                break
            except _UploadCrash:
                raise
            except (OSError, IOError) as exc:
                attempt += 1
                if attempt > self.upload_retries:
                    raise OSError(
                        f"upload of step {handle.step} failed after "
                        f"{attempt} attempts: {exc}") from exc
                time.sleep(self.backoff_seconds * (2 ** (attempt - 1)))  # kftpu: ignore[no-blocking-in-async] runs on the ckpt-uploader worker thread, never the event loop

        # Mirror the commit to staging (the stale-staging fault may
        # silently skip the pointer advance — restore tolerates that
        # because the remote pointer is authoritative).
        if self.staging is not None:
            self.staging.put_manifest(handle.step, manifest)
            self.staging.commit(handle.step)

        self._m_commits.labels(kind=manifest["kind"]).inc()
        self._retain()
        handle._finish(True)
        if on_commit is not None:
            on_commit(handle.step, time.monotonic() - t0)

    def _probe(self, name: str) -> bool:
        fn = getattr(self.faults, name, None)
        return bool(fn()) if callable(fn) else False

    def _retain(self) -> None:
        """Keep the newest ``keep`` manifests; GC unreferenced chunks.
        Runs on the worker thread after a commit, so it can never
        collect under an in-flight upload (the queue serializes)."""
        for tier in filter(None, (self.remote, self.staging)):
            steps = tier.manifest_steps()
            drop = steps[:-self.keep] if self.keep > 0 else []
            committed = tier.committed_step()
            live: set[str] = set()
            for step in steps:
                if step in drop and step != committed:
                    tier.drop_manifest(step)
                    continue
                try:
                    m = tier.get_manifest(step)
                except (TornManifestError, FileNotFoundError):
                    continue
                for leaf in m.get("leaves", ()):
                    live.update(leaf.get("chunks", ()))
            tier.gc(live)

    # ---- restore path ------------------------------------------------------

    def latest_step(self) -> int | None:
        """The last durably *committed* step — an in-flight upload is
        invisible here by design."""
        return self.remote.committed_step()

    def all_steps(self) -> list[int]:
        return self.remote.manifest_steps()

    def restore(self, step: int | None = None, abstract=None):
        """Restore ``step`` (default: last committed). Integrity failures
        (torn manifest, corrupt chunk) fall back to the previous committed
        step and count ``tpu_checkpoint_integrity_failures_total`` —
        callers only see an exception when no intact step exists.

        Leaves come back as CPU tensors. With ``abstract``, a tree of
        :class:`~kubeflow_tpu_torch.checkpoint.abstract.LeafSpec` (e.g.
        ``trainer.abstract_state``), each is placed per its spec and the
        tree takes the abstract's containers; a spec on a CUDA device
        raises where there is no card, before anything is read."""
        if abstract is not None:
            for spec in abstract_leaves(abstract):
                target_device(spec)
        t0 = time.monotonic()
        committed = self.remote.committed_step()
        if step is None:
            if committed is None:
                raise FileNotFoundError(
                    f"no committed checkpoint under {self.directory}")
            target = committed
        else:
            available = self.all_steps()
            if step not in available:
                raise FileNotFoundError(
                    f"no checkpoint for step {step} under "
                    f"{self.directory}; available steps: "
                    f"{available or 'none'}")
            target = step

        candidates = [target] + [s for s in sorted(self.all_steps(),
                                                   reverse=True)
                                 if s < target]
        last_error: Exception | None = None
        for candidate in candidates:
            try:
                tree, tier = self._restore_step(candidate)
            except (TornManifestError, ChunkCorruptionError,
                    FileNotFoundError) as exc:
                self._m_integrity.inc()
                last_error = exc
                continue
            elapsed = time.monotonic() - t0
            self.last_restore = {"step": candidate, "tier": tier,
                                 "seconds": elapsed,
                                 "fallback": candidate != target}
            slo.observe("restore", elapsed, key=self.directory)
            if abstract is not None:
                tree = self._apply_abstract(tree, abstract)
            return tree
        raise CheckpointIntegrityError(
            f"no intact checkpoint restorable under {self.directory} "
            f"(tried steps {candidates}): {last_error}")

    def _restore_step(self, step: int):
        """Restore one exact step through the tiers, verifying every
        hash; raises on the first unrecoverable integrity problem."""
        manifest = None
        if self.staging is not None:
            try:
                manifest = self.staging.get_manifest(step)
            except (TornManifestError, FileNotFoundError):
                manifest = None
        if manifest is None:
            manifest = self.remote.get_manifest(step)

        used_remote = False
        leaves = []
        for spec in manifest["leaves"]:
            buf = bytearray()
            for digest in spec["chunks"]:
                piece = None
                if self.staging is not None and \
                        self.staging.has_chunk(digest):
                    try:
                        piece = self.staging.get_chunk(digest)
                        self._m_tier_hits.labels(tier="staging").inc()
                    except ChunkCorruptionError:
                        piece = None
                if piece is None:
                    piece = self.remote.get_chunk(digest)
                    self._m_tier_hits.labels(tier="remote").inc()
                    used_remote = True
                buf.extend(piece)
            leaves.append(_decode_leaf(buf, spec["dtype"], spec["shape"]))
        tree = _unflatten(manifest["tree"], leaves)
        return tree, ("remote" if used_remote else "staging"
                      if self.staging is not None else "remote")

    @staticmethod
    def _apply_abstract(tree, abstract):
        """Place restored host tensors per an abstract tree of
        ``LeafSpec``s: each on its device, cut to this process's shard
        where its spec has a rule."""
        return place(tree, abstract)

    # ---- lifecycle ---------------------------------------------------------

    def pending(self) -> list[SaveHandle]:
        with self._lock:
            return list(self._inflight)

    def wait(self) -> None:
        """Block until every queued save has committed (or failed)."""
        while True:
            with self._lock:
                handles = list(self._inflight)
            if not handles and self._queue.empty():
                return
            for h in handles:
                h.wait()
            if self._queue.empty() and not self.pending():
                return

    def close(self) -> None:
        """Block on in-flight commits, then stop the uploader. After
        close there are no orphaned ``.tmp`` files in either tier."""
        if self._closed:
            return
        self._closed = True
        self.wait()
        self._queue.put(None)
        self._worker.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
