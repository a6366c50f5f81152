"""Content-addressed chunk store + atomic manifest commit — the fabric's
durable format.

A copy of ``kubeflow_tpu/checkpoint/store.py`` (no JAX in it): both
packages write and read the same steps, byte for byte.

A checkpoint step is never one opaque blob. It is:

- **chunks/**: content-hashed segments (``sha256(data)`` names the file),
  shared across steps — an unchanged leaf hashes to chunks the store
  already has, so a *delta* save writes only what changed;
- **manifests/manifest-<step>.json**: the step's leaf table (keypath →
  dtype/shape/chunk hashes) plus the tree skeleton, self-checksummed
  (``integrity`` = sha256 of the canonical body) so a torn or truncated
  manifest is *detectable*, not just malformed;
- **COMMITTED**: the last-committed-step pointer, advanced by a
  two-phase rename (write ``.tmp`` + fsync, then ``os.replace``) — the
  only mutation restore trusts. A crash anywhere before the rename
  leaves the previous step committed and the half-written one invisible.

Two tiers speak this format (:class:`DirectoryTier` for the durable
"object store" side, :class:`StagingTier` adding LRU-by-bytes eviction
for the host-local copy); :mod:`kubeflow_tpu_torch.checkpoint.fabric` moves
chunks between them. Fault hooks (``faults=``) are duck-typed so a
test's fault plan can tear manifests, corrupt reads, and slow a tier
without this module importing testing code.
"""

from __future__ import annotations

import hashlib
import json
import os
import time


class TornManifestError(Exception):
    """A manifest that is unreadable, truncated, or fails its own
    checksum — restore must refuse it and fall back, never parse around
    it."""


class ChunkCorruptionError(Exception):
    """A chunk whose bytes no longer hash to their name."""


def chunk_hash(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def split_chunks(data: bytes, chunk_bytes: int) -> list[bytes]:
    if chunk_bytes <= 0:
        return [data]
    return [data[i:i + chunk_bytes]
            for i in range(0, max(len(data), 1), chunk_bytes)]


# ---- manifest encode/decode ----------------------------------------------------


def encode_manifest(manifest: dict) -> bytes:
    """Canonical JSON + a self-checksum trailer. The checksum covers the
    body exactly as serialized, so any truncation, bit-flip, or partial
    replication is caught by :func:`decode_manifest`."""
    body = dict(manifest)
    body.pop("integrity", None)
    canonical = json.dumps(body, sort_keys=True, separators=(",", ":"))
    body["integrity"] = hashlib.sha256(canonical.encode()).hexdigest()
    return json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()


def decode_manifest(raw: bytes) -> dict:
    """Parse + verify; raises :class:`TornManifestError` on anything
    short of a bit-perfect manifest."""
    try:
        body = json.loads(raw)
    except (ValueError, UnicodeDecodeError) as exc:
        raise TornManifestError(f"unparseable manifest: {exc}") from exc
    if not isinstance(body, dict):
        raise TornManifestError("manifest is not an object")
    integrity = body.pop("integrity", None)
    canonical = json.dumps(body, sort_keys=True, separators=(",", ":"))
    want = hashlib.sha256(canonical.encode()).hexdigest()
    if integrity != want:
        raise TornManifestError(
            f"manifest checksum mismatch (got {integrity!r})")
    return body


# ---- fault-hook helpers --------------------------------------------------------
# The fabric's storage faults are duck-typed probes on whatever object
# the caller passes as ``faults`` (production passes None; the chaos
# soak passes its FaultPlan). A missing method means "fault never fires".


def _probe(faults, name: str, *args) -> bool:
    fn = getattr(faults, name, None)
    return bool(fn(*args)) if callable(fn) else False


def _delay(faults, tier: str) -> None:
    fn = getattr(faults, "storage_delay", None)
    if callable(fn):
        d = fn(tier)
        if d and d > 0:
            time.sleep(d)  # kftpu: ignore[no-blocking-in-async] tier ops run on the ckpt-uploader thread or via asyncio.to_thread


# ---- tiers ---------------------------------------------------------------------


class DirectoryTier:
    """One tier of the fabric over a directory: the durable "object
    store" shape. ``op_delay`` is the bench's simulated per-operation
    round trip (an object store is never free); ``faults`` is the
    duck-typed storage-fault hook."""

    name = "remote"

    def __init__(self, directory: str, *, op_delay: float = 0.0,
                 faults=None):
        self.directory = os.path.abspath(directory) \
            if "://" not in directory else directory
        self.op_delay = op_delay
        self.faults = faults
        self._chunk_dir = os.path.join(self.directory, "chunks")
        self._manifest_dir = os.path.join(self.directory, "manifests")
        os.makedirs(self._chunk_dir, exist_ok=True)
        os.makedirs(self._manifest_dir, exist_ok=True)

    # -- plumbing ------------------------------------------------------------

    def _pause(self) -> None:
        if self.op_delay > 0:
            time.sleep(self.op_delay)  # kftpu: ignore[no-blocking-in-async] tier ops run on the ckpt-uploader thread or via asyncio.to_thread
        _delay(self.faults, self.name)

    def _chunk_path(self, digest: str) -> str:
        return os.path.join(self._chunk_dir, digest)

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"manifest-{step}.json")

    @staticmethod
    def _replace(tmp: str, final: str) -> None:
        with open(tmp, "rb") as fh:  # fsync before the rename: the
            os.fsync(fh.fileno())    # two-phase commit's first phase
        os.replace(tmp, final)

    # -- chunks --------------------------------------------------------------

    def has_chunk(self, digest: str) -> bool:
        return os.path.exists(self._chunk_path(digest))

    def put_chunk(self, digest: str, data: bytes) -> int:
        """Write one content-addressed chunk (idempotent). Returns bytes
        written (0 when the store already had it — the delta path)."""
        self._pause()
        path = self._chunk_path(digest)
        if os.path.exists(path):
            return 0
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
        self._replace(tmp, path)
        return len(data)

    def get_chunk(self, digest: str) -> bytes:
        """Read + verify one chunk; raises :class:`ChunkCorruptionError`
        when the bytes no longer match their name (bit rot, injected
        corruption)."""
        self._pause()
        with open(self._chunk_path(digest), "rb") as fh:
            data = fh.read()
        if _probe(self.faults, "should_corrupt_read", self.name):
            data = (b"\x00" if not data else
                    bytes([data[0] ^ 0xFF]) + data[1:])
        if chunk_hash(data) != digest:
            raise ChunkCorruptionError(
                f"{self.name} chunk {digest[:12]}… failed verification")
        return data

    # -- manifests + commit --------------------------------------------------

    def put_manifest(self, step: int, manifest: dict) -> None:
        """Two-phase manifest write. The torn-manifest fault emulates a
        non-atomic backend (partial object-store replication): the final
        path receives a truncated body — exactly what restore's checksum
        must catch."""
        self._pause()
        raw = encode_manifest(manifest)
        path = self._manifest_path(step)
        if _probe(self.faults, "should_tear_manifest", self.name):
            with open(path, "wb") as fh:
                fh.write(raw[:max(1, len(raw) // 2)])
            return
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(raw)
        self._replace(tmp, path)

    def get_manifest(self, step: int) -> dict:
        self._pause()
        path = self._manifest_path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no manifest for step {step} under {self.directory}")
        with open(path, "rb") as fh:
            return decode_manifest(fh.read())

    def manifest_steps(self) -> list[int]:
        steps = []
        try:
            names = os.listdir(self._manifest_dir)
        except OSError:
            return []
        for n in names:
            if n.startswith("manifest-") and n.endswith(".json"):
                try:
                    steps.append(int(n[len("manifest-"):-len(".json")]))
                except ValueError:
                    continue
        return sorted(steps)

    def commit(self, step: int) -> None:
        """Advance the committed pointer — THE commit, via two-phase
        rename. Everything before this call is invisible to restore."""
        self._pause()
        pointer = os.path.join(self.directory, "COMMITTED")
        tmp = pointer + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(str(step))
        self._replace(tmp, pointer)

    def committed_step(self) -> int | None:
        self._pause()
        pointer = os.path.join(self.directory, "COMMITTED")
        try:
            with open(pointer) as fh:
                return int(fh.read().strip())
        except (OSError, ValueError):
            return None

    # -- retention -----------------------------------------------------------

    def drop_manifest(self, step: int) -> None:
        try:
            os.remove(self._manifest_path(step))
        except OSError:
            pass

    def gc(self, live_hashes: set[str]) -> int:
        """Delete chunks no retained manifest references; returns bytes
        reclaimed. Callers only invoke this AFTER a commit, so the
        previous committed step's chunks are never collected while it is
        still the restore guarantee."""
        freed = 0
        try:
            names = os.listdir(self._chunk_dir)
        except OSError:
            return 0
        for digest in names:
            if digest.endswith(".tmp") or digest in live_hashes:
                continue
            path = self._chunk_path(digest)
            try:
                freed += os.path.getsize(path)
                os.remove(path)
            except OSError:
                continue
        return freed

    def bytes_used(self) -> int:
        total = 0
        for root in (self._chunk_dir, self._manifest_dir):
            try:
                for n in os.listdir(root):
                    try:
                        total += os.path.getsize(os.path.join(root, n))
                    except OSError:
                        continue
            except OSError:
                continue
        return total

    def orphaned_tmp_files(self) -> list[str]:
        """Leftover first-phase files — must be empty after close()."""
        out = []
        for root in (self.directory, self._chunk_dir, self._manifest_dir):
            try:
                out.extend(os.path.join(root, n) for n in os.listdir(root)
                           if n.endswith(".tmp"))
            except OSError:
                continue
        return out


class StagingTier(DirectoryTier):
    """The host-local staging copy: same format, bounded by
    ``max_bytes`` with LRU-by-bytes chunk eviction (touch on read). A
    parked replica restoring on the same node is served from here and
    never touches the remote tier."""

    name = "staging"

    def __init__(self, directory: str, *, max_bytes: int = 1 << 30,
                 faults=None):
        super().__init__(directory, faults=faults)
        self.max_bytes = max_bytes
        # digest → (last-touch monotonic, size); rebuilt lazily from disk
        # so a new process over an existing staging dir still evicts.
        self._lru: dict[str, tuple[float, int]] = {}
        for digest in (os.listdir(self._chunk_dir)
                       if os.path.isdir(self._chunk_dir) else ()):
            if not digest.endswith(".tmp"):
                try:
                    size = os.path.getsize(self._chunk_path(digest))
                except OSError:
                    continue
                self._lru[digest] = (0.0, size)

    def put_chunk(self, digest: str, data: bytes) -> int:
        written = super().put_chunk(digest, data)
        self._lru[digest] = (time.monotonic(),
                             self._lru.get(digest, (0, len(data)))[1]
                             if written == 0 else len(data))
        self._evict()
        return written

    def get_chunk(self, digest: str) -> bytes:
        data = super().get_chunk(digest)
        if digest in self._lru:
            self._lru[digest] = (time.monotonic(), self._lru[digest][1])
        return data

    def commit(self, step: int) -> None:
        # Stale-staging fault: the local pointer silently fails to
        # advance (node-local disk lagging the object store). Restore
        # must never trust a stale staging pointer over the remote one.
        if _probe(self.faults, "should_skip_staging_commit"):
            return
        super().commit(step)

    def _evict(self) -> None:
        used = sum(size for _, size in self._lru.values())
        if used <= self.max_bytes:
            return
        for digest, (_, size) in sorted(self._lru.items(),
                                        key=lambda kv: kv[1][0]):
            if used <= self.max_bytes:
                break
            try:
                os.remove(self._chunk_path(digest))
            except OSError:
                pass
            used -= size
            self._lru.pop(digest, None)
