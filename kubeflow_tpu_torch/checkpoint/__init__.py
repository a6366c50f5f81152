"""Checkpoint fabric: crash-safe async multi-tier checkpoints.

The port of ``kubeflow_tpu/checkpoint``. Two save paths share one
package:

- :class:`CheckpointManager` — ``torch.distributed.checkpoint`` for
  in-notebook training loops (every process saves its shards; a step
  directory appears whole or not at all; sharded restore);
- :class:`CheckpointFabric` — the drain-path fabric: snapshot-then-ack
  (``save_async``), content-hashed chunks with an atomic manifest
  commit, and tiered restore (host-local staging → object store) with
  integrity fallback to the previous committed step. Its format is the
  JAX fabric's, byte for byte.

Both restore onto an abstract tree of :class:`LeafSpec` (what
``trainer.abstract_state`` gives). The :class:`kubeflow_tpu_torch.sdk.
CheckpointGuard` speaks to either: with a fabric it acks the drain at
snapshot and reports the durable commit via the migration protocol's
``checkpoint-committed-at`` mark; with the manager it falls back to the
synchronous save-then-ack path.
"""

from .abstract import LeafSpec
from .fabric import (
    CheckpointFabric,
    CheckpointIntegrityError,
    SaveHandle,
)
from .manager import CheckpointManager
from .store import (
    ChunkCorruptionError,
    DirectoryTier,
    StagingTier,
    TornManifestError,
)

__all__ = [
    "CheckpointFabric",
    "CheckpointIntegrityError",
    "CheckpointManager",
    "ChunkCorruptionError",
    "DirectoryTier",
    "LeafSpec",
    "SaveHandle",
    "StagingTier",
    "TornManifestError",
]
