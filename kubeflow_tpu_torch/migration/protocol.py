"""Pure core of the drain/checkpoint/restore protocol, as the port's SDK
speaks it: a trimmed copy of ``kubeflow_tpu/migration/protocol.py``
(``drain_acked`` and the patches the SDK stamps: ack, commit, upload
progress, restore tier). Everything here is a function of (annotations,
now): no I/O, no clock reads. The control plane's state machine, knobs
and its own patches stay in the JAX package.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.objects import fmt_iso, parse_iso


def drain_requested_at(annotations: dict) -> float | None:
    return parse_iso(
        annotations.get(nbapi.DRAIN_REQUESTED_ANNOTATION) or "")


def checkpointed_at(annotations: dict) -> float | None:
    return parse_iso(
        annotations.get(nbapi.CHECKPOINTED_AT_ANNOTATION) or "")


def drain_acked(annotations: dict) -> bool:
    """Has the SDK committed a checkpoint for the CURRENT drain? The
    primary signal is the echo: the ack's ``checkpointed-for`` carries
    the raw drain-requested value it answers, so the comparison never
    involves two clocks (the controller stamps the request, the pod
    stamps the ack — skew between them must not make acks invisible or a
    stale checkpoint look fresh). The timestamp ordering remains as a
    fallback for acks stamped without the echo — but only alongside a
    ``checkpointing-at`` progress mark, which every drain request CLEARS
    and the SDK re-stamps when it starts saving for that drain: the
    checkpoint path/step/commit-time survive re-admission as the restore
    hint, and with second-granularity timestamps a surviving old commit
    could otherwise instant-"ack" a new drain requested in the same second
    (rapid spot-reclaim cycles hit exactly this)."""
    requested_raw = annotations.get(nbapi.DRAIN_REQUESTED_ANNOTATION)
    if not requested_raw:
        return False
    echo = annotations.get(nbapi.CHECKPOINTED_FOR_ANNOTATION)
    if echo is not None:
        return echo == requested_raw
    if not annotations.get(nbapi.CHECKPOINTING_AT_ANNOTATION):
        return False
    requested = drain_requested_at(annotations)
    acked = checkpointed_at(annotations)
    return requested is not None and acked is not None and acked >= requested


def ack_patch(path: str, step: int, now: float,
              *, for_request: str | None = None) -> dict:
    """The SDK's commit mark: checkpoint durable at (path, step).
    ``for_request`` echoes the raw drain-requested value being answered
    (see :func:`drain_acked` — the echo makes ack detection clock-skew
    immune); pass the annotation value the SDK read. The patch also
    (re)stamps ``checkpointing-at``: a commit implies a started save,
    and echo-less acks are only honored alongside that progress mark
    (every drain request clears it, so a pre-park checkpoint cannot
    instant-ack the next cycle's drain)."""
    patch = {
        nbapi.CHECKPOINTING_AT_ANNOTATION: fmt_iso(now),
        nbapi.CHECKPOINTED_AT_ANNOTATION: fmt_iso(now),
        nbapi.CHECKPOINT_PATH_ANNOTATION: path,
        nbapi.CHECKPOINT_STEP_ANNOTATION: str(step),
    }
    if for_request is not None:
        patch[nbapi.CHECKPOINTED_FOR_ANNOTATION] = for_request
    return patch


def commit_patch(now: float, *, for_request: str | None = None) -> dict:
    """The fabric's durable-commit mark, stamped by the SDK when the
    background uploader lands the manifest + pointer. Distinct from
    :func:`ack_patch` (the snapshot ack) — the scheduler frees chips on
    the ack but only hard-releases the restore guarantee on this.
    Clears the in-flight progress mark."""
    patch = {
        nbapi.CHECKPOINT_COMMITTED_AT_ANNOTATION: fmt_iso(now),
        nbapi.CHECKPOINT_COMMIT_DIRTY_ANNOTATION: None,
        nbapi.CHECKPOINT_PROGRESS_ANNOTATION: None,
    }
    if for_request is not None:
        patch[nbapi.CHECKPOINT_COMMITTED_FOR_ANNOTATION] = for_request
    return patch


def progress_patch(done: int, total: int) -> dict:
    """Upload progress ("k/N" chunks) for JWA's parked-uncommitted
    status message."""
    return {nbapi.CHECKPOINT_PROGRESS_ANNOTATION: f"{done}/{total}"}


def restore_tier_patch(tier: str) -> dict:
    """Record which tier served a restore ("staging" / "remote") for
    JWA's restore-path status message; empty clears the mark."""
    return {nbapi.RESTORE_TIER_ANNOTATION: tier or None}
