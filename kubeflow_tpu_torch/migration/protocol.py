"""Pure core of the drain/checkpoint/restore protocol.

Everything here is a function of (annotations, now) — no I/O, no clock
reads — so the scheduler, the notebook controller, the culler, the SDK,
and tier-1 can all reason about the same state machine without an event
loop. The durable state lives in CR annotations (api/notebook.py), which
is what makes the protocol survive controller restarts and reach the pod
through the SDK's in-cluster CR fetch.

State machine (derive_state)::

    Running ──drain requested──► DrainRequested
                                      │ SDK stamps checkpointing-at
                                      ▼
                                 Checkpointing
                                      │ SDK stamps checkpointed-at (+path/step)
                                      ▼
                                 Checkpointed ──finalizer stops the CR──► Parked
                                      │
        Running ◄── all workers ready ── Restoring ◄── re-admitted with a
                                                       restore hint

A drain that outlives ``KFTPU_DRAIN_GRACE`` falls back to today's hard
stop: the finalizer (scheduler/culler/controller — identified by the
``drain-reason`` prefix it stamped) clears the drain marks and stops the
CR without a checkpoint. Chips are never held hostage to a wedged pod.

Drain reasons and their finalizers: ``preempt:idle``/``preempt:priority``
(scheduler preemption — park until user restart), ``spot-reclaim`` and
``defrag`` (elastic fleet, kubeflow_tpu/scheduler/elastic.py — park,
then auto-re-queue at original priority with aging credit), ``cull``
(idle culler), ``suspend`` (user/controller).

The port's copy of ``kubeflow_tpu/migration/protocol.py``: it keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.objects import fmt_iso, parse_iso

# Derived lifecycle states (status.migration.state + /debug rows).
RUNNING = "Running"
DRAIN_REQUESTED = "DrainRequested"
CHECKPOINTING = "Checkpointing"
CHECKPOINTED = "Checkpointed"
PARKED = "Parked"
RESTORING = "Restoring"

DEFAULT_DRAIN_GRACE_SECONDS = 120.0

# Restore hint env the controller stamps into the pod template; the SDK's
# CheckpointManager/notebook code reads these to resume where it left off.
RESTORE_PATH_ENV = "KFTPU_RESTORE_CHECKPOINT_PATH"
RESTORE_STEP_ENV = "KFTPU_RESTORE_STEP"

# Knobs (docs/operations.md "Preempt-to-checkpoint migration"):
MIGRATION_ENV = "KFTPU_MIGRATION"
CULL_DRAIN_ENV = "KFTPU_CULL_DRAIN"
DRAIN_GRACE_ENV = "KFTPU_DRAIN_GRACE"
COMMIT_GRACE_ENV = "KFTPU_COMMIT_GRACE"


def migration_enabled(environ=os.environ) -> bool:
    """``KFTPU_MIGRATION`` master switch — anything but off/false/0/no
    leaves the drain protocol on. Off restores the pre-migration
    immediate stop on every path (preemption, culling, suspend)."""
    return environ.get(MIGRATION_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


def cull_drain_enabled(environ=os.environ) -> bool:
    """``KFTPU_CULL_DRAIN`` — culling-only kill switch layered under the
    master one: off restores the bare idle-cull stop while preemption
    keeps draining."""
    return environ.get(CULL_DRAIN_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


def drain_grace_seconds(environ=os.environ) -> float:
    """``KFTPU_DRAIN_GRACE`` — seconds a drain may hold chips before the
    hard-stop fallback fires."""
    raw = environ.get(DRAIN_GRACE_ENV)
    try:
        value = float(raw) if raw is not None else DEFAULT_DRAIN_GRACE_SECONDS
    except ValueError:
        return DEFAULT_DRAIN_GRACE_SECONDS
    return value if value > 0 else DEFAULT_DRAIN_GRACE_SECONDS


def commit_grace_seconds(environ=os.environ) -> float:
    """``KFTPU_COMMIT_GRACE`` — seconds after the snapshot ack the
    background upload may take before the park is marked commit-dirty
    and the drain counted as a fallback. Defaults to the drain grace:
    the upload gets the same patience the snapshot did."""
    raw = environ.get(COMMIT_GRACE_ENV)
    try:
        value = float(raw) if raw is not None else 0.0
    except ValueError:
        value = 0.0
    return value if value > 0 else drain_grace_seconds(environ)


# ---- annotation readers --------------------------------------------------------


def drain_requested_at(annotations: dict) -> float | None:
    return parse_iso(
        annotations.get(nbapi.DRAIN_REQUESTED_ANNOTATION) or "")


def drain_reason(annotations: dict) -> str:
    return annotations.get(nbapi.DRAIN_REASON_ANNOTATION) or ""


def checkpointed_at(annotations: dict) -> float | None:
    return parse_iso(
        annotations.get(nbapi.CHECKPOINTED_AT_ANNOTATION) or "")


def checkpoint_step(annotations: dict) -> int | None:
    raw = annotations.get(nbapi.CHECKPOINT_STEP_ANNOTATION)
    try:
        return int(raw) if raw is not None else None
    except ValueError:
        return None


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
    could otherwise instant-"ack" a new drain issued in the same second
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


def drain_deadline(annotations: dict, grace: float) -> float | None:
    """When the hard-stop fallback fires (epoch seconds), or None when no
    drain is pending."""
    requested = drain_requested_at(annotations)
    return None if requested is None else requested + grace


def drain_expired(annotations: dict, now: float, grace: float) -> bool:
    deadline = drain_deadline(annotations, grace)
    return deadline is not None and now >= deadline and \
        not drain_acked(annotations)


def checkpoint_committed(annotations: dict) -> bool:
    """Has the checkpoint fabric durably committed the checkpoint for
    the CURRENT drain? Same echo discipline as :func:`drain_acked`: the
    commit's ``checkpoint-committed-for`` must carry the raw
    drain-requested value it answers, so a surviving commit mark from a
    previous park can never satisfy a new drain. With the drain marks
    already cleared (post-park), any committed-at mark counts — the
    commit outliving the drain is exactly the success case."""
    committed_raw = annotations.get(
        nbapi.CHECKPOINT_COMMITTED_AT_ANNOTATION)
    if not committed_raw:
        return False
    requested_raw = annotations.get(nbapi.DRAIN_REQUESTED_ANNOTATION)
    if not requested_raw:
        return True
    echo = annotations.get(nbapi.CHECKPOINT_COMMITTED_FOR_ANNOTATION)
    return echo == requested_raw


def commit_dirty(annotations: dict) -> bool:
    """True when a hard stop caught the upload still in flight — the
    durable 'this park's checkpoint may be stale' marker."""
    return bool(annotations.get(nbapi.CHECKPOINT_COMMIT_DIRTY_ANNOTATION))


def upload_progress(annotations: dict) -> tuple[int, int] | None:
    """(chunks done, chunks total) of the in-flight upload, or None."""
    raw = annotations.get(nbapi.CHECKPOINT_PROGRESS_ANNOTATION) or ""
    head, sep, tail = raw.partition("/")
    if not sep:
        return None
    try:
        done, total = int(head), int(tail)
    except ValueError:
        return None
    return (done, total) if total > 0 and 0 <= done <= total else None


def restore_tier(annotations: dict) -> str:
    """Which tier served the last restore ("staging" / "remote" / "")."""
    return annotations.get(nbapi.RESTORE_TIER_ANNOTATION) or ""


def restore_hint(annotations: dict) -> tuple[str, int | None] | None:
    """(checkpoint path, step) to restore from, or None. The path alone
    is enough (CheckpointManager.restore defaults to the latest step);
    the step is surfaced for status messages and determinism."""
    path = annotations.get(nbapi.CHECKPOINT_PATH_ANNOTATION)
    if not path:
        return None
    return path, checkpoint_step(annotations)


# ---- state derivation ----------------------------------------------------------


def derive_state(annotations: dict, *, stopped: bool,
                 ready_hosts: int = 0, want_hosts: int = 0) -> str:
    """The migration lifecycle state as a pure function of the CR. Only
    meaningful when migration is in play (a drain mark or a checkpoint
    exists); a plain notebook derives Running/Parked trivially.

    Parked requires BOTH a committed checkpoint and the drain-reason
    marker every drain park keeps: the checkpoint path/step annotations
    survive re-admission as the durable restore hint, so a later plain
    user stop — with no fresh checkpoint — must not present as a clean
    "Suspended (checkpoint @ step N)" park. Re-admission clears the
    reason, so only a stop that actually came from a drain qualifies."""
    if stopped:
        return PARKED if (checkpointed_at(annotations) is not None
                          and drain_reason(annotations)) else RUNNING
    if drain_requested_at(annotations) is not None:
        if drain_acked(annotations):
            return CHECKPOINTED
        if annotations.get(nbapi.CHECKPOINTING_AT_ANNOTATION):
            return CHECKPOINTING
        return DRAIN_REQUESTED
    if restore_hint(annotations) is not None and (
            want_hosts == 0 or ready_hosts < want_hosts):
        return RESTORING
    return RUNNING


# ---- patch shapes --------------------------------------------------------------
# Merge-patch annotation dicts, so every participant stamps the same keys.


def request_drain_patch(reason: str, now: float) -> dict:
    """Ask the pod to checkpoint: starts the grace clock. Stale progress
    marks from a PREVIOUS drain cycle are cleared so ack detection can't
    confuse an old checkpointing-at for fresh progress."""
    return {
        nbapi.DRAIN_REQUESTED_ANNOTATION: fmt_iso(now),
        nbapi.DRAIN_REASON_ANNOTATION: reason,
        nbapi.CHECKPOINTING_AT_ANNOTATION: None,
        # A new drain cycle starts with a clean commit slate: the
        # previous cycle's commit/dirty/progress marks must not satisfy
        # or confuse this cycle's commit wait.
        nbapi.CHECKPOINT_COMMITTED_AT_ANNOTATION: None,
        nbapi.CHECKPOINT_COMMITTED_FOR_ANNOTATION: None,
        nbapi.CHECKPOINT_COMMIT_DIRTY_ANNOTATION: None,
        nbapi.CHECKPOINT_PROGRESS_ANNOTATION: None,
    }


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


def mark_commit_dirty_patch(now: float) -> dict:
    """Hard stop caught the upload in flight: the checkpoint annotations
    still point at the last *committed* step, but this cycle's upload
    never landed — mark the park dirty so status and restore policy can
    say so. Stamped by the drain finalizer alongside the fallback."""
    return {
        nbapi.CHECKPOINT_COMMIT_DIRTY_ANNOTATION: fmt_iso(now),
        nbapi.CHECKPOINT_PROGRESS_ANNOTATION: None,
    }


def restore_tier_patch(tier: str) -> dict:
    """Record which tier served a restore ("staging" / "remote") for
    JWA's restore-path status message; empty clears the mark."""
    return {nbapi.RESTORE_TIER_ANNOTATION: tier or None}


def clear_drain_patch(*, keep_checkpoint: bool = True,
                      keep_reason: bool = False) -> dict:
    """Drop the drain marks (re-admission, cancel, or hard-stop
    fallback). The checkpoint path/step survive by default — they are the
    durable restore hint; ``keep_checkpoint=False`` also drops those.
    ``keep_reason=True`` is the PARK variant: the drain-reason stays as
    the durable "this stop came from a drain" marker (derive_state's
    Parked gate and the controller's resume path key off it); it clears
    on re-admission via the default variant."""
    patch = {
        nbapi.DRAIN_REQUESTED_ANNOTATION: None,
        nbapi.CHECKPOINTING_AT_ANNOTATION: None,
        nbapi.CHECKPOINTED_FOR_ANNOTATION: None,
    }
    if not keep_reason:
        patch[nbapi.DRAIN_REASON_ANNOTATION] = None
    if not keep_checkpoint:
        patch.update({
            nbapi.CHECKPOINTED_AT_ANNOTATION: None,
            nbapi.CHECKPOINT_PATH_ANNOTATION: None,
            nbapi.CHECKPOINT_STEP_ANNOTATION: None,
            nbapi.CHECKPOINT_COMMITTED_AT_ANNOTATION: None,
            nbapi.CHECKPOINT_COMMITTED_FOR_ANNOTATION: None,
            nbapi.CHECKPOINT_COMMIT_DIRTY_ANNOTATION: None,
            nbapi.CHECKPOINT_PROGRESS_ANNOTATION: None,
        })
    return patch
