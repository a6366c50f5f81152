"""Notebook status state machine for the UI.

Reference: ``crud-web-apps/jupyter/backend/apps/common/status.py:9-57`` —
phases [ready|waiting|warning|terminating|stopped], derived in priority
order from: age, stop annotation, deletionTimestamp, readyReplicas,
containerState, conditions, then warning Events.

Multi-host twist: "ready" compares readyReplicas against the slice's host
count (``status.gpu.hosts``), not the reference's hard-coded 1.

The port of ``kubeflow_tpu/web/common/status.py``: it reads the leaves the
port's controllers write under ``status.gpu`` (hosts, capacityPending,
warmPool, telemetry), and every message is the JAX package's with "TPU"
read as "GPU" (same counts, positions and reasons).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime import slo
from kubeflow_tpu_torch.runtime import timeline as timeline_mod
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, parse_iso

READY = "ready"
WAITING = "waiting"
WARNING = "warning"
TERMINATING = "terminating"
STOPPED = "stopped"


@dataclass(frozen=True)
class Status:
    phase: str
    message: str


def _age_seconds(notebook: dict) -> float:
    created = get_meta(notebook).get("creationTimestamp")
    ts = parse_iso(created) if created else None
    if ts is None:
        return 1e9
    return max(0.0, time.time() - ts)


def event_stamp(ev: dict) -> str:
    """The one event-timestamp precedence rule (lastTimestamp →
    eventTime → metadata.creationTimestamp) — shared by the filter below
    and the dashboard activity feed so it can't drift."""
    return (
        ev.get("lastTimestamp") or ev.get("eventTime")
        or deep_get(ev, "metadata", "creationTimestamp") or ""
    )


def filter_events(notebook: dict, events: list[dict]) -> list[dict]:
    """Drop events that predate the CR — a recreated server with the same
    name must not surface the previous incarnation's errors (reference
    ``crud-web-apps/jupyter/backend/apps/common/status.py``
    get_notebook_events creationTimestamp filter)."""
    created = get_meta(notebook).get("creationTimestamp")
    created_ts = parse_iso(created) if created else None
    if created_ts is None:
        return list(events)
    out = []
    for ev in events:
        stamp = event_stamp(ev)
        ts = parse_iso(stamp) if stamp else None
        if ts is None or ts >= created_ts:
            out.append(ev)
    return out


def _pending_since(notebook: dict) -> float | None:
    """Start of the current startup episode, from the durable lifecycle
    timeline's episode boundary (survives re-queues and manager
    restarts). Deliberately timeline-only — age since creation would
    misread a long-RUNNING server that was later re-queued, and a
    pre-timeline CR has no trustworthy episode start; None = never
    guess a breach."""
    entries = timeline_mod.decode(
        get_meta(notebook).get("annotations") or {})
    start = timeline_mod.episode_start(entries)
    return start["at"] if start is not None else None


def _time_to_ready_breach(notebook: dict) -> dict | None:
    """The JWA "waiting longer than expected" signal: the pending episode
    has outlived the ``notebook_time_to_ready`` objective
    (KFTPU_SLO_NOTEBOOK_TIME_TO_READY). Returns the message pieces, or
    None inside the objective."""
    threshold, target = slo.objective_for("notebook_time_to_ready")
    since = _pending_since(notebook)
    if since is None:
        return None
    waited = time.time() - since
    if waited <= threshold:
        return None
    meta = get_meta(notebook)
    return {
        "percentile": f"p{target * 100:g}",
        "threshold": threshold,
        "waited": waited,
        "explain": (f"/debug/scheduler/explain/"
                    f"{meta.get('namespace', '')}/{meta.get('name', '')}"),
    }


def _breach_message(breach: dict, reason: str) -> str:
    return (f"Waiting longer than expected "
            f"({breach['percentile']} objective {breach['threshold']:g}s, "
            f"waiting {breach['waited']:.0f}s) — {reason}; "
            f"explain: {breach['explain']} on the controller manager")


def process_status(notebook: dict, events: list[dict] | None = None) -> Status:
    meta = get_meta(notebook)
    annotations = meta.get("annotations") or {}
    ready = deep_get(notebook, "status", "readyReplicas", default=0) or 0
    container_state = deep_get(notebook, "status", "containerState", default={})
    conditions = deep_get(notebook, "status", "conditions", default=[])
    want_hosts = deep_get(notebook, "status", "gpu", "hosts", default=1) or 1

    # Poison-pill quarantine first (runtime/manager.py stamps the
    # Degraded condition): reconciliation is SUSPENDED, so every other
    # signal below is frozen at quarantine time — nothing is more
    # actionable than saying so. Conditions are newest-first history; the
    # most recent Degraded entry wins (False = released, fall through).
    for c in conditions:
        if c.get("type") == "Degraded":
            if c.get("status") == "True":
                return Status(
                    WARNING,
                    "Reconciliation suspended after repeated errors "
                    f"({c.get('reason', 'ReconcileQuarantined')}) — edit "
                    "the notebook to retry, or ask an operator to requeue "
                    "it (POST /debug/queue/requeue on the controller "
                    "manager)",
                )
            break

    # Fleet-scheduler verdicts first (controllers/notebook.py writes
    # status.scheduler): a Queued gang is waiting *by design*, with a
    # position and a chip count the user can act on — more specific than
    # the provisioning wait and any age/pod-state heuristic below.
    sched = deep_get(notebook, "status", "scheduler", default={}) or {}
    mig = deep_get(notebook, "status", "migration", default={}) or {}
    if sched.get("state") == "Queued":
        # Elastic-fleet refinements first — each is more specific than
        # the generic queue position:
        if sched.get("reclaimed") == "spot-reclaim":
            step = mig.get("checkpointStep")
            ckpt = (f"checkpoint @ step {step}" if step is not None
                    else "checkpoint saved")
            return Status(
                WAITING,
                f"Reclaimed from spot capacity ({ckpt}, re-queued at "
                f"position {sched.get('position', 0)})",
            )
        if sched.get("reclaimed") == "defrag":
            return Status(
                WAITING,
                f"Migrating to pack pool (re-queued at position "
                f"{sched.get('position', 0)})",
            )
        scale_up = sched.get("scaleUp") or {}
        if scale_up.get("chips"):
            pending = scale_up.get("pendingSeconds", 0) or 0
            return Status(
                WAITING,
                f"Waiting for pool scale-up ({scale_up['chips']} chips "
                f"requested, intent pending {pending:.0f}s)",
            )
        breach = _time_to_ready_breach(notebook)
        if breach is not None:
            # Past the time-to-ready objective: escalate to a warning
            # whose reason is the SAME machine answer the explain
            # endpoint serves (status.scheduler.reason comes from
            # schedule_preview, the explain endpoint's source).
            return Status(
                WARNING,
                _breach_message(
                    breach,
                    f"{sched.get('reason') or 'queued for GPU capacity'} "
                    f"(position {sched.get('position', 0)})"),
            )
        return Status(
            WAITING,
            f"Queued for GPU capacity (position {sched.get('position', 0)},"
            f" waiting for {sched.get('waitingChips', 0)} chips)",
        )
    if sched.get("state") == "Draining":
        reason = sched.get("reason") or "capacity reclaimed"
        if reason == "defrag":
            return Status(
                WAITING,
                "Migrating to pack pool (checkpointing)…",
            )
        if reason == "spot-reclaim":
            return Status(
                WAITING,
                "Checkpointing before spot capacity is reclaimed…",
            )
        return Status(
            WAITING,
            f"Checkpointing before preemption ({reason})…",
        )
    if sched.get("state") == "Preempted" and ready == 0:
        reason = sched.get("reason") or "capacity reclaimed"
        step = mig.get("checkpointStep")
        restore = (
            f"; restarts resume from checkpoint @ step {step}"
            if step is not None and mig.get("checkpointedAt")
            else ""
        )
        return Status(
            STOPPED,
            f"Preempted by the GPU fleet scheduler ({reason}); "
            f"restart the server to re-queue{restore}",
        )

    # Queued provisioning: nothing runs yet *by design* — more specific
    # than any age/pod-state heuristic below, so it goes first.
    if deep_get(notebook, "status", "gpu", "capacityPending"):
        return Status(
            WAITING,
            "Waiting for GPU capacity (queued ProvisioningRequest)",
        )

    # Warm pod pools (controllers/warmpool.py): a claimed
    # notebook starting up says HOW it is starting (the warm path is the
    # product's headline — surface it); a pool caught empty says why the
    # cold path ran and how close the pool is to refilled. Both only
    # matter pre-Ready — a Running server falls through to the normal
    # Ready message.
    warm_pool = deep_get(notebook, "status", "gpu", "warmPool",
                         default={}) or {}
    if warm_pool.get("claimed") and ready < want_hosts \
            and nbapi.STOP_ANNOTATION not in annotations:
        claimed_in = warm_pool.get("claimedInSec")
        return Status(
            WAITING,
            "Starting from warm pool"
            + (f" (claimed in {claimed_in:g}s)"
               if isinstance(claimed_in, (int, float)) else ""),
        )
    repl = warm_pool.get("replenishing") or {}
    if repl and ready < want_hosts \
            and nbapi.STOP_ANNOTATION not in annotations:
        return Status(
            WAITING,
            f"Warming pool replenishing ({repl.get('ready', 0)}/"
            f"{repl.get('size', 0)} ready); starting cold",
        )

    # Brand-new CR: show a benign waiting message for the first seconds.
    if not container_state and not conditions and _age_seconds(notebook) <= 10:
        return Status(WAITING, "Waiting for StatefulSet to create the underlying Pod.")

    if nbapi.STOP_ANNOTATION in annotations:
        if ready == 0:
            if mig.get("state") == "Parked":
                step = mig.get("checkpointStep")
                base = (f"Suspended (checkpoint @ step {step})"
                        if step is not None
                        else "Suspended (checkpoint saved)")
                # Checkpoint fabric: the park happened at the snapshot
                # ack — say so while the durable upload is still in
                # flight, and flag a park whose upload never landed
                # (restore may fall back to an older committed step).
                if mig.get("commitDirty"):
                    return Status(
                        WARNING,
                        base + " — checkpoint upload did not complete; "
                        "restore may use an older committed step",
                    )
                if (mig.get("uploadProgress")
                        and not mig.get("committedAt")):
                    return Status(
                        STOPPED,
                        base + f" — checkpoint uploading "
                        f"({mig['uploadProgress']} chunks)",
                    )
                return Status(STOPPED, base)
            return Status(STOPPED, "No Pods are currently running for this Notebook Server.")
        return Status(WAITING, "Notebook Server is stopping.")

    if meta.get("deletionTimestamp"):
        return Status(TERMINATING, "Deleting this Notebook Server.")

    # Re-admitted with a checkpoint hint: workers are coming up and will
    # restore where the drain left off — more specific than the generic
    # partial-readiness message below.
    if mig.get("state") == "Restoring" and ready < want_hosts:
        step = mig.get("checkpointStep")
        # Checkpoint fabric: name the tier that served the restore —
        # a staging hit is the fast path, object storage the fallback.
        tier = mig.get("restoreTier")
        source = {"staging": "Restoring from local staging tier",
                  "remote": "Restoring from object storage"}.get(
                      tier, "Restoring from checkpoint")
        return Status(
            WAITING,
            source
            + (f" (step {step})" if step is not None else "")
            + f" ({ready}/{want_hosts} workers ready)",
        )

    if ready >= want_hosts and ready > 0:
        # Impending node maintenance (controller-mirrored taint): the
        # server is still up — say so, but tell the user to checkpoint.
        pending = annotations.get(nbapi.MAINTENANCE_ANNOTATION)
        if pending:
            return Status(
                READY,
                f"Running — node maintenance pending on {pending}; "
                "checkpoint your work",
            )
        # The webhook reverted a live pod-affecting edit (restart
        # blocking, reference maybeRestartRunningNotebook): the change
        # was NOT applied — say so, and say what to do.
        if annotations.get(nbapi.UPDATE_PENDING_ANNOTATION):
            return Status(
                READY,
                "Running — a configuration change was blocked while the "
                "server is running; stop it and re-apply the change",
            )
        # Training telemetry (controllers/notebook.py folds the
        # SDK's annotation into status.gpu.telemetry): a Running server
        # that is mid-training says so, with the achieved MFU when the
        # profiler knew its FLOPs basis. A STALE entry (publisher gone
        # quiet past KFTPU_TELEMETRY_STALE_SECONDS) must not present
        # week-old MFU as live — degrade to saying the telemetry is
        # stale instead.
        telem = deep_get(notebook, "status", "gpu", "telemetry",
                         default={}) or {}
        if telem.get("step"):
            workers = (f" ({ready}/{want_hosts} GPU workers)"
                       if want_hosts > 1 else "")
            if telem.get("stale"):
                return Status(
                    READY,
                    f"Running{workers} — training telemetry stale "
                    f"(last step {telem['step']})",
                )
            mfu = telem.get("mfu")
            mfu_part = (f", {mfu:.0%} MFU"
                        if isinstance(mfu, (int, float)) else "")
            return Status(
                READY,
                f"Running{workers} — Training: step {telem['step']}"
                f"{mfu_part} ({telem.get('family') or 'unknown'})",
            )
        if want_hosts > 1:
            return Status(READY, f"Running ({ready}/{want_hosts} GPU workers)")
        return Status(READY, "Running")

    waiting = container_state.get("waiting")
    if waiting is not None:
        reason = waiting.get("reason", "Undefined")
        if reason == "PodInitializing":
            return Status(WAITING, reason)
        message = waiting.get("message", "No available message for container state.")
        return Status(WARNING, f"{reason}: {message}")

    for condition in conditions:
        if condition.get("reason"):
            return Status(
                WARNING, f"{condition['reason']}: {condition.get('message', '')}"
            )

    # Partially-ready slice: surface progress rather than a generic warning.
    if 0 < ready < want_hosts:
        breach = _time_to_ready_breach(notebook)
        if breach is not None:
            return Status(
                WARNING,
                _breach_message(
                    breach,
                    f"waiting for GPU workers ({ready}/{want_hosts} "
                    "ready)"),
            )
        return Status(WAITING, f"Waiting for GPU workers ({ready}/{want_hosts} ready)")

    for ev in sorted(
        filter_events(notebook, events or []),
        key=lambda e: e.get("lastTimestamp", ""),
        reverse=True,
    ):
        if ev.get("type") == "Warning":
            return Status(WARNING, ev.get("message", ""))

    return Status(
        WARNING, "Couldn't find any information for the status of this notebook."
    )


def process_serving_status(isvc: dict) -> Status:
    """InferenceService status state machine for the UI — the serving
    analogue of :func:`process_status`. Priority order mirrors the
    controller's state derivation (serving/controller.py): quarantine,
    park lifecycle, fleet queueing, readiness."""
    meta = get_meta(isvc)
    serving = deep_get(isvc, "status", "serving", default={}) or {}
    state = serving.get("state") or ""
    for c in deep_get(isvc, "status", "conditions", default=[]):
        if c.get("type") == "Degraded":
            if c.get("status") == "True":
                return Status(
                    WARNING,
                    "Reconciliation suspended after repeated errors "
                    f"({c.get('reason', 'ReconcileQuarantined')})")
            break
    if meta.get("deletionTimestamp"):
        return Status(TERMINATING, "Deleting this InferenceService.")
    if state == "Parked":
        ckpt = serving.get("parkedCheckpoint") or {}
        step = ckpt.get("step")
        return Status(
            STOPPED,
            "Scaled to zero — parked warm standby"
            + (f" (checkpoint @ step {step})" if step is not None
               else " (checkpoint saved)" if ckpt else "")
            + "; the first request restores it")
    if state == "Parking":
        return Status(WAITING, "Idle — checkpointing before scale-to-zero…")
    # Engine-v2 data-plane conditions outrank the steady
    # states below: a Ready service that is swapping models or queueing
    # requests behind KV-cache pressure should say so, not "Serving".
    swap = serving.get("modelSwap") or {}
    if swap.get("model"):
        if swap.get("warm"):
            return Status(
                WAITING,
                f"Swapping model {swap['model']} "
                "(warm standby, weights resident)")
        return Status(
            WAITING,
            f"Swapping model {swap['model']} (cold: init + compile)")
    kv = serving.get("kvPressure") or {}
    blocks_short = kv.get("blocksShort") or 0
    if blocks_short > 0:
        return Status(
            WAITING,
            f"Queued behind KV-cache pressure ({blocks_short} "
            "blocks short)")
    if state == "Queued":
        return Status(
            WAITING,
            f"All {serving.get('queuedReplicas', 0)} replica(s) queued "
            "for GPU capacity")
    if state == "Scaling":
        queued = serving.get("queuedReplicas", 0)
        note = (f"; {queued} replica(s) queued for GPU capacity"
                if queued else "")
        ready = deep_get(isvc, "status", "readyReplicas", default=0) or 0
        return Status(
            WAITING,
            f"Scaling to {serving.get('desiredReplicas', 0)} replica(s) "
            f"({ready} worker(s) ready{note})")
    if state == "Ready":
        n = serving.get("admittedReplicas", 0)
        return Status(READY,
                      f"Serving ({n} replica(s), "
                      f"{deep_get(isvc, 'status', 'readyReplicas', default=0) or 0} "
                      "worker(s) ready)")
    if _age_seconds(isvc) <= 10:
        return Status(WAITING, "Waiting for the serving controller.")
    return Status(WARNING,
                  "Couldn't find any information for the status of this "
                  "InferenceService.")


async def events_for(kube, namespace: str, name: str, kinds: tuple) -> list[dict]:
    """One Event list call filtered to the involved object — shared by the
    per-app events routes (JWA pod/CR events, VWA pvc_events, TWA
    tensorboard_events) so involvedObject matching evolves in one place."""
    return [
        ev for ev in await kube.list("Event", namespace)
        if (ev.get("involvedObject") or {}).get("name") == name
        and (ev.get("involvedObject") or {}).get("kind") in kinds
    ]
