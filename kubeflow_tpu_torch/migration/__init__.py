"""Preempt-to-checkpoint migration.

One drain protocol spanning scheduler → controller → pod/SDK turns every
"this gang must stop" decision — fleet preemption, idle culling, user
suspend — into checkpoint-then-park instead of a bare kill, and every
re-admission into a restore:

    Running → DrainRequested → Checkpointing → Checkpointed → Parked
                                                   │
                                  Restoring ◄──────┘ (re-admission)
                                      │
                                   Running

:mod:`kubeflow_tpu_torch.migration.protocol` is the pure core: state
derivation from CR annotations, deadline math, and the patch shapes
every participant uses. The scheduler's runtime, the notebook
controller, the culler, and the in-pod SDK all import from here so the
wire contract cannot drift between layers.

Kill switches: ``KFTPU_MIGRATION=off`` restores the pre-migration
immediate stop everywhere; ``KFTPU_CULL_DRAIN=off`` restores bare-stop
culling only. ``KFTPU_DRAIN_GRACE`` bounds how long chips wait on a
checkpoint — a victim that cannot ack within it is hard-stopped exactly
as before (chips are never held hostage).

The port's copy of ``kubeflow_tpu/migration/__init__.py``: it keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

from kubeflow_tpu_torch.migration.protocol import (  # noqa: F401
    CHECKPOINTED,
    CHECKPOINTING,
    DEFAULT_DRAIN_GRACE_SECONDS,
    DRAIN_REQUESTED,
    PARKED,
    RESTORING,
    RUNNING,
    ack_patch,
    checkpoint_step,
    checkpointed_at,
    clear_drain_patch,
    cull_drain_enabled,
    derive_state,
    drain_acked,
    drain_deadline,
    drain_expired,
    drain_grace_seconds,
    drain_reason,
    drain_requested_at,
    migration_enabled,
    request_drain_patch,
    restore_hint,
)
