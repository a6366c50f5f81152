"""The wire strings of ``kubeflow_tpu/api/keys.py`` that the port's SDK
sends or reads: the apiserver path of a notebook, the drain protocol's
annotation keys, and the warm-pool claim. A trimmed copy: the values are
the JAX package's (a test holds them equal)."""

NOTEBOOKS_API_PATH_PREFIX = "/apis/kubeflow.org/v1/namespaces/"

NOTEBOOK_MAINTENANCE_PENDING = "notebooks.kubeflow.org/maintenance-pending"

# Migration drain protocol — the controller↔SDK handshake:
NOTEBOOK_DRAIN_REQUESTED = "notebooks.kubeflow.org/drain-requested"
NOTEBOOK_DRAIN_REASON = "notebooks.kubeflow.org/drain-reason"
NOTEBOOK_CHECKPOINTING_AT = "notebooks.kubeflow.org/checkpointing-at"
NOTEBOOK_CHECKPOINTED_AT = "notebooks.kubeflow.org/checkpointed-at"
NOTEBOOK_CHECKPOINTED_FOR = "notebooks.kubeflow.org/checkpointed-for"
NOTEBOOK_CHECKPOINT_PATH = "notebooks.kubeflow.org/checkpoint-path"
NOTEBOOK_CHECKPOINT_STEP = "notebooks.kubeflow.org/checkpoint-step"
NOTEBOOK_SUSPEND = "notebooks.kubeflow.org/suspend"

# Checkpoint fabric — the commit half of snapshot-then-ack:
NOTEBOOK_CHECKPOINT_COMMITTED_AT = \
    "notebooks.kubeflow.org/checkpoint-committed-at"
NOTEBOOK_CHECKPOINT_COMMITTED_FOR = \
    "notebooks.kubeflow.org/checkpoint-committed-for"
NOTEBOOK_CHECKPOINT_COMMIT_DIRTY = \
    "notebooks.kubeflow.org/checkpoint-commit-dirty"
NOTEBOOK_CHECKPOINT_PROGRESS = \
    "notebooks.kubeflow.org/checkpoint-upload-progress"
NOTEBOOK_RESTORE_TIER = "notebooks.kubeflow.org/restore-tier"

# Warm pod pools: the claim the pool's claim protocol stamps on a pod.
TPU_WARM_CLAIM = "tpu.kubeflow.org/warm-claim"
