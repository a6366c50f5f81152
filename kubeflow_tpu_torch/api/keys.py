"""Single source of truth for every ``*.kubeflow.org``-domain key.

Annotation and label keys ARE the control plane's wire protocol: the
migration drain handshake, scheduler verdicts, serving park states and
the SDK's acks all ride CR annotations. Before this registry these literals
were scattered across api/controllers/scheduler/migration/serving — the
drift class behind several hardening fixes (a consumer typo
breaks the handshake with no error anywhere). Now:

- the ``annotation-keys`` pass (``ci/analysis/passes/keys.py``) rejects
  any kubeflow.org-domain string literal OUTSIDE this module, so a typo
  is an ``ImportError`` and a rename touches one line;
- this module imports nothing, so every layer (including the in-pod
  SDK) can import it without cycles.

Naming: ``<OWNER>_<WHAT>``; the semantic commentary for each key stays
with its subsystem's re-export (api/notebook.py, api/inferenceservice.py)
— this file is the registry, not the documentation.

The port's copy of ``kubeflow_tpu/api/keys.py``: it keeps its own so that
it imports nothing of the JAX package.
"""

from __future__ import annotations

# ---- API group + versions ----------------------------------------------------

GROUP = "kubeflow.org"
API_V1 = "kubeflow.org/v1"
API_V1BETA1 = "kubeflow.org/v1beta1"
API_V1ALPHA1 = "kubeflow.org/v1alpha1"
TENSORBOARD_API_V1ALPHA1 = "tensorboard.kubeflow.org/v1alpha1"
# The SDK's in-cluster CR endpoint prefix (sdk.py builds
# ``https://<apiserver>/apis/kubeflow.org/v1/namespaces/<ns>/notebooks/...``).
NOTEBOOKS_API_PATH_PREFIX = "/apis/kubeflow.org/v1/namespaces/"

# ---- workload classing (shared notebook/serving) -----------------------------

WORKLOAD_CLASS_LABEL = "kubeflow.org/workload-class"

# ---- notebooks.kubeflow.org: Notebook CR contract ----------------------------

NOTEBOOK_LAST_ACTIVITY = "notebooks.kubeflow.org/last-activity"
NOTEBOOK_LAST_ACTIVITY_CHECK_TIMESTAMP = (
    "notebooks.kubeflow.org/last_activity_check_timestamp")
NOTEBOOK_HTTP_REWRITE_URI = "notebooks.kubeflow.org/http-rewrite-uri"
NOTEBOOK_HTTP_HEADERS_REQUEST_SET = (
    "notebooks.kubeflow.org/http-headers-request-set")
NOTEBOOK_SERVER_TYPE = "notebooks.kubeflow.org/server-type"
NOTEBOOK_CREATOR = "notebooks.kubeflow.org/creator"
NOTEBOOK_LAST_IMAGE_SELECTION = "notebooks.kubeflow.org/last-image-selection"
NOTEBOOK_RESTART = "notebooks.kubeflow.org/restart"
NOTEBOOK_UPDATE_PENDING = "notebooks.kubeflow.org/update-pending"
NOTEBOOK_MAINTENANCE_PENDING = "notebooks.kubeflow.org/maintenance-pending"
NOTEBOOK_INJECT_AUTH_PROXY = "notebooks.kubeflow.org/inject-auth-proxy"
NOTEBOOK_SLICE_RESTART_ATTEMPTS = (
    "notebooks.kubeflow.org/slice-restart-attempts")
NOTEBOOK_SLICE_RESTART_AT = "notebooks.kubeflow.org/slice-restart-at"

# Fleet-scheduler verdicts:
NOTEBOOK_PRIORITY = "notebooks.kubeflow.org/priority"
NOTEBOOK_ADMITTED_AT = "notebooks.kubeflow.org/admitted-at"
NOTEBOOK_PREEMPTED = "notebooks.kubeflow.org/preempted"
NOTEBOOK_FLEX_POOL = "notebooks.kubeflow.org/flex-pool"

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
# checkpointed-at marks the snapshot ack (chips can free), committed-at
# marks the durable upload landing. committed-for echoes the raw
# drain-requested value (same clock-skew-immune echo as checkpointed-for);
# commit-dirty records a hard stop that caught the upload still in
# flight; upload-progress is the JWA-facing "k/N chunks"; restore-tier
# records which tier served the last restore (staging vs remote).
NOTEBOOK_CHECKPOINT_COMMITTED_AT = \
    "notebooks.kubeflow.org/checkpoint-committed-at"
NOTEBOOK_CHECKPOINT_COMMITTED_FOR = \
    "notebooks.kubeflow.org/checkpoint-committed-for"
NOTEBOOK_CHECKPOINT_COMMIT_DIRTY = \
    "notebooks.kubeflow.org/checkpoint-commit-dirty"
NOTEBOOK_CHECKPOINT_PROGRESS = \
    "notebooks.kubeflow.org/checkpoint-upload-progress"
NOTEBOOK_RESTORE_TIER = "notebooks.kubeflow.org/restore-tier"

# Durable lifecycle timeline (runtime/timeline.py): the compact
# capped journal of lifecycle transitions that survives manager restarts.
NOTEBOOK_TIMELINE = "notebooks.kubeflow.org/timeline"

# Step-level training telemetry (telemetry/publisher.py): the
# compact capped rolling-window summary the SDK publishes from inside
# the training loop — step/MFU/overlap/HBM — read by the controller
# status fold, JWA, and the scheduler's efficiency ledger. Single
# writer: telemetry/publisher.py.
NOTEBOOK_TPU_TELEMETRY = "notebooks.kubeflow.org/tpu-telemetry"

# Warm pod pools (controllers/warmpool.py): the claim verdict
# stamped on a Notebook that adopted a pre-warmed pod instead of paying
# the cold pod+runtime start — pod name, when, and how long the claim
# took from the startup episode's start (JWA's "claimed in Xs").
NOTEBOOK_WARM_CLAIMED = "notebooks.kubeflow.org/warm-claimed"
NOTEBOOK_WARM_CLAIMED_AT = "notebooks.kubeflow.org/warm-claimed-at"
NOTEBOOK_WARM_CLAIMED_IN = "notebooks.kubeflow.org/warm-claimed-in"

# ---- tpu.kubeflow.org: pod-template TPU wiring -------------------------------

TPU_ACCELERATOR = "tpu.kubeflow.org/accelerator"
TPU_TOPOLOGY = "tpu.kubeflow.org/topology"
TPU_SLICE_ID = "tpu.kubeflow.org/slice-id"
TPU_NUM_SLICES = "tpu.kubeflow.org/num-slices"
TPU_SLICE_LABEL = "tpu.kubeflow.org/slice"
# Elastic scale-up intents: labels marking OUR ProvisioningRequest
# CRs (the janitor keys on them — a notebook named pool-scale-up-* has a
# capacity PR with a matching name prefix but no scale-up label).
TPU_SCALE_UP_ACCELERATOR = "tpu.kubeflow.org/scale-up-accelerator"
TPU_SCALE_UP_TOPOLOGY = "tpu.kubeflow.org/scale-up-topology"

# Warm pod pools: the pool label every warm slot StatefulSet
# and pod carries (value = pool slug), and the CAS-style claim annotation
# the claim protocol stamps on a warm pod — value "<ns>/<name>/<nonce>";
# a claimer that reads back a value it did not write LOST the race and
# must pick another pod, so two reconcilers can never adopt one pod.
TPU_WARM_POOL_LABEL = "tpu.kubeflow.org/warm-pool"
TPU_WARM_CLAIM = "tpu.kubeflow.org/warm-claim"

# ---- serving.kubeflow.org: InferenceService contract -----------------

SERVING_SERVICE_LABEL = "serving.kubeflow.org/inference-service"
SERVING_REPLICA_STS_LABEL = "serving.kubeflow.org/replica-sts"
SERVING_OBSERVED_RATE = "serving.kubeflow.org/observed-rate"
SERVING_OBSERVED_INFLIGHT = "serving.kubeflow.org/observed-inflight"
SERVING_LAST_REQUEST_AT = "serving.kubeflow.org/last-request-at"
SERVING_PARK_REQUESTED = "serving.kubeflow.org/park-requested"
SERVING_PARKED_AT = "serving.kubeflow.org/parked-at"
SERVING_PARK_CHECKPOINT_PATH = "serving.kubeflow.org/parked-checkpoint-path"
SERVING_PARK_CHECKPOINT_STEP = "serving.kubeflow.org/parked-checkpoint-step"
SERVING_PARK_CHECKPOINT_FOR = "serving.kubeflow.org/parked-checkpoint-for"
SERVING_FLEX_POOL_PREFIX = "serving.kubeflow.org/flex-pool-r"
SERVING_PRIORITY = "serving.kubeflow.org/priority"

# Serving engine v2: data-plane pressure + multiplexing
# surfaces. ``kv-blocks-short`` is the head-of-queue KV-cache shortfall
# the gateway stamps from the engine's debug payload (the k the JWA
# renders as "Queued behind KV-cache pressure (k blocks short)").
# ``model-swap`` carries the model id mid-swap and ``model-swap-warm``
# whether it comes from a warm standby (device transfer) or a cold
# init+compile. ``model-rate-<model>`` is the per-model observed
# request rate — the multiplexing load breakdown the autoscaler sums
# when the aggregate rate annotation is missing and the JWA shows.
SERVING_KV_BLOCKS_SHORT = "serving.kubeflow.org/kv-blocks-short"
SERVING_MODEL_SWAP = "serving.kubeflow.org/model-swap"
SERVING_MODEL_SWAP_WARM = "serving.kubeflow.org/model-swap-warm"
SERVING_MODEL_RATE_PREFIX = "serving.kubeflow.org/model-rate-"

# ---- sharding.kubeflow.org: shard ring rebalance protocol ---------
#
# Stamped on a shard's Lease (metadata.annotations) by a replica whose
# PREFERRED shard is held by someone else: ``"<identity> <micro-stamp>"``.
# The holder honors a claim younger than lease_seconds by releasing the
# shard (demand-driven handback); a stale claim — its stamper died —
# is ignored, so rebalance never churns toward a dead replica.
SHARD_PREFERRED_CLAIM = "sharding.kubeflow.org/preferred-claim"
