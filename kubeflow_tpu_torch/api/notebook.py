"""Notebook CRD semantics: the port of ``kubeflow_tpu/api/notebook.py``.

Reference shape: ``notebook-controller/api/v1/notebook_types.go:27-76`` — the
spec wraps a literal ``corev1.PodSpec`` (``spec.template.spec``), which is the
cross-layer contract every other component composes against (SURVEY.md §1).

The accelerator block is ``spec.gpu``, the counterpart of the JAX
package's ``spec.tpu`` with the same four fields and meanings::

    spec:
      gpu:
        accelerator: nvidia-h100-80gb   # a gpu/topology.ACCELERATORS key
        topology: "2x8"                 # <nodes>x<gpus per node>
        numSlices: 2                    # optional, identical slices
        queuedProvisioning: true        # optional, a ProvisioningRequest
      template:
        spec: {containers: [...]}   # literal PodSpec

Everything accelerator-specific is derived from (accelerator, topology) via
``kubeflow_tpu_torch.gpu.topology.GpuSlice``. A ``spec.tpu`` block names
TPU generations this control plane cannot place, so :func:`validate`
refuses it rather than spawn the notebook without its accelerator. The
pod-template annotation and label keys stay ``tpu.kubeflow.org/*``: they
are the wire between the controller and the per-ordinal webhook
(``api/keys.py``).
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of
from kubeflow_tpu_torch.gpu.topology import GpuSlice, MultiSlice, TopologyError

GROUP = keys.GROUP
KIND = "Notebook"
API_VERSION = keys.API_V1

# Version lineage, mirroring the reference which serves v1 (storage),
# v1beta1, and v1alpha1 with structurally identical schemas
# (notebook-controller/api/{v1,v1beta1,v1alpha1}/notebook_types.go — the
# only diffs are package names and kubebuilder markers; conversion is the
# hub/spoke no-op of api/v1beta1/notebook_conversion.go). Keeping the old
# versions served makes ``kubectl apply`` of existing kubeflow manifests
# work unchanged (docs/migration.md's wire-compat claim).
STORAGE_API_VERSION = API_VERSION
SERVED_API_VERSIONS = (
    keys.API_V1,
    keys.API_V1BETA1,
    keys.API_V1ALPHA1,
)


def convert(notebook: dict, to_api_version: str) -> dict:
    """Convert a Notebook between served versions (identity rewrite — see
    kubeflow_tpu_torch.api.convert for why)."""
    from kubeflow_tpu_torch.api.convert import identity_convert

    return identity_convert(notebook, to_api_version,
                            served=SERVED_API_VERSIONS,
                            storage=STORAGE_API_VERSION, kind=KIND)

# Annotation/label contract — kept wire-compatible with the reference so
# existing tooling (and muscle memory) carries over:
STOP_ANNOTATION = "kubeflow-resource-stopped"          # notebook_controller.go:410
LAST_ACTIVITY_ANNOTATION = keys.NOTEBOOK_LAST_ACTIVITY
LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION = (
    keys.NOTEBOOK_LAST_ACTIVITY_CHECK_TIMESTAMP
)
NOTEBOOK_NAME_LABEL = "notebook-name"                  # notebook_controller.go:430
ANNOTATION_REWRITE_URI = keys.NOTEBOOK_HTTP_REWRITE_URI
ANNOTATION_HEADERS_REQUEST_SET = keys.NOTEBOOK_HTTP_HEADERS_REQUEST_SET
SERVER_TYPE_ANNOTATION = keys.NOTEBOOK_SERVER_TYPE
CREATOR_ANNOTATION = keys.NOTEBOOK_CREATOR
# Spawner's image pick, resolved to a pinned reference at admission by the
# catalog ConfigMap (odh's last-image-selection, notebook_webhook.go:556).
IMAGE_SELECTION_ANNOTATION = keys.NOTEBOOK_LAST_IMAGE_SELECTION

# Restart protocol (reference: culler pkg + odh webhook "update-pending"):
RESTART_ANNOTATION = keys.NOTEBOOK_RESTART
# Stamped by the restart-blocking webhook when a live pod-affecting edit
# was reverted (webhooks/notebook.py); read by the status machine.
UPDATE_PENDING_ANNOTATION = keys.NOTEBOOK_UPDATE_PENDING

# Controller-mirrored impending-maintenance signal: comma-joined nodes
# hosting this notebook's GPU workers that carry a maintenance taint
# (controllers/notebook.py _check_maintenance). Read by the status
# machine and by in-notebook tooling that wants to checkpoint early.
MAINTENANCE_ANNOTATION = keys.NOTEBOOK_MAINTENANCE_PENDING

# Fleet-scheduler contract (kubeflow_tpu/scheduler/):
# - priority class ("low"|"normal"|"high"|"critical" or an int) the user
#   sets on the CR; read at gang admission;
PRIORITY_ANNOTATION = keys.NOTEBOOK_PRIORITY
# - stamped by the scheduler when the gang is admitted; culling floors
#   its idle clock on it (a notebook that queued for hours must not be
#   culled seconds after it finally starts), and the scheduler's idle-
#   preemption ranking reads it back;
SCHEDULER_ADMITTED_AT_ANNOTATION = keys.NOTEBOOK_ADMITTED_AT
# - stamped (with the reason) alongside the stop annotation when the
#   scheduler preempts the gang; cleared on re-admission.
PREEMPTED_ANNOTATION = keys.NOTEBOOK_PREEMPTED
# - elastic flex placement (scheduler/elastic.py): the foreign pool this
#   gang borrows a host from, stamped at admission and cleared on a
#   native admission/release. A controller restart reads it to restore
#   the BORROW booking (re-seating natively would resell the host its
#   pods still occupy and flip their node selectors).
FLEX_POOL_ANNOTATION = keys.NOTEBOOK_FLEX_POOL

# Migration contract (kubeflow_tpu/migration/protocol.py): preemption,
# culling, and user suspend all speak one drain protocol — request a
# checkpoint, wait for the in-pod SDK's ack, then park. The SDK reads
# these through the same in-cluster CR fetch as MAINTENANCE_ANNOTATION.
# - stamped (ISO time) by whoever wants the gang parked; the SDK polls
#   it and checkpoints when it appears;
DRAIN_REQUESTED_ANNOTATION = keys.NOTEBOOK_DRAIN_REQUESTED
# - why the drain was requested: "preempt:idle" | "preempt:priority" |
#   "spot-reclaim" | "defrag" | "cull" | "suspend" — the finalizer
#   (scheduler, elastic runtime, culler, notebook controller) only acts
#   on its own reasons;
DRAIN_REASON_ANNOTATION = keys.NOTEBOOK_DRAIN_REASON
# - SDK progress marks: snapshot started / committed. An ack echoes the
#   drain request it answers (checkpointed-for = the raw drain-requested
#   value), so ack detection never compares timestamps stamped by two
#   different clocks (controller vs pod).
CHECKPOINTING_AT_ANNOTATION = keys.NOTEBOOK_CHECKPOINTING_AT
CHECKPOINTED_AT_ANNOTATION = keys.NOTEBOOK_CHECKPOINTED_AT
CHECKPOINTED_FOR_ANNOTATION = keys.NOTEBOOK_CHECKPOINTED_FOR
# - the durable restore hint the controller turns into pod env
#   (KFTPU_RESTORE_CHECKPOINT_PATH / KFTPU_RESTORE_STEP) on re-admission.
CHECKPOINT_PATH_ANNOTATION = keys.NOTEBOOK_CHECKPOINT_PATH
CHECKPOINT_STEP_ANNOTATION = keys.NOTEBOOK_CHECKPOINT_STEP
# - the checkpoint fabric's commit half: checkpointed-at is
#   the snapshot ack (drain can finalize), committed-at is the durable
#   upload landing; committed-for echoes the drain-requested value the
#   commit answers; commit-dirty marks a hard stop that interrupted the
#   upload; upload-progress ("k/N") and restore-tier feed JWA status.
CHECKPOINT_COMMITTED_AT_ANNOTATION = keys.NOTEBOOK_CHECKPOINT_COMMITTED_AT
CHECKPOINT_COMMITTED_FOR_ANNOTATION = keys.NOTEBOOK_CHECKPOINT_COMMITTED_FOR
CHECKPOINT_COMMIT_DIRTY_ANNOTATION = keys.NOTEBOOK_CHECKPOINT_COMMIT_DIRTY
CHECKPOINT_PROGRESS_ANNOTATION = keys.NOTEBOOK_CHECKPOINT_PROGRESS
RESTORE_TIER_ANNOTATION = keys.NOTEBOOK_RESTORE_TIER
# - user-facing suspend/resume: present → drain-then-park; removed →
#   un-park and restore. Set by kubectl/JWA or sdk.suspend().
SUSPEND_ANNOTATION = keys.NOTEBOOK_SUSPEND

# Durable lifecycle timeline (runtime/timeline.py): compact capped
# journal of lifecycle transitions (Queued→Admitted→Ready→…), persisted
# on the CR so it survives manager restarts; /debug/timeline reads it.
TIMELINE_ANNOTATION = keys.NOTEBOOK_TIMELINE

# Warm pod pools (controllers/warmpool.py): stamped by the claim protocol
# when this notebook adopted a pre-warmed pod instead of creating slice
# StatefulSets — the claimed pod's name, the claim time, and how many
# seconds the claim took from the startup episode's start. Cleared on
# stop (a restart claims fresh) and when the claimed pod is lost (the
# reconcile falls back to the cold path transparently).
WARM_CLAIMED_ANNOTATION = keys.NOTEBOOK_WARM_CLAIMED
WARM_CLAIMED_AT_ANNOTATION = keys.NOTEBOOK_WARM_CLAIMED_AT
WARM_CLAIMED_IN_ANNOTATION = keys.NOTEBOOK_WARM_CLAIMED_IN

# Pod-template annotations the controller stamps so pod-level admission can
# compute per-node GPU env as a pure function of the pod (webhooks/gpu.py).
TPU_ACCELERATOR_ANNOTATION = keys.TPU_ACCELERATOR
TPU_TOPOLOGY_ANNOTATION = keys.TPU_TOPOLOGY
# Multislice: stamped per-StatefulSet so the pod webhook can compute the
# global PET_NODE_RANK (= sliceId·nodesPerSlice + ordinal) at admission.
TPU_SLICE_ID_ANNOTATION = keys.TPU_SLICE_ID
TPU_NUM_SLICES_ANNOTATION = keys.TPU_NUM_SLICES
# Pod-template label marking slice workers; the admission registration keys
# a failurePolicy:Fail objectSelector on it (labels, not annotations, are
# what objectSelector can match).
TPU_SLICE_LABEL = keys.TPU_SLICE_LABEL

PREFIX_ENV_VAR = "NB_PREFIX"                           # notebook_controller.go:56
DEFAULT_CONTAINER_PORT = 8888
SERVICE_PORT = 80


def new(
    name: str,
    namespace: str,
    *,
    image: str = "kubeflow-tpu/jupyter-jax:latest",
    accelerator: str | None = None,
    topology: str | None = None,
    num_slices: int | None = None,
    queued: bool = False,
    pod_spec: dict | None = None,
) -> dict:
    """Convenience constructor used by tests, the web app, and the load test."""
    spec: dict = {"template": {"spec": pod_spec or {
        "containers": [{"name": name, "image": image}],
    }}}
    if accelerator:
        spec["gpu"] = {"accelerator": accelerator, "topology": topology or "1x1"}
        if num_slices and num_slices > 1:
            spec["gpu"]["numSlices"] = num_slices
        if queued:
            spec["gpu"]["queuedProvisioning"] = True
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name, "namespace": namespace},
        "spec": spec,
    }


def pod_spec_of(notebook: dict) -> dict:
    """The literal PodSpec the whole stack composes against."""
    return deep_get(notebook, "spec", "template", "spec", default={}) or {}


def gpu_spec_of(notebook: dict) -> dict | None:
    return deep_get(notebook, "spec", "gpu")


def queued_provisioning(notebook: dict) -> bool:
    """spec.gpu.queuedProvisioning: gate slice creation on a GKE
    ProvisioningRequest reserving the whole slice's capacity first
    (queued-provisioning.gke.io) — large slices are scarce, and a
    half-scheduled gang burns quota while it waits."""
    return bool((gpu_spec_of(notebook) or {}).get("queuedProvisioning"))


def gpu_slice_of(notebook: dict) -> GpuSlice | None:
    """Resolve spec.gpu → GpuSlice; None when the notebook is CPU-only.

    Raises Invalid for a malformed gpu block (surface at admission time).
    """
    gpu = gpu_spec_of(notebook)
    if not gpu:
        return None
    try:
        return GpuSlice.parse(
            str(gpu.get("accelerator", "")), str(gpu.get("topology", ""))
        )
    except TopologyError as e:
        raise Invalid(f"Notebook {name_of(notebook)}: invalid spec.gpu: {e}") from e


def multi_slice_of(notebook: dict) -> MultiSlice | None:
    """Resolve spec.gpu → MultiSlice (``numSlices`` ≥ 1 identical slices
    joined over the data-center network); None when the notebook is
    CPU-only. Single-slice notebooks get ``num_slices=1`` — callers
    branch on ``.multi``."""
    gpu = gpu_spec_of(notebook)
    if not gpu:
        return None
    try:
        return MultiSlice.parse(
            str(gpu.get("accelerator", "")), str(gpu.get("topology", "")),
            gpu.get("numSlices", 1),  # parse() rejects non-ints with the
        )                             # actual offending value in the message
    except TopologyError as e:
        raise Invalid(f"Notebook {name_of(notebook)}: invalid spec.gpu: {e}") from e


def is_stopped(notebook: dict) -> bool:
    return STOP_ANNOTATION in (get_meta(notebook).get("annotations") or {})


def default(notebook: dict) -> None:
    """Defaulting (webhook ``Default()`` equivalent): ensure a container
    exists and the first container is named after the notebook, matching the
    reference's assumption that container[0] is *the* notebook server
    (``notebook_controller.go:418-462``)."""
    spec = notebook.setdefault("spec", {})
    template = spec.setdefault("template", {})
    pod_spec = template.setdefault("spec", {})
    containers = pod_spec.setdefault("containers", [])
    if containers and not containers[0].get("name"):
        containers[0]["name"] = name_of(notebook)
    gpu = spec.get("gpu")
    if gpu is not None:
        gpu.setdefault("topology", "1x1")


def validate(notebook: dict) -> None:
    """Validation (webhook ``ValidateCreate/Update`` equivalent)."""
    name = name_of(notebook)
    if not name:
        raise Invalid("Notebook: metadata.name is required")
    if len(name) > 52:
        # StatefulSet appends "-<ordinal>" and pod hostnames must stay <63.
        raise Invalid(f"Notebook {name}: name longer than 52 characters")
    containers = deep_get(
        notebook, "spec", "template", "spec", "containers", default=[]
    )
    if not containers:
        raise Invalid(f"Notebook {name}: spec.template.spec.containers required")
    if deep_get(notebook, "spec", "tpu") is not None:
        # A TPU block asks for chips this control plane cannot place;
        # spawning the notebook without them would hide the mistake.
        raise Invalid(
            f"Notebook {name}: spec.tpu is not supported on GPU nodes — "
            "request the accelerator in spec.gpu (accelerator, topology "
            "<nodes>x<gpus per node>, numSlices, queuedProvisioning)"
        )
    multi_slice_of(notebook)  # raises Invalid on a malformed gpu block
    qp = (gpu_spec_of(notebook) or {}).get("queuedProvisioning")
    if qp is not None and not isinstance(qp, bool):
        raise Invalid(
            f"Notebook {name}: spec.gpu.queuedProvisioning must be a boolean"
        )
