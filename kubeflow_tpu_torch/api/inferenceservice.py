"""InferenceService CRD semantics — the serving workload class: the port
of ``kubeflow_tpu/api/inferenceservice.py``.

An InferenceService is N **replicas**, each a whole GPU slice gang
admitted through the fleet scheduler exactly like a notebook's
MultiSlice — but scaled like a *service*: a request-rate autoscaler
(kubeflow_tpu_torch/serving/autoscaler.py) moves the replica count
between ``minReplicas`` and ``maxReplicas``, and with ``minReplicas: 0``
the service parks to zero with a checkpoint as a warm standby::

    spec:
      gpu:
        accelerator: nvidia-h100-80gb   # a gpu/topology.ACCELERATORS key
        topology: "1x1"                 # per-replica <nodes>x<gpus per node>
        numSlices: 1                    # slices per replica
      model:
        name: my-model
        checkpointPath: /models/my-model   # initial weights
      template:
        spec: {containers: [...]}   # literal PodSpec (the serving server)
      scaling:
        minReplicas: 0
        maxReplicas: 4
        targetRequestsPerReplica: 8
        scaleToZeroAfterSeconds: 300

Everything accelerator-specific derives from the same
``kubeflow_tpu_torch.gpu.topology`` library as Notebooks; replica ``i``'s
slice ``j`` materialises as StatefulSet ``<name>-r<i>`` (single slice)
or ``<name>-r<i>-s<j>``. A ``spec.tpu`` block names TPU generations this
control plane cannot place, so :func:`validate` refuses it, as the
Notebook's does.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.gpu.topology import MultiSlice, TopologyError
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta, name_of

GROUP = keys.GROUP
KIND = "InferenceService"
API_VERSION = keys.API_V1

# ---- workload-class contract ---------------------------------------------------
# The one label every layer keys the notebook/serving distinction on. The
# culler and the scheduler's victim search must never treat a serving
# workload as an idle notebook: serving pods expose no Jupyter activity
# signal, so "no kernels" would read as "idle forever" and the service
# would be culled/preempted precisely when it is busiest.
WORKLOAD_CLASS_LABEL = keys.WORKLOAD_CLASS_LABEL
SERVING_CLASS = "serving"
NOTEBOOK_CLASS = "notebook"

# Replica STS/pod label (the Service selects on it).
SERVICE_LABEL = keys.SERVING_SERVICE_LABEL

# ---- annotation contract -------------------------------------------------------
# Observed-load signals, stamped by the serving gateway / load generator;
# the autoscaler reads them — the CR is the wire between the data plane
# and the control plane, same pattern as the culler's last-activity
# annotation.
OBSERVED_RATE_ANNOTATION = keys.SERVING_OBSERVED_RATE
OBSERVED_INFLIGHT_ANNOTATION = keys.SERVING_OBSERVED_INFLIGHT
LAST_REQUEST_AT_ANNOTATION = keys.SERVING_LAST_REQUEST_AT

# Park protocol (scale-to-zero over the drain idiom): the controller
# requests a checkpoint, the serving engine acks with the committed
# path/step, and only then do the replicas scale to zero. The parked
# checkpoint is the warm-standby restore hint — scale-from-zero stamps it
# back into the pod env (KFTPU_RESTORE_*) so the first burst restores
# instead of cold-starting.
PARK_REQUESTED_ANNOTATION = keys.SERVING_PARK_REQUESTED
PARKED_AT_ANNOTATION = keys.SERVING_PARKED_AT
PARK_CHECKPOINT_PATH_ANNOTATION = keys.SERVING_PARK_CHECKPOINT_PATH
PARK_CHECKPOINT_STEP_ANNOTATION = keys.SERVING_PARK_CHECKPOINT_STEP
# The ack's echo of the park request it answers (the raw park-requested
# value) — same clock-skew-immune correlation as the migration
# protocol's checkpointed-for: the checkpoint path/step survive as the
# warm-restore hint across cycles, so WITHOUT the echo a second idle
# spell would instant-park off the previous cycle's stale checkpoint
# and silently drop everything served since.
PARK_CHECKPOINT_FOR_ANNOTATION = keys.SERVING_PARK_CHECKPOINT_FOR

# Per-replica durable flex marker (the serving analogue of the notebook
# FLEX_POOL_ANNOTATION): `<prefix><i>` names the foreign pool replica i
# borrows a node from. A controller restart reads it to restore the
# BORROW booking instead of re-seating the replica natively under its
# running pods.
FLEX_POOL_ANNOTATION_PREFIX = keys.SERVING_FLEX_POOL_PREFIX

# Serving-class priority for fleet admission ("low"|"normal"|"high"|
# "critical" or an int; default "high" — an always-on service outranks
# interactive notebooks and reclaims idle ones through the drain
# protocol, never the other way around).
PRIORITY_ANNOTATION = keys.SERVING_PRIORITY

# Serving engine data-plane surfaces: KV-cache shortfall, in-flight
# model swap (+ warm/cold kind), and the per-model observed rate
# breakdown — stamped by the gateway from the engine's debug payload,
# read by the controller's status fold and the autoscaler.
KV_BLOCKS_SHORT_ANNOTATION = keys.SERVING_KV_BLOCKS_SHORT
MODEL_SWAP_ANNOTATION = keys.SERVING_MODEL_SWAP
MODEL_SWAP_WARM_ANNOTATION = keys.SERVING_MODEL_SWAP_WARM
MODEL_RATE_ANNOTATION_PREFIX = keys.SERVING_MODEL_RATE_PREFIX

SERVICE_PORT = 80
DEFAULT_CONTAINER_PORT = 8000


def model_rates(annotations: dict) -> dict:
    """Parse the per-model observed-rate annotations
    (``model-rate-<model>: <req/s>``) into ``{model: rate}`` — the
    multiplexing load breakdown. Unparseable values are dropped, not
    raised: load annotations are gateway-stamped wire data."""
    rates: dict = {}
    prefix = MODEL_RATE_ANNOTATION_PREFIX
    for key, raw in (annotations or {}).items():
        if not key.startswith(prefix):
            continue
        model = key[len(prefix):]
        if not model:
            continue
        try:
            value = float(raw)
        except (TypeError, ValueError):
            continue
        if value >= 0:
            rates[model] = value
    return rates


def new(
    name: str,
    namespace: str,
    *,
    image: str = "kubeflow-tpu/jax-serve:latest",
    accelerator: str = "nvidia-h100-80gb",
    topology: str = "1x1",
    num_slices: int = 1,
    min_replicas: int = 0,
    max_replicas: int = 1,
    target_rate: float | None = None,
    scale_to_zero_after: float | None = None,
    checkpoint_path: str | None = None,
    pod_spec: dict | None = None,
) -> dict:
    """Convenience constructor used by tests and the smoke script. The
    default image is the reference's string: the repo builds no CUDA
    serving image."""
    scaling: dict = {"minReplicas": min_replicas, "maxReplicas": max_replicas}
    if target_rate is not None:
        scaling["targetRequestsPerReplica"] = target_rate
    if scale_to_zero_after is not None:
        scaling["scaleToZeroAfterSeconds"] = scale_to_zero_after
    spec: dict = {
        "gpu": {"accelerator": accelerator, "topology": topology},
        "scaling": scaling,
        "template": {"spec": pod_spec or {
            "containers": [{"name": name, "image": image}],
        }},
    }
    if num_slices > 1:
        spec["gpu"]["numSlices"] = num_slices
    if checkpoint_path:
        spec["model"] = {"name": name, "checkpointPath": checkpoint_path}
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {
            "name": name, "namespace": namespace,
            "labels": {WORKLOAD_CLASS_LABEL: SERVING_CLASS},
        },
        "spec": spec,
    }


def pod_spec_of(isvc: dict) -> dict:
    return deep_get(isvc, "spec", "template", "spec", default={}) or {}


def gpu_spec_of(isvc: dict) -> dict | None:
    return deep_get(isvc, "spec", "gpu")


def scaling_of(isvc: dict) -> dict:
    return deep_get(isvc, "spec", "scaling", default={}) or {}


def min_replicas(isvc: dict) -> int:
    try:
        return max(0, int(scaling_of(isvc).get("minReplicas", 0) or 0))
    except (TypeError, ValueError):
        return 0  # validate() rejects garbage at admission; stay safe
                  # for CRs that predate the webhook


def max_replicas(isvc: dict) -> int:
    try:
        return max(1, int(scaling_of(isvc).get("maxReplicas", 1) or 1))
    except (TypeError, ValueError):
        return 1


def multi_slice_of(isvc: dict) -> MultiSlice | None:
    """Resolve one REPLICA's spec.gpu → MultiSlice; None for a CPU-only
    service. Raises Invalid on a malformed block (surface at admission)."""
    gpu = gpu_spec_of(isvc)
    if not gpu:
        return None
    try:
        return MultiSlice.parse(
            str(gpu.get("accelerator", "")), str(gpu.get("topology", "")),
            gpu.get("numSlices", 1),
        )
    except TopologyError as e:
        raise Invalid(
            f"InferenceService {name_of(isvc)}: invalid spec.gpu: {e}"
        ) from e


def replica_sts_name(name: str, replica: int, *, slice_id: int = 0,
                     num_slices: int = 1) -> str:
    """Replica ``i``'s slice ``j`` StatefulSet. Single-slice replicas keep
    the short ``<name>-r<i>`` name (zero churn for the common case)."""
    base = f"{name}-r{replica}"
    return base if num_slices <= 1 else f"{base}-s{slice_id}"


def replica_key(namespace: str, name: str, replica: int) -> tuple:
    """A replica's gang key in the shared fleet scheduler. The ``#`` makes
    the key name an impossible Kubernetes object name, so a serving
    replica can never alias a Notebook CR in the scheduler's ledger or
    its annotation side effects."""
    return (namespace, f"{name}#r{replica}")


def parse_replica_key(key: tuple) -> tuple[str, int] | None:
    """(service name, replica index) for a serving replica key, else None."""
    name = key[1]
    if "#r" not in name:
        return None
    base, _, idx = name.rpartition("#r")
    try:
        return base, int(idx)
    except ValueError:
        return None


def parked_checkpoint(annotations: dict) -> tuple[str, int | None] | None:
    """(path, step) of the parked warm-standby checkpoint, or None."""
    path = annotations.get(PARK_CHECKPOINT_PATH_ANNOTATION)
    if not path:
        return None
    step = annotations.get(PARK_CHECKPOINT_STEP_ANNOTATION)
    try:
        return path, int(step) if step is not None else None
    except ValueError:
        return path, None


def park_acked(annotations: dict) -> bool:
    """Has the engine committed a checkpoint for the CURRENT park
    request? The ack must echo the raw park-requested value it answers
    (``parked-checkpoint-for``) — a surviving checkpoint from a previous
    cycle must never instant-ack a new park."""
    requested = annotations.get(PARK_REQUESTED_ANNOTATION)
    if not requested:
        return False
    if parked_checkpoint(annotations) is None:
        return False
    return annotations.get(PARK_CHECKPOINT_FOR_ANNOTATION) == requested


def default(isvc: dict) -> None:
    """Defaulting (webhook ``Default()`` equivalent): workload-class
    label, container name, topology, scaling bounds."""
    meta = isvc.setdefault("metadata", {})
    labels = meta.setdefault("labels", {})
    labels.setdefault(WORKLOAD_CLASS_LABEL, SERVING_CLASS)
    spec = isvc.setdefault("spec", {})
    template = spec.setdefault("template", {})
    pod_spec = template.setdefault("spec", {})
    containers = pod_spec.setdefault("containers", [])
    if containers and not containers[0].get("name"):
        containers[0]["name"] = name_of(isvc)
    gpu = spec.get("gpu")
    if gpu is not None:
        gpu.setdefault("topology", "1x1")
    scaling = spec.setdefault("scaling", {})
    scaling.setdefault("minReplicas", 0)
    try:
        floor = int(scaling["minReplicas"])
    except (TypeError, ValueError):
        # Garbage minReplicas must reach validate()'s actionable Invalid,
        # not crash defaulting with a raw admission 500.
        floor = 0
    scaling.setdefault("maxReplicas", max(1, floor))


def validate(isvc: dict) -> None:
    """Validation (webhook ``ValidateCreate/Update`` equivalent)."""
    name = name_of(isvc)
    if not name:
        raise Invalid("InferenceService: metadata.name is required")
    if len(name) > 45:
        # "-r<i>[-s<j>]-<ordinal>" rides on top and pod hostnames must
        # stay under 63 characters.
        raise Invalid(
            f"InferenceService {name}: name longer than 45 characters")
    containers = deep_get(
        isvc, "spec", "template", "spec", "containers", default=[])
    if not containers:
        raise Invalid(
            f"InferenceService {name}: spec.template.spec.containers "
            "required")
    if deep_get(isvc, "spec", "tpu") is not None:
        # A TPU block asks for chips this control plane cannot place;
        # serving the model without them would hide the mistake.
        raise Invalid(
            f"InferenceService {name}: spec.tpu is not supported on GPU "
            "nodes — request the accelerator in spec.gpu (accelerator, "
            "topology <nodes>x<gpus per node>, numSlices)")
    multi_slice_of(isvc)  # raises Invalid on a malformed gpu block
    scaling = scaling_of(isvc)
    try:
        lo = int(scaling.get("minReplicas", 0))
        hi = int(scaling.get("maxReplicas", 1))
    except (TypeError, ValueError):
        raise Invalid(
            f"InferenceService {name}: spec.scaling.minReplicas/"
            "maxReplicas must be integers") from None
    if lo < 0:
        raise Invalid(
            f"InferenceService {name}: spec.scaling.minReplicas must be "
            ">= 0")
    if hi < 1 or hi < lo:
        raise Invalid(
            f"InferenceService {name}: spec.scaling.maxReplicas must be "
            f">= max(1, minReplicas); got min={lo} max={hi}")
    rate = scaling.get("targetRequestsPerReplica")
    if rate is not None:
        try:
            ok = float(rate) > 0
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise Invalid(
                f"InferenceService {name}: "
                "spec.scaling.targetRequestsPerReplica must be a positive "
                "number")


def is_serving_class(obj: dict) -> bool:
    """Does this object (any kind) carry the serving workload-class
    label? The culler and the victim search key their guards on this."""
    return (get_meta(obj).get("labels") or {}).get(
        WORKLOAD_CLASS_LABEL) == SERVING_CLASS
