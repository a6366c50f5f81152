"""Notebook admission: defaulting + validation + restart blocking.

Restart blocking is the odh webhook's ``maybeRestartRunningNotebook``
protocol (``odh-notebook-controller/controllers/notebook_webhook.go:
312-368``): a spec edit that would restart a RUNNING notebook's pods is not
applied live — the pod-affecting fields are reverted to their current
values and the CR is annotated ``update-pending`` so the UI can show
"restart required". Edits to a *stopped* notebook apply directly (and clear
the annotation); the user's stop→start cycle is the restart consent.

On a GPU slice this matters more than it did in the reference: an
accidental restart doesn't bounce one pod, it bounces every node of the
slice and re-forms the whole ``torch.distributed`` world.

The port of ``kubeflow_tpu/webhooks/notebook.py``. Its capacity gate
checks the namespace's card quota (Profile ``spec.gpuQuota``) and the
declared GPU fleet's ceiling for the gang's shape.
"""

from __future__ import annotations

import time
import os
import weakref

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import annotations_of, deep_get, deepcopy

UPDATE_PENDING_ANNOTATION = nbapi.UPDATE_PENDING_ANNOTATION

# Fleet source knobs, shared with scheduler_options()/the scheduler
# runtime (the reference's docs/operations.md "TPU fleet scheduler"): the
# webhook reads them directly because admission runs in its own process.
FLEET_ENV = "KFTPU_FLEET"
FLEET_CONFIGMAP_ENV = "KFTPU_FLEET_CONFIGMAP"

# Spec paths whose change forces a pod restart (the template IS the pod;
# the gpu block changes replicas/selectors/env).
_POD_AFFECTING = (("spec", "template"), ("spec", "gpu"))


def _pod_affecting_changed(nb: dict, old: dict) -> bool:
    return any(
        deep_get(nb, *path) != deep_get(old, *path) for path in _POD_AFFECTING
    )


def mutate(nb: dict, info: dict) -> None:
    """Full Notebook mutator: block live restarts, default, validate."""
    # Old served versions (v1beta1/v1alpha1) are schema-identical; normalize
    # to the storage version so the rest of the stack sees one apiVersion
    # (the real apiserver does this rewrite itself for strategy:None CRD
    # conversion; the in-process fake goes through admission instead).
    if nb.get("apiVersion") in nbapi.SERVED_API_VERSIONS:
        nb["apiVersion"] = nbapi.STORAGE_API_VERSION
    old = info.get("old")
    if info.get("operation") == "UPDATE" and old is not None:
        if nbapi.is_stopped(old) or nbapi.is_stopped(nb) \
                or deep_get(old, "status", "scheduler", "state") == "Queued":
            # Stopped (or stopping) notebooks accept edits; they apply on
            # the next start. A gang Queued by the fleet scheduler has no
            # pods to protect either — and blocking spec.gpu edits there
            # would trap the user out of the remediation its own queue
            # reason suggests ("reduce spec.gpu.numSlices").
            annotations_of(nb).pop(UPDATE_PENDING_ANNOTATION, None)
        elif _pod_affecting_changed(nb, old):
            for path in _POD_AFFECTING:
                current = deep_get(old, *path)
                parent = nb.setdefault(path[0], {})
                if current is None:
                    parent.pop(path[1], None)
                else:
                    parent[path[1]] = deepcopy(current)
            annotations_of(nb)[UPDATE_PENDING_ANNOTATION] = "true"
    nbapi.default(nb)
    nbapi.validate(nb)


# ---- capacity fast-fail ------------------------------------------------------
#
# A card request that can NEVER be satisfied must die at admission with an
# actionable message, not sit in the fleet scheduler's queue (or behind a
# ResourceQuota) forever. Two ceilings are checkable synchronously:
#
# - the namespace's Profile ``spec.gpuQuota`` (the per-tenant card
#   ceiling the profile controller materialises as a ResourceQuota);
# - the configured fleet's whole-cluster capacity for the requested slice
#   shape (``KFTPU_FLEET`` — an auto-inferred fleet is deliberately NOT
#   checked here: node pools come and go, and a transient empty fleet
#   must not reject CRs that would queue and then run).
#
# CREATE-only: rejecting UPDATEs against a later-lowered ceiling would
# freeze the controller's own annotation/status patches on the CR.


async def validate_capacity(kube, nb: dict) -> None:
    """Raise Invalid when the notebook's gang can never fit."""
    ms = nbapi.multi_slice_of(nb)  # raises Invalid on a malformed block
    if ms is None:
        return
    name = deep_get(nb, "metadata", "name")
    ns = deep_get(nb, "metadata", "namespace")
    cards = ms.num_chips
    if ns and kube is not None:
        # Profiles are cluster-scoped and named after their namespace.
        # TTL-cached like the fleet ConfigMap: an admission burst must
        # not GET the same Profile once per CREATE.
        profile = await _ttl_cached(
            _profile_cache, kube, ns,
            lambda: kube.get_or_none("Profile", ns))
        quota = deep_get(profile or {}, "spec", "gpuQuota")
        if isinstance(quota, int) and not isinstance(quota, bool) \
                and cards > quota:
            raise Invalid(
                f"Notebook {name}: requests {cards} GPUs but the "
                f"namespace ceiling (Profile {ns} spec.gpuQuota) is "
                f"{quota} — shrink spec.gpu.topology/numSlices or raise "
                "the quota")
    from kubeflow_tpu_torch.scheduler import scheduler_enabled

    if not scheduler_enabled():
        # KFTPU_SCHEDULER=off must restore the pre-scheduler behavior
        # end to end: a stale KFTPU_FLEET left in the deployment env
        # must not keep rejecting CRs the capacity gate would run.
        return
    fleet = await _declared_fleet(kube)
    if fleet is not None and fleet.pools:
        acc = ms.slice.accelerator.name
        topo = ms.slice.topology_str
        ceiling = fleet.total_slices(acc, topo)
        if ceiling < ms.num_slices and not _flex_schedulable(fleet, ms):
            detail = (
                f"no configured node pool hosts {acc}:{topo} slices"
                if ceiling == 0 else
                f"the fleet holds at most {ceiling} {acc}:{topo} "
                f"slice(s), the gang needs {ms.num_slices}")
            raise Invalid(
                f"Notebook {name}: can never be scheduled — {detail}. "
                "Pick a shape from the configured fleet (KFTPU_FLEET) "
                "or reduce spec.gpu.numSlices")


def _flex_schedulable(fleet, ms) -> bool:
    """With the elastic fleet on, a single-node gang can borrow a node
    from a same-accelerator pool (scheduler/elastic.py flex placement) —
    the shape ceiling alone must not fast-fail it. One shared predicate
    (elastic.flex_capable) keeps this aligned with the scheduler's own
    eligibility rule."""
    from kubeflow_tpu_torch.scheduler import elastic

    if not elastic.elastic_enabled():
        return False
    return elastic.flex_capable(fleet, ms.slice,
                                num_slices=ms.num_slices)


async def _declared_fleet(kube):
    """The operator-declared fleet for the fast-fail ceiling: the
    KFTPU_FLEET env spec, else the KFTPU_FLEET_CONFIGMAP ConfigMap
    (TTL-cached — admission bursts must not GET it per CREATE). An
    auto-inferred fleet (`KFTPU_FLEET=auto`) is deliberately excluded:
    node pools come and go, and a transiently empty fleet must not
    reject CRs that would queue and then run. Returns None when nothing
    is declared or the spec is broken (a bad spec must not block
    admissions)."""
    from kubeflow_tpu_torch.scheduler.fleet import Fleet, FleetConfigError
    from kubeflow_tpu_torch.scheduler.runtime import load_fleet_from_configmap

    spec = os.environ.get(FLEET_ENV, "").strip()
    if spec == "auto":
        return None
    if not spec:
        configmap = os.environ.get(FLEET_CONFIGMAP_ENV)
        if not configmap or kube is None:
            return None
        from kubeflow_tpu_torch.runtime.deployment import controller_namespace

        ns = controller_namespace()
        return await _ttl_cached(
            _fleet_cache, kube, (ns, configmap),
            lambda: load_fleet_from_configmap(kube, configmap, ns))
    try:
        return Fleet.parse(spec)
    except FleetConfigError:
        return None


_fleet_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()
_profile_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


# ---- image-alias resolution --------------------------------------------------
#
# odh's SetContainerImageFromRegistry (notebook_webhook.go:539-645) resolves
# the spawner's "<stream>:<tag>" selection annotation to a pinned image
# reference from OpenShift ImageStreams. The k8s-native equivalent is an
# admin-curated ConfigMap catalog: data["images.yaml"] maps
# ``<stream>: {<tag>: <pinned reference>}``; the webhook rewrites the main
# container's image (and JUPYTER_IMAGE env) unless it is already
# digest-pinned (the analogue of the internal-registry short-circuit).

IMAGE_SELECTION_ANNOTATION = nbapi.IMAGE_SELECTION_ANNOTATION
IMAGE_CATALOG_CONFIGMAP = "notebook-images"
IMAGE_CATALOG_KEY = "images.yaml"


def _controller_namespace() -> str:
    from kubeflow_tpu_torch.runtime.deployment import controller_namespace

    return controller_namespace()


def _catalog_lookup(catalog: dict, stream: str, tag: str) -> str | None:
    entry = catalog.get(stream)
    if isinstance(entry, dict):
        ref = entry.get(tag)
        if isinstance(ref, str) and ref:
            return ref
    return None


# Short TTL cache for the parsed catalog, per client object (weak keys so a
# test's FakeKube doesn't pin stale entries for the next test). Admission
# bursts — the 200-notebook load test — would otherwise GET the ConfigMap
# once per Notebook CREATE/UPDATE; this mirrors the controller's TTL-cached
# Role probe (controllers/notebook.py _namespace_has_role).
CATALOG_CACHE_TTL = 10.0
_catalog_cache: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


async def _ttl_cached(cache, kube, key, loader):
    """Per-client TTL memo for ConfigMap-backed admission lookups (the
    image catalog and the declared-fleet ceiling share it). Weak client
    keys so a test's FakeKube doesn't pin stale entries for the next
    test; a non-weakrefable client just skips caching."""
    now = time.monotonic()
    per_kube = None
    try:
        per_kube = cache.setdefault(kube, {})
        hit = per_kube.get(key)
        if hit and now - hit[0] < CATALOG_CACHE_TTL:
            return hit[1]
    except TypeError:
        per_kube = None
    value = await loader()
    if per_kube is not None:
        per_kube[key] = (now, value)
    return value


async def _load_catalog(kube, ns: str, configmap: str) -> dict:
    async def load() -> dict:
        cm = await kube.get_or_none("ConfigMap", configmap, ns)
        catalog: dict = {}
        if cm is not None:
            try:
                import yaml

                parsed = yaml.safe_load(
                    (cm.get("data") or {}).get(IMAGE_CATALOG_KEY) or "")
                if isinstance(parsed, dict):
                    catalog = parsed
            except Exception:
                catalog = {}
        return catalog

    return await _ttl_cached(_catalog_cache, kube, (ns, configmap), load)


async def resolve_image_from_catalog(
    kube,
    nb: dict,
    *,
    namespace: str | None = None,
    configmap: str = IMAGE_CATALOG_CONFIGMAP,
) -> bool:
    """Rewrite the main container's image from the catalog ConfigMap.

    Returns True when a rewrite happened. Missing catalog / unknown
    selection are soft no-ops (the reference logs and admits unchanged —
    the image may be directly pullable without a catalog entry).
    """
    selection = annotations_of(nb).get(IMAGE_SELECTION_ANNOTATION)
    if not selection or ":" not in selection:
        return False
    stream, _, tag = selection.rpartition(":")
    name = deep_get(nb, "metadata", "name")
    containers = deep_get(nb, "spec", "template", "spec", "containers") or []
    container = next((c for c in containers if c.get("name") == name), None)
    if container is None:
        return False
    if "@sha256:" in (container.get("image") or ""):
        return False  # already pinned; nothing to resolve
    catalog = await _load_catalog(
        kube, namespace or _controller_namespace(), configmap)
    ref = _catalog_lookup(catalog, stream, tag)
    if ref is None or ref == container.get("image"):
        return False
    container["image"] = ref
    for env in container.get("env") or []:
        if env.get("name") == "JUPYTER_IMAGE":
            env["value"] = selection
            break
    return True
