"""Warm pod pools: pre-started notebook pods claimed into incoming CRs.

The port of ``kubeflow_tpu/controllers/warmpool.py`` on GPU nodes.

Cold start is the worst-scaling user-facing number in the stack, and
almost none of it is reconcile time — the spend is pod scheduling, image
pull, interpreter + import, card attach, and the kernels' ``nvcc`` build.
This module attacks all of it at once with the pool-of-prewarmed-sandboxes
idiom (KServe/ModelMesh in the reference's ODH ecosystem): per image×shape
pools of **fully started** pods — interpreter up, ``torch`` imported,
the card attached, kernel cache seeded and kernels built — held by the
SDK's warm-idle
loop (:func:`kubeflow_tpu_torch.sdk.warm_idle`), so an incoming Notebook can
**claim** one and be Ready in the time it takes to re-label a pod.

Shape of the thing:

- **Spec**: ``KFTPU_WARM_POOLS=[ns/]image@acc:shape:n,...`` (env, static;
  e.g. ``ns/img:latest@nvidia-h100-80gb:1x1:2``)
  or the same grammar under ``data["warm-pools"]`` of a ConfigMap
  (``KFTPU_WARM_POOLS_CONFIGMAP``, dynamic — re-read on a throttle),
  mirroring the fleet-spec grammar. Pools are namespace-local (pods
  cannot cross namespaces, so a pool serves notebooks in its own
  namespace; the default is the controller namespace). Only single-node,
  single-slice shapes pre-warm (``1x1`` through ``1x8`` on H100 nodes) —
  a warm pod IS the slice.
- **Slots**: each warm pod rides its own one-replica StatefulSet
  (``<pool-slug>-p<i>``) labeled :data:`keys.TPU_WARM_POOL_LABEL`, so
  the kubelet path (admission webhooks, pod identity labels) is exactly
  the cold path's. A claim CONSUMES the slot (the StatefulSet is
  deleted; the pod, re-owned to the Notebook, survives); the
  **replenisher** tops the pool back up off the reconcile hot path.
- **Claim protocol** (the ONLY way a pool pod changes hands — enforced
  by the ``warm-pool-contract`` analysis pass): CAS-claim → adopt.
  The claimer stamps :data:`keys.TPU_WARM_CLAIM` with a nonce'd value
  and reads it back; a claimer that sees a value it did not write LOST
  the race and tries another pod — two reconcilers can never adopt the
  same pod. Adoption re-labels the pod into the Notebook's identity
  (``notebook-name``/``statefulset``/pod-name labels — the Service
  selects it), re-owns it (GC cascades with the CR), and injects the
  user's env (NB_PREFIX, restore hints; the in-pod warm-idle shim
  applies them by exec'ing the real server). An empty pool falls back
  to the cold path transparently.
- **Card accounting**: every slot holds a ledger reservation
  (``GpuFleetScheduler.warm_reserve``) at warm-pool priority — the
  fleet's capacity view stays honest, and the reservation is the FIRST
  preemption victim (before any real gang, released instantly — nothing
  to checkpoint), so the scheduler cannibalizes the pool under pressure
  and the replenisher rebuilds it when pressure clears.
"""

from __future__ import annotations

import asyncio
import logging
import time
import zlib
from dataclasses import dataclass

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.controllers.common import bounded_name
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.runtime.errors import AlreadyExists, ApiError, NotFound
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import (
    annotations_of,
    deep_get,
    fmt_iso,
    get_meta,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.runtime.tracing import span
from kubeflow_tpu_torch.gpu.topology import GpuSlice, TopologyError

log = logging.getLogger(__name__)

# Knobs (docs/operations.md "Warm pools & cold-start"):
WARM_POOLS_ENV = "KFTPU_WARM_POOLS"
WARM_POOLS_CONFIGMAP_ENV = "KFTPU_WARM_POOLS_CONFIGMAP"
WARM_REPLENISH_ENV = "KFTPU_WARM_REPLENISH_SECONDS"
WARM_IDLE_ENV = "KFTPU_WARM_IDLE"

WARM_POOLS_CONFIGMAP_KEY = "warm-pools"
DEFAULT_REPLENISH_SECONDS = 5.0

# The pod-identity labels the claim re-stamps so the Notebook's Service
# (and every notebook-name-indexed lookup) selects the adopted pod —
# the same labels the cold path's StatefulSet template carries
# (controllers/notebook.py STS_LABEL / POD_NAME_LABEL; duplicated here
# because notebook.py imports this module, not the reverse).
_STS_LABEL = "statefulset"
_POD_NAME_LABEL = "statefulset.kubernetes.io/pod-name"


class WarmPoolConfigError(ValueError):
    """Malformed warm-pool specification."""


@dataclass(frozen=True)
class WarmPoolSpec:
    """One pool: ``size`` fully-started pods of one image×shape in one
    namespace."""

    namespace: str
    image: str
    accelerator: str
    topology: str
    size: int

    def __post_init__(self):
        if not self.image:
            raise WarmPoolConfigError("warm pool: image must be non-empty")
        if self.size < 0:
            raise WarmPoolConfigError(
                f"warm pool {self.image}: size must be >= 0, "
                f"got {self.size}")
        shape = GpuSlice.parse(self.accelerator, self.topology)
        if shape.num_hosts != 1:
            raise WarmPoolConfigError(
                f"warm pool {self.image}@{self.accelerator}:"
                f"{self.topology}: only single-node shapes can pre-warm "
                f"(this one needs {shape.num_hosts} nodes — a warm pod "
                "IS the slice; multi-node gangs take the cold path)")

    @property
    def shape_key(self) -> tuple[str, str]:
        return (self.accelerator.lower(), self.topology.lower())

    @property
    def slice(self) -> GpuSlice:
        return GpuSlice.parse(self.accelerator, self.topology)

    @property
    def slug(self) -> str:
        """Deterministic DNS-safe pool id: image basename + shape + a
        short hash of the full (ns, image, shape) — slot StatefulSets
        keep their names across controller restarts, so a rebuilt
        manager adopts the running pool instead of rebuilding it."""
        base = self.image.rsplit("/", 1)[-1].split(":", 1)[0].lower()
        base = "".join(c if c.isalnum() or c == "-" else "-" for c in base)
        h = zlib.crc32(
            f"{self.namespace}/{self.image}@{self.accelerator}:"
            f"{self.topology}".encode()) & 0xFFFFFF
        return bounded_name(
            f"warm-{base}-{self.accelerator}-{self.topology.replace('x', '')}"
            f"-{h:06x}")


def parse_warm_pools(spec: str, *,
                     default_namespace: str) -> tuple[WarmPoolSpec, ...]:
    """``[ns/]image@acc:topo:n,...`` → pool specs (the fleet-spec grammar
    with ``@`` separating the image). Empty spec → no pools (the whole
    subsystem is a no-op — the kill-switch story). Duplicate
    (namespace, image, shape) entries are a hard error, like duplicate
    fleet pool names: two entries would race one slot namespace."""
    pools: list[WarmPoolSpec] = []
    seen: dict[tuple, int] = {}
    position = 0
    for raw in (spec or "").replace("\n", ",").split(","):
        entry = raw.strip()
        if not entry:
            continue
        position += 1
        image, sep, shape = entry.rpartition("@")
        parts = shape.split(":")
        if not sep or not image or len(parts) != 3:
            raise WarmPoolConfigError(
                f"bad warm-pool entry {entry!r}: want "
                "[namespace/]image@accelerator:shape:size")
        ns, slash, image_only = image.partition("/")
        # An image reference itself contains "/" (registry/repo) — only a
        # FIRST segment with no dot/colon (not a registry host) and a
        # remaining path reads as a namespace prefix.
        if slash and "." not in ns and ":" not in ns and "/" in image:
            namespace, image_ref = ns, image_only
            if not image_ref:
                raise WarmPoolConfigError(
                    f"bad warm-pool entry {entry!r}: empty image after "
                    f"namespace {ns!r}")
        else:
            namespace, image_ref = default_namespace, image
        acc, topo, n = (p.strip() for p in parts)
        try:
            size = int(n)
        except ValueError:
            raise WarmPoolConfigError(
                f"bad warm-pool entry {entry!r}: size {n!r} is not an "
                "integer") from None
        key = (namespace, image_ref, acc.lower(), topo.lower())
        if key in seen:
            raise WarmPoolConfigError(
                f"duplicate warm pool {image_ref}@{acc}:{topo} in "
                f"namespace {namespace} (entries {seen[key]} and "
                f"{position}): merge the sizes into one entry")
        seen[key] = position
        try:
            pools.append(WarmPoolSpec(namespace, image_ref, acc.lower(),
                                      topo.lower(), size))
        except TopologyError as e:
            raise WarmPoolConfigError(
                f"bad warm-pool entry {entry!r}: {e}") from None
    return tuple(pools)


async def load_warm_pools_from_configmap(
        kube, name: str, namespace: str, *,
        default_namespace: str) -> tuple[WarmPoolSpec, ...] | None:
    """ConfigMap source (``data["warm-pools"]``), same tolerance contract
    as the fleet loader: absent/malformed → None (a broken spec must not
    wedge the replenisher — the last good spec keeps serving)."""
    cm = await kube.get_or_none("ConfigMap", name, namespace)
    spec = ((cm or {}).get("data") or {}).get(WARM_POOLS_CONFIGMAP_KEY) or ""
    if not spec.strip():
        return None
    try:
        return parse_warm_pools(spec, default_namespace=default_namespace)
    except Exception:
        log.exception("bad warm-pool spec in ConfigMap %s/%s",
                      namespace, name)
        return None


@dataclass
class WarmPoolOptions:
    """Env contract (cmd/envconfig.py warm_pool_options)."""

    spec: str = ""                      # KFTPU_WARM_POOLS
    configmap: str | None = None        # KFTPU_WARM_POOLS_CONFIGMAP
    controller_namespace: str = "kubeflow-tpu"
    replenish_seconds: float = DEFAULT_REPLENISH_SECONDS
    # Dynamic (ConfigMap) spec re-read throttle; rides the replenish
    # cadence by default.
    refresh_seconds: float = 30.0

    @property
    def enabled(self) -> bool:
        return bool(self.spec.strip()) or bool(self.configmap)


class WarmPoolManager:
    """Maintains the pools and owns the claim protocol. One instance per
    manager process, shared by the notebook reconciler (claims) and the
    replenisher background task; the in-process claim lock plus the CAS
    annotation make claims safe against both local concurrency and a
    second manager process."""

    def __init__(self, kube, options: WarmPoolOptions | None = None, *,
                 scheduler=None, registry: Registry | None = None):
        self.kube = kube
        self.options = options or WarmPoolOptions()
        self.scheduler = scheduler
        self._pools: tuple[WarmPoolSpec, ...] = ()
        if self.options.spec.strip():
            self._pools = parse_warm_pools(
                self.options.spec,
                default_namespace=self.options.controller_namespace)
        self._spec_next_try = 0.0
        self._now = time.time
        self._lock = asyncio.Lock()
        self._claimed_local: set[tuple] = set()
        self._nonce_seq = 0
        # Slots whose ledger reservation the scheduler cannibalized
        # (note_reclaimed): torn down by the next replenish pass UNLESS a
        # claim consumed them first — an admission that reclaims warm
        # chips and a claim racing it in the same reconcile should hand
        # the pod over, not kill it.
        self._reclaimed_slots: set[tuple] = set()
        self._wake = asyncio.Event()
        self._running = False
        registry = registry or global_registry
        self.m_target = registry.gauge(
            "warm_pool_target", "Configured warm-pool size", ["pool"])
        self.m_ready = registry.gauge(
            "warm_pool_ready", "Warm pods up and claimable", ["pool"])
        self.m_unfilled = registry.gauge(
            "warm_pool_unfilled",
            "Slots the replenisher could not back with GPUs", ["pool"])
        self.m_claims = registry.counter(
            "warm_pool_claims_total", "Warm pods claimed into Notebooks",
            ["pool"])
        self.m_exhausted = registry.counter(
            "warm_pool_exhausted_total",
            "Claim attempts that found the pool empty (cold fallback)",
            ["pool"])
        self.m_reclaimed = registry.counter(
            "warm_pool_reclaimed_total",
            "Warm slots cannibalized by the fleet scheduler")
        self.m_claim_seconds = registry.histogram(
            "warm_pool_claim_seconds",
            "Claim protocol duration (CAS + adopt)")

    # ---- spec --------------------------------------------------------------------

    @property
    def active(self) -> bool:
        return bool(self._pools)

    @property
    def pools(self) -> tuple[WarmPoolSpec, ...]:
        return self._pools

    async def _ensure_pools(self) -> None:
        """Dynamic spec refresh (ConfigMap source only — env is immutable
        for the process's lifetime), throttled like the fleet source."""
        opts = self.options
        if opts.spec.strip() or not opts.configmap:
            return
        now = self._now()
        if now < self._spec_next_try:
            return
        self._spec_next_try = now + max(opts.refresh_seconds, 0.01)
        pools = await load_warm_pools_from_configmap(
            self.kube, opts.configmap, opts.controller_namespace,
            default_namespace=opts.controller_namespace)
        if pools is not None and pools != self._pools:
            log.info("warm pools updated: %d pool(s)", len(pools))
            self._pools = pools

    # ---- eligibility + claim -----------------------------------------------------

    def pool_for(self, nb: dict, ms) -> WarmPoolSpec | None:
        """The pool that could serve this notebook, or None: same
        namespace (pods cannot cross namespaces), same image, same
        single-node single-slice shape."""
        if not self.active or ms is None or ms.num_slices != 1 \
                or ms.slice.num_hosts != 1:
            return None
        ns = namespace_of(nb)
        containers = deep_get(nb, "spec", "template", "spec", "containers",
                              default=[]) or []
        image = (containers[0].get("image") if containers else None) or ""
        shape = (ms.slice.accelerator.name.lower(),
                 ms.slice.topology_str.lower())
        for pool in self._pools:
            if pool.size > 0 and pool.namespace == ns \
                    and pool.image == image and pool.shape_key == shape:
                return pool
        return None

    async def claim(self, nb: dict, ms, *,
                    since: float | None = None) -> dict | None:
        """Claim one warm pod for this notebook: CAS the claim annotation,
        adopt the winner, consume its slot, stamp the verdict on the CR.
        Returns the adopted pod, or None (pool empty / every CAS lost /
        no matching pool) — the caller falls back to the cold path."""
        pool = self.pool_for(nb, ms)
        if pool is None:
            return None
        key = (namespace_of(nb), name_of(nb))
        t0 = time.perf_counter()
        with span("warm_claim", key=f"{key[0]}/{key[1]}", pool=pool.slug):
            async with self._lock:
                for pod in await self._claimable_pods(pool):
                    pod_key = (pool.namespace, name_of(pod))
                    if pod_key in self._claimed_local:
                        continue
                    nonce = self._next_nonce(key)
                    if not await self._cas_claim(pool, name_of(pod), nonce):
                        continue
                    self._claimed_local.add(pod_key)
                    try:
                        adopted = await self._adopt(nb, pod, ms, pool,
                                                    since=since)
                    except ApiError:
                        # Adoption half-done: release the claim so the
                        # pod stays poolable; the caller goes cold.
                        self._claimed_local.discard(pod_key)
                        try:
                            await self.kube.patch(
                                "Pod", name_of(pod),
                                {"metadata": {"annotations": {
                                    keys.TPU_WARM_CLAIM: None}}},
                                pool.namespace)
                        except ApiError as exc:
                            log.debug("CAS rollback for pod %s failed "
                                      "(stale-claim healer finishes "
                                      "it): %s", name_of(pod), exc)
                        continue
                    # The durable claim annotation (never cleared after a
                    # successful hand-off) guards from here; keeping the
                    # local mark would leak it forever and block a future
                    # pod that legitimately reuses this slot pod name.
                    self._claimed_local.discard(pod_key)
                    self.m_claims.labels(pool=pool.slug).inc()
                    self.m_claim_seconds.observe(time.perf_counter() - t0)
                    self._wake.set()  # replenish the consumed slot now
                    return adopted
            self.m_exhausted.labels(pool=pool.slug).inc()
            return None

    def _next_nonce(self, key: tuple) -> str:
        self._nonce_seq += 1
        return f"{key[0]}/{key[1]}/{self._nonce_seq}"

    async def _cas_claim(self, pool: WarmPoolSpec, pod_name: str,
                         nonce: str) -> bool:
        """The CAS: claim only an unclaimed pod (fresh read), then verify
        OUR value survived. Merge-patch is last-wins, so exactly one
        claimer's value is final — a claimer that reads back a foreign
        value lost and moves on; the unclaimed-precheck keeps the race
        window to one in-flight patch."""
        fresh = await self.kube.get_or_none("Pod", pod_name, pool.namespace)
        if fresh is None or annotations_of(fresh).get(keys.TPU_WARM_CLAIM):
            return False
        try:
            await self.kube.patch(
                "Pod", pod_name,
                {"metadata": {"annotations": {keys.TPU_WARM_CLAIM: nonce}}},
                pool.namespace)
        except ApiError:
            return False
        check = await self.kube.get_or_none("Pod", pod_name, pool.namespace)
        return check is not None \
            and annotations_of(check).get(keys.TPU_WARM_CLAIM) == nonce

    async def _adopt(self, nb: dict, pod: dict, ms, pool: WarmPoolSpec,
                     *, since: float | None) -> dict:
        """Re-own a CAS-won pod into the Notebook: identity labels (the
        Service and every notebook-name index select it), ownerReference
        (GC cascades with the CR), user env (NB_PREFIX + the notebook's
        own env + restore hints — the in-pod warm-idle shim execs the
        real server with them). Then consume the slot: delete its
        StatefulSet (the re-owned pod survives the cascade) and release
        its chip reservation — the notebook's own admission carries the
        booking from here.

        Fault ordering matters (the chaos soak's claim-uniqueness
        invariant found the original hole): (a) the CR's claim INTENT is
        stamped first — a failure there aborts with nothing mutated but
        the CAS mark; (b) the pod hand-off — a failure rolls the intent
        back (best-effort; the claim gate validates ownership and heals
        a surviving stale intent); (c) slot consumption is best-effort —
        the replenisher's stale-claim healer finishes whatever a fault
        interrupts. The CAS mark is NEVER cleared after a successful
        hand-off: an adopted pod that looked unclaimed could be adopted
        twice.

        Real-cluster note: Kubernetes pod SPECS are immutable
        (metadata is not), so the env written below is the simulation
        of the delivery a real cluster does through the shim — the
        warm-idle loop reads the claim from the downward-API file,
        fetches its new identity's env off its claimer's CR, and execs
        the server; the metadata half of this patch is the actual
        on-the-wire protocol."""
        name, ns = name_of(nb), namespace_of(nb)
        pod_name = name_of(pod)
        sts0 = ms.slice_sts_name(name, 0)
        slot_ref = next(
            (r for r in get_meta(pod).get("ownerReferences", [])
             if r.get("controller") and r.get("kind") == "StatefulSet"),
            None)
        labels = {
            nbapi.NOTEBOOK_NAME_LABEL: name,
            "app": name,
            _STS_LABEL: sts0,
            _POD_NAME_LABEL: f"{sts0}-0",
        }
        owner_patch: dict = {"metadata": {}}
        from kubeflow_tpu_torch.runtime.objects import set_controller_owner

        set_controller_owner(owner_patch, nb)
        live_ctr = (deep_get(pod, "spec", "containers", default=[{}])
                    or [{}])[0]
        merged = self._merge_env(nb, live_ctr, ns, name)
        now = self._now()
        claimed_in = (round(max(0.0, now - since), 3)
                      if since is not None else None)
        # (a) intent on the CR first.
        await self.kube.patch(
            "Notebook", name,
            {"metadata": {"annotations": {
                nbapi.WARM_CLAIMED_ANNOTATION: pod_name,
                nbapi.WARM_CLAIMED_AT_ANNOTATION: fmt_iso(now),
                **({nbapi.WARM_CLAIMED_IN_ANNOTATION: str(claimed_in)}
                   if claimed_in is not None else {}),
            }}}, ns)
        # (b) the pod hand-off.
        try:
            await self.kube.patch(
                "Pod", pod_name,
                {
                    "metadata": {
                        "labels": labels,
                        "ownerReferences":
                            owner_patch["metadata"]["ownerReferences"],
                    },
                    "spec": {"containers": [merged]},
                },
                pool.namespace)
        except ApiError:
            try:
                await self.kube.patch(
                    "Notebook", name,
                    {"metadata": {"annotations": {
                        nbapi.WARM_CLAIMED_ANNOTATION: None,
                        nbapi.WARM_CLAIMED_AT_ANNOTATION: None,
                        nbapi.WARM_CLAIMED_IN_ANNOTATION: None,
                    }}}, ns)
            except ApiError as exc:
                # the gate's ownership validation self-heals this
                log.debug("claim-intent rollback for %s/%s failed: %s",
                          ns, name, exc)
            raise
        # (c) consume the slot — every step best-effort.
        if slot_ref is not None:
            slot_key = (pool.namespace, slot_ref["name"])
            self._reclaimed_slots.discard(slot_key)
            try:
                await self.kube.delete("StatefulSet", slot_ref["name"],
                                       pool.namespace)
            except (NotFound, ApiError) as exc:
                log.debug("slot consume delete %s failed (replenisher "
                          "heals interrupted claims): %s",
                          slot_ref["name"], exc)
            await self._release_reservation(slot_key)
        try:
            fresh = await self.kube.get_or_none("Pod", pod_name,
                                                pool.namespace)
        except ApiError:
            fresh = None
        return fresh if fresh is not None else pod

    def _merge_env(self, nb: dict, live_ctr: dict, ns: str,
                   name: str) -> dict:
        """The adopted container: the live warm container (image, ports,
        resources — immutable in spirit) with the USER's env layered on
        top, plus NB_PREFIX and the restore hint. The warm-idle shim in
        the pod applies these by exec'ing the real notebook server."""
        user_ctrs = deep_get(nb, "spec", "template", "spec", "containers",
                             default=[]) or []
        user_env = list((user_ctrs[0].get("env") if user_ctrs else None)
                        or [])
        env: dict[str, dict] = {}
        for e in (live_ctr.get("env") or []):
            if e.get("name") and e.get("name") != WARM_IDLE_ENV:
                env[e["name"]] = dict(e)
        for e in user_env:
            if e.get("name"):
                env[e["name"]] = dict(e)
        env[nbapi.PREFIX_ENV_VAR] = {
            "name": nbapi.PREFIX_ENV_VAR,
            "value": f"/notebook/{ns}/{name}"}
        hint = migration.restore_hint(annotations_of(nb))
        if hint is not None:
            env.setdefault(migration.RESTORE_PATH_ENV, {
                "name": migration.RESTORE_PATH_ENV, "value": hint[0]})
            if hint[1] is not None:
                env.setdefault(migration.RESTORE_STEP_ENV, {
                    "name": migration.RESTORE_STEP_ENV,
                    "value": str(hint[1])})
        merged = dict(live_ctr)
        merged["env"] = list(env.values())
        return merged

    async def _pool_pods(self, pool: WarmPoolSpec) -> list[dict]:
        """EVERY pod carrying the pool label — adopted (claimed) pods
        keep it, which is exactly why the slot indexer needs them."""
        try:
            return await self.kube.list(
                "Pod", pool.namespace,
                label_selector={"matchLabels": {
                    keys.TPU_WARM_POOL_LABEL: pool.slug}})
        except ApiError:
            return []

    async def _claimable_pods(self, pool: WarmPoolSpec) -> list[dict]:
        """Running+Ready, unclaimed pool pods, oldest-name-first (the
        longest-warmed pod has the most seeded cache)."""
        pods = await self._pool_pods(pool)
        out = []
        for pod in pods:
            if annotations_of(pod).get(keys.TPU_WARM_CLAIM):
                continue
            if deep_get(pod, "status", "phase") != "Running":
                continue
            if not any(c.get("type") == "Ready" and c.get("status") == "True"
                       for c in deep_get(pod, "status", "conditions",
                                         default=[])):
                continue
            out.append(pod)
        return sorted(out, key=name_of)

    def pool_status(self, pool: WarmPoolSpec,
                    ready: int | None = None) -> dict:
        return {"pool": pool.slug, "size": pool.size,
                **({"ready": ready} if ready is not None else {})}

    async def replenishing_status(self, nb: dict, ms) -> dict | None:
        """The JWA "Warming pool replenishing (k/n ready)" payload for a
        notebook whose pool was empty — None when no pool matches."""
        pool = self.pool_for(nb, ms)
        if pool is None:
            return None
        ready = len(await self._claimable_pods(pool))
        return {"ready": ready, "size": pool.size}

    # ---- ledger reservations + scheduler callback --------------------------------

    async def _reserve(self, pool: WarmPoolSpec, slot_name: str) -> bool:
        if self.scheduler is None:
            return True
        return await self.scheduler.warm_reserve(
            (pool.namespace, slot_name),
            namespace=pool.namespace,
            accelerator=pool.accelerator, topology=pool.topology)

    async def _release_reservation(self, slot_key: tuple) -> None:
        if self.scheduler is not None:
            await self.scheduler.warm_release(slot_key)

    async def note_reclaimed(self, key: tuple) -> None:
        """Scheduler callback: this slot's chip reservation was
        cannibalized for a real gang. The teardown is DEFERRED to the
        next replenish tick so a claim racing the same arbitration pass
        (the admitted notebook may be about to claim this very pod) wins
        the pod instead of finding it deleted."""
        self.m_reclaimed.inc()
        self._reclaimed_slots.add(tuple(key))
        self._wake.set()

    # ---- replenisher --------------------------------------------------------------

    async def run_replenisher(self) -> None:
        """Background loop (Manager.add_background): tops pools up to
        target, tears down reclaimed/excess/orphaned slots, and keeps
        every live slot's ledger reservation current — all off the
        reconcile hot path."""
        self._running = True
        while self._running:
            # Clear BEFORE the pass, not after: a claim or reclaim that
            # sets the wake DURING replenish() (its awaits interleave
            # with the reconcile tasks) must survive into the wait below
            # — clearing afterwards would erase the signal and delay the
            # top-up by a full replenish interval (the lost-wakeup shape
            # the await-race pass flags; regression test
            # test_wake_during_replenish_pass_is_not_lost).
            # kftpu: ignore[await-race] clear-before-work ordering: a set() landing during replenish() survives into the wait below by construction
            self._wake.clear()
            try:
                await self.replenish()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("warm-pool replenish pass failed; retrying")
            try:
                await asyncio.wait_for(
                    self._wake.wait(),
                    timeout=max(self.options.replenish_seconds, 0.01))
            except asyncio.TimeoutError:
                pass

    def stop(self) -> None:
        self._running = False
        self._wake.set()

    async def replenish(self) -> None:
        """One replenish pass. Idempotent and restart-safe: slots are
        discovered from their pool label (a rebuilt manager adopts the
        running pool), reservations re-assert per pass (a fleet that
        activated late back-fills), and a slot whose reservation cannot
        be backed is torn down (the chips belong to real gangs now)."""
        await self._ensure_pools()
        with span("warm_replenish"):
            # Only the HEALING steps take the claim lock (a healer that
            # observed a mid-flight claim would tear down the very pod
            # being adopted); the top-up below runs lock-free so claims
            # — the reconcile hot path — never wait out a full
            # multi-round-trip replenish pass. A top-up racing a claim
            # is graceful either way: a slot deleted under a CAS-winning
            # claimer fails its adopt patch and the claim moves on.
            async with self._lock:
                await self._teardown_reclaimed()
                for pool in self._pools:
                    await self._heal_pool(pool)
            seen_ns_slugs: dict[str, set] = {}
            for pool in self._pools:
                seen_ns_slugs.setdefault(pool.namespace, set()).add(
                    pool.slug)
                await self._replenish_pool(pool)
            await self._teardown_removed_pools(seen_ns_slugs)

    async def _heal_pool(self, pool: WarmPoolSpec) -> None:
        """Under the claim lock: tear down slots whose pod carries a
        claim annotation — such a slot should not exist (adoption
        deletes it), so a crash interrupted the claim protocol mid-way.
        An adopted pod (re-owned to its Notebook) survives the cascade;
        a stale-claimed pool pod dies with it and the top-up replaces
        the slot."""
        for sts in await self._slots(pool):
            if await self._slot_claim_interrupted(pool, sts):
                await self._delete_slot(pool, name_of(sts))

    async def _replenish_pool(self, pool: WarmPoolSpec) -> None:
        slots = await self._slots(pool)
        kept: list[dict] = []
        for sts in sorted(slots, key=name_of):
            if len(kept) >= pool.size \
                    or not await self._reserve(pool, name_of(sts)):
                # Excess (spec shrink) or unbackable (capacity gone to
                # real gangs): tear the slot down — its pod must not
                # squat on chips the ledger no longer reserves.
                await self._delete_slot(pool, name_of(sts))
                continue
            # The slot list is a pre-reserve snapshot: a claim can
            # consume this slot (delete the STS, release its
            # reservation) while _reserve's round trips are in flight,
            # and re-reserving AFTER the claim's release would book a
            # ghost allocation no later pass ever frees — the pool
            # permanently under-fills by one slot (chips held for a
            # slot that no longer exists). Re-validate and release.
            # (regression test test_claim_racing_replenish_leaves_no_
            # ghost_reservation)
            try:
                fresh = await self.kube.get_or_none(
                    "StatefulSet", name_of(sts), pool.namespace)
            except ApiError as exc:
                log.debug("slot liveness re-check for %s failed; "
                          "keeping it this pass: %s", name_of(sts), exc)
                fresh = sts
            if fresh is None:
                await self._release_reservation(
                    (pool.namespace, name_of(sts)))
                continue
            kept.append(sts)
        index = self._next_index(slots, await self._pool_pods(pool))
        while len(kept) < pool.size:
            slot_name = bounded_name(f"{pool.slug}-p{index}")
            index += 1
            if not await self._reserve(pool, slot_name):
                break  # no chips free — pressure wins; retry next pass
            try:
                created = await self.kube.create(
                    "StatefulSet", self._slot_statefulset(pool, slot_name),
                    pool.namespace)
            except AlreadyExists:
                created = None
            except ApiError:
                await self._release_reservation((pool.namespace, slot_name))
                break
            if created is not None:
                kept.append(created)
        ready = len(await self._claimable_pods(pool))
        self.m_target.labels(pool=pool.slug).set(pool.size)
        self.m_ready.labels(pool=pool.slug).set(ready)
        self.m_unfilled.labels(pool=pool.slug).set(
            max(0, pool.size - len(kept)))

    async def _teardown_reclaimed(self) -> None:
        for slot_key in list(self._reclaimed_slots):
            self._reclaimed_slots.discard(slot_key)
            ns, slot_name = slot_key
            pool = next((p for p in self._pools
                         if p.namespace == ns
                         and slot_name.startswith(p.slug)), None)
            sts = await self.kube.get_or_none("StatefulSet", slot_name, ns)
            if sts is None:
                continue  # already consumed by a claim — the race we defer for
            await self._delete_slot(pool, slot_name, namespace=ns)

    async def _teardown_removed_pools(self, seen: dict[str, set]) -> None:
        """Durable orphan sweep: every slot carries the pool label, so
        slots of a pool dropped from the spec are discovered from the
        cluster itself — including slots left behind while the manager
        was down, which no in-memory diff of previous passes can know
        about. Guarded on a loaded spec: a ConfigMap-sourced manager
        whose first read has not succeeded yet must not mistake every
        healthy pool for an orphan."""
        if not self._pools:
            return
        try:
            labeled = await self.kube.list(
                "StatefulSet", None,
                label_selector={"matchExpressions": [
                    {"key": keys.TPU_WARM_POOL_LABEL,
                     "operator": "Exists"}]})
        except ApiError as exc:
            log.debug("orphan-slot sweep LIST failed (retried next "
                      "pass): %s", exc)
            return
        for sts in labeled:
            ns = namespace_of(sts)
            slug = (get_meta(sts).get("labels") or {}).get(
                keys.TPU_WARM_POOL_LABEL)
            if slug in seen.get(ns, set()):
                continue
            await self._delete_slot(None, name_of(sts), namespace=ns)

    async def _delete_slot(self, pool: WarmPoolSpec | None, slot_name: str,
                           *, namespace: str | None = None) -> None:
        ns = namespace or (pool.namespace if pool else None)
        try:
            await self.kube.delete("StatefulSet", slot_name, ns)
        except (NotFound, ApiError) as exc:
            log.debug("slot teardown delete %s failed (reservation "
                      "still released; orphan sweep retries): %s",
                      slot_name, exc)
        await self._release_reservation((ns, slot_name))

    async def _slot_claim_interrupted(self, pool: WarmPoolSpec,
                                      sts: dict) -> bool:
        pod = await self.kube.get_or_none(
            "Pod", f"{name_of(sts)}-0", pool.namespace)
        if pod is None:
            return False
        return bool(annotations_of(pod).get(keys.TPU_WARM_CLAIM))

    async def _slots(self, pool: WarmPoolSpec) -> list[dict]:
        try:
            return await self.kube.list(
                "StatefulSet", pool.namespace,
                label_selector={"matchLabels": {
                    keys.TPU_WARM_POOL_LABEL: pool.slug}})
        except ApiError:
            return []

    @staticmethod
    def _next_index(slots: list[dict], pods: list[dict] = ()) -> int:
        """Monotone slot index. Claims CONSUME slot StatefulSets while
        the ADOPTED pod keeps living under the old slot's pod name
        (``<slug>-p<i>-0``) — so the index must clear every live slot
        AND every pool-labeled pod: counting only slots would reuse an
        index whose pod name is still taken the moment every slot is
        claimed within one replenish interval (or across a restart),
        and the recreated slot could never start its pod."""
        top = 0
        for sts in slots:
            _, _, tail = name_of(sts).rpartition("-p")
            if tail.isdigit():
                top = max(top, int(tail) + 1)
        for pod in pods:
            base, _, _ordinal = name_of(pod).rpartition("-")
            _, _, tail = base.rpartition("-p")
            if tail.isdigit():
                top = max(top, int(tail) + 1)
        return top

    def _slot_statefulset(self, pool: WarmPoolSpec, slot_name: str) -> dict:
        """One warm slot: a one-replica StatefulSet whose pod runs the
        SDK warm-idle loop under the pool's image with the full GPU
        wiring (node-type selector, ``nvidia.com/gpu`` requests, webhook
        annotations) — the
        kubelet path is exactly what a cold notebook pod would take, so
        the warmth is real, not simulated."""
        shape = pool.slice
        env = [
            {"name": WARM_IDLE_ENV, "value": "1"},
        ]
        template_labels = {
            keys.TPU_WARM_POOL_LABEL: pool.slug,
            nbapi.TPU_SLICE_LABEL: "true",
        }
        template_annotations = {
            nbapi.TPU_ACCELERATOR_ANNOTATION: shape.accelerator.name,
            nbapi.TPU_TOPOLOGY_ANNOTATION: shape.topology_str,
        }
        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": slot_name,
                "namespace": pool.namespace,
                "labels": {keys.TPU_WARM_POOL_LABEL: pool.slug},
            },
            "spec": {
                "replicas": 1,
                "serviceName": slot_name,
                "selector": {"matchLabels": {
                    keys.TPU_WARM_POOL_LABEL: pool.slug,
                    _STS_LABEL: slot_name}},
                "template": {
                    "metadata": {
                        "labels": {**template_labels,
                                   _STS_LABEL: slot_name},
                        "annotations": template_annotations,
                    },
                    "spec": {
                        "nodeSelector": shape.node_selectors(),
                        "containers": [{
                            "name": "warm",
                            "image": pool.image,
                            "command": ["python", "-m", "kubeflow_tpu_torch.sdk",
                                        "--warm-idle"],
                            "env": env,
                            "resources": {
                                "requests": shape.resource_requests(),
                                "limits": shape.resource_requests(),
                            },
                            # The claim annotation reaches the warm-idle
                            # shim through the downward API — live
                            # annotation updates, no apiserver credential.
                            "volumeMounts": [{
                                "name": "podinfo",
                                "mountPath": "/etc/podinfo",
                                "readOnly": True,
                            }],
                        }],
                        "volumes": [{
                            "name": "podinfo",
                            "downwardAPI": {"items": [{
                                "path": "annotations",
                                "fieldRef": {
                                    "fieldPath": "metadata.annotations"},
                            }]},
                        }],
                    },
                },
            },
        }

    # ---- introspection -------------------------------------------------------------

    async def debug_info(self) -> dict:
        pools = []
        for pool in self._pools:
            ready = len(await self._claimable_pods(pool))
            slots = await self._slots(pool)
            pools.append({
                "pool": pool.slug,
                "namespace": pool.namespace,
                "image": pool.image,
                "shape": f"{pool.accelerator}:{pool.topology}",
                "target": pool.size,
                "slots": len(slots),
                "ready": ready,
            })
        return {
            "active": self.active,
            "pools": pools,
            "reclaimed_pending_teardown": sorted(
                f"{k[0]}/{k[1]}" for k in self._reclaimed_slots),
        }
