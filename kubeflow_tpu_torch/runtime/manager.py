"""Controller manager: informers + workqueues + reconciler workers.

The asyncio equivalent of controller-runtime's Manager/Builder:

    mgr = Manager(kube)
    mgr.add_controller(
        Controller("notebook", "Notebook", reconciler.reconcile,
                   owns=["StatefulSet", "Service"],
                   watches=[Watch("Pod", map_fn=pod_to_notebook)]))
    await mgr.start()

``owns=`` maps child events to the controller owner (the reference's
``Owns(&appsv1.StatefulSet{})``); ``watches=`` takes an explicit mapping fn
(the reference's ``handler.EnqueueRequestsFromMapFunc``, e.g. pod events by
``notebook-name`` label, ``notebook_controller.go:739-787``).

The port's copy of ``kubeflow_tpu/runtime/manager.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Awaitable, Callable

from kubeflow_tpu_torch.runtime.aiotasks import reap
from kubeflow_tpu_torch.runtime.errors import ApiError, Conflict
from kubeflow_tpu_torch.runtime.events import EventRecorder
from kubeflow_tpu_torch.runtime.informer import OWNER_INDEX, Informer, index_by_owner_uid
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import (
    controller_of,
    deep_get,
    get_meta,
    name_of,
    namespace_of,
    now_iso,
)
from kubeflow_tpu_torch.runtime.queue import RateLimitedQueue
from kubeflow_tpu_torch.runtime import slo as slo_mod
from kubeflow_tpu_torch.runtime import timeline as timeline_mod
from kubeflow_tpu_torch.runtime.tracing import span

log = logging.getLogger(__name__)

# Consecutive reconcile failures before a key is dead-lettered
# (poison-pill quarantine, runtime/queue.py). 0 disables.
DEFAULT_QUARANTINE_AFTER = 12
QUARANTINE_AFTER_ENV = "KFTPU_QUARANTINE_AFTER"


def _quarantine_after_from_env(environ=os.environ) -> int:
    raw = environ.get(QUARANTINE_AFTER_ENV)
    try:
        value = int(raw) if raw is not None else DEFAULT_QUARANTINE_AFTER
    except ValueError:
        return DEFAULT_QUARANTINE_AFTER
    return max(0, value)


def _change_token(obj: dict | None) -> str | None:
    """Quarantine release token: a signature of the USER-EDITABLE half of
    the object — everything but ``status``, with resourceVersion masked
    out of metadata. Deliberately not the raw resourceVersion: the
    manager's own Degraded status write bumps rv, and a quarantine that
    released on its own announcement would flap forever. Computed only
    for quarantined keys (rare), never on the hot delta path."""
    if obj is None:
        return None
    body = {k: v for k, v in obj.items() if k not in ("status", "metadata")}
    body["metadata"] = {k: v for k, v in get_meta(obj).items()
                        if k not in ("resourceVersion", "managedFields")}
    return json.dumps(body, sort_keys=True, default=str)

Key = tuple  # (namespace | None, name)
ReconcileFn = Callable[[Key], Awaitable["Result | None"]]
MapFn = Callable[[dict], list[Key]]


@dataclass(frozen=True)
class Result:
    requeue_after: float | None = None


def soonest(*results) -> "Result | None":
    """The Result that reconciles first (smallest positive
    requeue_after); None only when every input is None. Shared by the
    notebook and serving reconcilers — a drain/park grace deadline must
    not be deferred behind a longer periodic requeue (or vice versa)."""
    best = None
    for r in results:
        if r is None or not getattr(r, "requeue_after", 0):
            continue
        if best is None or r.requeue_after < best.requeue_after:
            best = r
    if best is None:
        return next((r for r in results if r is not None), None)
    return best


@dataclass
class Watch:
    kind: str
    map_fn: MapFn
    label_selector: str | dict | None = None


@dataclass
class Controller:
    name: str
    kind: str
    reconcile: ReconcileFn
    owns: list[str] = field(default_factory=list)
    watches: list[Watch] = field(default_factory=list)
    workers: int = 2
    label_selector: str | dict | None = None
    # Event-coalescing window (seconds) for the controller's workqueue: a
    # burst of child events for one key triggers ONE reconcile at window
    # close instead of one per event. 0 disables (see RateLimitedQueue).
    coalesce_window: float = 0.0


class Manager:
    def __init__(self, kube, *, registry: Registry | None = None,
                 namespace: str | None = None,
                 quarantine_after: int | None = None,
                 shard_ring=None):
        self.kube = kube
        self.namespace = namespace
        self.registry = registry or global_registry
        self.controllers: list[Controller] = []
        self.informers: dict[tuple[str, str | None], Informer] = {}
        self._queues: dict[str, RateLimitedQueue] = {}
        self._tasks: list[asyncio.Task] = []
        # Active-active sharding (runtime/sharding.py): when a ring is
        # attached, this replica only caches, enqueues and reconciles
        # keys of the shards it holds. Three fences, outermost first:
        # filtered informers (the field selector below keeps unowned
        # objects out of the cache entirely), handler-side key checks
        # (for events that arrive while ownership shifts), and the
        # dequeue-side re-check in _worker (the last line against
        # processing a key whose shard was lost while it sat queued).
        self.shard_ring = shard_ring
        if shard_ring is not None:
            shard_ring.on_acquire(self._on_shard_acquired)
            shard_ring.on_lose(self._on_shard_lost)
        self._fenced_total = self.registry.counter(
            "controller_shard_fenced_total",
            "Dequeued keys skipped because their shard is not owned",
            ["controller"])
        # Poison-pill quarantine budget (KFTPU_QUARANTINE_AFTER): a key
        # failing this many reconciles in a row is dead-lettered instead
        # of retrying at max backoff forever.
        self.quarantine_after = (
            quarantine_after if quarantine_after is not None
            else _quarantine_after_from_env())
        # ctrl name → its primary informer: the quarantine path reads the
        # object's change token (release signal) and current status
        # (Degraded condition insert) from the cache, not fresh GETs.
        self._primaries: dict[str, Informer] = {}
        self.events = EventRecorder(kube, "controller-manager",
                                    registry=self.registry)
        from kubeflow_tpu_torch.runtime.tracing import Tracer

        # The tracer owns the flight recorder: every reconcile's span tree
        # (queue wait, controller phases, API verbs) is retained after the
        # reconcile ends and served by /debug/traces.
        self.tracer = Tracer(self.registry)
        # SLO engine (runtime/slo.py): the manager owns one and installs
        # it as the process-wide feed target, so scattered producers
        # (scheduler admission wait, drain finalize, serving completions)
        # observe without constructor threading. Serves /debug/slo.
        self.slo = slo_mod.install(slo_mod.SloEngine(self.registry))
        # Durable lifecycle timelines (runtime/timeline.py): journal of
        # per-object lifecycle transitions persisted as a capped CR
        # annotation — survives manager restarts, serves /debug/timeline.
        self.timeline = timeline_mod.TimelineRecorder(kube)
        self._reconcile_total = self.registry.counter(
            "controller_reconcile_total", "Reconciles per controller", ["controller", "result"]
        )
        self._queue_depth = self.registry.gauge(
            "controller_queue_depth", "Workqueue depth", ["controller"]
        )
        self.reconcile_seconds = self.registry.histogram(
            "controller_reconcile_seconds",
            "Reconcile latency per controller",
            ["controller"],
        )
        self._quarantined_gauge = self.registry.gauge(
            "workqueue_quarantined_keys",
            "Keys dead-lettered after exhausting their retry budget",
            ["controller"],
        )

    def _owns(self, key) -> bool:
        return self.shard_ring is None or self.shard_ring.owns_key(key)

    def _shard_filter(self, obj: dict) -> bool:
        """Informer field selector: cache only owned shards' objects.
        Reads LIVE ring state so the filter follows rebalances."""
        return self.shard_ring.owns_namespace(namespace_of(obj))

    def informer_for(
        self, kind: str, label_selector: str | dict | None = None
    ) -> Informer:
        key = (kind, str(label_selector) if label_selector else None)
        if key not in self.informers:
            self.informers[key] = Informer(
                self.kube, kind, namespace=self.namespace,
                label_selector=label_selector,
                field_selector=(self._shard_filter
                                if self.shard_ring is not None else None),
                registry=self.registry,
            )
        return self.informers[key]

    def add_controller(self, ctrl: Controller) -> None:
        self.controllers.append(ctrl)
        queue = RateLimitedQueue(coalesce_window=ctrl.coalesce_window,
                                 quarantine_after=self.quarantine_after)
        self._queues[ctrl.name] = queue

        primary = self.informer_for(ctrl.kind, ctrl.label_selector)
        self._primaries[ctrl.name] = primary

        def primary_handler(event: str, obj: dict) -> None:
            key = (namespace_of(obj), name_of(obj))
            if not self._owns(key):
                return
            if event == "DELETED":
                # Failure-counter hygiene: the backoff/quarantine state
                # dies with the object (an unbounded dict would otherwise
                # leak one entry per ever-failed key). The add still runs
                # so the reconcile observes the deletion and cleans up.
                queue.forget(key)
                queue.add(key)
                self._sync_quarantine_gauge(ctrl.name, queue)
                return
            if not queue.is_quarantined(key):
                queue.add(key)
                return
            # Quarantined key: the delta's change token (metadata+spec
            # signature, computed only here — never on the hot path) is
            # the release signal. A CHANGED object gets a fresh retry
            # budget; same-token re-deliveries (relists, status-only
            # writes) leave the poison pill parked.
            if queue.add(key, token=_change_token(obj)):
                log.info("quarantine released for %s %s: object changed",
                         ctrl.kind, key)
                self._sync_quarantine_gauge(ctrl.name, queue)

        primary.add_handler(primary_handler)

        def owner_handler(_event: str, obj: dict) -> None:
            ref = controller_of(obj)
            if ref and ref.get("kind") == ctrl.kind:
                key = (namespace_of(obj), ref["name"])
                if self._owns(key):
                    queue.add(key)

        for child_kind in ctrl.owns:
            child_inf = self.informer_for(child_kind)
            child_inf.add_handler(owner_handler)
            # client-go AddIndexers on every owned kind: reconcilers look
            # children up with by_index(OWNER_INDEX, owner_uid) instead of
            # scanning the cache (or LISTing the apiserver) per reconcile.
            child_inf.add_indexer(OWNER_INDEX, index_by_owner_uid)

        for watch in ctrl.watches:
            inf = self.informer_for(watch.kind, watch.label_selector)

            def mapped_handler(_event: str, obj: dict, _map=watch.map_fn) -> None:
                for key in _map(obj) or []:
                    if self._owns(tuple(key)):
                        queue.add(tuple(key))

            inf.add_handler(mapped_handler)

    def enqueue(self, controller_name: str, key) -> None:
        """Externally enqueue a reconcile key (config watchers, tests)."""
        self._queues[controller_name].add(tuple(key))

    def add_background(self, coro_fn) -> None:
        """Register an async task started with the manager (e.g. a mounted
        config-file watcher that re-enqueues objects on change)."""
        self._background_fns = getattr(self, "_background_fns", [])
        self._background_fns.append(coro_fn)

    async def start(self) -> None:
        for informer in self.informers.values():
            await informer.start()
        for fn in getattr(self, "_background_fns", []):
            self._tasks.append(asyncio.create_task(fn(), name="background"))
        for ctrl in self.controllers:
            for i in range(ctrl.workers):
                self._tasks.append(
                    asyncio.create_task(
                        self._worker(ctrl, self._queues[ctrl.name]),
                        name=f"{ctrl.name}-worker-{i}",
                    )
                )

    async def stop(self) -> None:
        for queue in self._queues.values():
            queue.shutdown()
        for task in self._tasks:
            task.cancel()
        await reap(*self._tasks)
        for informer in self.informers.values():
            await informer.stop()

    async def wait_idle(self, timeout: float = 10.0, settle: float = 0.05) -> None:
        """Test helper: wait until all queues drain and stay drained."""
        def drained() -> bool:
            return all(
                q.ready_count() == 0 and not q._in_flight
                for q in self._queues.values()
            )

        deadline = asyncio.get_event_loop().time() + timeout
        while asyncio.get_event_loop().time() < deadline:
            if drained():
                await asyncio.sleep(settle)
                if drained():
                    return
            await asyncio.sleep(0.01)
        raise TimeoutError("manager queues did not drain")

    # ---- shard rebalance ---------------------------------------------------------

    def _on_shard_acquired(self, shard: int) -> None:
        """Ring callback (sync): absorb the new shard's keyspace. The
        filtered watches already pass its events (the field selector
        reads live ring state); the refill surfaces every object with no
        event in flight, and the primary handlers enqueue them."""
        self._tasks.append(asyncio.create_task(
            self._absorb_shard(shard), name=f"absorb-shard-{shard}"))

    async def _absorb_shard(self, shard: int) -> None:
        for informer in list(self.informers.values()):
            try:
                added = await informer.refill()
                if added:
                    log.info("shard %d absorb: %s refill surfaced %d "
                             "object(s)", shard, informer.kind, added)
            except Exception:
                log.exception("shard %d absorb refill failed for %s",
                              shard, informer.kind)

    def _on_shard_lost(self, shard: int) -> None:
        """Ring callback (sync): evict the lost shard's keys from every
        workqueue AND informer cache before the new owner can start
        reconciling them. The cache eviction is load-bearing for
        re-acquisition, not just memory hygiene: ``refill()`` is an
        additive relist that only surfaces cache-MISSING objects, so a
        replica that loses and later regains the same shard would
        otherwise refill nothing — its stale cache still holds the
        keyspace whose queued keys the purge below just dropped."""
        from kubeflow_tpu_torch.runtime.sharding import shard_of

        shards = self.shard_ring.shards

        def lost(key) -> bool:
            return shard_of(key[0], shards) == shard

        for name, queue in self._queues.items():
            purged = queue.purge(lost)
            if purged:
                log.info("shard %d lost: purged %d queued key(s) from %s",
                         shard, purged, name)
        for informer in self.informers.values():
            evicted = [key for key in informer.cache if lost(key)]
            for ns, obj_name in evicted:
                informer.evict(obj_name, ns)
            if evicted:
                log.info("shard %d lost: evicted %d cached %s object(s)",
                         shard, len(evicted), informer.kind)

    def debug_sharding(self) -> dict | None:
        """Ring + fence state for /debug — None when unsharded."""
        if self.shard_ring is None:
            return None
        return self.shard_ring.debug_info()

    # ---- poison-pill quarantine ------------------------------------------------

    def _sync_quarantine_gauge(self, name: str, queue: RateLimitedQueue) -> None:
        self._quarantined_gauge.labels(controller=name).set(
            len(queue.quarantined_keys()))

    async def _announce_quarantine(self, ctrl: Controller, key,
                                   queue: RateLimitedQueue,
                                   cached: dict | None) -> None:
        """Surface a quarantine on the object itself: a Degraded status
        condition (what the web apps and kubectl watchers read) and a
        Warning Event. Best-effort — the object may be exactly what's
        broken — and traced, so /debug/traces shows the dead-lettering."""
        ns, name = key
        failures = queue.poison_streak(key)
        # A ROOT trace, not a bare span: the reconcile root that led here
        # already closed (the exception left its `with`), and only root
        # traces reach the flight recorder — the dead-lettering must show
        # up under /debug/traces?key=<ns>/<name>.
        with self.tracer.trace("quarantine", controller=ctrl.name,
                               key=key), \
                span("quarantine", key=f"{ns}/{name}", failures=failures):
            obj = cached
            if obj is None:
                try:
                    obj = await self.kube.get_or_none(ctrl.kind, name, ns)
                except ApiError:
                    obj = None
            if obj is None:
                return
            message = (
                f"reconcile failed {failures} times in a row; reconciliation "
                "suspended until the spec changes or an operator requeues "
                "the key (POST /debug/queue/requeue)")
            condition = {
                "type": "Degraded",
                "status": "True",
                "lastProbeTime": now_iso(),
                "reason": "ReconcileQuarantined",
                "message": message,
            }
            conditions = [condition] + [
                c for c in deep_get(obj, "status", "conditions", default=[])
                if c.get("type") != "Degraded"
            ][:7]
            try:
                await self.kube.patch(
                    ctrl.kind, name, {"status": {"conditions": conditions}},
                    ns, subresource="status")
            except ApiError as exc:
                log.debug("Degraded condition write for %s %s failed "
                          "(the quarantine itself holds; the Event "
                          "below still announces it): %s", ctrl.kind,
                          key, exc)
            await self.events.event(
                obj, "Warning", "ReconcileQuarantined", message)

    def requeue_quarantined(self, controller_name: str, key) -> bool:
        """Manual escape hatch behind POST /debug/queue/requeue: un-park a
        dead-lettered key with a fresh retry budget."""
        queue = self._queues.get(controller_name)
        if queue is None:
            return False
        released = queue.release_quarantined(tuple(key))
        if released:
            log.info("quarantine released for %s %s: manual requeue",
                     controller_name, key)
            self._sync_quarantine_gauge(controller_name, queue)
        return released

    # ---- /debug introspection --------------------------------------------------

    def debug_traces(self, key=None, limit: int = 50) -> list[dict]:
        """Recent flight-recorder entries (most recent first), optionally
        for one reconcile key."""
        return self.tracer.recorder.entries(key=key, limit=limit)

    def debug_queues(self) -> dict:
        """Per-controller workqueue state: depth, in-flight, backoff keys,
        oldest queue wait."""
        return {name: q.debug_info() for name, q in self._queues.items()}

    def debug_timeline(self, key) -> list[dict]:
        """One object's lifecycle timeline (/debug/timeline/<ns>/<name>):
        the recorder's cache merged with the durable annotation read from
        the primary informer — a rebuilt manager serves the journal its
        predecessor persisted."""
        key = tuple(key)
        annotations = None
        informer = self._primaries.get("notebook")
        if informer is not None:
            obj = informer.get(key[1], key[0])
            if obj is not None:
                annotations = (get_meta(obj).get("annotations") or {})
        return timeline_mod.render(
            self.timeline.entries(key, annotations=annotations))

    def debug_informers(self) -> dict:
        """Per-informer cache state: sync, object counts, index hit/miss."""
        out = {}
        for (kind, selector), inf in self.informers.items():
            name = kind if selector is None else f"{kind}[{selector}]"
            out[name] = inf.debug_info()
        return out

    async def _worker(self, ctrl: Controller, queue: RateLimitedQueue) -> None:
        while True:
            key = await queue.get()
            if key is None:
                return
            if not self._owns(key):
                # Shard fence: ownership moved while the key sat queued.
                # Drop it — the new owner's absorb refill re-discovers it
                # — and drop its failure state with it (the streak belongs
                # to the keyspace's new owner now, starting fresh).
                queue.forget(key)
                queue.done(key)
                self._fenced_total.labels(controller=ctrl.name).inc()
                await asyncio.sleep(0)
                continue
            queue_wait = queue.take_wait(key)
            self._queue_depth.labels(controller=ctrl.name).set(len(queue))
            t0 = time.perf_counter()
            trace_id = None
            try:
                with self.tracer.trace(
                    "reconcile", controller=ctrl.name, key=key
                ) as root, self.reconcile_seconds.time(controller=ctrl.name):
                    # The wait happened before any span context existed;
                    # inject it so the trace covers queue→done end to end.
                    root.add_synthetic("queue_wait", queue_wait)
                    trace_id = root.trace_id
                    result = await ctrl.reconcile(key)
            except Exception as exc:
                log.exception("reconcile %s %s failed", ctrl.name, key)
                self._reconcile_total.labels(controller=ctrl.name, result="error").inc()
                # Record the failure BEFORE done(): if the key went dirty in
                # flight, done() re-queues it with this failure's backoff.
                # Conflicts are optimistic-concurrency noise (a stale read
                # racing another writer), not poison — they back off but
                # never advance the quarantine streak: a 409 storm
                # self-heals the moment it lifts, and quarantining healthy
                # keys through an apiserver incident would strand them
                # until a spec edit.
                queue.note_failure(key,
                                   poisonous=not isinstance(exc, Conflict))
                went_dirty = queue.done(key)
                if queue.should_quarantine(key) and not went_dirty:
                    # A dirty key means the object changed WHILE this
                    # (stale) attempt was failing — quarantining now would
                    # record the edited object's token and park the user's
                    # fix unseen. Let the dirty re-add run; a truly
                    # poisoned key fails that attempt too and quarantines
                    # on the next non-dirty cycle.
                    # Poison pill: the key exhausted its consecutive-
                    # failure budget — park it in the dead-letter set
                    # instead of retrying at max backoff forever, and say
                    # so on the object (Degraded condition + Warning
                    # Event). A spec change (new informer delta rv) or
                    # POST /debug/queue/requeue releases it.
                    cached = self._primaries[ctrl.name].get(key[1], key[0])
                    queue.quarantine(key, token=_change_token(cached))
                    self._sync_quarantine_gauge(ctrl.name, queue)
                    await self._announce_quarantine(ctrl, key, queue, cached)
                else:
                    queue.add(key, queue.backoff_delay(key))
            else:
                queue.forget(key)
                self._reconcile_total.labels(controller=ctrl.name, result="success").inc()
                # done() BEFORE the delayed re-add: adding while the key is
                # still in flight would mark it dirty and done() would then
                # re-add it with no delay — a hot requeue loop.
                queue.done(key)
                if result and result.requeue_after:
                    queue.add(key, result.requeue_after)
            # Reconcile-latency SLI: the histogram above is the raw
            # signal; this is the same number scored against the
            # objective (success and failure alike — a failing reconcile
            # still spent the operator's latency budget).
            self.slo.observe("reconcile_latency",
                             time.perf_counter() - t0, key=key,
                             trace_id=trace_id)
            # Fairness: FakeKube awaits are often non-blocking, so guarantee
            # the event loop runs between reconciles even in a hot loop.
            await asyncio.sleep(0)
