"""List/watch informer with a local cache and secondary indexes.

Mirrors client-go's shared informer: an initial list primes the cache, a watch
streams deltas, and registered handlers receive (event, obj). On watch failure
the informer relists (resync-on-error), which is all the reference stack needs
(controller-runtime does the same under the hood).

Indexes follow client-go's ``AddIndexers`` semantics: an index function maps
an object to zero or more hashable values, the informer maintains the inverted
value → keys mapping incrementally on every watch delta (and rebuilds it on
relist), and ``by_index(name, value)`` answers in O(matches) instead of the
O(cache) linear scan every per-event lookup used to pay.

The port's copy of ``kubeflow_tpu/runtime/informer.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
import zlib
from typing import Awaitable, Callable, Hashable

from kubeflow_tpu_torch.runtime.aiotasks import reap
from kubeflow_tpu_torch.runtime.objects import (
    controller_of,
    get_meta,
    key_of,
    name_of,
    namespace_of,
)

log = logging.getLogger(__name__)

Handler = Callable[[str, dict], None]
IndexFn = Callable[[dict], list[Hashable]]

# ---- built-in index functions (the client-go "namespace" indexer and the
# two shapes every controller here needs: owner UID and a label's value) ----

OWNER_INDEX = "owner"
NAMESPACE_INDEX = "namespace"


def index_by_owner_uid(obj: dict) -> list[Hashable]:
    """Index children under their controller owner's UID (unique
    cluster-wide, so the value needs no namespace qualifier)."""
    ref = controller_of(obj)
    return [ref["uid"]] if ref and ref.get("uid") else []


def index_by_namespace(obj: dict) -> list[Hashable]:
    return [namespace_of(obj)]


def index_by_label(label: str) -> IndexFn:
    """Index by a label's value, namespace-qualified: values are
    ``(namespace, label_value)`` because label values (unlike UIDs) only
    identify an object within its namespace."""

    def fn(obj: dict) -> list[Hashable]:
        value = (get_meta(obj).get("labels") or {}).get(label)
        return [(namespace_of(obj), value)] if value is not None else []

    return fn


class Informer:
    def __init__(
        self,
        kube,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        field_selector=None,
        resync_backoff: float = 1.0,
        resync_backoff_max: float = 30.0,
        registry=None,
    ):
        self.kube = kube
        self.kind = kind
        self.namespace = namespace
        self.label_selector = label_selector
        # Sharded (filtered) informer: a predicate threaded into every
        # list AND watch — the client only ever sees its slice of the
        # keyspace. A predicate reading live state (ShardRing ownership)
        # makes the filter follow rebalances without informer restarts;
        # refill() closes the gap for objects with no event in flight.
        self.field_selector = field_selector
        # Relist storm control: ``resync_backoff`` is the BASE delay (a
        # cleanly-closed watch relists after it); consecutive list/watch
        # FAILURES escalate exponentially toward ``resync_backoff_max``
        # with jitter, and any successful list resets the streak — a
        # flapping apiserver sees a decorrelated trickle of LISTs, not a
        # fixed-cadence hammer from every informer at once.
        self.resync_backoff = resync_backoff
        self.resync_backoff_max = resync_backoff_max
        self._consecutive_failures = 0
        self._last_sync: float | None = None   # monotonic of last good list
        self._current_backoff = resync_backoff
        # Deterministic per-informer jitter stream — crc32, not hash():
        # built-in str hashing is salted per process (PYTHONHASHSEED),
        # which would make a chaos-soak seed irreproducible across runs.
        self._jitter_rng = random.Random(zlib.crc32(
            f"{kind}/{namespace}/{label_selector}".encode()))
        self.cache: dict[tuple[str | None, str], dict] = {}
        self._handlers: list[Handler] = []
        self._task: asyncio.Task | None = None
        self._synced = asyncio.Event()
        # name → index fn; name → value → set of cache keys; key → the
        # values it currently occupies per index (so a MODIFIED delta can
        # leave its old buckets without re-deriving them from a stale obj).
        self._index_fns: dict[str, IndexFn] = {}
        self._indexes: dict[str, dict[Hashable, set]] = {}
        self._indexed_values: dict[str, dict[tuple, list[Hashable]]] = {}
        # Per-index [hits, misses] — the registry metric aggregates the
        # same numbers fleet-wide; these local counters feed the
        # per-informer /debug/informers view without a registry scrape.
        self._index_stats: dict[str, list[int]] = {}
        self._relists = 0
        self._refills = 0
        self._lookups = (
            registry.counter(
                "informer_index_lookups_total",
                "Secondary-index lookups per informer",
                ["kind", "index", "result"],
            )
            if registry is not None
            else None
        )
        self._relists_total = (
            registry.counter(
                "informer_relists_total",
                "List attempts per informer (first sync + every relist)",
                ["kind"],
            )
            if registry is not None
            else None
        )
        self._sync_age = (
            registry.gauge(
                "informer_last_sync_age_seconds",
                "Seconds since the informer's last successful list "
                "(refreshed on sync and on every /debug/informers read)",
                ["kind"],
            )
            if registry is not None
            else None
        )

    # ---- indexes ---------------------------------------------------------------

    def add_indexer(self, name: str, fn: IndexFn) -> None:
        """Register a secondary index (idempotent per name, client-go
        AddIndexers). Safe after start: existing cache entries are indexed
        on the spot."""
        if name in self._index_fns:
            return
        self._index_fns[name] = fn
        self._indexes[name] = {}
        self._indexed_values[name] = {}
        for key, obj in self.cache.items():
            self._index_one(name, key, obj)

    def has_indexer(self, name: str) -> bool:
        return name in self._index_fns

    def by_index(self, name: str, value: Hashable) -> list[dict]:
        """Objects whose index fn emitted ``value`` — O(matches)."""
        keys = self._indexes[name].get(value)  # KeyError for unknown index
        stats = self._index_stats.setdefault(name, [0, 0])
        stats[0 if keys else 1] += 1
        if self._lookups is not None:
            self._lookups.labels(
                kind=self.kind, index=name, result="hit" if keys else "miss"
            ).inc()
        return [self.cache[k] for k in keys or () if k in self.cache]

    def _index_one(self, name: str, key: tuple, obj: dict) -> None:
        try:
            values = list(self._index_fns[name](obj))
        except Exception:
            log.exception("index %s failed for %s %s", name, self.kind, key)
            values = []
        self._indexed_values[name][key] = values
        for value in values:
            self._indexes[name].setdefault(value, set()).add(key)

    def _unindex_one(self, name: str, key: tuple) -> None:
        for value in self._indexed_values[name].pop(key, ()):
            bucket = self._indexes[name].get(value)
            if bucket is not None:
                bucket.discard(key)
                if not bucket:
                    del self._indexes[name][value]

    def _apply_delta(self, event: str, key: tuple, obj: dict) -> None:
        """Single cache+index writer for watch deltas and relist diffs —
        indexes can never drift from the cache because every mutation
        funnels through here."""
        for name in self._index_fns:
            self._unindex_one(name, key)
        if event == "DELETED":
            self.cache.pop(key, None)
        else:
            self.cache[key] = obj
            for name in self._index_fns:
                self._index_one(name, key, obj)

    # ---- handlers / lifecycle --------------------------------------------------

    def add_handler(self, fn: Handler) -> None:
        self._handlers.append(fn)

    def get(self, name: str, namespace: str | None = None) -> dict | None:
        return self.cache.get((namespace, name))

    def evict(self, name: str, namespace: str | None = None) -> None:
        """Drop one entry from the cache AND every index (controllers that
        must not trust a possibly-stale read — e.g. after deleting the
        object — use this instead of poking ``cache`` directly, which
        would strand index entries). The watch repopulates it if the
        object still exists."""
        key = (namespace, name)
        if key in self.cache:
            self._apply_delta("DELETED", key, self.cache[key])

    def items(self) -> list[dict]:
        return list(self.cache.values())

    def _selector_kwargs(self) -> dict:
        # Built conditionally so clients without filtered-watch support
        # (HttpKube today) keep their unchanged call signature.
        return ({"field_selector": self.field_selector}
                if self.field_selector is not None else {})

    def _admit(self, obj: dict) -> bool:
        """Live re-check of a callable field selector at CACHE-APPLY time.
        List snapshots and queued watch events cross awaits; with a
        shard-filter selector the ownership they were filtered under can
        be stale by the time they land — applying a pre-loss snapshot
        would re-cache a foreign object, and refill() (cache-miss based)
        would then never re-surface it on a later regain."""
        fs = self.field_selector
        return not callable(fs) or fs(obj)

    async def refill(self) -> int:
        """Additive relist: list under the CURRENT field selector and
        dispatch ADDED for keys missing from the cache. Never deletes —
        a list snapshot racing the live watch must not retract objects
        the watch already delivered. This is the shard-absorption path:
        after a replica acquires a shard, refill() surfaces every object
        of the new keyspace that has no organic event in flight, and the
        primary handlers enqueue them."""
        objs, _rv = await self.kube.list_with_rv(
            self.kind, self.namespace, self.label_selector,
            **self._selector_kwargs())
        self._refills += 1
        added = 0
        for obj in objs:
            if not self._admit(obj):
                continue  # shard lost while the list was in flight
            key = key_of(obj)
            if key in self.cache:
                continue
            self._apply_delta("ADDED", key, obj)
            self._dispatch("ADDED", obj)
            added += 1
        return added

    def debug_info(self) -> dict:
        """JSON-shaped snapshot for the /debug/informers endpoint."""
        sync_age = (
            round(time.monotonic() - self._last_sync, 3)
            if self._last_sync is not None else None
        )
        if self._sync_age is not None and sync_age is not None:
            # /debug reads double as the gauge refresh (a plain gauge
            # can't age itself between scrapes).
            self._sync_age.labels(kind=self.kind).set(sync_age)
        return {
            "kind": self.kind,
            "namespace": self.namespace,
            "label_selector": (
                str(self.label_selector) if self.label_selector else None
            ),
            "synced": self._synced.is_set(),
            "filtered": self.field_selector is not None,
            "objects": len(self.cache),
            "relists": self._relists,
            "refills": self._refills,
            # Storm-control state: a flapping watch shows up as a failure
            # streak + growing backoff + an aging last sync, instead of a
            # fixed-cadence LIST hammer.
            "consecutive_failures": self._consecutive_failures,
            "current_backoff_sec": round(self._current_backoff, 3),
            "last_sync_age_sec": sync_age,
            "indexes": {
                name: {
                    "values": len(self._indexes.get(name, {})),
                    "hits": self._index_stats.get(name, [0, 0])[0],
                    "misses": self._index_stats.get(name, [0, 0])[1],
                }
                for name in self._index_fns
            },
        }

    async def start(self) -> None:
        self._task = asyncio.create_task(self._run(), name=f"informer-{self.kind}")
        await self._synced.wait()

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            await reap(self._task)

    def _dispatch(self, event: str, obj: dict) -> None:
        for fn in self._handlers:
            try:
                fn(event, obj)
            except Exception:
                log.exception("informer handler failed for %s %s", self.kind, key_of(obj))

    async def _run(self) -> None:
        while True:
            try:
                # kftpu: ignore[await-race] the single _run task is this counter's only writer; debug_info only reads it
                self._relists += 1
                if self._relists_total is not None:
                    self._relists_total.labels(kind=self.kind).inc()
                refills_at_list = self._refills
                objs, rv = await self.kube.list_with_rv(
                    self.kind, self.namespace, self.label_selector,
                    **self._selector_kwargs()
                )
                # A successful list resets the failure streak — backoff
                # escalation is for CONSECUTIVE failures only.
                # kftpu: ignore[await-race] the single _run task is this attr's only writer; debug_info only reads it
                self._consecutive_failures = 0
                self._current_backoff = self.resync_backoff
                self._last_sync = time.monotonic()
                if self._sync_age is not None:
                    self._sync_age.labels(kind=self.kind).set(0.0)
                fresh = {key_of(o): o for o in objs if self._admit(o)}
                # The deletion sweep trusts the snapshot's completeness;
                # a refill() that interleaved with the list (shard
                # absorbed mid-await) added keys the stale snapshot never
                # saw — sweeping now would evict them with no event ever
                # coming back. Skip one round; the next relist re-syncs.
                if self._refills == refills_at_list:
                    for key, obj in list(self.cache.items()):
                        if key not in fresh:
                            self._apply_delta("DELETED", key, obj)
                            self._dispatch("DELETED", obj)
                for key, obj in fresh.items():
                    existed = key in self.cache
                    self._apply_delta("MODIFIED" if existed else "ADDED", key, obj)
                    self._dispatch("MODIFIED" if existed else "ADDED", obj)
                self._synced.set()
                # resource_version threads the list's snapshot into the watch
                # so deletes between list and watch are never missed; a 410
                # Gone (or any error) falls through to a relist.
                async for event, obj in self.kube.watch(
                    self.kind,
                    self.namespace,
                    self.label_selector,
                    send_initial=False,
                    resource_version=rv,
                    **self._selector_kwargs(),
                ):
                    if event != "DELETED" and not self._admit(obj):
                        continue  # ownership moved while the event queued
                    self._apply_delta(event, (namespace_of(obj), name_of(obj)), obj)
                    self._dispatch(event, obj)
                # Watch closed cleanly → relist after the base backoff,
                # jittered DOWN like the failure path: an apiserver restart
                # closes every informer's watch in the same instant, and a
                # clean close must not relist in lockstep either.
                delay = self.resync_backoff * \
                    (1.0 - 0.25 * self._jitter_rng.random())
            except asyncio.CancelledError:
                raise
            except Exception:
                self._consecutive_failures += 1
                delay = min(
                    self.resync_backoff * (2 ** (self._consecutive_failures - 1)),
                    self.resync_backoff_max,
                )
                # Jitter decorrelates the relist herd: every informer of a
                # restarting apiserver would otherwise LIST in lockstep.
                # Jittered DOWNWARD so the configured ceiling is a real
                # ceiling (additive jitter would overshoot it by 25%).
                delay *= 1.0 - 0.25 * self._jitter_rng.random()
                self._current_backoff = delay
                log.exception(
                    "informer %s list/watch failed (%d in a row); relist "
                    "in %.2fs", self.kind, self._consecutive_failures, delay)
            await asyncio.sleep(delay)
