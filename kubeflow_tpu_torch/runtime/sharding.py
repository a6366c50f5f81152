"""Namespace-hash sharding for an active-active control plane.

One manager replica per *process slot*, N lease-backed **shards** over the
controller keyspace: every key hashes namespace → shard, and a replica
reconciles a key iff it currently holds that shard's Lease. This is the
direction knative's StatefulSet bucket leases and client-go sharded
informers take — membership IS lease ownership, so the failure story
reduces to the lease protocol already proven in
``runtime/leaderelection.py``:

* one ``coordination.k8s.io/v1`` Lease per shard
  (``kubeflow-tpu-shard-<i>``), held by at most one replica;
* each replica has a static *preferred* slice (``shard % replicas ==
  replica``) it claims eagerly, so a healthy fleet converges to an even
  spread without coordination;
* a dead replica's shards expire and are absorbed by survivors — a
  non-preferred shard is only claimed after it has been observed
  orphaned on two consecutive ticks, giving the preferred owner a full
  tick of priority and keeping startup races from scrambling the spread;
* a restarted preferred owner reclaims its slice **on demand**: it
  stamps a claim annotation (``SHARD_PREFERRED_CLAIM``) on the held
  Lease, and the holder releases at its next renew iff the claim is
  younger than ``lease_seconds``. A dead replica never stamps, so an
  absorbed shard whose preferred owner is gone is simply kept — no
  periodic release churn into a void (the failure mode of timer-based
  handback). ``handback_ticks`` remains as an optional belt-and-
  suspenders periodic release, off by default.

Hashing is ``zlib.crc32``, not ``hash()``: built-in str hashing is salted
per process (PYTHONHASHSEED) and would both break seed-reproducible
chaos runs and disagree ACROSS replicas — two replicas disagreeing on
``shard_of`` is a dual-processing bug, not a perf problem.

Shard 0 doubles as the **arbiter** shard: cluster-scoped keys (no
namespace) hash there, and whichever replica holds it runs the global
chip-ledger arbitration (scheduler/runtime.py ``attach_ring``).

The port's copy of ``kubeflow_tpu/runtime/sharding.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import time
import zlib

from kubeflow_tpu_torch.api.keys import SHARD_PREFERRED_CLAIM
from kubeflow_tpu_torch.runtime.aiotasks import reap
from kubeflow_tpu_torch.runtime.errors import ApiError
from kubeflow_tpu_torch.runtime.leaderelection import LeaderElector
from kubeflow_tpu_torch.runtime.metrics import global_registry
from kubeflow_tpu_torch.runtime.objects import deep_get, fmt_iso_micro, parse_iso

log = logging.getLogger(__name__)

LEASE_PREFIX = "kubeflow-tpu-shard"
ARBITER_SHARD = 0


def shard_of(namespace: str | None, shards: int) -> int:
    """Map a key's namespace to its shard. Cluster-scoped objects (no
    namespace) land on the arbiter shard deterministically."""
    if shards <= 1:
        return 0
    if not namespace:
        return ARBITER_SHARD
    return zlib.crc32(namespace.encode()) % shards


class ShardRing:
    """One replica's view of the shard lease ring.

    The ring never runs per-elector renew loops; a single maintenance
    loop ticks every ``renew_seconds`` and, per shard: renews what it
    holds, eagerly claims its preferred slice, and absorbs orphans after
    the two-tick confirmation. Ownership reads (``owns_key`` & friends)
    are synchronous set lookups — they sit on the informer-delta and
    dequeue hot paths.
    """

    def __init__(
        self,
        kube,
        *,
        shards: int = 4,
        replica: int = 0,
        replicas: int = 1,
        identity: str | None = None,
        namespace: str = "kubeflow-tpu",
        lease_prefix: str = LEASE_PREFIX,
        lease_seconds: float = 15.0,
        renew_seconds: float = 5.0,
        handback_ticks: int = 0,
        clock=None,
        registry=None,
    ):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if not (0 <= replica < max(1, replicas)):
            raise ValueError(f"replica {replica} out of range for "
                             f"{replicas} replicas")
        self.kube = kube
        self.shards = shards
        self.replica = replica
        self.replicas = max(1, replicas)
        self.identity = identity or f"replica-{replica}"
        self.namespace = namespace
        self.renew_seconds = renew_seconds
        self.lease_seconds = lease_seconds
        self.handback_ticks = handback_ticks
        self.clock = clock or time.time
        self._lease_prefix = lease_prefix
        registry = registry or global_registry
        self._electors = [
            LeaderElector(
                kube,
                lease_name=f"{lease_prefix}-{i}",
                namespace=namespace,
                identity=self.identity,
                lease_seconds=lease_seconds,
                renew_seconds=renew_seconds,
                clock=self.clock,
                registry=registry,
            )
            for i in range(shards)
        ]
        self._owned: set[int] = set()
        self._renew_failures: dict[int, int] = {}
        # shard → consecutive ticks observed orphaned (expired/unheld);
        # a non-preferred shard needs 2 before absorption.
        self._orphan_ticks: dict[int, int] = {}
        # shard → ticks left before a voluntary handback (absorbed
        # shards only; 0 entries mean no countdown running).
        self._handback: dict[int, int] = {}
        # Last observed holder per shard (observability only).
        self.holders: dict[int, str | None] = {}
        self.transitions = 0
        self._acquire_cbs: list = []
        self._lose_cbs: list = []
        self._task: asyncio.Task | None = None
        self._m_owned = registry.gauge(
            "shard_ring_owned_shards",
            "Shards whose lease this replica currently holds")
        self._m_transitions = registry.counter(
            "shard_ring_transitions_total",
            "Shard ownership changes observed by this replica",
            ["shard", "event"])  # acquired | lost | handback

    # ---- ownership reads (hot path, sync) ---------------------------------------

    @property
    def owned(self) -> frozenset:
        return frozenset(self._owned)

    def owns_shard(self, shard: int) -> bool:
        return shard in self._owned

    def owns_namespace(self, namespace: str | None) -> bool:
        return shard_of(namespace, self.shards) in self._owned

    def owns_key(self, key) -> bool:
        """key is a (namespace, name) tuple — the manager's Key shape."""
        return shard_of(key[0], self.shards) in self._owned

    @property
    def is_arbiter(self) -> bool:
        return ARBITER_SHARD in self._owned

    # ---- callbacks --------------------------------------------------------------

    def on_acquire(self, cb) -> None:
        """cb(shard: int), fired synchronously when a shard is gained."""
        self._acquire_cbs.append(cb)

    def on_lose(self, cb) -> None:
        """cb(shard: int), fired synchronously when a shard is lost —
        BEFORE any lease API write, so fencing precedes visibility."""
        self._lose_cbs.append(cb)

    def _fire(self, cbs: list, shard: int) -> None:
        for cb in cbs:
            try:
                cb(shard)
            except Exception:
                log.exception("shard ring callback failed for shard %d", shard)

    def _gain(self, shard: int) -> None:
        if shard in self._owned:
            return
        self._owned.add(shard)
        self.transitions += 1
        self.holders[shard] = self.identity
        self._electors[shard]._set_leader(True)
        self._m_owned.set(len(self._owned))
        self._m_transitions.labels(shard=str(shard), event="acquired").inc()
        self._renew_failures[shard] = 0
        self._orphan_ticks.pop(shard, None)
        if self.handback_ticks and not self._preferred(shard):
            self._handback[shard] = self.handback_ticks
        log.info("shard ring: %s acquired shard %d", self.identity, shard)
        self._fire(self._acquire_cbs, shard)

    def _drop(self, shard: int, event: str = "lost") -> None:
        if shard not in self._owned:
            return
        # Fence FIRST: the moment ownership is gone locally, workers stop
        # dequeuing this shard's keys — only then may the lease become
        # claimable by someone else.
        self._owned.discard(shard)
        self.transitions += 1
        self._handback.pop(shard, None)
        self._electors[shard]._set_leader(False)
        self._m_owned.set(len(self._owned))
        self._m_transitions.labels(shard=str(shard), event=event).inc()
        log.log(logging.INFO if event == "handback" else logging.ERROR,
                "shard ring: %s %s shard %d", self.identity, event, shard)
        self._fire(self._lose_cbs, shard)

    def _preferred(self, shard: int) -> bool:
        return shard % self.replicas == self.replica

    # ---- maintenance ------------------------------------------------------------

    async def tick(self) -> None:
        """One maintenance round: renew held shards, claim preferred and
        confirmed-orphan shards. Public so tests (and soak harnesses with
        scaled clocks) can drive the ring deterministically."""
        for shard in range(self.shards):
            el = self._electors[shard]
            if shard in self._owned:
                countdown = self._handback.get(shard)
                if countdown is not None:
                    if countdown <= 1:
                        await self._handback_shard(shard, el)
                        continue
                    # kftpu: ignore[await-race] the single maintenance task (start's tick + _loop) is the only writer of the per-shard counters; debug_info only reads, and a torn snapshot there is harmless
                    self._handback[shard] = countdown - 1
                if await el.try_acquire():
                    # kftpu: ignore[await-race] same single-maintenance-writer argument as _handback above
                    self._renew_failures[shard] = 0
                    # Demand-driven handback: an absorbed shard goes back
                    # the moment its preferred owner proves it is alive by
                    # stamping a fresh claim on the Lease. No claimant →
                    # keep the shard forever (the owner is dead; releasing
                    # would just churn the keyspace through an unowned
                    # window every few ticks for nobody).
                    if not self._preferred(shard):
                        claimant = await self._fresh_claim(shard)
                        if claimant is not None and claimant != self.identity:
                            await self._handback_shard(shard, el)
                    continue
                # Mirror the single-lease renew tolerance: transient API
                # failures are survivable while the lease is still fresh;
                # an observed FOREIGN holder is an immediate loss.
                self._renew_failures[shard] = \
                    self._renew_failures.get(shard, 0) + 1
                holder = await el.current_holder()
                lost_for_sure = holder is not None and holder != self.identity
                expired_budget = (self._renew_failures[shard]
                                  * self.renew_seconds >= self.lease_seconds)
                if lost_for_sure or expired_budget:
                    self.holders[shard] = holder
                    self._drop(shard)
                continue
            holder = await el.current_holder()
            self.holders[shard] = holder
            if holder is None:
                # kftpu: ignore[await-race] same single-maintenance-writer argument as _handback above
                self._orphan_ticks[shard] = \
                    self._orphan_ticks.get(shard, 0) + 1
            else:
                self._orphan_ticks[shard] = 0
            eager = self._preferred(shard)
            confirmed_orphan = self._orphan_ticks.get(shard, 0) >= 2
            if eager or confirmed_orphan:
                if await el.try_acquire():
                    self._gain(shard)
                elif eager and holder is not None:
                    # Preferred shard held fresh by someone else (we came
                    # back after a crash, or a startup race scrambled the
                    # spread): ask for it back. The holder releases at its
                    # next renew; acquisition follows on our next tick.
                    await self._stamp_claim(shard)

    async def _handback_shard(self, shard: int, el: LeaderElector) -> None:
        """Voluntarily release an absorbed shard so its (possibly
        restarted) preferred owner can reclaim it."""
        self._drop(shard, event="handback")
        await el.release()

    # ---- demand-driven handback (claim protocol) --------------------------------

    def _lease_name(self, shard: int) -> str:
        return f"{self._lease_prefix}-{shard}"

    def _parse_claim(self, lease: dict) -> str | None:
        """The claim annotation's identity, or None when absent/stale.
        Freshness is judged against ``lease_seconds`` with THIS replica's
        clock — same skew tolerance as the lease protocol itself; a
        claimant that stopped stamping (died) goes stale within one
        lease duration and is ignored."""
        raw = deep_get(lease, "metadata", "annotations",
                       SHARD_PREFERRED_CLAIM, default="") or ""
        ident, _, stamp = raw.rpartition(" ")
        ts = parse_iso(stamp)
        if not ident or ts is None or self.clock() - ts > self.lease_seconds:
            return None
        return ident

    async def _fresh_claim(self, shard: int) -> str | None:
        try:
            lease = await self.kube.get(
                "Lease", self._lease_name(shard), self.namespace)
        except ApiError:
            return None
        return self._parse_claim(lease)

    async def _stamp_claim(self, shard: int) -> None:
        """Record that this live replica wants its preferred shard back.
        Write-through CAS like the lease protocol: the update carries the
        read's resourceVersion, so a racing holder renew wins cleanly and
        we simply retry next tick."""
        try:
            lease = await self.kube.get(
                "Lease", self._lease_name(shard), self.namespace)
        except ApiError:
            return
        if self._parse_claim(lease) == self.identity:
            return  # our claim is still fresh; don't churn the holder's CAS
        ann = lease.setdefault("metadata", {}).setdefault("annotations", {})
        ann[SHARD_PREFERRED_CLAIM] = \
            f"{self.identity} {fmt_iso_micro(self.clock())}"
        try:
            # kftpu: ignore[await-race] the update IS the CAS: it carries the resourceVersion from the get above, so a racing holder renew wins with Conflict and we retry next tick — re-validation is server-side
            await self.kube.update("Lease", lease)
        except ApiError:
            pass  # lost the CAS to the holder's renew; retry next tick

    async def start(self) -> None:
        """Run one synchronous tick (so a cold replica owns its preferred
        shards before its manager starts), then maintain in background."""
        await self.tick()
        self._task = asyncio.create_task(self._loop(), name="shard-ring")

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.renew_seconds)
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("shard ring maintenance tick failed")

    async def stop(self, *, release: bool = True) -> None:
        """Graceful departure: stop maintaining and (by default) release
        every held lease so survivors absorb without waiting for expiry.
        ``release=False`` models a crash — leases are left to expire."""
        if self._task:
            self._task.cancel()
            await reap(self._task)
            # kftpu: ignore[await-race] the cancel above stopped the only other writer (_loop never touches _task anyway); shutdown is caller-serialized
            self._task = None
        for shard in sorted(self._owned):
            self._drop(shard, event="lost")
            if release:
                await self._electors[shard].release()

    async def kill(self) -> None:
        """Simulated process crash for chaos harnesses: the maintenance
        loop dies and NOTHING else happens — no lease writes, no fencing
        callbacks, local ownership state frozen mid-flight. Survivors must
        recover purely from lease expiry, exactly as with a real SIGKILL."""
        if self._task:
            self._task.cancel()
            await reap(self._task)
            # kftpu: ignore[await-race] same cancel-first shutdown ordering as stop()
            self._task = None

    # ---- observability ----------------------------------------------------------

    def debug_info(self) -> dict:
        return {
            "identity": self.identity,
            "shards": self.shards,
            "replica": self.replica,
            "replicas": self.replicas,
            "owned": sorted(self._owned),
            "is_arbiter": self.is_arbiter,
            "transitions": self.transitions,
            "holders": {str(s): h for s, h in sorted(self.holders.items())},
        }
