"""Lease-based leader election.

controller-runtime equivalent (the reference managers pass
``--leader-elect``; e.g. ``notebook-controller/main.go``): one replica holds
a ``coordination.k8s.io/v1`` Lease and runs the controllers; standbys renew-
watch and take over when the lease expires. The same object/protocol as
client-go's leaderelection package, asyncio-native.

``ShardRing`` (runtime/sharding.py) composes N of these — one Lease per
keyspace shard — into an active-active membership ring.

The port's copy of ``kubeflow_tpu/runtime/leaderelection.py``: it keeps
its own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid

from kubeflow_tpu_torch.runtime.aiotasks import reap
from kubeflow_tpu_torch.runtime.errors import ApiError, NotFound
from kubeflow_tpu_torch.runtime.metrics import global_registry
from kubeflow_tpu_torch.runtime.objects import deep_get, fmt_iso_micro, parse_iso

log = logging.getLogger(__name__)


class LeaderElector:
    def __init__(
        self,
        kube,
        *,
        lease_name: str = "kubeflow-tpu-controller-manager",
        namespace: str = "kubeflow-tpu",
        identity: str | None = None,
        lease_seconds: float = 15.0,
        renew_seconds: float = 5.0,
        retry_seconds: float = 2.0,
        clock=None,
        registry=None,
        on_lost=None,
    ):
        self.kube = kube
        self.lease_name = lease_name
        self.namespace = namespace
        self.identity = identity or f"manager-{uuid.uuid4().hex[:8]}"
        self.lease_seconds = lease_seconds
        self.renew_seconds = renew_seconds
        self.retry_seconds = retry_seconds
        self.clock = clock or time.time
        self.is_leader = False
        self.transitions = 0
        # Sync callback fired from the renew loop the moment leadership is
        # (possibly) lost — split-brain fencing must not wait for a poll.
        self._on_lost = on_lost
        self._renew_task: asyncio.Task | None = None
        registry = registry or global_registry
        self._m_held = registry.gauge(
            "leader_election_is_leader",
            "1 while this process holds the named lease",
            ["lease"])
        self._m_transitions = registry.counter(
            "leader_election_transitions_total",
            "Leadership acquisitions and losses observed by this process",
            ["lease", "event"])  # acquired | lost

    def _set_leader(self, held: bool) -> None:
        if held == self.is_leader:
            return
        self.is_leader = held
        self.transitions += 1
        self._m_held.labels(lease=self.lease_name).set(1.0 if held else 0.0)
        self._m_transitions.labels(
            lease=self.lease_name,
            event="acquired" if held else "lost").inc()
        if not held and self._on_lost is not None:
            try:
                self._on_lost(self)
            except Exception:
                log.exception("leader election: on_lost callback failed")

    def _lease_body(self) -> dict:
        # The apiserver's field is int32 seconds; int() would truncate a
        # sub-second test lease to 0 — instantly expired for EVERY reader,
        # which collapses mutual exclusion (all candidates acquire). Keep
        # the float for fractional durations (FakeKube soak clocks only;
        # production configs are whole seconds).
        duration = (int(self.lease_seconds) if self.lease_seconds >= 1
                    else self.lease_seconds)
        return {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.lease_name, "namespace": self.namespace},
            "spec": {
                "holderIdentity": self.identity,
                "leaseDurationSeconds": duration,
                "renewTime": fmt_iso_micro(self.clock()),
            },
        }

    def _expired(self, lease: dict) -> bool:
        renew = parse_iso(deep_get(lease, "spec", "renewTime", default="") or "")
        duration = deep_get(
            lease, "spec", "leaseDurationSeconds", default=self.lease_seconds
        )
        if renew is None:
            return True
        return self.clock() - renew > duration

    async def current_holder(self) -> str | None:
        """Read the lease's holder (None when absent/unset/expired) —
        observability only, never part of the acquisition protocol."""
        try:
            lease = await self.kube.get("Lease", self.lease_name, self.namespace)
        except ApiError:
            return None
        if self._expired(lease):
            return None
        return deep_get(lease, "spec", "holderIdentity") or None

    async def try_acquire(self) -> bool:
        """One acquisition attempt; True when this identity holds the lease.
        Any apiserver error is a failed attempt, never an exception — a
        transient blip must not crash acquire() nor kill the renew loop."""
        try:
            lease = await self.kube.get("Lease", self.lease_name, self.namespace)
        except NotFound:
            try:
                await self.kube.create("Lease", self._lease_body())
                return True
            except ApiError:
                return False
        except ApiError:
            return False
        holder = deep_get(lease, "spec", "holderIdentity")
        if holder == self.identity or self._expired(lease):
            lease["spec"] = self._lease_body()["spec"]
            try:
                # kftpu: ignore[await-race] the update IS the CAS: it carries the resourceVersion read above, and the apiserver rejects a racing writer with Conflict — re-validation is server-side
                await self.kube.update("Lease", lease)
                return True
            except ApiError:
                return False
        return False

    async def acquire(self) -> None:
        """Block until leadership is held, then keep renewing in background."""
        while not await self.try_acquire():
            await asyncio.sleep(self.retry_seconds)
        self._set_leader(True)
        log.info("leader election: %s acquired %s", self.identity, self.lease_name)
        self._renew_task = asyncio.create_task(self._renew_loop())

    async def _renew_loop(self) -> None:
        try:
            failures = 0
            while True:
                await asyncio.sleep(self.renew_seconds)
                if await self.try_acquire():
                    failures = 0
                    continue
                # Tolerate transient renew failures while the lease we hold
                # is still fresh; give up once it could have expired.
                failures += 1
                if failures * self.renew_seconds >= self.lease_seconds:
                    break
        except asyncio.CancelledError:
            raise
        except Exception:
            log.exception("leader election: renew loop crashed")
        # Lost (or possibly lost) the lease: a split-brain manager must
        # stop reconciling immediately.
        self._set_leader(False)
        log.error("leader election: %s LOST %s", self.identity, self.lease_name)

    async def release(self) -> None:
        if self._renew_task:
            self._renew_task.cancel()
            await reap(self._renew_task)
            # kftpu: ignore[await-race] the cancel above stopped the only other writer of _renew_task; release() itself is not re-entered (callers serialize shutdown)
            self._renew_task = None
        # Unconditionally offer the lease back when the API says we hold
        # it — callers that drive try_acquire() directly (ShardRing) never
        # set is_leader, and a graceful departure must not leave survivors
        # waiting out the full lease expiry.
        try:
            lease = await self.kube.get(
                "Lease", self.lease_name, self.namespace
            )
            if deep_get(lease, "spec", "holderIdentity") == self.identity:
                lease["spec"]["holderIdentity"] = ""
                lease["spec"]["renewTime"] = None
                # kftpu: ignore[await-race] CAS again: the update carries the freshly-read resourceVersion, so clearing a lease stolen mid-flight fails with Conflict instead of clobbering
                await self.kube.update("Lease", lease)
        except ApiError:
            pass
        self._set_leader(False)
