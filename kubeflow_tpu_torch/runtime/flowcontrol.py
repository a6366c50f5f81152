"""Client-side priority & fairness for apiserver traffic (the port of
``kubeflow_tpu/runtime/flowcontrol.py``).

The server-side APF machinery protects the apiserver from *all* clients;
this is the client protecting itself — and the cluster — from its own
burst shapes. Three lanes, each a bounded concurrency pool:

- **read** (get/list): the informer relists and cold-cache fallbacks.
- **write** (create/update/patch/delete of anything but Events): the
  traffic that makes reconciles converge.
- **event**: best-effort Event emission. Low priority by construction —
  an event-lane request defers while the write lane is SATURATED
  (queued-or-in-flight writes ≥ the write limit), so an event flood (a
  cluster-wide slice restart narrating itself) can never starve the CR
  writes that fix it. The deference is bounded (``event_patience``):
  reconciles await their own event emissions inline, so an event must
  never wedge the reconcile issuing the writes — after the patience
  window it proceeds through its own (tiny) lane, which by construction
  never consumes write capacity anyway.

Watches are exempt: they are long-lived streams, and parking one in a
semaphore slot would deadlock the informer machinery the lanes exist to
serve. Both API clients route through this class — ``HttpKube`` on the
wire, ``FakeKube`` in-process — so lane behavior is testable in tier-1.

Limits default from env (documented in docs/operations.md):
``KUBE_CLIENT_MAX_READS``, ``KUBE_CLIENT_MAX_WRITES``,
``KUBE_CLIENT_EVENT_LANE``.
"""

from __future__ import annotations

import asyncio
import contextlib
import os

from kubeflow_tpu_torch.runtime.errors import NotFound

WRITE_VERBS = frozenset(
    {"create", "update", "update_status", "patch", "delete"})
READ_VERBS = frozenset({"get", "list"})

READS_ENV = "KUBE_CLIENT_MAX_READS"
WRITES_ENV = "KUBE_CLIENT_MAX_WRITES"
EVENTS_ENV = "KUBE_CLIENT_EVENT_LANE"
EVENT_PATIENCE_ENV = "KUBE_CLIENT_EVENT_PATIENCE"
QPS_ENV = "KUBE_CLIENT_MAX_QPS"

DEFAULT_MAX_READS = 16
DEFAULT_MAX_WRITES = 8
DEFAULT_EVENT_LANE = 1
DEFAULT_EVENT_PATIENCE_SEC = 1.0
# client-go's rest.Config defaults QPS=20/Burst=30, i.e. burst = 1.5×QPS.
# Off (None) by default here: lanes bound concurrency already, and the
# QPS bucket is the per-REPLICA budget knob for sharded deployments.
QPS_BURST_FACTOR = 1.5


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, "") or default))
    except ValueError:
        return default


class FlowControl:
    """Bounded per-lane concurrency with a low-priority event lane."""

    def __init__(
        self,
        max_reads: int | None = None,
        max_writes: int | None = None,
        event_lane: int | None = None,
        event_patience: float | None = None,
        max_qps: float | None = None,
    ):
        # Explicit 0 is clamped to 1, not silently replaced by the env
        # default — a lane can be narrowed to serial, never to "off".
        self.max_reads = (max(1, max_reads) if max_reads is not None
                          else _env_int(READS_ENV, DEFAULT_MAX_READS))
        self.max_writes = (max(1, max_writes) if max_writes is not None
                           else _env_int(WRITES_ENV, DEFAULT_MAX_WRITES))
        self.event_lane = (max(1, event_lane) if event_lane is not None
                           else _env_int(EVENTS_ENV, DEFAULT_EVENT_LANE))
        self.event_patience = (
            event_patience if event_patience is not None
            else _env_float(EVENT_PATIENCE_ENV, DEFAULT_EVENT_PATIENCE_SEC))
        # client-go-style request rate cap (QPS + burst bucket), applied
        # to read/write lanes before lane admission. None = unlimited
        # (the historical behavior); the env knob lets a deployment cap
        # every replica uniformly.
        if max_qps is None:
            env_qps = _env_float(QPS_ENV, 0.0)
            max_qps = env_qps if env_qps > 0 else None
        self.max_qps = max_qps
        self._qps_burst = (max(1.0, max_qps * QPS_BURST_FACTOR)
                           if max_qps else 0.0)
        self._qps_tokens = self._qps_burst
        self._qps_refill_at: float | None = None
        self._read_sem = asyncio.Semaphore(self.max_reads)
        self._write_sem = asyncio.Semaphore(self.max_writes)
        self._event_sem = asyncio.Semaphore(self.event_lane)
        # Writes queued OR in flight. The event lane defers while this
        # saturates the write limit (set() = lane has spare capacity).
        self._writes_busy = 0
        self._lane_open = asyncio.Event()
        self._lane_open.set()
        self.admitted = {"read": 0, "write": 0, "event": 0}

    @staticmethod
    def lane_of(verb: str, kind: str | None = None) -> str | None:
        if verb in WRITE_VERBS:
            return "event" if kind == "Event" else "write"
        if verb in READ_VERBS:
            return "read"
        return None  # watch / pod_logs: long-lived or out of scope

    async def _pace(self) -> None:
        """Token-bucket pacing: take one token (going negative reserves a
        future slot, which keeps waiters FIFO-fair) and sleep out the
        deficit. Watches and the event lane are exempt — streams are
        long-lived, and events already yield to writes by design."""
        if not self.max_qps:
            return
        loop = asyncio.get_running_loop()
        now = loop.time()
        if self._qps_refill_at is not None:
            self._qps_tokens = min(
                self._qps_burst,
                self._qps_tokens + (now - self._qps_refill_at) * self.max_qps)
        self._qps_refill_at = now
        self._qps_tokens -= 1.0
        if self._qps_tokens < 0:
            await asyncio.sleep(-self._qps_tokens / self.max_qps)

    async def acquire(self, verb: str, kind: str | None = None) -> str | None:
        lane = self.lane_of(verb, kind)
        if lane in ("read", "write"):
            await self._pace()
        if lane == "read":
            await self._read_sem.acquire()
        elif lane == "write":
            self._bump_writes(+1)
            try:
                await self._write_sem.acquire()
            except BaseException:
                self._bump_writes(-1)
                raise
        elif lane == "event":
            # Low priority, bounded: defer while the write lane is
            # saturated (re-check after every wakeup — a new write may
            # have re-closed the gate), but never past the patience
            # window — reconciles await their own emissions inline, and
            # the event lane never consumes write capacity anyway.
            deadline = asyncio.get_running_loop().time() + self.event_patience
            while self._writes_busy >= self.max_writes:
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    break
                try:
                    await asyncio.wait_for(self._lane_open.wait(), remaining)
                except asyncio.TimeoutError:
                    break
            await self._event_sem.acquire()
        if lane is not None:
            self.admitted[lane] += 1
        return lane

    def release(self, verb: str, kind: str | None = None) -> None:
        lane = self.lane_of(verb, kind)
        if lane == "read":
            self._read_sem.release()
        elif lane == "write":
            self._write_sem.release()
            self._bump_writes(-1)
        elif lane == "event":
            self._event_sem.release()

    def _bump_writes(self, delta: int) -> None:
        self._writes_busy = max(0, self._writes_busy + delta)
        if self._writes_busy >= self.max_writes:
            self._lane_open.clear()
        else:
            self._lane_open.set()

    @contextlib.asynccontextmanager
    async def slot(self, verb: str, kind: str | None = None):
        lane = await self.acquire(verb, kind)
        try:
            yield lane
        finally:
            self.release(verb, kind)

    def debug_info(self) -> dict:
        return {
            "limits": {"read": self.max_reads, "write": self.max_writes,
                       "event": self.event_lane, "qps": self.max_qps},
            "writes_busy": self._writes_busy,
            "admitted": dict(self.admitted),
        }


class BudgetedClient:
    """A per-replica client facade: the SAME apiserver handle, its own
    FlowControl budget — the in-process equivalent of each manager
    replica carrying its own client-go rate limiter. Sharded deployments
    wrap every replica's kube in one of these so the aggregate request
    budget scales with replica count (that scaling IS the active-active
    throughput win; one event loop gains no CPU from more replicas).

    Rate-limited verbs pass through ``flow``; everything else (watch,
    pod_logs, test conveniences) delegates untouched. ``get_or_none``
    is reimplemented on the wrapped ``get`` so it pays for its read.
    """

    _PACED = ("get", "list", "list_with_rv", "create", "update",
              "patch", "delete")

    def __init__(self, kube, flow: FlowControl):
        self._kube = kube
        self.flow = flow
        for verb in self._PACED:
            if hasattr(kube, verb):
                setattr(self, verb, self._wrap(verb))

    def _wrap(self, verb: str):
        inner = getattr(self._kube, verb)
        lane_verb = verb if verb != "list_with_rv" else "list"

        async def call(*args, **kwargs):
            kind = args[0] if args else kwargs.get("kind")
            async with self.flow.slot(lane_verb, kind):
                return await inner(*args, **kwargs)

        return call

    async def get_or_none(self, kind, name, namespace=None):
        try:
            return await self.get(kind, name, namespace)
        except NotFound:
            return None

    def __getattr__(self, name):
        return getattr(self._kube, name)
