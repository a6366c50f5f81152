"""Rate-limited workqueue (client-go semantics, asyncio-native).

Deduplicates keys while queued, tracks in-flight keys so a key re-added during
processing is re-queued afterwards, and applies per-item exponential backoff —
the behaviors the reference's hot loop depends on (every pod event maps back
to a Notebook reconcile, SURVEY.md §3.1).

``coalesce_window`` adds per-key event coalescing: an immediate add
(delay 0) is held for the window so a burst of child events for one owner
— a slice's worth of pod status flaps, say — collapses into ONE reconcile
at window close instead of one per event. Explicit delays (backoff,
requeue_after) are never stretched by the window.

``quarantine_after`` adds poison-pill quarantine (dead-lettering): a key
whose reconcile fails that many times IN A ROW is parked in a quarantine
set instead of retrying at max backoff forever — a permanently-broken
object must not eat a worker slot and a log line every ``max_delay``
until the end of time. A quarantined key is released (failure budget
reset, re-queued immediately) when its object actually CHANGES — add()
carries an opaque change token (the manager derives it from metadata +
spec, NOT resourceVersion: the manager's own Degraded status write bumps
rv and must not free the pill it just parked), and a differing token is
the release signal — or via the manual escape hatch
(``release_quarantined``, surfaced as POST /debug/queue/requeue).
Same-token re-deliveries (relists, status-only writes) do not release:
the user-editable half of the object is unchanged, so the reconcile
would only fail the same way again.

The port's copy of ``kubeflow_tpu/runtime/queue.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import heapq
import time
from typing import Hashable


class RateLimitedQueue:
    def __init__(
        self,
        base_delay: float = 0.005,
        max_delay: float = 60.0,
        coalesce_window: float = 0.0,
        quarantine_after: int = 0,
    ):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.coalesce_window = coalesce_window
        # Consecutive failures before a key is dead-lettered; 0 disables.
        self.quarantine_after = quarantine_after
        self.peak_depth = 0  # high-water mark of queued keys (bench telemetry)
        self._queue: list[tuple[float, int, Hashable]] = []  # (ready_at, seq, key)
        self._seq = 0
        self._queued: set[Hashable] = set()
        self._earliest: dict[Hashable, float] = {}  # earliest ready_at per key
        self._in_flight: set[Hashable] = set()
        self._dirty: set[Hashable] = set()  # re-added while in flight
        self._failures: dict[Hashable, int] = {}
        # Consecutive POISONOUS failures (the quarantine budget). Tracked
        # apart from _failures: a 409 Conflict backs off like any error
        # but is optimistic-concurrency noise, not poison — it must
        # neither advance this streak nor (being neutral evidence) reset
        # it, or a conflict storm plus one trailing 5xx would dead-letter
        # a healthy key.
        self._poison_streak: dict[Hashable, int] = {}
        # key → (change token at quarantine time | None, monotonic
        # quarantined-at). Keys here are parked: add() drops them unless
        # the delta's token proves the object changed.
        self._quarantined: dict[Hashable, tuple[str | None, float]] = {}
        # Queue-wait telemetry: after get(), how long the popped key sat
        # READY (past its ready_at) before a worker picked it up — pure
        # contention signal; intentional backoff/requeue_after delay is
        # excluded. The manager turns this into the ``queue_wait`` span.
        self._last_wait: dict[Hashable, float] = {}
        self._event = asyncio.Event()
        self._closed = False

    def __len__(self) -> int:
        return len(self._queued)

    def ready_count(self) -> int:
        """Keys ready to be processed now (excludes future-delayed entries —
        a controller that perpetually requeues itself would otherwise never
        look 'idle' to Manager.wait_idle)."""
        now = time.monotonic()
        return sum(1 for t in self._earliest.values() if t <= now)

    def add(self, key: Hashable, delay: float = 0.0, *,
            token: str | None = None) -> bool:
        """Queue a key. ``token`` is the object's opaque change token
        (metadata+spec signature), when the caller has one: it is ONLY
        consulted for quarantined keys, where a changed token is the
        release signal. Returns True iff this add released the key from
        quarantine."""
        if self._closed:
            return False
        released = False
        if key in self._quarantined:
            held_token, _since = self._quarantined[key]
            if token is None or token == held_token:
                return False  # unchanged object: stay parked
            self._quarantined.pop(key)
            self._failures.pop(key, None)  # fresh budget for the new spec
            self._poison_streak.pop(key, None)
            released = True
        if key in self._in_flight:
            self._dirty.add(key)
            return released
        if delay == 0.0 and self.coalesce_window:
            # Event-driven adds ride the coalescing window; because an add
            # may only move a key EARLIER (below), every event inside the
            # window lands on the first event's deadline — one reconcile
            # per burst. Explicit delays (backoff/requeue_after) pass
            # through untouched.
            delay = self.coalesce_window
        ready_at = time.monotonic() + delay
        if key in self._queued:
            # Already queued: a NEW add may only move the key *earlier*
            # (client-go semantics — an immediate change event must not wait
            # behind a long requeue_after/backoff entry). Push a second heap
            # entry; get() takes the earliest and drops stale duplicates.
            if ready_at >= self._earliest.get(key, float("inf")):
                return released
        else:
            self._queued.add(key)
            self.peak_depth = max(self.peak_depth, len(self._queued))
        self._earliest[key] = min(ready_at, self._earliest.get(key, float("inf")))
        self._seq += 1
        heapq.heappush(self._queue, (ready_at, self._seq, key))
        self._event.set()
        return released

    def note_failure(self, key: Hashable, *, poisonous: bool = True) -> None:
        """Record a failed reconcile. ``poisonous=False`` (409 Conflicts)
        still grows the backoff but never the quarantine streak."""
        self._failures[key] = self._failures.get(key, 0) + 1
        if poisonous:
            self._poison_streak[key] = self._poison_streak.get(key, 0) + 1

    def backoff_delay(self, key: Hashable) -> float:
        failures = self._failures.get(key, 0)
        if failures == 0:
            return 0.0
        return min(self.base_delay * (2 ** (failures - 1)), self.max_delay)

    def add_rate_limited(self, key: Hashable) -> None:
        """Re-queue after a failure with exponential backoff."""
        self.note_failure(key)
        self.add(key, self.backoff_delay(key))

    def forget(self, key: Hashable) -> None:
        """Drop the key's failure state — called on success AND on object
        deletion (informer DELETED), so the failure map and quarantine set
        cannot leak one entry per ever-failed key forever."""
        self._failures.pop(key, None)
        self._poison_streak.pop(key, None)
        self._quarantined.pop(key, None)
        self._last_wait.pop(key, None)

    # ---- poison-pill quarantine ------------------------------------------------

    def poison_streak(self, key: Hashable) -> int:
        """Consecutive poisonous failures recorded for the key — the
        number the quarantine budget compares against (callers must not
        reach into the internal maps)."""
        return self._poison_streak.get(key, 0)

    def should_quarantine(self, key: Hashable) -> bool:
        """Has the key exhausted its consecutive-failure budget?"""
        return (self.quarantine_after > 0
                and self._poison_streak.get(key, 0) >= self.quarantine_after)

    def quarantine(self, key: Hashable, token: str | None = None) -> None:
        """Dead-letter the key: it leaves the queue entirely (any pending
        heap entries go stale) and no add() re-queues it until its object
        changes (token differs) or release_quarantined() is called.
        ``token`` is the object's change token as of quarantine time."""
        if key in self._quarantined:
            return
        self._quarantined[key] = (token, time.monotonic())
        self._queued.discard(key)
        self._earliest.pop(key, None)
        self._dirty.discard(key)

    def release_quarantined(self, key: Hashable) -> bool:
        """Manual escape hatch (POST /debug/queue/requeue): un-park the
        key with a fresh failure budget and queue it immediately."""
        if key not in self._quarantined:
            return False
        self._quarantined.pop(key)
        self._failures.pop(key, None)
        self._poison_streak.pop(key, None)
        self.add(key)
        return True

    def quarantined_keys(self) -> list[Hashable]:
        return list(self._quarantined)

    def purge(self, predicate) -> int:
        """Drop every queued/backoff/quarantine record whose key matches
        ``predicate`` — the shard-rebalance eviction: when this replica
        loses a shard, that shard's keys must leave the queue NOW (the
        new owner re-discovers them via its refill; a worker here
        dequeuing one later would race the new owner's reconcile).
        In-flight keys are not touched — the worker's dequeue fence
        drops them on done(). Returns the number of queued keys purged;
        stale heap entries are left to get()'s staleness check."""
        purged = 0
        for key in [k for k in self._queued if predicate(k)]:
            self._queued.discard(key)
            self._earliest.pop(key, None)
            purged += 1
        for key in [k for k in list(self._failures) if predicate(k)]:
            self._failures.pop(key, None)
            self._poison_streak.pop(key, None)
        for key in [k for k in list(self._quarantined) if predicate(k)]:
            self._quarantined.pop(key, None)
        for key in [k for k in self._dirty if predicate(k)]:
            self._dirty.discard(key)
        return purged

    def is_quarantined(self, key: Hashable) -> bool:
        return key in self._quarantined

    async def get(self) -> Hashable | None:
        """Next ready key, or None when the queue is shut down."""
        while True:
            now = time.monotonic()
            if self._closed and not (
                self._queue and self._queue[0][0] <= now
            ):
                # Shut down: drain entries that are ready NOW, but never
                # wait out future-delayed ones (a 300 s capacity-retry
                # entry would otherwise pin a worker — and its cancelled
                # shutdown — for the full delay; shutdown() already woke
                # us via the event precisely so this check runs).
                return None
            if self._queue and self._queue[0][0] <= now:
                ready_at, _, key = heapq.heappop(self._queue)
                # Drop stale entries: from a previous queued lifetime of the
                # key (not queued now, or queued again with a DIFFERENT
                # ready_at — honoring backoff set after the stale push).
                if key not in self._queued or ready_at != self._earliest.get(key):
                    continue
                # kftpu: ignore[await-race] no suspension between the fresh heap pop, the staleness re-check and this discard — racing workers pop distinct entries
                self._queued.discard(key)
                # kftpu: ignore[await-race] same atomic pop-to-mutate window as the discard above
                self._earliest.pop(key, None)
                # Time past eligibility only — ready_at already folds in
                # any intentional delay (coalesce/backoff/requeue_after).
                self._last_wait[key] = max(0.0, now - ready_at)
                self._in_flight.add(key)
                return key
            timeout = (self._queue[0][0] - now) if self._queue else None
            # kftpu: ignore[await-race] no suspension between the queue-state read and this clear — add()'s set() can only interleave inside the awaited wait
            self._event.clear()
            try:
                await asyncio.wait_for(self._event.wait(), timeout)
            except asyncio.TimeoutError:
                pass

    def done(self, key: Hashable) -> bool:
        """Finish processing a key. Returns True iff the key had gone
        dirty in flight (and was re-queued) — new information arrived
        DURING the reconcile, which the manager's quarantine gate must
        honor: dead-lettering on the stale attempt would capture the
        already-changed object's token and park the user's fix forever."""
        self._in_flight.discard(key)
        if key in self._dirty:
            self._dirty.discard(key)
            if key in self._quarantined:
                return False  # parked: the dirty re-add must not resurrect it
            # A dirty key that has recorded failures re-queues with its
            # backoff, not immediately — otherwise a failing reconciler that
            # touches its own children retries in a hot loop.
            self.add(key, self.backoff_delay(key))
            return True
        return False

    def take_wait(self, key: Hashable) -> float:
        """Queue wait of the most recent get() of ``key`` — time the key
        sat ready past its eligibility, consumed once (the manager
        attaches it to the reconcile trace as the ``queue_wait`` span)."""
        return self._last_wait.pop(key, 0.0)

    def debug_info(self) -> dict:
        """JSON-shaped snapshot for the /debug/queue endpoint: depth,
        backoff keys, oldest wait — the "why is nothing happening"
        questions answered without a debugger."""
        now = time.monotonic()
        return {
            "depth": len(self._queued),
            "ready": self.ready_count(),
            "in_flight": sorted(str(k) for k in self._in_flight),
            "dirty": len(self._dirty),
            "peak_depth": self.peak_depth,
            "coalesce_window_sec": self.coalesce_window,
            "backoff_keys": {
                str(k): {
                    "failures": n,
                    "next_delay_sec": round(self.backoff_delay(k), 4),
                }
                for k, n in sorted(self._failures.items(), key=lambda kv: str(kv[0]))
                if k not in self._quarantined
            },
            # Dead-lettered keys: reconcile suspended until the object
            # changes or an operator hits /debug/queue/requeue.
            "quarantined": {
                str(k): {
                    "failures": self._failures.get(k, 0),
                    "since_sec": round(now - since, 3),
                }
                for k, (_token, since) in sorted(
                    self._quarantined.items(), key=lambda kv: str(kv[0]))
            },
            # Longest a currently-READY key has been waiting for a worker
            # (keys still inside an intentional delay don't count — their
            # "wait" is a timer, not contention).
            "oldest_wait_sec": round(
                max((now - t for t in self._earliest.values() if t <= now),
                    default=0.0), 4
            ),
        }

    def shutdown(self) -> None:
        self._closed = True
        self._event.set()
