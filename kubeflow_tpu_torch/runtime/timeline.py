"""Durable per-object lifecycle timelines.

The flight recorder (runtime/tracing.py) answers "what did the last
reconcile DO" — but it is an in-memory ring that dies with every manager
restart, and the chaos soak restarts managers on purpose. This module is
the durable complement: an append-only journal of LIFECYCLE transitions
(Queued → Admitted → Ready → Draining → Parked → Restoring → Ready,
Preempted, Reclaimed, …) per object, each entry carrying a timestamp,
reason, exemplar trace id, and the gang's chip shape.

Durability: the journal is persisted as ONE compact capped annotation on
the object itself (``notebooks.kubeflow.org/timeline``) — the same
substrate that already makes the drain protocol restart-safe. A rebuilt
manager decodes the annotation and appends from the durable sequence
number, so the chaos soak's kill/rebuild cycles replay into an unbroken
timeline: sequence numbers stay consecutive, no transition is recorded
twice (:func:`continuity_problems` is the shared invariant checker the
soak and tier-1 both run).

Writers: the notebook reconciler is the SINGLE writer per key (its
workqueue already serializes reconciles per key) — every layer's state
lands in the one status derivation ``_update_status`` performs, so one
``record()`` call per reconcile captures scheduler, migration, and
readiness transitions alike. Readers: ``/debug/timeline/<ns>/<name>``,
the scheduler-explain endpoint, and the SLO engine (time-to-ready is
measured from the timeline's startup-episode boundary).

The port's copy of ``kubeflow_tpu/runtime/timeline.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import json
import logging
import os
from collections import OrderedDict

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.errors import ApiError
from kubeflow_tpu_torch.runtime.objects import fmt_iso

log = logging.getLogger(__name__)

TIMELINE_ANNOTATION = keys.NOTEBOOK_TIMELINE

# Knobs (docs/operations.md "SLOs & burn-rate alerting"):
TIMELINE_ENABLED_ENV = "KFTPU_TIMELINE"
TIMELINE_MAX_ENTRIES_ENV = "KFTPU_TIMELINE_MAX_ENTRIES"
DEFAULT_MAX_ENTRIES = 24

# Canonical lifecycle states. ``derive_lifecycle`` folds the scheduler
# verdict, the migration protocol state, and pod readiness into one
# chain, so a timeline reads as the object's life story.
CREATING = "Creating"          # no scheduler verdict yet, workers coming up
QUEUED = "Queued"
ADMITTED = "Admitted"          # chips booked, workers not all Ready
READY = "Ready"
DRAINING = "Draining"          # checkpoint requested / in progress
PARKED = "Parked"              # stopped with a committed checkpoint
RESTORING = "Restoring"
PREEMPTED = "Preempted"
RECLAIMED = "Reclaimed"        # re-queued after spot reclaim / defrag
STOPPED = "Stopped"
# Warm pod pools: Claimed = this startup adopted a pre-warmed
# pod (the episode's Claimed→Ready gap is the warm path's whole cost);
# Warming = a matching pool existed but was EMPTY, so the cold path ran
# while the pool replenished — the miss that cost this episode the warm
# start. An episode containing either transition attributes its
# time-to-ready to the warm (or missed-warm) path from the journal alone.
CLAIMED = "Claimed"
WARMING = "Warming"

# States that END a startup episode: time-to-ready measures from the
# first entry AFTER the latest of these to the Ready transition.
_EPISODE_BOUNDARIES = frozenset({READY, STOPPED, PARKED, PREEMPTED})

_enabled = True  # process-wide A/B switch for the overhead bench


def set_enabled(on: bool) -> None:
    global _enabled
    _enabled = bool(on)


def is_enabled() -> bool:
    return _enabled


def timeline_enabled(environ=os.environ) -> bool:
    """``KFTPU_TIMELINE`` master switch (default on)."""
    return environ.get(TIMELINE_ENABLED_ENV, "on").strip().lower() not in (
        "off", "false", "0", "no", "disabled",
    )


def max_entries(environ=os.environ) -> int:
    raw = environ.get(TIMELINE_MAX_ENTRIES_ENV)
    try:
        value = int(raw) if raw is not None else DEFAULT_MAX_ENTRIES
    except ValueError:
        return DEFAULT_MAX_ENTRIES
    return value if value >= 2 else DEFAULT_MAX_ENTRIES


# ---- pure core: derive / encode / append / check -------------------------------


def derive_lifecycle(*, sched_state: str | None, mig_state: str | None,
                     stopped: bool, ready: int, want_hosts: int,
                     reclaimed: str = "", warm: str = "") -> str:
    """The object's lifecycle state as a pure function of what
    ``_update_status`` already derived. Priority order mirrors the JWA
    status machine: park/preempt verdicts over queueing over readiness.
    ``warm`` is the warm-pool verdict ("claimed" = a pre-warmed pod was
    adopted this episode, "warming" = a matching pool was empty and the
    cold path ran) — it refines the pre-Ready states only; Ready and
    every park/queue verdict outrank it."""
    if stopped:
        if mig_state == "Parked":
            return PARKED
        if sched_state == "Preempted":
            return PREEMPTED
        return STOPPED
    if sched_state == "Draining" or mig_state in (
            "DrainRequested", "Checkpointing", "Checkpointed"):
        return DRAINING
    if sched_state == "Queued":
        return RECLAIMED if reclaimed else QUEUED
    if sched_state == "Preempted":
        return PREEMPTED
    if ready and want_hosts and ready >= want_hosts:
        return READY
    if warm == "claimed":
        return CLAIMED
    if mig_state == "Restoring":
        return RESTORING
    if warm == "warming":
        return WARMING
    if sched_state == "Admitted":
        return ADMITTED
    return CREATING


def decode(annotations: dict | None) -> list[dict]:
    """Annotation → entry dicts. Tolerant: a corrupt value decodes to an
    empty journal (the next transition rewrites it whole) rather than
    wedging the reconcile."""
    raw = (annotations or {}).get(TIMELINE_ANNOTATION)
    if not raw:
        return []
    try:
        rows = json.loads(raw)
    except (ValueError, TypeError):
        return []
    out: list[dict] = []
    if not isinstance(rows, list):
        return out
    for row in rows:
        if not isinstance(row, list) or len(row) < 3:
            continue
        try:
            out.append({
                "seq": int(row[0]),
                "at": float(row[1]),
                "state": str(row[2]),
                "reason": str(row[3]) if len(row) > 3 else "",
                "trace_id": str(row[4]) if len(row) > 4 and row[4] else "",
                "shape": str(row[5]) if len(row) > 5 else "",
            })
        except (ValueError, TypeError):
            continue
    return out


def encode(entries: list[dict]) -> str:
    """Entry dicts → the compact annotation value (JSON list-of-lists,
    short on purpose: annotations ride every GET of the object)."""
    return json.dumps(
        [[e["seq"], round(e["at"], 3), e["state"], e.get("reason", ""),
          e.get("trace_id", ""), e.get("shape", "")]
         for e in entries],
        separators=(",", ":"))


def append(entries: list[dict], state: str, *, at: float, reason: str = "",
           trace_id: str | None = None, shape: str = "",
           cap: int = DEFAULT_MAX_ENTRIES) -> bool:
    """Append one transition IN PLACE if it is a real change (the last
    recorded state differs); returns whether anything was appended. Seq
    continues from the durable tail, so entries evicted by the cap never
    create a gap inside the retained window."""
    if entries and entries[-1]["state"] == state:
        return False
    seq = entries[-1]["seq"] + 1 if entries else 1
    ts = max(at, entries[-1]["at"]) if entries else at
    entries.append({
        "seq": seq, "at": ts, "state": state, "reason": reason or "",
        "trace_id": trace_id or "", "shape": shape or "",
    })
    while len(entries) > cap:
        entries.pop(0)
    return True


def continuity_problems(entries: list[dict]) -> list[str]:
    """The unbroken-timeline invariant (chaos soak + tier-1): within the
    retained window, sequence numbers are consecutive (no gap, no
    duplicate), no two adjacent entries share a state (no duplicate
    transition), and timestamps never go backwards."""
    problems: list[str] = []
    for i in range(1, len(entries)):
        prev, cur = entries[i - 1], entries[i]
        if cur["seq"] != prev["seq"] + 1:
            problems.append(
                f"seq gap/duplicate: {prev['seq']} -> {cur['seq']} "
                f"({prev['state']} -> {cur['state']})")
        if cur["state"] == prev["state"]:
            problems.append(
                f"duplicate transition to {cur['state']!r} at seq "
                f"{cur['seq']}")
        if cur["at"] < prev["at"]:
            problems.append(
                f"time went backwards at seq {cur['seq']} "
                f"({prev['at']} -> {cur['at']})")
    return problems


def episode_start(entries: list[dict]) -> dict | None:
    """First entry of the CURRENT startup episode: the earliest entry
    after the latest boundary state (Ready/Stopped/Parked/Preempted).
    None when the journal is empty or the latest entry IS a boundary."""
    start = None
    for e in reversed(entries):
        if e["state"] in _EPISODE_BOUNDARIES:
            break
        start = e
    return start


def time_to_ready(entries: list[dict]) -> float | None:
    """Seconds from the current episode's start to its Ready tail —
    meaningful right after a Ready transition was appended."""
    if not entries or entries[-1]["state"] != READY:
        return None
    start = episode_start(entries[:-1])
    if start is None:
        return None
    return max(0.0, entries[-1]["at"] - start["at"])


def render(entries: list[dict]) -> list[dict]:
    """Entries shaped for /debug responses (ISO timestamps)."""
    return [{**e, "time": fmt_iso(e["at"])} for e in entries]


# ---- runtime recorder ----------------------------------------------------------


class TimelineRecorder:
    """Write-through journal store: in-memory cache (bounded, LRU) over
    the durable annotation. ``record()`` is called once per reconcile by
    the single writer; a no-transition call is free. A failed annotation
    patch keeps the journal dirty and re-flushes on the next call (every
    write carries the FULL capped list, so durability self-heals)."""

    def __init__(self, kube, *, kind: str = "Notebook",
                 environ=os.environ, max_keys: int = 4096):
        self.kube = kube
        self.kind = kind
        self.enabled = timeline_enabled(environ)
        self.cap = max_entries(environ)
        self.max_keys = max_keys
        self._entries: "OrderedDict[tuple, list]" = OrderedDict()
        self._dirty: set = set()

    def _load(self, key: tuple, annotations: dict | None) -> list[dict]:
        cached = self._entries.get(key)
        durable = decode(annotations) if annotations else []
        if cached is None:
            entries = durable
        elif durable and (not cached
                          or durable[-1]["seq"] > cached[-1]["seq"]):
            # Another writer (or a previous incarnation) got further
            # than our cache: the durable record wins.
            entries = durable
        else:
            entries = cached
        self._entries[key] = entries
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_keys:
            # Evict clean journals first: a DIRTY one holds transitions
            # the apiserver hasn't accepted yet, and dropping it would
            # silently lose them despite the re-flush self-heal. Only
            # when EVERY cached journal is dirty (total write outage)
            # does the oldest go, loudly — memory stays bounded.
            evicted = next((k for k in self._entries
                            if k not in self._dirty), None)
            if evicted is None:
                evicted, _ = self._entries.popitem(last=False)
                self._dirty.discard(evicted)
                log.warning(
                    "lifecycle timeline for %s evicted with unflushed "
                    "transitions (are apiserver writes failing?)",
                    evicted)
            else:
                self._entries.pop(evicted)
        return entries

    async def record(self, key: tuple, state: str, *, at: float,
                     reason: str = "", trace_id: str | None = None,
                     shape: str = "",
                     annotations: dict | None = None) -> list[dict] | None:
        """Record the object's current lifecycle state. Returns the
        entry list when a NEW transition was appended (the caller feeds
        time-to-ready into the SLO engine off that), else None.
        ``annotations`` is the live object's annotations this reconcile
        already holds — no extra GET."""
        if not (self.enabled and _enabled):
            return None
        key = tuple(key)
        entries = self._load(key, annotations)
        changed = append(entries, state, at=at, reason=reason,
                         trace_id=trace_id, shape=shape, cap=self.cap)
        if changed or key in self._dirty:
            await self._flush(key, entries)
        return entries if changed else None

    async def _flush(self, key: tuple, entries: list[dict]) -> None:
        try:
            await self.kube.patch(
                self.kind, key[1],
                {"metadata": {"annotations": {
                    TIMELINE_ANNOTATION: encode(entries)}}},
                key[0])
            self._dirty.discard(key)
        except ApiError:
            # Best-effort by design: the journal stays cached and the
            # next record() re-writes the full list. Losing the tail to
            # a process death is safe — seq continues from the durable
            # record, so the retained window stays unbroken.
            self._dirty.add(key)

    def entries(self, key: tuple,
                annotations: dict | None = None) -> list[dict]:
        """Read the journal (cache-first, durable fallback) WITHOUT
        recording anything — /debug handlers."""
        key = tuple(key)
        cached = self._entries.get(key)
        durable = decode(annotations) if annotations else []
        if cached is None:
            return durable
        if durable and (not cached or durable[-1]["seq"] > cached[-1]["seq"]):
            return durable
        return cached

    def forget(self, key: tuple) -> None:
        key = tuple(key)
        self._entries.pop(key, None)
        self._dirty.discard(key)
