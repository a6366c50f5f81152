"""In-memory Kubernetes apiserver with real API semantics.

Implements the ``KubeApi`` surface the controllers use, with the semantics
that matter for correctness testing:

- resourceVersion on every write + Conflict on stale full updates
- metadata.generation bumped on spec changes, mirrored nowhere (status is a
  subresource, like the real server)
- watches with ADDED/MODIFIED/DELETED events fanned out per watcher
- finalizers + deletionTimestamp two-phase delete
- ownerReference cascade deletion (background propagation)
- admission plugin chain (mutating then validating) so webhook logic is
  exercised through the same path the real apiserver would drive it
- namespace existence is NOT enforced (matches envtest looseness) but
  namespace-scoped listing/selectors are

This is our envtest (reference: suite_test.go boots envtest with CRDs;
here CRDs are just registered kinds in the scheme).

The port's copy of ``kubeflow_tpu/testing/fakekube.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import copy
import fnmatch
import random
import time
import uuid
from collections import defaultdict, deque
from typing import Any, AsyncIterator, Awaitable, Callable

from kubeflow_tpu_torch.runtime import tracing

from kubeflow_tpu_torch.runtime.errors import (
    AlreadyExists,
    ApiError,
    Conflict,
    Invalid,
    NotFound,
    ServerTimeout,
    TooManyRequests,
)
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    deepcopy,
    get_meta,
    matches_selector,
    name_of,
    namespace_of,
    parse_label_selector,
)
from kubeflow_tpu_torch.runtime.objects import now_iso as _now
from kubeflow_tpu_torch.runtime.scheme import DEFAULT_SCHEME, Scheme

Mutator = Callable[[dict, dict], Awaitable[None] | None]  # (obj, request-info)
Validator = Callable[[dict, dict], Awaitable[None] | None]


class _Watch:
    def __init__(self, kind: str, namespace: str | None, selector: dict | None,
                 field_selector: Callable[[dict], bool] | None = None):
        self.kind = kind
        self.namespace = namespace
        self.selector = selector
        self.field_selector = field_selector
        self.queue: asyncio.Queue[tuple[str, dict] | None] = asyncio.Queue()

    def wants(self, obj: dict) -> bool:
        if self.namespace and namespace_of(obj) != self.namespace:
            return False
        if not matches_selector(get_meta(obj).get("labels"), self.selector):
            return False
        if self.field_selector is not None:
            # Same contract as list(): the predicate runs against the LIVE
            # store dict and must be pure. A predicate that reads mutable
            # external state (a shard ring) re-evaluates per event — that
            # is the point: filtered informers follow ownership changes.
            try:
                return bool(self.field_selector(obj))
            except Exception:
                return False
        return True


def _injected_error(error: str) -> ApiError:
    """Build the ApiError an injected fault surfaces as. The five flavors
    cover the real apiserver's transient-failure taxonomy: 500 internal,
    503 overloaded/apiserver-restarting, 504 client deadline, 409 optimistic
    concurrency, 429 priority & fairness."""
    if error == "timeout":
        return ServerTimeout("injected fault: no response within deadline")
    if error == "conflict":
        return Conflict("injected fault: the object has been modified")
    if error == "throttle":
        return TooManyRequests("injected fault: too many requests")
    err = ApiError(f"injected fault: {error}")
    err.code = {"internal": 500, "unavailable": 503}.get(error, 500)
    err.reason = {"internal": "InternalError",
                  "unavailable": "ServiceUnavailable"}.get(error, error)
    return err


class FaultRule:
    """One scheduled fault: which requests it matches and how it fails them.

    ``verbs=None`` matches every verb; ``kinds``/``names`` are fnmatch
    globs. ``rate`` is the per-matching-request injection probability
    (drawn from the plan's seeded RNG — deterministic per seed + request
    order), ``after`` skips the first N matching requests, and ``times``
    bounds total injections (None = unlimited, e.g. a permanent poison).
    """

    ERRORS = ("internal", "unavailable", "timeout", "conflict", "throttle")

    def __init__(self, error: str = "unavailable", *,
                 verbs: tuple[str, ...] | None = None,
                 kinds: str = "*", names: str = "*",
                 rate: float = 1.0, times: int | None = None,
                 after: int = 0):
        if error not in self.ERRORS:
            raise ValueError(f"unknown fault error {error!r}; "
                             f"want one of {self.ERRORS}")
        self.error = error
        self.verbs = tuple(verbs) if verbs is not None else None
        self.kinds = kinds
        self.names = names
        self.rate = rate
        self.times = times
        self.after = after
        self.injected = 0
        self._seen = 0

    def matches(self, verb: str, kind: str, name: str) -> bool:
        if self.verbs is not None and verb not in self.verbs:
            return False
        return fnmatch.fnmatch(kind, self.kinds) and \
            fnmatch.fnmatch(name or "", self.names)

    def consume(self, rng: random.Random, verb: str, kind: str,
                name: str) -> bool:
        """True if this rule injects for the matching request. The RNG is
        consulted only for probabilistic rules, so deterministic schedules
        (rate=1.0) never perturb the seed stream."""
        if not self.matches(verb, kind, name):
            return False
        if self.times is not None and self.injected >= self.times:
            return False
        self._seen += 1
        if self._seen <= self.after:
            return False
        if self.rate < 1.0 and rng.random() >= self.rate:
            return False
        self.injected += 1
        return True


class _WatchResetRule:
    def __init__(self, kinds: str, rate: float, every: int | None):
        self.kinds = kinds
        self.rate = rate
        self.every = every
        self.triggered = 0
        self._seen = 0

    def consume(self, rng: random.Random, kind: str) -> bool:
        if not fnmatch.fnmatch(kind, self.kinds):
            return False
        self._seen += 1
        if self.every is not None:
            if self._seen % self.every:
                return False
        elif rng.random() >= self.rate:
            return False
        self.triggered += 1
        return True


class _StorageRule:
    """One storage-fault schedule (checkpoint fabric): matches a tier
    glob, fires after every ``every``-th probe or with probability
    ``rate``, bounded by ``times``; ``seconds`` carries the slow-tier
    delay."""

    def __init__(self, tiers: str = "*", *, rate: float = 0.0,
                 every: int | None = None, times: int | None = None,
                 seconds: float = 0.0):
        self.tiers = tiers
        self.rate = rate
        self.every = every
        self.times = times
        self.seconds = seconds
        self.triggered = 0
        self._seen = 0

    def consume(self, rng: random.Random, tier: str = "") -> bool:
        if not fnmatch.fnmatch(tier or "", self.tiers):
            return False
        if self.times is not None and self.triggered >= self.times:
            return False
        self._seen += 1
        if self.every is not None:
            if self._seen % self.every:
                return False
        elif rng.random() >= self.rate:
            return False
        self.triggered += 1
        return True


class FaultPlan:
    """Deterministic, seeded API fault schedule for :class:`FakeKube`.

    The failure paths the reference stack never exercised (SURVEY.md §5),
    one injection point per apiserver behavior:

    - request errors (``fail``): matched in ``FakeKube._admit`` after
      flow-control admission and the RTT sleep, so faults compose with
      the latency and priority-and-fairness mirrors;
    - mid-stream watch resets (``reset_watch``): the server closes the
      stream after a delivered event — informers must relist;
    - stale LISTs (``stale_list``): the server answers from its previous
      snapshot of the kind (an old-resourceVersion read) — informer
      caches must self-correct on a later relist.

    Storage faults (checkpoint fabric) ride the same plan:
    the fabric duck-types its ``faults`` object against the
    ``should_*``/``storage_delay`` probes below, so a plan armed with
    :meth:`crash_upload` / :meth:`tear_manifest` / :meth:`corrupt_read`
    / :meth:`slow_tier` / :meth:`stale_staging` drives the
    crash-mid-upload, torn-manifest, read-corruption, slow-tier, and
    stale-staging-pointer windows deterministically.

    All randomness comes from one ``random.Random(seed)``: the same seed
    over the same request sequence replays the same fault schedule.
    """

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._rng = random.Random(seed)
        self.rules: list[FaultRule] = []
        self._watch_rules: list[_WatchResetRule] = []
        self._stale_rules: list[FaultRule] = []
        self._reclaim_rules: list[_WatchResetRule] = []
        # Storage-fault buckets (one per fabric probe). The storage RNG
        # is separate so arming checkpoint faults never perturbs the API
        # fault schedule of an existing seed.
        self._storage_rng = random.Random((seed << 4) ^ 0x5EED)
        self._crash_upload_rules: list[_StorageRule] = []
        self._fail_upload_rules: list[_StorageRule] = []
        self._tear_rules: list[_StorageRule] = []
        self._corrupt_rules: list[_StorageRule] = []
        self._slow_rules: list[_StorageRule] = []
        self._stale_staging_rules: list[_StorageRule] = []
        # Per-error injection counts — the soak report and tests assert
        # faults actually fired.
        self.injected: dict[str, int] = defaultdict(int)

    def fail(self, error: str = "unavailable", *,
             verbs: tuple[str, ...] | None = None,
             kinds: str = "*", names: str = "*", rate: float = 1.0,
             times: int | None = None, after: int = 0) -> FaultRule:
        rule = FaultRule(error, verbs=verbs, kinds=kinds, names=names,
                         rate=rate, times=times, after=after)
        self.rules.append(rule)
        return rule

    def reset_watch(self, kinds: str = "*", *, rate: float = 0.0,
                    every: int | None = None) -> _WatchResetRule:
        """Close matching watch streams mid-flight: after every ``every``-th
        delivered event, or with probability ``rate`` per event."""
        rule = _WatchResetRule(kinds, rate, every)
        self._watch_rules.append(rule)
        return rule

    def stale_list(self, kinds: str = "*", *, rate: float = 1.0,
                   times: int | None = None, after: int = 0) -> FaultRule:
        """Serve matching LISTs from the kind's previous snapshot."""
        rule = FaultRule("unavailable", verbs=("list",), kinds=kinds,
                         rate=rate, times=times, after=after)
        self._stale_rules.append(rule)
        return rule

    def reclaim_spot(self, pools: str = "*", *, rate: float = 0.0,
                     every: int | None = None) -> _WatchResetRule:
        """Seeded spot-revocation schedule for harnesses (chaos soak,
        bench reclaim storm): each :meth:`should_reclaim_spot` probe
        consults it — after every ``every``-th probe of a matching pool,
        or with probability ``rate`` per probe. The harness acts on a
        True by tainting the pool's Node through the normal API, so the
        control plane sees exactly what GKE would send; determinism
        comes from the plan's one seeded RNG."""
        rule = _WatchResetRule(pools, rate, every)
        self._reclaim_rules.append(rule)
        return rule

    def should_reclaim_spot(self, pool: str) -> bool:
        for rule in self._reclaim_rules:
            if rule.consume(self._rng, pool):
                self.injected["spot_reclaim"] += 1
                return True
        return False

    # ---- storage faults (checkpoint fabric) ------------------------------------

    def crash_upload(self, *, rate: float = 0.0, every: int | None = None,
                     times: int | None = None) -> _StorageRule:
        """Kill the uploading process mid-chunk-stream: the fabric aborts
        the upload with partial chunks in the remote tier and NO commit —
        the chaos invariant is that such a step is never restored."""
        rule = _StorageRule(rate=rate, every=every, times=times)
        self._crash_upload_rules.append(rule)
        return rule

    def fail_upload(self, *, rate: float = 0.0, every: int | None = None,
                    times: int | None = None) -> _StorageRule:
        """Transient upload error — the fabric's bounded retry/backoff
        must absorb it (unlike :meth:`crash_upload`, which is fatal to
        the attempt)."""
        rule = _StorageRule(rate=rate, every=every, times=times)
        self._fail_upload_rules.append(rule)
        return rule

    def tear_manifest(self, tiers: str = "*", *, rate: float = 0.0,
                      every: int | None = None,
                      times: int | None = None) -> _StorageRule:
        """Write a truncated manifest at the final path (non-atomic
        backend / partial replication) — restore's self-checksum must
        refuse it and fall back."""
        rule = _StorageRule(tiers, rate=rate, every=every, times=times)
        self._tear_rules.append(rule)
        return rule

    def corrupt_read(self, tiers: str = "*", *, rate: float = 0.0,
                     every: int | None = None,
                     times: int | None = None) -> _StorageRule:
        """Flip bits on a chunk read — hash verification must catch it
        (staging corruption falls through to remote; remote corruption
        falls back a step)."""
        rule = _StorageRule(tiers, rate=rate, every=every, times=times)
        self._corrupt_rules.append(rule)
        return rule

    def slow_tier(self, tiers: str = "*", *, seconds: float,
                  rate: float = 1.0, every: int | None = None,
                  times: int | None = None) -> _StorageRule:
        """Add per-operation latency to a tier (a degraded disk or an
        overloaded object store)."""
        rule = _StorageRule(tiers, rate=rate, every=every, times=times,
                            seconds=seconds)
        self._slow_rules.append(rule)
        return rule

    def stale_staging(self, *, rate: float = 0.0, every: int | None = None,
                      times: int | None = None) -> _StorageRule:
        """Silently skip the staging tier's pointer advance — restore
        must trust the remote committed pointer, never the stale local
        one."""
        rule = _StorageRule(rate=rate, every=every, times=times)
        self._stale_staging_rules.append(rule)
        return rule

    # Fabric-facing probes (duck-typed; see kubeflow_tpu/checkpoint).

    def should_crash_upload(self) -> bool:
        for rule in self._crash_upload_rules:
            if rule.consume(self._storage_rng):
                self.injected["storage_crash_upload"] += 1
                return True
        return False

    def should_fail_upload(self) -> bool:
        for rule in self._fail_upload_rules:
            if rule.consume(self._storage_rng):
                self.injected["storage_fail_upload"] += 1
                return True
        return False

    def should_tear_manifest(self, tier: str) -> bool:
        for rule in self._tear_rules:
            if rule.consume(self._storage_rng, tier):
                self.injected["storage_torn_manifest"] += 1
                return True
        return False

    def should_corrupt_read(self, tier: str) -> bool:
        for rule in self._corrupt_rules:
            if rule.consume(self._storage_rng, tier):
                self.injected["storage_read_corrupt"] += 1
                return True
        return False

    def storage_delay(self, tier: str) -> float:
        total = 0.0
        for rule in self._slow_rules:
            if rule.consume(self._storage_rng, tier):
                self.injected["storage_slow_tier"] += 1
                total += rule.seconds
        return total

    def should_skip_staging_commit(self) -> bool:
        for rule in self._stale_staging_rules:
            if rule.consume(self._storage_rng):
                self.injected["storage_stale_staging"] += 1
                return True
        return False

    def clear(self) -> None:
        """Lift every fault (rules stay readable for their counters)."""
        self.rules = []
        self._watch_rules = []
        self._stale_rules = []
        self._reclaim_rules = []
        self._crash_upload_rules = []
        self._fail_upload_rules = []
        self._tear_rules = []
        self._corrupt_rules = []
        self._slow_rules = []
        self._stale_staging_rules = []

    def drop(self, rule) -> None:
        for bucket in (self.rules, self._watch_rules, self._stale_rules,
                       self._reclaim_rules, self._crash_upload_rules,
                       self._fail_upload_rules, self._tear_rules,
                       self._corrupt_rules, self._slow_rules,
                       self._stale_staging_rules):
            if rule in bucket:
                bucket.remove(rule)

    # ---- FakeKube-facing hooks ------------------------------------------------

    def error_for(self, verb: str, kind: str, name: str | None) -> ApiError | None:
        for rule in self.rules:
            if rule.consume(self._rng, verb, kind, name or ""):
                self.injected[rule.error] += 1
                return _injected_error(rule.error)
        return None

    def watch_should_reset(self, kind: str) -> bool:
        for rule in self._watch_rules:
            if rule.consume(self._rng, kind):
                self.injected["watch_reset"] += 1
                return True
        return False

    def list_is_stale(self, kind: str) -> bool:
        for rule in self._stale_rules:
            if rule.consume(self._rng, "list", kind, ""):
                self.injected["stale_list"] += 1
                return True
        return False

    def debug_info(self) -> dict:
        return {
            "seed": self.seed,
            "injected": dict(sorted(self.injected.items())),
            "active_rules": len(self.rules) + len(self._watch_rules)
            + len(self._stale_rules) + len(self._reclaim_rules)
            + len(self._crash_upload_rules) + len(self._fail_upload_rules)
            + len(self._tear_rules) + len(self._corrupt_rules)
            + len(self._slow_rules) + len(self._stale_staging_rules),
        }


class FakeKube:
    """The in-memory apiserver. All methods are async and deep-copy at the boundary."""

    WRITE_VERBS = ("create", "update", "update_status", "patch", "delete")

    def __init__(self, scheme: Scheme | None = None):
        self.scheme = scheme or DEFAULT_SCHEME
        self._store: dict[str, dict[tuple[str | None, str], dict]] = defaultdict(dict)
        self._rv = 0
        self._watches: list[_Watch] = []
        self._mutators: list[tuple[str, Mutator]] = []      # (kind-glob, fn)
        self._validators: list[tuple[str, Validator]] = []
        self._pod_logs: dict[tuple[str | None, str], str] = {}
        self._lock = asyncio.Lock()
        # Per-verb request counter (client entry points only — cascade GC
        # and admission are server-side work, not requests). Lets tests and
        # the bench PROVE write elision: a steady-state no-op reconcile
        # must move none of the write verbs.
        self.requests: dict[str, int] = defaultdict(int)
        # Bounded request log with the headers a real client would have
        # sent — in particular X-Request-Id carrying the active trace id,
        # mirroring HttpKube — plus per-request start/end monotonic
        # stamps, so latency tests can prove which requests overlapped.
        # Tests pin controller → request-header → flight-recorder
        # trace-id propagation against it.
        self.request_log: deque[dict] = deque(maxlen=1000)
        # Injectable per-request latency (set_latency): simulated network
        # RTT, slept OUTSIDE the store lock so concurrent requests
        # overlap exactly as real round trips do.
        self.latency = 0.0
        self.latency_jitter = 0.0
        self._rng = random.Random(0)  # deterministic jitter for tests
        # In-flight high-water gauge: the proof that requests actually
        # overlap (serial clients never exceed 1).
        self._in_flight = 0
        self.in_flight_peak = 0
        # Optional client-side flow control (runtime/flowcontrol.py),
        # mirroring HttpKube so lane behavior is testable in tier-1.
        self.flow = None
        # Optional API fault injection (use_faults): checked in _admit
        # after flow admission + RTT, so every fault composes with the
        # latency and flow-control mirrors.
        self.faults: FaultPlan | None = None
        # Previous LIST snapshot per kind — what a stale LIST serves.
        self._list_snapshots: dict[str, tuple[list[dict], str]] = {}

    # ---- latency / concurrency instrumentation --------------------------------

    def set_latency(self, seconds: float, jitter: float = 0.0) -> None:
        """Inject per-request latency (+ uniform jitter) — the simulated
        RTT every request pays before touching the store."""
        self.latency = seconds
        self.latency_jitter = jitter

    def use_flow_control(self, flow) -> None:
        """Route every request through a FlowControl lane gate, as
        HttpKube does on the wire."""
        self.flow = flow

    def use_faults(self, plan: FaultPlan | None) -> None:
        """Attach (or with None, detach) a FaultPlan; see its docstring."""
        self.faults = plan

    def reset_in_flight_peak(self) -> None:
        self.in_flight_peak = 0

    def _log_request(self, verb: str, kind: str, name: str | None = None,
                     namespace: str | None = None) -> dict:
        self.requests[verb] += 1
        trace_id = tracing.current_trace_id()
        entry = {
            "verb": verb,
            "kind": kind,
            "name": name,
            "namespace": namespace,
            "headers": {"X-Request-Id": trace_id} if trace_id else {},
            # start is stamped at ADMISSION (_admit), not arrival: the
            # [start, end] window means "being served", so overlap
            # assertions aren't muddied by flow-lane queue wait.
            "start": None,
            "end": None,
        }
        self.request_log.append(entry)
        tracing.note_api_call(verb, kind)
        return entry

    async def _admit(self, entry: dict) -> None:
        """Flow-control admission + RTT sleep; in-flight counts requests
        being SERVED (a lane-queued request isn't in flight yet), and the
        entry's ``start`` is stamped here for the same reason.
        Balanced under cancellation: anything acquired here is undone
        before re-raising, so callers only pair ``_finish`` with a fully
        admitted request."""
        verb, kind = entry["verb"], entry["kind"]
        if self.flow is not None:
            await self.flow.acquire(verb, kind)
        entry["start"] = time.monotonic()
        self._in_flight += 1
        if self._in_flight > self.in_flight_peak:
            self.in_flight_peak = self._in_flight
        if self.latency > 0.0:
            delay = self.latency
            if self.latency_jitter:
                delay += self._rng.uniform(0.0, self.latency_jitter)
            try:
                await asyncio.sleep(delay)
            except BaseException:  # cancelled mid-RTT: undo the admission
                self._in_flight -= 1
                if self.flow is not None:
                    self.flow.release(verb, kind)
                raise
        if self.faults is not None:
            # Injection AFTER lane admission + RTT: the request paid the
            # round trip, then the server failed it — exactly where a real
            # 5xx/429/409 lands. Undo the admission before raising so the
            # caller's _finish pairing stays balanced (same contract as a
            # mid-RTT cancellation above).
            err = self.faults.error_for(verb, kind, entry.get("name"))
            if err is not None:
                entry["fault"] = err.reason
                entry["end"] = time.monotonic()
                self._in_flight -= 1
                if self.flow is not None:
                    self.flow.release(verb, kind)
                raise err

    def _finish(self, entry: dict) -> None:
        self._in_flight -= 1
        entry["end"] = time.monotonic()
        if self.flow is not None:
            self.flow.release(entry["verb"], entry["kind"])

    def write_count(self) -> int:
        """Mutating requests issued so far (no-op writes the server
        swallowed still count — the client paid the round-trip)."""
        return sum(self.requests[v] for v in self.WRITE_VERBS)

    def reset_counts(self) -> None:
        self.requests.clear()
        self.request_log.clear()

    # ---- admission plugin registration ---------------------------------------

    def add_mutator(self, kind_glob: str, fn: Mutator) -> None:
        self._mutators.append((kind_glob, fn))

    def add_validator(self, kind_glob: str, fn: Validator) -> None:
        self._validators.append((kind_glob, fn))

    # ---- internals -----------------------------------------------------------

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _bucket(self, kind: str) -> dict[tuple[str | None, str], dict]:
        gvk = self.scheme.by_kind(kind)  # raises for unknown kinds
        return self._store[gvk.key]

    def _key(self, kind: str, obj_or_name, namespace: str | None) -> tuple[str | None, str]:
        gvk = self.scheme.by_kind(kind)
        if isinstance(obj_or_name, dict):
            name, namespace = name_of(obj_or_name), namespace_of(obj_or_name)
        else:
            name = obj_or_name
        return (namespace if gvk.namespaced else None, name)

    async def _run_admission(self, obj: dict, op: str, old: dict | None = None) -> None:
        info = {"operation": op, "old": deepcopy(old) if old else None}
        for glob, fn in self._mutators:
            if fnmatch.fnmatch(obj.get("kind", ""), glob):
                res = fn(obj, info)
                if asyncio.iscoroutine(res):
                    await res
        for glob, fn in self._validators:
            if fnmatch.fnmatch(obj.get("kind", ""), glob):
                res = fn(obj, info)
                if asyncio.iscoroutine(res):
                    await res

    def _notify(self, event: str, obj: dict) -> None:
        for w in self._watches:
            if w.kind == obj.get("kind") and w.wants(obj):
                w.queue.put_nowait((event, deepcopy(obj)))

    async def _cascade_delete(self, parent: dict) -> None:
        """Background GC: delete dependents whose ownerReference points here."""
        uid = get_meta(parent).get("uid")
        if not uid:
            return
        for bucket in list(self._store.values()):
            for key, obj in list(bucket.items()):
                refs = get_meta(obj).get("ownerReferences", [])
                if any(r.get("uid") == uid for r in refs):
                    await self._delete_obj(obj["kind"], key)

    # ---- KubeApi surface -----------------------------------------------------

    async def get(self, kind: str, name: str, namespace: str | None = None) -> dict:
        entry = self._log_request("get", kind, name, namespace)
        await self._admit(entry)

        try:
            bucket = self._bucket(kind)
            key = self._key(kind, name, namespace)
            obj = bucket.get(key)
            if obj is None:
                raise NotFound(f"{kind} {key[0]}/{key[1]} not found")
            return deepcopy(obj)
        finally:
            self._finish(entry)

    async def list(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        field_selector: Callable[[dict], bool] | None = None,
        copy: bool = True,
    ) -> list[dict]:
        """List objects; the returned list holds defensive copies by
        default (``field_selector`` predicates always run against the live
        store dicts and must be pure — don't mutate or retain their
        argument).

        ``copy=False`` hands out the LIVE store dicts for read-only scans —
        a FakeKube-only escape hatch (HttpKube has no such parameter, so
        production controller code can't grow a dependency on it) used by
        the kubelet simulator and load test, whose per-event ownership
        scans dominated the control-plane bench's profile otherwise.
        Callers must not mutate the returned objects.
        """
        entry = self._log_request("list", kind, namespace=namespace)
        await self._admit(entry)

        try:
            items, _rv = self._list_locked(
                kind, namespace, label_selector, field_selector, copy)
            return items
        finally:
            self._finish(entry)

    def _list_locked(
        self, kind, namespace, label_selector, field_selector, copy,
    ) -> tuple[list[dict], str]:
        selector = (
            parse_label_selector(label_selector)
            if isinstance(label_selector, str)
            else label_selector
        )
        gvk_key = self.scheme.by_kind(kind).key
        source = self._bucket(kind).values()
        rv = str(self._rv)
        stale = False
        if (self.faults is not None and gvk_key in self._list_snapshots
                and self.faults.list_is_stale(kind)):
            # Stale snapshot: the previous LIST's view of the kind — an
            # old-resourceVersion read. Served from copies, never the
            # live store.
            source, rv = self._list_snapshots[gvk_key]
            stale = True
        out = []
        for obj in source:
            if namespace and namespace_of(obj) != namespace:
                continue
            if not matches_selector(get_meta(obj).get("labels"), selector):
                continue
            if field_selector and not field_selector(obj):
                continue
            out.append(deepcopy(obj) if copy else obj)
        out.sort(key=lambda o: (namespace_of(o) or "", name_of(o)))
        if not stale and self.faults is not None:
            # Remember this (fresh) view so a later injected stale LIST
            # has a genuinely older snapshot to serve. Only while a fault
            # plan is attached — the O(bucket) copy must not tax the
            # copy=False fast paths (kubelet sim, load test) otherwise.
            self._list_snapshots[gvk_key] = (
                [deepcopy(o) for o in self._bucket(kind).values()], rv)
        return out, rv

    async def list_with_rv(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        field_selector: Callable[[dict], bool] | None = None,
    ) -> tuple[list[dict], str | None]:
        entry = self._log_request("list", kind, namespace=namespace)
        await self._admit(entry)
        try:
            return self._list_locked(
                kind, namespace, label_selector, field_selector, True)
        finally:
            self._finish(entry)

    async def create(self, kind: str, obj: dict, namespace: str | None = None) -> dict:
        entry = self._log_request(
            "create", kind, name_of(obj), namespace or namespace_of(obj))
        await self._admit(entry)

        try:
            return await self._create_locked(kind, obj, namespace)
        finally:
            self._finish(entry)

    async def _create_locked(
        self, kind: str, obj: dict, namespace: str | None = None
    ) -> dict:
        async with self._lock:
            obj = deepcopy(obj)
            obj.setdefault("kind", kind)
            obj.setdefault("apiVersion", self.scheme.by_kind(kind).api_version)
            meta = get_meta(obj)
            if namespace and self.scheme.by_kind(kind).namespaced:
                meta.setdefault("namespace", namespace)
            if not meta.get("name"):
                if meta.get("generateName"):
                    meta["name"] = meta["generateName"] + uuid.uuid4().hex[:6]
                else:
                    raise Invalid(f"{kind}: metadata.name required")
            bucket = self._bucket(kind)
            key = self._key(kind, obj, None)
            if key in bucket:
                raise AlreadyExists(f"{kind} {key} already exists")
            await self._run_admission(obj, "CREATE")
            # A mutator may replace the metadata (a webhook's JSONPatch
            # applied to the object): stamp the admitted object's.
            meta = get_meta(obj)
            meta["uid"] = str(uuid.uuid4())
            meta["resourceVersion"] = self._next_rv()
            meta["generation"] = 1
            meta.setdefault("creationTimestamp", _now())
            bucket[self._key(kind, obj, None)] = deepcopy(obj)
            self._notify("ADDED", obj)
            return deepcopy(obj)

    async def update(self, kind: str, obj: dict) -> dict:
        entry = self._log_request("update", kind, name_of(obj), namespace_of(obj))
        await self._admit(entry)

        try:
            return await self._update_locked(kind, obj)
        finally:
            self._finish(entry)

    async def _update_locked(self, kind: str, obj: dict) -> dict:
        async with self._lock:
            obj = deepcopy(obj)
            bucket = self._bucket(kind)
            key = self._key(kind, obj, None)
            current = bucket.get(key)
            if current is None:
                raise NotFound(f"{kind} {key} not found")
            meta, cur_meta = get_meta(obj), get_meta(current)
            if meta.get("resourceVersion") and meta["resourceVersion"] != cur_meta["resourceVersion"]:
                raise Conflict(
                    f"{kind} {key}: resourceVersion {meta['resourceVersion']} != "
                    f"{cur_meta['resourceVersion']}"
                )
            await self._run_admission(obj, "UPDATE", old=current)
            # status is a subresource: full updates never change it
            if "status" in current:
                obj["status"] = deepcopy(current["status"])
            else:
                obj.pop("status", None)
            meta = get_meta(obj)  # as in create: admission may replace it
            meta["uid"] = cur_meta["uid"]
            meta["creationTimestamp"] = cur_meta["creationTimestamp"]
            meta["resourceVersion"] = cur_meta["resourceVersion"]
            meta["generation"] = cur_meta.get("generation", 1)
            if obj == current and not cur_meta.get("deletionTimestamp"):
                return deepcopy(current)  # no-op update: no rv bump, no event
            meta["resourceVersion"] = self._next_rv()
            spec_changed = obj.get("spec") != current.get("spec")
            meta["generation"] = cur_meta.get("generation", 1) + (1 if spec_changed else 0)
            # deleting objects: removing the last finalizer completes deletion
            if cur_meta.get("deletionTimestamp"):
                meta["deletionTimestamp"] = cur_meta["deletionTimestamp"]
                if not meta.get("finalizers"):
                    del bucket[key]
                    self._notify("DELETED", obj)
                    await self._cascade_delete(obj)
                    return deepcopy(obj)
            bucket[key] = deepcopy(obj)
            self._notify("MODIFIED", obj)
            return deepcopy(obj)

    async def update_status(self, kind: str, obj: dict) -> dict:
        entry = self._log_request(
            "update_status", kind, name_of(obj), namespace_of(obj))
        await self._admit(entry)

        try:
            return await self._update_status_locked(kind, obj)
        finally:
            self._finish(entry)

    async def _update_status_locked(self, kind: str, obj: dict) -> dict:
        async with self._lock:
            bucket = self._bucket(kind)
            key = self._key(kind, obj, None)
            current = bucket.get(key)
            if current is None:
                raise NotFound(f"{kind} {key} not found")
            new = deepcopy(current)
            if "status" in obj:
                new["status"] = deepcopy(obj["status"])
            if new == current:  # no-op writes don't bump rv (real-apiserver semantics)
                return deepcopy(current)
            get_meta(new)["resourceVersion"] = self._next_rv()
            bucket[key] = deepcopy(new)
            self._notify("MODIFIED", new)
            return deepcopy(new)

    async def patch(
        self,
        kind: str,
        name: str,
        patch: dict,
        namespace: str | None = None,
        subresource: str | None = None,
    ) -> dict:
        """Strategic-ish merge patch: dicts merge recursively, None deletes,
        lists replace (the k8s merge-patch rule)."""
        entry = self._log_request("patch", kind, name, namespace)
        await self._admit(entry)

        try:
            return await self._patch_locked(kind, name, patch, namespace,
                                            subresource)
        finally:
            self._finish(entry)

    async def _patch_locked(
        self,
        kind: str,
        name: str,
        patch: dict,
        namespace: str | None = None,
        subresource: str | None = None,
    ) -> dict:
        async with self._lock:
            bucket = self._bucket(kind)
            key = self._key(kind, name, namespace)
            current = bucket.get(key)
            if current is None:
                raise NotFound(f"{kind} {key} not found")
            new = deepcopy(current)

            def merge(dst: dict, src: dict) -> None:
                for k, v in src.items():
                    if v is None:
                        dst.pop(k, None)
                    elif isinstance(v, dict) and isinstance(dst.get(k), dict):
                        merge(dst[k], v)
                    else:
                        dst[k] = copy.deepcopy(v)

            if subresource == "status":
                merge(new.setdefault("status", {}), patch.get("status", patch))
            else:
                merge(new, patch)
                await self._run_admission(new, "UPDATE", old=current)
                if "status" in current:
                    new["status"] = deepcopy(current["status"])
            if new == current:  # no-op patch: no rv bump, no event (apiserver semantics)
                return deepcopy(current)
            meta = get_meta(new)
            meta["resourceVersion"] = self._next_rv()
            if new.get("spec") != current.get("spec"):
                meta["generation"] = get_meta(current).get("generation", 1) + 1
            # Removing the last finalizer from a deleting object completes the
            # delete (same two-phase semantics as update()).
            if get_meta(current).get("deletionTimestamp") and not meta.get("finalizers"):
                del bucket[key]
                self._notify("DELETED", new)
                await self._cascade_delete(new)
                return deepcopy(new)
            bucket[key] = deepcopy(new)
            self._notify("MODIFIED", new)
            return deepcopy(new)

    async def delete(self, kind: str, name: str, namespace: str | None = None) -> None:
        entry = self._log_request("delete", kind, name, namespace)
        await self._admit(entry)

        try:
            async with self._lock:
                key = self._key(kind, name, namespace)
                await self._delete_obj(kind, key)
        finally:
            self._finish(entry)

    async def _delete_obj(self, kind: str, key: tuple[str | None, str]) -> None:
        bucket = self._bucket(kind)
        obj = bucket.get(key)
        if obj is None:
            raise NotFound(f"{kind} {key} not found")
        meta = get_meta(obj)
        if meta.get("finalizers"):
            if not meta.get("deletionTimestamp"):
                meta["deletionTimestamp"] = _now()
                meta["resourceVersion"] = self._next_rv()
                self._notify("MODIFIED", obj)
            return
        del bucket[key]
        self._notify("DELETED", obj)
        await self._cascade_delete(obj)

    def watch(
        self,
        kind: str,
        namespace: str | None = None,
        label_selector: str | dict | None = None,
        *,
        field_selector: Callable[[dict], bool] | None = None,
        send_initial: bool = True,
        resource_version: str | None = None,
    ) -> AsyncIterator[tuple[str, dict]]:
        """Watch registration is EAGER (at call time, not first iteration) so a
        synchronous list→watch sequence observes every event — the in-memory
        equivalent of resourceVersion continuity (``resource_version`` is
        accepted and ignored). ``field_selector`` mirrors list(): a pure
        predicate over the live store dict, re-evaluated per event."""
        selector = (
            parse_label_selector(label_selector)
            if isinstance(label_selector, str)
            else label_selector
        )
        w = _Watch(kind, namespace, selector, field_selector)
        if send_initial:
            for obj in self._bucket(kind).values():
                if w.wants(obj):
                    w.queue.put_nowait(("ADDED", deepcopy(obj)))
        self._watches.append(w)
        return self._drain_watch(w)

    async def _drain_watch(self, w: _Watch) -> AsyncIterator[tuple[str, dict]]:
        try:
            while True:
                item = await w.queue.get()
                if item is None:
                    return
                yield item
                if self.faults is not None and \
                        self.faults.watch_should_reset(w.kind):
                    # Mid-stream reset: the server closed the stream after
                    # this event (network blip, apiserver restart, 410
                    # Gone). The client sees a cleanly-ended watch and must
                    # relist to regain resourceVersion continuity.
                    return
        finally:
            if w in self._watches:
                self._watches.remove(w)

    def close_watches(self) -> None:
        for w in self._watches:
            w.queue.put_nowait(None)

    # ---- pod logs (kubelet surface) ------------------------------------------

    def set_pod_logs(self, namespace: str, name: str, text: str) -> None:
        self._pod_logs[(namespace, name)] = text

    async def pod_logs(
        self, name: str, namespace: str, container: str | None = None,
        tail_lines: int | None = None,
    ) -> str:
        """Kubelet log read. Tests seed with set_pod_logs; unseeded running
        pods synthesize a plausible startup log."""
        if (namespace, name) not in self._pod_logs:
            pod = await self.get("Pod", name, namespace)  # NotFound propagates
            phase = deep_get(pod, "status", "phase", default="Pending")
            self._pod_logs[(namespace, name)] = (
                f"[s6-init] making user provided files available\n"
                f"[{name}] phase={phase}\n"
            )
        text = self._pod_logs[(namespace, name)]
        if tail_lines is not None:
            if tail_lines <= 0:
                return ""  # kubelet semantics: tailLines=0 → nothing
            lines = text.splitlines()[-tail_lines:]
            text = "\n".join(lines) + ("\n" if lines else "")
        return text

    # ---- test conveniences ---------------------------------------------------

    async def get_or_none(self, kind: str, name: str, namespace: str | None = None) -> dict | None:
        try:
            return await self.get(kind, name, namespace)
        except NotFound:
            return None

    def dump(self) -> dict[str, list[str]]:
        return {
            key: [f"{ns or '-'}/{n}" for (ns, n) in sorted(bucket, key=lambda t: (t[0] or "", t[1]))]
            for key, bucket in self._store.items()
            if bucket
        }
