"""Create-or-update helpers with drift detection.

Port-in-spirit of the reference's ``components/common/reconcilehelper/util.go``
(:18-219): each helper fetches the live object, creates it if absent, and
otherwise copies only the fields the controller owns — preserving
cluster-managed fields (Service clusterIP, statuses) so reconciles converge
instead of fighting the apiserver.

The port's copy of ``kubeflow_tpu/runtime/apply.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass

from kubeflow_tpu_torch.runtime.errors import AlreadyExists, Conflict, NotFound
from kubeflow_tpu_torch.runtime.metrics import global_registry
from kubeflow_tpu_torch.runtime.tracing import span
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    deepcopy,
    get_meta,
    name_of,
    namespace_of,
    set_controller_owner,
)

log = logging.getLogger(__name__)

# Write-elision telemetry (bench reports these): "hash" means the
# last-applied cache short-circuited before even diffing; "diff" means the
# copier compared and found no drift. Either way zero API writes happened.
M_ELIDED = global_registry.counter(
    "apply_writes_elided_total",
    "Child reconciles that issued no API write",
    ["kind", "via"],
)


def state_hash(obj) -> str:
    """Stable content hash of a JSON-shaped object (dict key order and
    whitespace don't matter; list order does — k8s list order is
    semantic, matching subset_equal below)."""
    return hashlib.sha1(
        json.dumps(obj, sort_keys=True, separators=(",", ":"),
                   default=str).encode()
    ).hexdigest()


class ApplyCache:
    """Per-key last-applied memory: (kind, ns, name) → (desired-state
    hash, live resourceVersion at last convergence). A reconcile whose
    desired state hashes the same while the live object's rv is unchanged
    is provably a no-op — skip the diff entirely. Any external change
    bumps the rv and falls through to the copier, so drift repair is
    untouched; a desired-state change misses on the hash.

    LRU-bounded: deletion paths (owner cascade, GC) don't flow through
    here, so without a bound the cache would grow with *historical*
    object count under create/delete churn. Eviction only costs a diff
    on the next reconcile of that key — never correctness."""

    def __init__(self, max_entries: int = 4096):
        self.max_entries = max_entries
        self._entries: "OrderedDict[tuple, tuple[str, str | None]]" = \
            OrderedDict()

    @staticmethod
    def key_of(desired: dict) -> tuple:
        return (desired.get("kind"), namespace_of(desired), name_of(desired))

    def unchanged(self, key: tuple, desired_hash: str, live_rv) -> bool:
        entry = self._entries.get(key)
        if entry is None or entry != (desired_hash, live_rv):
            return False
        self._entries.move_to_end(key)
        return True

    def record(self, key: tuple, desired_hash: str, live_rv) -> None:
        self._entries[key] = (desired_hash, live_rv)
        self._entries.move_to_end(key)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)

    def forget(self, key: tuple) -> None:
        self._entries.pop(key, None)


def informer_reader(informers: dict):
    """A ``reconcile_child`` reader over a kind → informer mapping (the
    shape every reconciler wires in its setup fn). The dict is read live,
    so setup may populate it after constructing the reader."""

    def reader(kind: str, name: str, namespace: str | None) -> dict | None:
        inf = informers.get(kind)
        return inf.get(name, namespace) if inf is not None else None

    return reader


def subset_equal(want, have) -> bool:
    """True when every field the controller sets is already present in the
    live object. The live object legitimately has MORE fields (apiserver
    defaulting: Service ipFamilies/sessionAffinity, pod restartPolicy/
    dnsPolicy, ...); comparing whole subtrees with ``==`` would see permanent
    drift and update in a hot loop against a real cluster. Trade-off: a field
    the controller *removes* from its desired state is not reverted — owned
    objects are regenerated wholesale on spec changes, so this doesn't bite.
    Lists compare element-wise (k8s list order is semantic)."""
    if isinstance(want, dict) and isinstance(have, dict):
        return all(k in have and subset_equal(v, have[k]) for k, v in want.items())
    if isinstance(want, list) and isinstance(have, list):
        return len(want) == len(have) and all(
            subset_equal(w, h) for w, h in zip(want, have)
        )
    return want == have


def copy_statefulset_fields(desired: dict, live: dict) -> bool:
    """Reference: CopyStatefulSetFields (util.go:57-86) — labels, annotations,
    replicas, template; returns True when an update is required."""
    changed = _copy_meta(desired, live)
    for path in (("spec", "replicas"), ("spec", "template")):
        changed |= _copy_path(desired, live, path)
    return changed


copy_deployment_fields = copy_statefulset_fields  # identical owned-field set


def copy_service_fields(desired: dict, live: dict) -> bool:
    """Reference: CopyServiceFields (util.go:118-145) — preserves clusterIP.

    The live clusterIP is folded into the desired spec *before* comparison so
    repeated reconciles converge instead of updating forever.
    """
    changed = _copy_meta(desired, live)
    want = deepcopy(deep_get(desired, "spec") or {})
    cluster_ip = deep_get(live, "spec", "clusterIP")
    if cluster_ip is not None and "clusterIP" not in want:
        want["clusterIP"] = cluster_ip
    if not subset_equal(want, deep_get(live, "spec") or {}):
        live["spec"] = want
        changed = True
    return changed


def copy_virtual_service(desired: dict, live: dict) -> bool:
    changed = _copy_meta(desired, live)
    changed |= _copy_path(desired, live, ("spec",))
    return changed


def copy_spec(desired: dict, live: dict) -> bool:
    changed = _copy_meta(desired, live)
    changed |= _copy_path(desired, live, ("spec",))
    return changed


def _copy_meta(desired: dict, live: dict) -> bool:
    """Fold desired labels/annotations into the live ones (other actors may
    legitimately add their own; only ours must be present and equal)."""
    changed = False
    for field in ("labels", "annotations"):
        want = get_meta(desired).get(field)
        have = get_meta(live).get(field) or {}
        if want is not None and not subset_equal(want, have):
            get_meta(live)[field] = {**have, **deepcopy(want)}
            changed = True
    return changed


def _copy_path(desired: dict, live: dict, path: tuple[str, ...]) -> bool:
    want = deep_get(desired, *path)
    have = deep_get(live, *path)
    if want is None or subset_equal(want, have):
        return False
    cur = live
    for part in path[:-1]:
        cur = cur.setdefault(part, {})
    cur[path[-1]] = deepcopy(want)
    return True


def copy_rolebinding_fields(desired: dict, live: dict) -> bool:
    """RoleBindings have no spec: the owned payload is subjects (+ roleRef).
    Note roleRef is immutable on a real apiserver — our bindings derive the
    role from the binding *name*, so a roleRef change implies a new name
    (delete + create), never an in-place update."""
    changed = _copy_meta(desired, live)
    for field in ("subjects", "roleRef"):
        want = desired.get(field)
        if want is not None and not subset_equal(want, live.get(field)):
            live[field] = deepcopy(want)
            changed = True
    return changed


COPIERS = {
    "StatefulSet": copy_statefulset_fields,
    "Deployment": copy_deployment_fields,
    "Service": copy_service_fields,
    "VirtualService": copy_virtual_service,
    "RoleBinding": copy_rolebinding_fields,
}


async def reconcile_child(
    kube, desired: dict, *, copier=None, cache: ApplyCache | None = None,
    reader=None,
) -> tuple[dict, bool]:
    """Ensure ``desired`` exists and owned fields match.

    Returns ``(live_object, created)`` — callers that count creations (e.g.
    the notebook_create_total metric) use the flag instead of a second
    read-before-write. The per-kind copier defaults from COPIERS; unknown
    kinds copy the whole spec. Conflict → raise (the workqueue retries with
    backoff, matching the reference's requeue-on-conflict behavior).

    ``reader(kind, name, namespace) -> dict | None`` reads the live object
    from a watch cache (informer) instead of a per-reconcile apiserver GET
    — a None return (cold cache) falls back to the GET, so correctness
    never depends on cache warmth. A stale cached rv at worst produces a
    Conflict the workqueue retries, same as any writer race.

    ``cache`` (ApplyCache) elides the whole diff when the desired-state
    hash AND the live rv match the last convergence — the steady-state
    reconcile touches neither the apiserver nor the copier.
    """
    kind = desired["kind"]
    copier = copier or COPIERS.get(kind, copy_spec)
    name, namespace = name_of(desired), namespace_of(desired)
    ckey = ApplyCache.key_of(desired) if cache is not None else None
    dh = state_hash(desired) if cache is not None else None

    with span("apply_child", kind=kind, name=name) as sp:
        live = reader(kind, name, namespace) if reader is not None else None
        if live is not None:
            if cache is not None and cache.unchanged(
                ckey, dh, get_meta(live).get("resourceVersion")
            ):
                M_ELIDED.labels(kind=kind, via="hash").inc()
                sp.set_attribute("outcome", "elided_hash")
                return deepcopy(live), False
            # The copier folds fields INTO live; never mutate the informer's
            # stored object.
            live = deepcopy(live)
        if live is None:
            try:
                live = await kube.get(kind, name, namespace)
            except NotFound:
                try:
                    created = await kube.create(kind, desired)
                    if cache is not None:
                        cache.record(
                            ckey, dh, get_meta(created).get("resourceVersion"))
                    sp.set_attribute("outcome", "created")
                    return created, True
                except AlreadyExists:
                    live = await kube.get(kind, name, namespace)
        if copier(desired, live):
            log.debug("updating %s %s/%s (drift)", kind, namespace, name)
            updated = await kube.update(kind, live)
            if cache is not None:
                cache.record(ckey, dh, get_meta(updated).get("resourceVersion"))
            sp.set_attribute("outcome", "updated")
            return updated, False
        M_ELIDED.labels(kind=kind, via="diff").inc()
        sp.set_attribute("outcome", "elided_diff")
        if cache is not None:
            cache.record(ckey, dh, get_meta(live).get("resourceVersion"))
        return live, False


# ---- DAG-parallel child apply (latency hiding) -------------------------------

# Kill switch / bench baseline: forces apply_set stages and overlap() to
# run sequentially, restoring the serial round-trip shape.
SERIAL_ENV = "KFTPU_SERIAL_APPLY"


def _serial() -> bool:
    return os.environ.get(SERIAL_ENV, "") not in ("", "0", "false")


class Stage:
    """One dependency stage of an :func:`apply_set` DAG: a NAME (lands on
    the ``apply_stage`` span; ci/check_tracing.py pins that converted
    controllers declare literal stage names) plus the children that may
    run concurrently. A child is a desired-object dict (applied through
    :func:`reconcile_child`) or a coroutine / zero-arg async callable for
    custom work that must still respect the stage ordering. ``None``
    children are dropped, so option-gated children read naturally at the
    call site."""

    __slots__ = ("name", "children")

    def __init__(self, name: str, children):
        self.name = name
        self.children = [c for c in children if c is not None]


@dataclass
class ChildOutcome:
    """Per-child result of :func:`apply_set` — recorded even when a
    stage-mate failed (first-error semantics raise only after the whole
    stage settles)."""

    child: object
    result: object = None   # reconcile_child's live object / callable return
    created: bool = False
    error: Exception | None = None


async def _run_child(kube, row: ChildOutcome, cache, reader, owner) -> None:
    child = row.child
    try:
        if isinstance(child, dict):
            if owner is not None:
                set_controller_owner(child, owner)
            row.result, row.created = await reconcile_child(
                kube, child, cache=cache, reader=reader)
        elif asyncio.iscoroutine(child):
            row.result = await child
        else:
            row.result = await child()
    except Exception as e:  # CancelledError propagates (shutdown)
        row.error = e


def _discard(children) -> None:
    """Close coroutine children that will never run (stages skipped after
    an earlier-stage error, or everything pending when a cancellation
    tears through mid-run), so they don't warn about never being
    awaited. Closing a finished coroutine is a no-op; a (theoretically)
    still-running one refuses — skip it rather than mask the real
    exception."""
    for c in children:
        if asyncio.iscoroutine(c):
            try:
                c.close()
            except RuntimeError:
                pass


async def apply_set(
    kube, stages, *, cache: ApplyCache | None = None, reader=None, owner=None,
) -> list[list[ChildOutcome]]:
    """Apply children as a dependency DAG of :class:`Stage` s.

    Children within a stage overlap via ``asyncio.gather`` — each keeps
    its own ``apply_child`` span and write elision — so a stage's wall
    time is its slowest child's RTT chain, not the sum. Stage N+1 starts
    only after every stage-N child settled (the barrier IS the dependency
    edge: e.g. capacity → slice StatefulSets → Services).

    First-error semantics: every stage-mate runs to completion and its
    outcome is recorded, then the first error re-raises (the workqueue
    retries with backoff). Later stages do not run; their coroutine
    children are closed.

    ``owner`` stamps the controller ownerReference on dict children;
    ``cache``/``reader`` thread through to :func:`reconcile_child`.
    ``KFTPU_SERIAL_APPLY=1`` forces sequential execution — the operator
    escape hatch, and the measured serial baseline of
    ``bench.py simulated_rtt``.
    """
    stages = list(stages)
    outcomes: list[list[ChildOutcome]] = []
    error: Exception | None = None
    for i, stage in enumerate(stages):
        if error is not None:
            _discard(stage.children)
            continue
        rows = [ChildOutcome(c) for c in stage.children]
        try:
            with span("apply_stage", stage=stage.name,
                      children=len(rows)) as sp:
                if _serial() or len(rows) <= 1:
                    for row in rows:
                        await _run_child(kube, row, cache, reader, owner)
                else:
                    await asyncio.gather(
                        *(_run_child(kube, row, cache, reader, owner)
                          for row in rows))
                failed = [r for r in rows if r.error is not None]
                if failed:
                    sp.fail(repr(failed[0].error))
                    error = failed[0].error
        except BaseException:
            # Cancellation (or a non-Exception) tore through mid-stage:
            # close this stage's never-started children and every later
            # stage's, then let it propagate.
            _discard(stage.children)
            for later in stages[i + 1:]:
                _discard(later.children)
            raise
        outcomes.append(rows)
    if error is not None:
        raise error
    return outcomes


async def overlap(*aws):
    """Run independent reconcile steps concurrently (sequentially under
    ``KFTPU_SERIAL_APPLY=1``) and return their results in argument order.
    ``None`` arguments stay ``None`` in the result, so option-gated steps
    keep positional results aligned. Same first-error semantics as an
    apply_set stage: every step settles, then the first error re-raises.
    """
    async def run_one(a):
        return None if a is None else await a

    # ≤1 real awaitable or the kill switch: nothing to overlap — skip
    # the per-coroutine Task spawns (the 0-RTT hot path keeps its cost).
    if _serial() or sum(a is not None for a in aws) <= 1:
        results, first = [], None
        for i, a in enumerate(aws):
            try:
                results.append(await run_one(a))
            except Exception as e:
                results.append(None)
                if first is None:
                    first = e
            except BaseException:
                _discard(aws[i + 1:])  # cancelled mid-run
                raise
        if first is not None:
            raise first
        return results
    try:
        results = await asyncio.gather(
            *(run_one(a) for a in aws), return_exceptions=True)
    except BaseException:
        # gather only raises here when itself cancelled; its run_one
        # tasks were cancelled too, but one cancelled before its first
        # step never awaited its inner coroutine — close stragglers.
        _discard(aws)
        raise
    for r in results:
        if isinstance(r, BaseException):
            raise r
    return results
