"""Event recorder: create/aggregate v1 Events on objects.

The reference re-emits pod/STS events onto Notebook CRs so the UI can surface
them (``notebook_controller.go:94-123``); this recorder provides the emit
side, with count aggregation like client-go's EventRecorder.

The port's copy of ``kubeflow_tpu/runtime/events.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict

from kubeflow_tpu_torch.runtime import tracing
from kubeflow_tpu_torch.runtime.errors import AlreadyExists, ApiError, NotFound
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import name_of, namespace_of, uid_of
from kubeflow_tpu_torch.runtime.objects import now_iso as _now


class EventRecorder:
    # Known-digest LRU bound: enough for every hot event series of a busy
    # controller; an evicted digest costs one GET on its next emit.
    CACHE_SIZE = 512

    def __init__(self, kube, component: str,
                 registry: Registry | None = None):
        self.kube = kube
        self.component = component
        # Events are best-effort BY CONTRACT: a failed create/patch (an
        # injected 500, a saturated apiserver) must never fail the
        # reconcile that emitted it — swallowed here, visible there.
        self._emit_failures = (registry or global_registry).counter(
            "events_emit_failures_total",
            "Event create/patch attempts swallowed as best-effort",
            ["component"],
        )
        # (namespace, event-name) → last-written count. Steady-state
        # aggregation (the overwhelmingly common case: the same reason
        # re-emitted every reconcile) patches the count directly instead
        # of paying a GET round trip per emit just to decide
        # create-vs-patch. NotFound on the patch (event TTL'd/GC'd under
        # us) invalidates the entry and falls back to create.
        self._known: OrderedDict[tuple, int] = OrderedDict()

    def count_drop(self) -> None:
        """Count an emission dropped OUTSIDE the recorder (a caller's
        best-effort guard around :meth:`event` — non-API failures the
        recorder itself can't see). Same ``events_emit_failures_total``
        series as the recorder's own swallows, so 'events stopped
        appearing' always has one metric to alert on (the
        ``exception-swallow`` pass rejects uncounted drops)."""
        self._emit_failures.labels(component=self.component).inc()

    def _remember(self, key: tuple, count: int) -> None:
        self._known[key] = count
        self._known.move_to_end(key)
        while len(self._known) > self.CACHE_SIZE:
            self._known.popitem(last=False)

    async def event(
        self, obj: dict, event_type: str, reason: str, message: str
    ) -> None:
        # The flight-recorder entry lists the reasons a reconcile emitted,
        # next to the API verbs it issued.
        tracing.note_event(reason)
        namespace = namespace_of(obj) or "default"
        ref = {
            "apiVersion": obj.get("apiVersion"),
            "kind": obj.get("kind"),
            "name": name_of(obj),
            "namespace": namespace_of(obj),
            "uid": uid_of(obj),
        }
        digest = hashlib.sha1(
            f"{ref['kind']}/{ref['namespace']}/{ref['name']}/{reason}/{message}".encode()
        ).hexdigest()[:10]
        name = f"{name_of(obj)}.{digest}"
        key = (namespace, name)
        count = self._known.get(key)
        if count is not None:
            try:
                await self.kube.patch(
                    "Event",
                    name,
                    {"count": count + 1, "lastTimestamp": _now()},
                    namespace,
                )
                self._remember(key, count + 1)
                return
            except NotFound:
                # The event expired between emits; create it fresh below.
                self._known.pop(key, None)
            except ApiError:
                self._emit_failures.labels(component=self.component).inc()
                return
        # Cold miss: optimistic create — a brand-new event (the common
        # cold case) costs ONE round trip instead of GET + create; an
        # AlreadyExists (recorder restart over a live event, or a racing
        # writer) falls back to read-and-aggregate.
        event = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": namespace},
            "involvedObject": ref,
            "reason": reason,
            "message": message,
            "type": event_type,
            "source": {"component": self.component},
            "firstTimestamp": _now(),
            "lastTimestamp": _now(),
            "count": 1,
        }
        try:
            await self.kube.create("Event", event)
            self._remember(key, 1)
            return
        except AlreadyExists:
            pass
        except ApiError:
            self._emit_failures.labels(component=self.component).inc()
            return  # events are best-effort
        try:
            existing = await self.kube.get("Event", name, namespace)
            await self.kube.patch(
                "Event",
                existing["metadata"]["name"],
                {"count": existing.get("count", 1) + 1,
                 "lastTimestamp": _now()},
                namespace,
            )
            self._remember(key, existing.get("count", 1) + 1)
        except ApiError:
            self._emit_failures.labels(component=self.component).inc()
            self._known.pop(key, None)
