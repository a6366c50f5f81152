"""Culling reconciler: probe Jupyter activity, stop idle notebooks. The
port of ``kubeflow_tpu/controllers/culling.py``.

Reference: ``notebook-controller/controllers/culling_controller.go``:

- periodic requeue every IDLENESS_CHECK_PERIOD (default 1 min, :31)
- probes ``http://<nb>.<ns>.svc.<domain>/notebook/<ns>/<nb>/api/kernels``
  and ``/api/terminals`` (:209-279) with a 10 s timeout (:210-212)
- a notebook is busy if any kernel's ``execution_state`` != idle; last
  activity folds the max of kernel/terminal ``last_activity`` (:281-315)
- tracks ``notebooks.kubeflow.org/last-activity`` + check-timestamp
  annotations (:156-167); idle > CULL_IDLE_TIME (default 1440 min, :30)
  → sets the ``kubeflow-resource-stopped`` annotation, which the notebook
  reconciler turns into replicas=0 (notebook_controller.go:410-412)

GPU slice semantics (SURVEY.md §2.4 last row): the Jupyter server —
and therefore kernel activity — lives on node 0; culling one node of a
slice is meaningless, so the stop annotation always parks the *whole* slice
(the notebook reconciler scales every node to zero together). Cards are
the scarce resource: default idle window is kept but the controller exposes
``gpu_cards_idle_culled_total`` (the counterpart of the reference's
``tpu_chips_idle_culled_total``, summing ``status.gpu.chips``) so
operators can see reclaimed capacity.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Awaitable, Callable

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.runtime.errors import ApiError
from kubeflow_tpu_torch.runtime.events import EventRecorder
from kubeflow_tpu_torch.runtime.manager import Controller, Manager, Result
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import deep_get, get_meta
from kubeflow_tpu_torch.runtime.objects import fmt_iso as _fmt_time
from kubeflow_tpu_torch.runtime.objects import parse_iso as _parse_time
from kubeflow_tpu_torch.runtime.tracing import span

log = logging.getLogger(__name__)

# Prober contract: GET url → parsed JSON (list) or None on any error.
Prober = Callable[[str], Awaitable[list | None]]


async def http_prober(url: str) -> list | None:
    """Production prober over aiohttp (10 s budget like the reference)."""
    import aiohttp

    try:
        async with aiohttp.ClientSession(
            timeout=aiohttp.ClientTimeout(total=10)
        ) as sess:
            async with sess.get(url) as resp:
                if resp.status != 200:
                    return None
                data = await resp.json()
                return data if isinstance(data, list) else None
    except Exception:
        return None


@dataclass
class CullingOptions:
    """Reference env contract (culling_controller.go:511-544) as one block."""

    enable_culling: bool = True
    cull_idle_seconds: float = 1440 * 60.0     # CULL_IDLE_TIME (minutes) default
    check_period_seconds: float = 60.0         # IDLENESS_CHECK_PERIOD
    cluster_domain: str = "cluster.local"
    dev_url: str | None = None                 # DEV mode: probe localhost instead
    notebook_port: int = nbapi.DEFAULT_CONTAINER_PORT  # direct pod probes
    # Preempt-to-checkpoint reuse (kubeflow_tpu_torch/migration): an idle
    # cull of a GPU notebook requests checkpoint-then-stop instead of a bare
    # stop, so culled servers resume where they left off. The DATACLASS
    # default is off (bare construction = pre-migration behavior); the
    # env wiring (KFTPU_CULL_DRAIN under KFTPU_MIGRATION, both default
    # on) turns it on in production.
    drain_on_cull: bool = False
    drain_grace_seconds: float = migration.DEFAULT_DRAIN_GRACE_SECONDS


class CullingReconciler:
    def __init__(
        self,
        kube,
        prober: Prober | None = None,
        options: CullingOptions | None = None,
        *,
        clock: Callable[[], float] = time.time,
        registry: Registry | None = None,
    ):
        self.kube = kube
        self.prober = prober or http_prober
        self.opts = options or CullingOptions()
        self.clock = clock
        self.recorder = EventRecorder(kube, "culling-controller")
        # Pod informer (wired by setup_culling_controller): the auth-proxy
        # probe path resolves worker-0's pod IP from the watch cache
        # instead of a per-check apiserver GET.
        self._pod_informer = None
        registry = registry or global_registry
        self.m_culled = registry.counter(
            "notebook_culling_total", "Total times of culling notebooks"
        )
        self.m_last_cull = registry.gauge(
            "last_notebook_culling_timestamp_seconds",
            "Timestamp of the last notebook culling",
            ["namespace", "notebook"],
        )
        self.m_chips_culled = registry.counter(
            "gpu_cards_idle_culled_total",
            "GPUs reclaimed by culling idle notebooks",
        )

    def probe_url(self, name: str, ns: str, api: str) -> str:
        if self.opts.dev_url:
            return f"{self.opts.dev_url}/notebook/{ns}/{name}/api/{api}"
        return (
            f"http://{name}.{ns}.svc.{self.opts.cluster_domain}"
            f"/notebook/{ns}/{name}/api/{api}"
        )

    async def _probe_urls(self, nb: dict, name: str, ns: str) -> dict | None:
        """Resolve the probe endpoints for this notebook.

        When the auth-proxy sidecar is injected, the Service targetPort is
        the proxy (controllers/notebook.py _serving_target_port) and an
        unauthenticated probe through it gets a non-200 — the notebook
        would never be culled and idle GPUs never reclaimed. Probe
        node 0's pod IP on the notebook port directly instead, bypassing
        the proxied Service. Returns None if the pod IP isn't known yet
        (probe later rather than mis-deciding)."""
        from kubeflow_tpu_torch.controllers.notebook import (
            AUTH_PROXY_ANNOTATION)

        annotations = get_meta(nb).get("annotations") or {}
        if self.opts.dev_url or annotations.get(AUTH_PROXY_ANNOTATION) != "true":
            return {
                api: self.probe_url(name, ns, api)
                for api in ("kernels", "terminals")
            }
        if self._pod_informer is not None:
            pod = self._pod_informer.get(f"{name}-0", ns)
        else:
            pod = await self.kube.get_or_none("Pod", f"{name}-0", ns)
        pod_ip = deep_get(pod or {}, "status", "podIP")
        if not pod_ip:
            return None
        base = (
            f"http://{pod_ip}:{self.opts.notebook_port}"
            f"/notebook/{ns}/{name}/api"
        )
        return {api: f"{base}/{api}" for api in ("kernels", "terminals")}

    async def reconcile(self, key) -> Result | None:
        ns, name = key
        requeue = Result(requeue_after=self.opts.check_period_seconds)
        if not self.opts.enable_culling:
            return None
        with span("cache_read"):
            nb = await self.kube.get_or_none("Notebook", name, ns)
        if nb is None or get_meta(nb).get("deletionTimestamp"):
            return None
        if _is_serving_workload(nb):
            # Workload-class guard (kubeflow_tpu_torch/serving): a serving
            # workload exposes no Jupyter kernels, so every probe below
            # would read "idle forever" and the culler would stop the
            # service precisely when it is busiest. Serving capacity is
            # the InferenceService autoscaler's to reclaim (scale-to-
            # zero after ITS idle window), never the culler's.
            return None
        if nbapi.is_stopped(nb):
            return None  # already parked; notebook reconciler owns restart

        now = self.clock()
        drain_annotations = get_meta(nb).get("annotations") or {}
        if migration.drain_requested_at(drain_annotations) is not None:
            # A drain is in flight. Ours ("cull") is driven to its stop
            # here; anyone else's (preemption, suspend) owns the park —
            # probing/culling under it would race the finalizer.
            if migration.drain_reason(drain_annotations) == "cull":
                return await self._drive_cull_drain(nb, name, ns, now)
            return requeue
        with span("probe"):
            urls = await self._probe_urls(nb, name, ns)
            if urls is None:
                return requeue  # auth-proxied pod IP not known yet
            kernels = await self.prober(urls["kernels"])
            if kernels is None:
                # Kernels probe unreachable/invalid (server starting,
                # crashed, or mid-restart): without it a busy kernel is
                # indistinguishable from idle — never make a cull decision
                # on a failed probe (reference skips and retries, :226-239).
                return requeue
            # Terminals are tolerated missing (servers run with terminals
            # disabled → 404 forever; hard-requiring it would block culling
            # permanently). Kernels above are the authoritative busy signal.
            terminals = await self.prober(urls["terminals"])

        annotations = dict(get_meta(nb).get("annotations") or {})
        last_activity = _parse_time(
            annotations.get(nbapi.LAST_ACTIVITY_ANNOTATION, "")
        )
        # Idleness clocks from when the notebook last RAN, not from its
        # history: a gang that sat hours in the fleet scheduler's queue
        # still carries its pre-queue last-activity annotation, and
        # culling it seconds after admission would bounce it between
        # queue and cull forever. The scheduler's admitted-at stamp
        # (which it also reads back for idle-preemption ranking) floors
        # the clock at the moment the notebook actually started running.
        # It only RAISES an existing stale signal — a notebook with no
        # activity record at all must fall through to the fresh-server
        # branch below, not inherit the admission time as "activity"
        # (admission precedes the GKE provisioning wait, so that would
        # cull a slow-booting gang on its very first probe).
        admitted_at = _parse_time(
            annotations.get(nbapi.SCHEDULER_ADMITTED_AT_ANNOTATION, "")
        )
        if admitted_at is not None and last_activity is not None:
            last_activity = max(last_activity, admitted_at)

        busy, probe_activity = _fold_activity(kernels or [], terminals or [])
        if busy:
            last_activity = now
        elif probe_activity is not None:
            last_activity = max(last_activity or 0, probe_activity)
        elif last_activity is None:
            # Fresh server, no kernels yet: start the idle clock now.
            last_activity = now

        patch_annotations = {
            nbapi.LAST_ACTIVITY_ANNOTATION: _fmt_time(last_activity),
            nbapi.LAST_ACTIVITY_CHECK_TIMESTAMP_ANNOTATION: _fmt_time(now),
        }

        with span("status"):
            if not busy and now - last_activity > self.opts.cull_idle_seconds:
                if (self.opts.drain_on_cull
                        and nbapi.gpu_spec_of(nb) is not None):
                    # Checkpoint-then-stop (kubeflow_tpu_torch/migration): ask
                    # the in-pod SDK to snapshot first, so the culled
                    # server resumes where it left off. The stop lands in
                    # _drive_cull_drain on the ack — or on the grace
                    # deadline for servers that never ack (no SDK loop
                    # running), which restores plain culling, just
                    # delayed by the grace. KFTPU_CULL_DRAIN=off skips
                    # this branch entirely.
                    patch_annotations.update(
                        migration.request_drain_patch("cull", now))
                    try:
                        await self.kube.patch(
                            "Notebook", name,
                            {"metadata": {"annotations": patch_annotations}},
                            ns)
                    except ApiError:
                        return requeue
                    await self.recorder.event(
                        nb, "Normal", "CullDrainRequested",
                        f"Notebook idle for "
                        f"{(now - last_activity) / 60:.0f} min; "
                        "checkpointing before scale-to-zero (grace "
                        f"{self.opts.drain_grace_seconds:.0f}s)")
                    return Result(requeue_after=min(
                        self.opts.check_period_seconds,
                        self.opts.drain_grace_seconds + 0.1))
                if not await self._cull_stop(nb, name, ns, now,
                                             patch_annotations):
                    return requeue
                return None  # parked; nothing to poll until restarted
            if any(annotations.get(k) != v for k, v in patch_annotations.items()):
                try:
                    await self.kube.patch(
                        "Notebook", name,
                        {"metadata": {"annotations": patch_annotations}}, ns,
                    )
                except ApiError as exc:
                    log.debug("activity-stamp patch for %s/%s failed "
                              "(next probe re-stamps): %s", ns, name, exc)
        return requeue

    async def _cull_stop(self, nb: dict, name: str, ns: str, now: float,
                         extra_annotations: dict | None = None,
                         *, checkpoint_step: int | None = None) -> bool:
        """The one place an idle cull actually parks a notebook — shared
        by the bare-stop path and the drain finalizer so the bookkeeping
        (event, counters, reclaimed-card metric) can't drift."""
        annotations = dict(extra_annotations or {})
        annotations[nbapi.STOP_ANNOTATION] = _fmt_time(now)
        try:
            await self.kube.patch(
                "Notebook", name,
                {"metadata": {"annotations": annotations}}, ns)
        except ApiError:
            return False
        last = _parse_time(
            (get_meta(nb).get("annotations") or {}).get(
                nbapi.LAST_ACTIVITY_ANNOTATION, "")) or now
        idle_min = max(0.0, now - last) / 60
        note = (f"; resumes from checkpoint @ step {checkpoint_step}"
                if checkpoint_step is not None else "")
        await self.recorder.event(
            nb, "Normal", "NotebookCulled",
            f"Notebook idle for {idle_min:.0f} min; scaled to zero{note}")
        self.m_culled.inc()
        self.m_last_cull.labels(namespace=ns or "", notebook=name).set(now)
        chips = deep_get(nb, "status", "gpu", "chips", default=0) or 0
        if chips:
            self.m_chips_culled.inc(chips)
        return True

    async def _drive_cull_drain(self, nb: dict, name: str, ns: str,
                                now: float) -> Result | None:
        """Finalize a cull-owned drain: stop on the checkpoint ack, or on
        the grace deadline for a server that never acks — UNLESS the user
        came back: the grace window is exactly the span the pre-migration
        code never had, so busyness is re-probed every pass and a busy
        kernel cancels the drain instead of parking an actively-used
        server. The drain marks clear with the stop; the checkpoint
        path/step annotations stay — they are the restore hint a later
        restart rides."""
        urls = await self._probe_urls(nb, name, ns)
        if urls is not None:
            kernels = await self.prober(urls["kernels"])
            if kernels is not None:
                busy, _ = _fold_activity(kernels, [])
                if busy:
                    try:
                        await self.kube.patch(
                            "Notebook", name,
                            {"metadata": {"annotations": {
                                **migration.clear_drain_patch(),
                                nbapi.LAST_ACTIVITY_ANNOTATION:
                                    _fmt_time(now),
                            }}}, ns)
                    except ApiError as exc:
                        log.debug("cull-drain cancel patch for %s/%s "
                                  "failed (re-probed next pass): %s",
                                  ns, name, exc)
                    else:
                        await self.recorder.event(
                            nb, "Normal", "CullDrainCancelled",
                            "Activity detected during the checkpoint "
                            "grace window; cull cancelled")
                    return Result(
                        requeue_after=self.opts.check_period_seconds)
        annotations = get_meta(nb).get("annotations") or {}
        acked = migration.drain_acked(annotations)
        expired = migration.drain_expired(
            annotations, now, self.opts.drain_grace_seconds)
        if not (acked or expired):
            deadline = migration.drain_deadline(
                annotations, self.opts.drain_grace_seconds) or now
            return Result(requeue_after=min(
                self.opts.check_period_seconds,
                max(0.1, deadline - now + 0.05)))
        step = migration.checkpoint_step(annotations) if acked else None
        if not acked:
            await self.recorder.event(
                nb, "Warning", "CullDrainDeadlineExceeded",
                f"No checkpoint ack within "
                f"{self.opts.drain_grace_seconds:.0f}s; culling without "
                "a fresh checkpoint")
        if not await self._cull_stop(
                nb, name, ns, now,
                migration.clear_drain_patch(keep_reason=True),
                checkpoint_step=step):
            return Result(requeue_after=self.opts.check_period_seconds)
        return None


def _is_serving_workload(nb: dict) -> bool:
    """The culler's workload-class guard (see reconcile)."""
    from kubeflow_tpu_torch.api import inferenceservice as isvcapi

    return isvcapi.is_serving_class(nb)


def _fold_activity(kernels: list, terminals: list) -> tuple[bool, float | None]:
    """→ (busy, latest_activity_ts). A kernel not idle ⇒ busy
    (culling_controller.go:281-315)."""
    busy = any(
        isinstance(k, dict) and k.get("execution_state") not in (None, "idle")
        for k in kernels
    )
    times = []
    for item in [*kernels, *terminals]:
        if isinstance(item, dict) and item.get("last_activity"):
            ts = _parse_time(str(item["last_activity"]))
            if ts is not None:
                times.append(ts)
    return busy, (max(times) if times else None)


def setup_culling_controller(
    mgr: Manager,
    prober: Prober | None = None,
    options: CullingOptions | None = None,
    *,
    clock: Callable[[], float] = time.time,
) -> CullingReconciler:
    rec = CullingReconciler(
        mgr.kube, prober, options, clock=clock, registry=mgr.registry
    )
    mgr.add_controller(
        Controller(name="culling", kind="Notebook", reconcile=rec.reconcile)
    )
    rec._pod_informer = mgr.informer_for("Pod")
    return rec
