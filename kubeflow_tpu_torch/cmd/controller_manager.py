"""Controller-manager entrypoint: all reconcilers in one process.

Deliberately one process where the reference ran five (notebook, odh
notebook, profile, tensorboard, pvcviewer) — the two-controller lock
protocol and its race class disappear (SURVEY.md §7 hard-part (c)).

The port of ``kubeflow_tpu/cmd/controller_manager.py``: the notebook,
culling, profile, Tensorboard, PVCViewer and InferenceService controllers
on one ``GpuFleetScheduler`` (``KFTPU_SCHEDULER`` / ``KFTPU_FLEET``),
against the apiserver that ``runtime.httpclient.HttpKube`` finds
(in-cluster ServiceAccount, else ``http://127.0.0.1:8001``)::

    METRICS_PORT=8080 KFTPU_FLEET=a3=nvidia-h100-80gb:1x8:1 \
        python -m kubeflow_tpu_torch.cmd.controller_manager
"""

from __future__ import annotations

import asyncio
import logging
import os

from aiohttp import web

from kubeflow_tpu_torch.cmd import envconfig
from kubeflow_tpu_torch.controllers.culling import setup_culling_controller
from kubeflow_tpu_torch.controllers.notebook import setup_notebook_controller
from kubeflow_tpu_torch.controllers.profile import setup_profile_controller
from kubeflow_tpu_torch.controllers.pvcviewer import setup_pvcviewer_controller
from kubeflow_tpu_torch.controllers.tensorboard import setup_tensorboard_controller
from kubeflow_tpu_torch.runtime.httpclient import HttpKube
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.runtime.metrics import global_registry

log = logging.getLogger(__name__)


def build_manager_app(mgr=None) -> web.Application:
    """The manager's introspection app: probes, /metrics, and the /debug
    surface (controller-runtime's pprof/zpages idiom rebuilt):

    - ``/debug/traces[?key=ns/name&limit=N]`` — flight-recorder entries:
      the span tree (queue wait, cache read, apply, status), API verbs,
      events, and outcome of recent reconciles, retained per object.
    - ``/debug/queue`` — per-controller workqueue depth, in-flight keys,
      backoff keys with their next delay, quarantined (dead-lettered)
      keys, oldest queue wait.
    - ``POST /debug/queue/requeue?controller=notebook&namespace=ns&name=x``
      — manual escape hatch for a quarantined key: releases it with a
      fresh retry budget and reconciles it immediately.
    - ``/debug/informers`` — cache sync state, object counts, and
      secondary-index hit/miss per informer.
    - ``/debug/scheduler`` (when the fleet scheduler is wired) — pools
      and free slices, admitted gangs, the ranked queue, per-namespace
      card shares, preemption verdicts, invariant-violation counter.
    - ``/debug/slo`` — the SLO engine's per-SLI status: objective,
      window counts, 5m/1h/6h burn rates, budget remaining, health, and
      the worst offenders with exemplar trace ids.
    - ``/debug/timeline/<ns>/<name>`` — the object's durable lifecycle
      timeline (Queued→Admitted→Ready→Draining→Parked→…), replayed from
      the capped CR annotation so it survives manager restarts.
    - ``/debug/scheduler/explain/<ns>/<name>`` — scheduler
      explainability: why a gang is queued (position, rank, blocking
      shape, feasible-if-drained candidates, scale-up intent age,
      starvation-door state) plus the timeline tail.
    - ``/debug/warmpool`` (when warm pools are configured) — per-pool
      target/ready/slot counts and the slots pending teardown after a
      scheduler reclaim.
    - ``/debug/telemetry`` (when the notebook controller is wired) —
      every notebook's latest decoded training-telemetry entry (family,
      step, MFU, overlap, publish seq) with live staleness, from the
      controller's fold of the capped telemetry annotation.
    """
    app = web.Application()

    async def ok(_request):
        return web.json_response({"status": "ok"})

    async def metrics(_request):
        registry = mgr.registry if mgr is not None else global_registry
        if mgr is not None and getattr(mgr, "slo", None) is not None:
            # Burn-rate/budget gauges are recomputed at scrape time, not
            # per observation — the windows slide whether or not events
            # arrive, so a scrape must never serve stale burn.
            mgr.slo.refresh()
        return web.Response(
            text=registry.expose(), content_type="text/plain"
        )

    app.router.add_get("/healthz", ok)
    app.router.add_get("/readyz", ok)
    app.router.add_get("/metrics", metrics)
    if mgr is not None:
        async def debug_traces(request):
            try:
                limit = int(request.query.get("limit", "50"))
            except ValueError:
                limit = 50
            return web.json_response({
                "traces": mgr.debug_traces(
                    key=request.query.get("key"), limit=limit
                ),
            })

        async def debug_queue(_request):
            return web.json_response({"queues": mgr.debug_queues()})

        async def debug_informers(_request):
            return web.json_response({"informers": mgr.debug_informers()})

        async def debug_queue_requeue(request):
            # Params from the query string or a JSON body ({"controller":
            # ..., "namespace": ..., "name": ...}); cluster-scoped keys
            # pass namespace="" (stored as None).
            params = dict(request.query)
            if not params:
                try:
                    params = await request.json()
                except Exception:
                    params = {}
                if not isinstance(params, dict):
                    params = {}  # valid JSON but not an object → 400 below
            controller = params.get("controller", "")
            name = params.get("name", "")
            namespace = params.get("namespace") or None
            if not controller or not name:
                return web.json_response(
                    {"error": "controller and name are required"},
                    status=400)
            released = mgr.requeue_quarantined(controller, (namespace, name))
            return web.json_response(
                {"released": released,
                 "controller": controller,
                 "key": f"{namespace or '-'}/{name}"},
                status=200 if released else 404)

        async def debug_slo(_request):
            # Per-SLI objective, window counts, multi-window burn rates,
            # budget remaining, health verdict, and the worst offenders
            # with exemplar trace ids (join them against /debug/traces).
            mgr.slo.refresh()
            payload = {"slo": mgr.slo.debug_info()}
            # Lease observability: who holds what, and how often it has
            # changed hands — the "is shard ownership stable" question
            # answered next to the SLO verdict it explains.
            elector = getattr(mgr, "elector", None)
            if elector is not None:
                payload["leader_election"] = {
                    "lease": elector.lease_name,
                    "identity": elector.identity,
                    "is_leader": elector.is_leader,
                    "transitions": elector.transitions,
                }
            ring_info = mgr.debug_sharding() \
                if hasattr(mgr, "debug_sharding") else None
            if ring_info is not None:
                payload["shard_ring"] = ring_info
            return web.json_response(payload)

        async def debug_timeline(request):
            ns = request.match_info["ns"]
            name = request.match_info["name"]
            entries = mgr.debug_timeline((ns or None, name))
            return web.json_response({
                "key": f"{ns}/{name}",
                "timeline": entries,
            }, status=200 if entries else 404)

        app.router.add_get("/debug/traces", debug_traces)
        app.router.add_get("/debug/queue", debug_queue)
        app.router.add_post("/debug/queue/requeue", debug_queue_requeue)
        app.router.add_get("/debug/informers", debug_informers)
        app.router.add_get("/debug/slo", debug_slo)
        app.router.add_get("/debug/timeline/{ns}/{name}", debug_timeline)

        if getattr(mgr, "scheduler", None) is not None:
            async def debug_scheduler(_request):
                # Pools with free slices, admitted gangs with placements,
                # the ranked queue with positions/reasons, per-namespace
                # card shares, and the invariant-violation counter (must
                # read 0).
                return web.json_response(
                    {"scheduler": mgr.scheduler.debug_info()})

            async def debug_scheduler_explain(request):
                # The machine answer to "why is this gang still queued":
                # queue position + rank components, blocking shape,
                # feasible-if-drained victim candidates, pending
                # scale-up intent age, starvation-door state, and the
                # object's lifecycle timeline tail.
                ns = request.match_info["ns"]
                name = request.match_info["name"]
                explanation = mgr.scheduler.explain((ns or None, name))
                explanation["timeline"] = mgr.debug_timeline(
                    (ns or None, name))[-8:]
                return web.json_response(
                    {"explain": explanation},
                    status=404 if explanation.get("state") == "Unknown"
                    else 200)

            app.router.add_get("/debug/scheduler", debug_scheduler)
            app.router.add_get("/debug/scheduler/explain/{ns}/{name}",
                               debug_scheduler_explain)

        if getattr(mgr, "telemetry", None) is not None:
            async def debug_telemetry(_request):
                # Latest decoded telemetry entry per notebook — the
                # fleet-wide "who trains at what MFU" page next to the
                # per-family gauges on /metrics.
                return web.json_response({"telemetry": mgr.telemetry()})

            app.router.add_get("/debug/telemetry", debug_telemetry)

        if getattr(mgr, "warmpool", None) is not None:
            async def debug_warmpool(_request):
                # Per-pool target/ready/slots plus reclaimed slots
                # pending teardown — the pool-exhaustion runbook's
                # first stop (docs/operations.md "Warm pools").
                return web.json_response(
                    {"warmpool": await mgr.warmpool.debug_info()})

            app.router.add_get("/debug/warmpool", debug_warmpool)
    return app


async def serve_health_and_metrics(port: int, mgr=None) -> web.AppRunner:
    """/healthz /readyz /metrics like the reference manager
    (notebook-controller/main.go:65-66,125-133), plus /debug/* when a
    manager is attached."""
    runner = web.AppRunner(build_manager_app(mgr))
    await runner.setup()
    site = web.TCPSite(runner, "0.0.0.0", port)
    await site.start()
    return runner


async def amain() -> None:
    logging.basicConfig(
        level=os.environ.get("LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    kube = HttpKube()
    # Sharded active-active control plane (docs/operations.md): with
    # KFTPU_SHARDS > 1, this replica joins the shard lease ring and only
    # reconciles the keyspace slices it holds. Replica identity comes
    # from the StatefulSet ordinal (KFTPU_SHARD_REPLICA) so the preferred
    # spread is stable across restarts.
    ring = None
    shards, shard_replica, shard_replicas, handback = \
        envconfig.shard_ring_config()
    if shards > 1:
        from kubeflow_tpu_torch.runtime.sharding import ShardRing

        ring = ShardRing(
            kube,
            shards=shards,
            replica=shard_replica,
            replicas=shard_replicas,
            identity=os.environ.get("POD_NAME") or None,
            namespace=envconfig.controller_namespace(),
            handback_ticks=handback,
        )
    mgr = Manager(kube, namespace=os.environ.get("WATCH_NAMESPACE") or None,
                  shard_ring=ring)
    setup_notebook_controller(mgr, envconfig.notebook_options())
    culling = envconfig.culling_options()
    if culling.enable_culling:
        setup_culling_controller(mgr, options=culling)
    setup_profile_controller(mgr, envconfig.profile_options())
    setup_tensorboard_controller(mgr, envconfig.tensorboard_options())
    setup_pvcviewer_controller(mgr, envconfig.pvcviewer_options())
    serving = envconfig.serving_options()
    if serving.enabled:
        # Serving workload class (KFTPU_SERVING, default on): the
        # InferenceService controller shares the notebook controller's
        # fleet scheduler — one card ledger for both workload classes.
        from kubeflow_tpu_torch.serving.controller import setup_serving_controller

        setup_serving_controller(
            mgr, serving, scheduler=getattr(mgr, "scheduler", None))

    health = await serve_health_and_metrics(
        int(os.environ.get("METRICS_PORT", "8080")), mgr
    )
    elector = None
    if envconfig.env_bool("LEADER_ELECT", False):
        from kubeflow_tpu_torch.runtime.leaderelection import LeaderElector

        elector = LeaderElector(
            kube,
            namespace=envconfig.controller_namespace(),
            identity=os.environ.get("POD_NAME") or None,
        )
        log.info("waiting for leader election as %s", elector.identity)
        await elector.acquire()
    mgr.elector = elector  # /debug/slo lease observability
    if ring is not None:
        # The scheduler (if any) arbitrates only while this replica holds
        # the arbiter shard — one global card ledger, N reconciling shards.
        if getattr(mgr, "scheduler", None) is not None:
            mgr.scheduler.attach_ring(ring)
        await ring.start()
        log.info("shard ring joined as %s: %d shard(s), owns %s",
                 ring.identity, ring.shards, sorted(ring.owned))
    await mgr.start()
    log.info("controller manager started (%d controllers)", len(mgr.controllers))
    try:
        if elector is not None:
            # Reconciling without the lease risks split-brain: exit when
            # leadership is lost and let the pod restart as a standby.
            while elector.is_leader:
                await asyncio.sleep(1.0)
            raise SystemExit("lost leader election lease")
        await asyncio.Event().wait()  # run forever
    finally:
        await mgr.stop()
        if ring is not None:
            # Graceful departure: release every shard lease so survivors
            # absorb the keyspace without waiting out lease expiry.
            await ring.stop()
        if elector is not None:
            await elector.release()
        await health.cleanup()
        await kube.close()


def main() -> None:
    asyncio.run(amain())


if __name__ == "__main__":
    main()
