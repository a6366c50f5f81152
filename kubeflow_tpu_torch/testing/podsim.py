"""Kubelet/controller-manager simulator for the fake apiserver.

envtest famously has no kubelet — pods never materialise, so the reference's
tests assert only on generated objects. For e2e-style flows (and the bench's
cold-start measurement) we go one step further: this simulator watches
StatefulSets and Deployments and plays the role of the statefulset/deployment
controllers + kubelet — creating pods through the admission chain (so
PodDefault injection really runs), marking them Running/Ready after a
configurable latency, and mirroring readiness into workload status.

The port's copy of ``kubeflow_tpu/testing/podsim.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import time

from kubeflow_tpu_torch.runtime.aiotasks import reap
from kubeflow_tpu_torch.runtime.errors import AlreadyExists, ApiError, NotFound
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    deepcopy,
    get_meta,
    name_of,
    namespace_of,
    set_controller_owner,
)
from kubeflow_tpu_torch.testing.fakekube import FakeKube


def _fake_pod_ip(name: str) -> str:
    """Deterministic cluster-range IP per pod name (kubelet assigns these;
    controllers that probe pods directly need one to exist)."""
    h = sum(name.encode()) % 254 + 1
    return f"10.244.0.{h}"


class PodSimulator:
    def __init__(
        self,
        kube: FakeKube,
        *,
        start_latency: float = 0.0,
        image_pull_latency: float = 0.0,
        runtime_start_latency: float = 0.0,
        failure_injector=None,
    ):
        """``failure_injector(pod) -> None | "fail" | "crash" | "crash:<ctr>"
        | "disrupt" | "disrupt:<reason>"`` — fault injection the reference
        never had (SURVEY.md §5 "No fault injection framework"): "fail"
        leaves the pod phase=Failed (scheduling/image errors); "crash"
        marks one in-place restart of every container (the signal the
        slice-atomic restart logic keys on); "crash:<name>" restarts only
        the named container (e.g. a sidecar), leaving the rest healthy;
        "disrupt" brings the pod up healthy but stamped with a
        DisruptionTarget=True condition (default reason
        PreemptionByScheduler) — a spot preemption / node drain in
        flight, containers still running.

        Cold-start latency model: real pod starts are
        dominated by two costs a reconcile-speed sim hides —
        ``image_pull_latency`` (paid ONCE per (node, image): kubelet's
        image cache makes later pulls free, which is exactly what warm
        pools and image streaming exploit) and ``runtime_start_latency``
        (paid by EVERY fresh pod: interpreter + imports + device-client
        attach). A warm-pool CLAIM creates no pod, so it pays neither —
        the asymmetry ``bench.py coldstart`` measures."""
        self.kube = kube
        self.start_latency = start_latency
        self.image_pull_latency = image_pull_latency
        self.runtime_start_latency = runtime_start_latency
        self._pulled_images: set[tuple] = set()
        self.failure_injector = failure_injector
        self._tasks: list[asyncio.Task] = []
        # Strong refs: asyncio holds tasks weakly; un-referenced _run_pod
        # tasks can be GC'd mid-flight (pods stuck Pending, flaky tests).
        self._pod_tasks: set[asyncio.Task] = set()
        # (namespace, pod name) with a live _run_pod task — the stuck-pod
        # backstop in _reconcile_workload must not double-drive a pod
        # whose first run is still in flight (a one-shot failure injector
        # consulted twice would lose its verdict).
        self._pods_in_flight: set[tuple] = set()
        # (namespace, owner uid) → pod names: the simulator's own owner
        # index, updated synchronously on its own creates/deletes and from
        # the pod watch for external actors. Replaces the per-event
        # namespace-wide pod scans that made the kubelet sim O(pods-in-ns)
        # per event — O(N²) across the load test's shared namespace.
        self._owner_pods: dict[tuple, set[str]] = {}
        # (namespace, owner uid) → (kind, name) of each indexed owner, so
        # a pod delete can reconcile every workload that listed the pod.
        self._owner_refs: dict[tuple, tuple[str, str]] = {}
        # Short-TTL Node cache for scheduler-like node assignment: pods
        # with a nodeSelector get spec.nodeName stamped from a matching
        # Node (round-robin by ordinal), so node-level signals — spot
        # revocation taints, maintenance — map to real pods in the sim.
        # Clusters with no Node objects behave exactly as before.
        self._nodes_cache: tuple[float, list] = (-1.0, [])
        self._running = False

    async def start(self) -> None:
        self._running = True
        self._tasks = [
            asyncio.create_task(self._watch_workloads("StatefulSet")),
            asyncio.create_task(self._watch_workloads("Deployment")),
            asyncio.create_task(self._watch_pods()),
        ]

    async def stop(self) -> None:
        self._running = False
        for t in [*self._tasks, *self._pod_tasks]:
            t.cancel()
        await reap(*self._tasks, *self._pod_tasks)
        self._pod_tasks.clear()

    async def _watch_workloads(self, kind: str) -> None:
        # Re-establish on every close (injected watch reset, apiserver
        # restart): a kubelet whose watch dies does not stop being the
        # kubelet. send_initial on re-watch doubles as the resync — any
        # workload whose events were lost in the gap reconciles again.
        while self._running:
            async for _event, obj in self.kube.watch(kind):
                if not self._running:
                    return
                try:
                    await self._reconcile_workload(kind, obj)
                except ApiError:
                    pass
            await asyncio.sleep(0.02)

    def _index_pod(self, event: str, pod: dict) -> list[tuple[str, str]]:
        """Fold one pod event into the owner index. A delete takes the
        pod's name out of every owner entry of its namespace that lists
        it (a pod re-owned by another controller, as a warm pool's claim
        is, stays listed under its first owner too) and returns those
        owners' (kind, name); other events return []."""
        ns, pod_name = namespace_of(pod), name_of(pod)
        if event == "DELETED":
            owners = []
            for key, names in list(self._owner_pods.items()):
                if key[0] != ns or pod_name not in names:
                    continue
                names.discard(pod_name)
                if not names:
                    del self._owner_pods[key]
                if key in self._owner_refs:
                    owners.append(self._owner_refs[key])
            return owners
        owner = next(
            (r for r in get_meta(pod).get("ownerReferences", [])
             if r.get("controller")),
            None,
        )
        if owner and owner.get("uid"):
            key = (ns, owner["uid"])
            self._owner_pods.setdefault(key, set()).add(pod_name)
            self._owner_refs[key] = (owner.get("kind"), owner.get("name"))
        return []

    async def _watch_pods(self) -> None:
        """The real STS/Deployment controllers watch pods: an out-of-band pod
        delete must trigger recreation from the owning workload. The same
        stream keeps the owner index current for pods other actors
        create/delete behind the simulator's back."""
        while self._running:
            async for event, pod in self.kube.watch("Pod"):
                if not self._running:
                    return
                for kind, workload in self._index_pod(event, pod):
                    if kind not in ("StatefulSet", "Deployment"):
                        continue
                    try:
                        wl = await self.kube.get_or_none(
                            kind, workload, namespace_of(pod)
                        )
                        if wl is not None:
                            await self._reconcile_workload(kind, wl)
                    except ApiError:
                        pass
            await asyncio.sleep(0.02)

    async def _reconcile_workload(self, kind: str, obj: dict) -> None:
        ns, name = namespace_of(obj), name_of(obj)
        # Re-fetch: the event may be stale (workload deleted since it was
        # queued) — acting on it would resurrect pods for a dead workload.
        obj = await self.kube.get_or_none(kind, name, ns)
        if obj is None or get_meta(obj).get("deletionTimestamp"):
            return
        replicas = deep_get(obj, "spec", "replicas", default=1)
        template = deep_get(obj, "spec", "template", default={})
        nodes = (await self._list_nodes()
                 if deep_get(template, "spec", "nodeSelector") else [])
        want: dict[str, dict] = {}
        for i in range(replicas):
            pod_name = f"{name}-{i}" if kind == "StatefulSet" else f"{name}-rs-{i}"
            want[pod_name] = self._pod_from_template(
                pod_name, ns, template, obj, ordinal=i, nodes=nodes)

        # Owner index, not a namespace scan; the simulator's own writes
        # update it synchronously below, so it cannot lag its own actions
        # (external deletes land via the pod watch; a double create hits
        # AlreadyExists and a double delete hits NotFound — both benign).
        owner_key = (ns, get_meta(obj).get("uid"))
        self._owner_refs[owner_key] = (kind, name)
        existing = set(self._owner_pods.get(owner_key, ()))
        for pod_name, pod in want.items():
            if pod_name in existing:
                # Stuck-pod backstop: a pod whose _run_pod task died under
                # an injected fault storm (status patch never landed — no
                # phase) gets re-driven on the next workload reconcile,
                # exactly as a real kubelet re-syncs pods it owns. Guarded
                # by _pods_in_flight so an in-flight first run — and its
                # one-shot failure-injector verdict — is never doubled.
                if (ns, pod_name) in self._pods_in_flight:
                    continue
                live = await self.kube.get_or_none("Pod", pod_name, ns)
                if live is not None:
                    if not deep_get(live, "status", "phase"):
                        self._spawn_pod_task(live)
                    continue
                # The index outlived the pod: its delete fell into a pod
                # watch gap (a re-watch replays what exists, never what
                # went), so create it again, as a controller resyncing
                # against the apiserver does.
            try:
                created = await self.kube.create("Pod", pod)
            except AlreadyExists:
                continue
            self._owner_pods.setdefault(owner_key, set()).add(pod_name)
            self._spawn_pod_task(created)
        for pod_name in existing:
            if pod_name not in want:
                try:
                    await self.kube.delete("Pod", pod_name, ns)
                except NotFound:
                    pass
                names = self._owner_pods.get(owner_key)
                if names is not None:
                    names.discard(pod_name)
        await self._mirror_status(kind, obj, len(want))

    async def _list_nodes(self) -> list:
        """Node objects for pod placement, cached briefly — one LIST per
        cache window instead of one per workload reconcile."""
        stamp, nodes = self._nodes_cache
        now = time.monotonic()
        if now - stamp < 0.5 and stamp >= 0:
            return nodes
        try:
            nodes = await self.kube.list("Node", copy=False)
        except ApiError:
            nodes = []
        self._nodes_cache = (now, nodes)
        return nodes

    def _pod_from_template(self, pod_name: str, ns: str, template: dict,
                           owner: dict, *, ordinal: int = 0,
                           nodes: list | None = None) -> dict:
        labels = dict(deep_get(template, "metadata", "labels", default={}))
        if owner.get("kind") == "StatefulSet":
            # The real STS controller stamps the stable pod identity label
            # (and, ≥1.28, the ordinal index) — controllers select on these.
            labels["statefulset.kubernetes.io/pod-name"] = pod_name
            labels["apps.kubernetes.io/pod-index"] = pod_name.rsplit("-", 1)[-1]
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod_name,
                "namespace": ns,
                "labels": labels,
                "annotations": dict(deep_get(template, "metadata", "annotations", default={})),
            },
            "spec": deepcopy(template.get("spec", {})),
        }
        selector = pod["spec"].get("nodeSelector") or {}
        if nodes and selector and not pod["spec"].get("nodeName"):
            # Scheduler stand-in: bind to a matching node, round-robin by
            # ordinal, so node taints/deletions reach the right pods.
            matching = [
                name_of(n) for n in nodes
                if all((deep_get(n, "metadata", "labels",
                                 default={}) or {}).get(k) == v
                       for k, v in selector.items())
            ]
            if matching:
                matching.sort()
                pod["spec"]["nodeName"] = matching[ordinal % len(matching)]
        set_controller_owner(pod, owner)
        return pod

    def _spawn_pod_task(self, pod: dict) -> None:
        key = (namespace_of(pod), name_of(pod))
        self._pods_in_flight.add(key)
        task = asyncio.create_task(self._run_pod(pod))
        self._pod_tasks.add(task)

        def _done(t, key=key):
            self._pod_tasks.discard(t)
            self._pods_in_flight.discard(key)

        task.add_done_callback(_done)

    async def _patch_status_retrying(self, kind: str, name: str, ns: str,
                                     status: dict) -> None:
        """Kubelet-style bounded retry: a transient apiserver error (5xx/
        429/409) must not leave a pod Pending forever — the real kubelet
        retries status syncs until they land. NotFound ends the retry (the
        object is gone); persistent failure gives up after ~2s and leaves
        the stuck-pod backstop to re-drive it."""
        delay = 0.02
        for attempt in range(8):
            try:
                await self.kube.patch(kind, name, {"status": status}, ns,
                                      subresource="status")
                return
            except NotFound:
                return
            except ApiError:
                if attempt == 7:
                    return
                await asyncio.sleep(delay)
                delay = min(delay * 2, 0.5)

    async def _run_pod(self, pod: dict) -> None:
        delay = self.start_latency
        if self.image_pull_latency or self.runtime_start_latency:
            image = (deep_get(pod, "spec", "containers", default=[{}])
                     or [{}])[0].get("image", "")
            node = deep_get(pod, "spec", "nodeName") or ""
            if self.image_pull_latency:
                if (node, image) not in self._pulled_images:
                    self._pulled_images.add((node, image))
                    delay += self.image_pull_latency
            delay += self.runtime_start_latency
        if delay:
            await asyncio.sleep(delay)
        ns, name = namespace_of(pod), name_of(pod)
        fault = self.failure_injector(pod) if self.failure_injector else None
        if fault == "fail":
            await self._patch_status_retrying(
                "Pod", name, ns,
                {"phase": "Failed", "reason": "Injected", "conditions": []})
            return
        if fault == "crash" or (isinstance(fault, str) and fault.startswith("crash:")):
            only = fault.split(":", 1)[1] if ":" in fault else None

            def ctr_status(c):
                cname = c.get("name", "main")
                crashed = only is None or cname == only
                st = {
                    "name": cname,
                    "ready": not crashed,
                    "restartCount": 1 if crashed else 0,
                    "state": {"running": {"startedAt": "now"}},
                }
                if crashed:
                    st["lastState"] = {
                        "terminated": {"exitCode": 137, "reason": "OOMKilled"}
                    }
                return st

            # A single crashed sidecar leaves the pod Running and (after
            # kubelet restarts it in place) Ready; a whole-pod crash flips
            # the Ready condition.
            pod_ready = "True" if only is not None else "False"
            await self._patch_status_retrying(
                "Pod", name, ns,
                {
                    "phase": "Running",
                    "conditions": [{"type": "Ready", "status": pod_ready}],
                    "containerStatuses": [
                        ctr_status(c)
                        for c in deep_get(pod, "spec", "containers", default=[])
                    ],
                })
            return
        disrupt_reason = None
        if fault == "disrupt" or (
            isinstance(fault, str) and fault.startswith("disrupt:")
        ):
            disrupt_reason = (
                fault.split(":", 1)[1] if ":" in fault
                else "PreemptionByScheduler"
            )
        conditions = [{"type": "Ready", "status": "True"}]
        if disrupt_reason:
            conditions.append({
                "type": "DisruptionTarget",
                "status": "True",
                "reason": disrupt_reason,
                "message": "injected disruption",
            })
        await self._patch_status_retrying(
            "Pod", name, ns,
            {
                "phase": "Running",
                "podIP": _fake_pod_ip(name),
                "conditions": conditions,
                "containerStatuses": [
                    {
                        "name": c.get("name", "main"),
                        "ready": True,
                        "restartCount": 0,
                        "state": {"running": {"startedAt": "now"}},
                    }
                    for c in deep_get(pod, "spec", "containers", default=[])
                ],
            })
        # The pod's controller ref names its workload directly — no scan.
        owner = next(
            (r for r in get_meta(pod).get("ownerReferences", [])
             if r.get("controller")),
            None,
        )
        if owner and owner.get("kind") in ("StatefulSet", "Deployment"):
            try:
                wl = await self.kube.get_or_none(owner["kind"], owner["name"], ns)
            except ApiError:
                return
            if wl is not None and get_meta(wl).get("uid") == owner.get("uid"):
                await self._mirror_status(
                    owner["kind"], wl,
                    deep_get(wl, "spec", "replicas", default=1))

    async def _mirror_status(self, kind: str, obj: dict, replicas: int) -> None:
        ns = namespace_of(obj)
        ready = 0
        # Names from the owner index, phases from fresh GETs (a pod whose
        # status another actor rewrote must count correctly) — O(replicas)
        # instead of a namespace-wide scan.
        for pod_name in list(
            self._owner_pods.get((ns, get_meta(obj).get("uid")), ())
        ):
            try:
                p = await self.kube.get_or_none("Pod", pod_name, ns)
            except ApiError:
                continue
            if p is not None and deep_get(p, "status", "phase") == "Running":
                ready += 1
        status = {"replicas": replicas, "readyReplicas": ready}
        if kind == "Deployment":
            status["availableReplicas"] = ready
        current = {
            k: deep_get(obj, "status", k) for k in status
        }
        if current == status:
            return  # avoid self-amplifying MODIFIED loops on our own watch
        await self._patch_status_retrying(kind, name_of(obj), ns, status)
