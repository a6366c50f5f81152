"""Chaos soak harness: crash/restart + API-fault churn with invariant gates.

The port of ``kubeflow_tpu/testing/chaos.py`` onto the GPU stack: the
fleet scheduler in cards (``spec.gpu`` / ``status.gpu``), the port's warm
pod pools and its checkpoint fabric, whose drain-ack saves snapshot torch
tensors (on the card where :class:`ChaosSoak` is given ``device``).

The control plane's correctness claims — card ledger invariants, the
multi-step drain/restore protocol, DAG-parallel applies — are otherwise
only exercised on a well-behaved FakeKube. This
module drives the REAL manager/controller/scheduler/migration stack
through seeded fault storms (:class:`~kubeflow_tpu_torch.testing.fakekube.
FaultPlan`: 5xx/429/409 injection, watch resets, stale LISTs) while
killing and restarting the Manager mid-reconcile, then asserts the
global invariants every convergence must restore:

- zero ``ChipLedger.violations`` and a self-consistent ledger;
- no gang both Admitted and Queued;
- no orphaned or duplicate slice StatefulSets (and none for Queued gangs);
- every drain terminal — Parked, restored, or hard-stopped — none wedged;
- every workqueue fully drained, no key stuck at max backoff forever
  (transient quarantines must release through the escape hatch);
- **committed-step restore**: drain acks run REAL
  ``CheckpointFabric`` saves against on-disk tiers while storage faults
  (crash-mid-upload, torn manifests, read corruption, stale staging
  pointers) blow through the storm — at every convergence each
  notebook's restore must yield a bit-exact member of its durably
  committed step set, never a partial.

tests/test_chaos.py's seeds replay on this module through
tests/test_torch_chaos_soak_a.py and _b.py.

``shard_kill_scenario`` extends the soak to the sharded
active-active control plane: N replicas over one apiserver, one crash-
killed mid-flight, survivors absorbing its keyspace with zero dropped
queued keys and every global invariant intact.
"""

from __future__ import annotations

import asyncio
import os
import random
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import torch

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.checkpoint import (
    CheckpointFabric,
    CheckpointIntegrityError,
)
from kubeflow_tpu_torch.controllers.notebook import (
    NotebookOptions,
    setup_notebook_controller,
)
from kubeflow_tpu_torch.controllers.warmpool import (
    WarmPoolManager,
    WarmPoolOptions,
)
from kubeflow_tpu_torch.migration import protocol as migration
from kubeflow_tpu_torch.runtime import timeline as timeline_mod
from kubeflow_tpu_torch.runtime.aiotasks import reap
from kubeflow_tpu_torch.runtime.errors import ApiError
from kubeflow_tpu_torch.runtime.manager import Manager
from kubeflow_tpu_torch.runtime.metrics import Registry
from kubeflow_tpu_torch.runtime.objects import (
    annotations_of,
    deep_get,
    fmt_iso,
    get_meta,
    name_of,
    namespace_of,
)
from kubeflow_tpu_torch.scheduler import (
    Fleet,
    SchedulerOptions,
    GpuFleetScheduler,
)
from kubeflow_tpu_torch.testing.fakekube import FakeKube, FaultPlan
from kubeflow_tpu_torch.testing.podsim import PodSimulator
from kubeflow_tpu_torch.webhooks import register_all


@dataclass
class SoakConfig:
    """One seeded soak run. Defaults are the tier-1/smoke shape; the full
    bench widens notebooks/rounds, not the semantics."""

    seed: int = 0
    namespaces: int = 2
    notebooks_per_namespace: int = 2
    # Manager kill/restart cycles; each round is storm → kill → restart
    # under faults → repair → converge → invariant check.
    rounds: int = 3
    storm_seconds: float = 0.8
    # Served through a fleet ConfigMap (a DYNAMIC source) so the elastic
    # scale-up grant action can actually grow it mid-soak; pool-spot is
    # reclaim-aware spot capacity; pool-small hosts the warm-eligible
    # single-node 1x4 gangs.
    fleet: str = ("pool-a=nvidia-h100-80gb:2x8:2,"
                  "pool-spot=nvidia-h100-80gb:2x8:2:spot,"
                  "pool-small=nvidia-h100-80gb:1x4:4")
    # Warm pod pools under the storm: a small pool in team-0
    # plus warm-eligible 1x4 notebooks drives claims through the fault
    # storm; check_invariants asserts no pod is claimed by two Notebooks
    # and the pool converges back to spec after kills/reclaims.
    warm_pools: str = "team-0/warm-img:latest@nvidia-h100-80gb:1x4:2"
    warm_image: str = "warm-img:latest"
    fault_rate: float = 0.12
    watch_reset_rate: float = 0.04
    stale_list_rate: float = 0.15
    # Per-probe chance a "spot" churn action revokes a spot node
    # (FaultPlan.reclaim_spot — same seeded RNG stream as the API
    # faults, so a seed replays the same revocation schedule).
    spot_reclaim_rate: float = 0.5
    # One never-fits gang per soak drives the scale-up intent path;
    # churn actions then grant (grow the ConfigMap) or deny (stamp
    # Failed on the intent's ProvisioningRequest).
    big_gang_slices: int = 6
    quarantine_after: int = 25
    drain_grace_seconds: float = 2.0
    converge_timeout: float = 30.0
    # Checkpoint-fabric storage faults: each drain ack runs a
    # REAL CheckpointFabric save (snapshot-then-ack, background upload)
    # against per-notebook on-disk tiers that survive manager kills;
    # these rates arm crash-mid-upload, torn-manifest, read-corruption,
    # and stale-staging-pointer windows during the storm. The committed-
    # step invariant then checks every restore at convergence. Rates are
    # probed PER CHUNK (the fabric's saves here are ~7 chunks), so the
    # per-save crash probability is roughly 1-(1-rate)^7.
    crash_upload_rate: float = 0.08
    torn_manifest_rate: float = 0.2
    corrupt_read_rate: float = 0.15
    stale_staging_rate: float = 0.3

    @property
    def controller_namespace(self) -> str:
        return "kubeflow-tpu"


@dataclass
class SoakReport:
    seed: int = 0
    rounds: int = 0
    manager_restarts: int = 0
    actions: int = 0
    injected: dict = field(default_factory=dict)
    ledger_violations: int = 0
    quarantined_transient: int = 0
    spot_revocations: int = 0
    scale_up_grants: int = 0
    scale_up_denials: int = 0
    # Checkpoint fabric under the storm: durable commits the simulated
    # SDK landed, uploads the crash fault killed, and restores the
    # committed-step invariant verified at convergence.
    checkpoint_commits: int = 0
    checkpoint_crashes: int = 0
    restores_checked: int = 0
    # Where the step trees lived (ChaosSoak's ``device``), the saves
    # whose every leaf was there, and the restored leaves compared there.
    device: str = "cpu"
    saves_on_device: int = 0
    compared_on_device: int = 0
    problems: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.problems and self.ledger_violations == 0

    def to_dict(self) -> dict:
        return {
            "seed": self.seed,
            "rounds": self.rounds,
            "manager_restarts": self.manager_restarts,
            "actions": self.actions,
            "injected": dict(sorted(self.injected.items())),
            "ledger_violations": self.ledger_violations,
            "quarantined_transient": self.quarantined_transient,
            "spot_revocations": self.spot_revocations,
            "scale_up_grants": self.scale_up_grants,
            "scale_up_denials": self.scale_up_denials,
            "checkpoint_commits": self.checkpoint_commits,
            "checkpoint_crashes": self.checkpoint_crashes,
            "restores_checked": self.restores_checked,
            "device": self.device,
            "saves_on_device": self.saves_on_device,
            "compared_on_device": self.compared_on_device,
            "problems": list(self.problems),
            "ok": self.ok,
        }


# ---- invariant checks ----------------------------------------------------------


async def check_invariants(kube: FakeKube, mgr: Manager,
                           sched: GpuFleetScheduler,
                           warmpool=None) -> list[str]:
    """The global truths every convergence must restore; returns human-
    readable violations (empty = healthy). Reads the store and in-memory
    scheduler state directly — no fault plan should be active."""
    problems: list[str] = []
    ledger = sched.policy.ledger
    if ledger.violations:
        problems.append(f"ledger violations counter = {ledger.violations}")
    try:
        ledger.assert_consistent()
    except Exception as e:  # LedgerError
        problems.append(f"ledger inconsistent: {e}")

    admitted = set(ledger.allocations)
    queued = set(sched.policy.pending)
    both = admitted & queued
    if both:
        problems.append(f"gangs both Admitted and Queued: {sorted(both)}")

    # Drain terminality: nothing mid-drain at convergence — every drain
    # must have ended Parked (ack), restored, or hard-stopped (deadline).
    if sched._draining:
        problems.append(
            f"non-terminal drains: {sorted(sched._draining)}")

    notebooks = await kube.list("Notebook")
    by_uid: dict[str, dict] = {}
    expected_sts: dict[tuple, set] = {}
    for nb in notebooks:
        key = (namespace_of(nb), name_of(nb))
        by_uid[get_meta(nb).get("uid")] = nb
        try:
            ms = nbapi.multi_slice_of(nb)
        except Exception:
            ms = None
        expected_sts[key] = (
            {ms.slice_sts_name(key[1], j) for j in range(ms.num_slices)}
            if ms else {key[1]}
        )
        ann = annotations_of(nb)
        if (migration.drain_requested_at(ann) is not None
                and not nbapi.is_stopped(nb)):
            problems.append(
                f"{key[0]}/{key[1]}: drain-requested but neither parked "
                "nor finalized (wedged drain)")
        # Unbroken lifecycle timeline: the durable journal is
        # written as one whole capped list per transition, so across
        # every manager kill/rebuild the retained window must replay
        # with consecutive seqs, no duplicate transitions, and monotone
        # timestamps — and every surviving object must HAVE one (a
        # rebuilt manager re-derives and persists the current state on
        # its first clean reconcile).
        tl = timeline_mod.decode(ann)
        for p in timeline_mod.continuity_problems(tl):
            problems.append(f"{key[0]}/{key[1]}: timeline {p}")
        if not tl and not get_meta(nb).get("deletionTimestamp"):
            problems.append(
                f"{key[0]}/{key[1]}: empty lifecycle timeline after "
                "convergence")
        # No gang lost across a reclaim: every live GPU
        # notebook must still be IN the scheduler — admitted, queued, or
        # draining. A reclaim/defrag that parked a gang and then dropped
        # it (auto-requeue lost) would leave it stopped-less yet absent
        # from both books.
        try:
            has_gpu = nbapi.multi_slice_of(nb) is not None
        except Exception:
            has_gpu = False
        if (has_gpu and sched.active and not nbapi.is_stopped(nb)
                and not get_meta(nb).get("deletionTimestamp")
                and key not in sched.policy.ledger.allocations
                and key not in sched.policy.pending
                and key not in sched._draining):
            problems.append(
                f"{key[0]}/{key[1]}: live gang lost by the scheduler "
                "(neither admitted nor queued nor draining)")

    sts_seen: dict[tuple, list] = {}
    for sts in await kube.list("StatefulSet"):
        ref = next((r for r in get_meta(sts).get("ownerReferences", [])
                    if r.get("controller") and r.get("kind") == "Notebook"),
                   None)
        if ref is None:
            continue
        owner = by_uid.get(ref.get("uid"))
        if owner is None:
            problems.append(
                f"orphan StatefulSet {namespace_of(sts)}/{name_of(sts)}: "
                "owner Notebook gone")
            continue
        okey = (namespace_of(owner), name_of(owner))
        if name_of(sts) not in expected_sts.get(okey, set()):
            problems.append(
                f"duplicate/stale slice StatefulSet "
                f"{namespace_of(sts)}/{name_of(sts)} for {okey}")
        sts_seen.setdefault(okey, []).append(sts)

    for key in queued:
        # A Queued gang may keep zero-replica StatefulSet shells from an
        # earlier parked run (stop scales to 0, it does not delete) — the
        # violation is a Queued gang with SCALED-UP slices: pods on cards
        # the ledger gave to someone else.
        hot = [
            name_of(s) for s in sts_seen.get(key, ())
            if (deep_get(s, "spec", "replicas", default=1) or 0) > 0
            or (deep_get(s, "status", "readyReplicas", default=0) or 0) > 0
        ]
        if hot:
            problems.append(
                f"Queued gang {key} owns scaled-up StatefulSets {hot}")

    # Warm-pool invariants. (a) No pod claimed by two
    # Notebooks: the CAS claim protocol must hold through every fault
    # storm and manager kill — two CRs whose warm-claimed annotations
    # name the same pod would mean the protocol double-adopted.
    claimed_by: dict[tuple, list] = {}
    for nb in notebooks:
        pod_name = annotations_of(nb).get(nbapi.WARM_CLAIMED_ANNOTATION)
        if pod_name:
            claimed_by.setdefault(
                (namespace_of(nb), pod_name), []).append(name_of(nb))
    for (ns, pod_name), owners in sorted(claimed_by.items()):
        if len(owners) > 1:
            problems.append(
                f"pod {ns}/{pod_name} claimed by two Notebooks: "
                f"{sorted(owners)}")
            continue
        pod = await kube.get_or_none("Pod", pod_name, ns)
        if pod is None:
            problems.append(
                f"{ns}/{owners[0]}: warm-claimed pod {pod_name} is gone "
                "but the claim annotation survived convergence")
        elif not (annotations_of(pod).get(keys.TPU_WARM_CLAIM) or ""
                  ).startswith(f"{ns}/{owners[0]}/"):
            problems.append(
                f"{ns}/{owners[0]}: claimed pod {pod_name} carries a "
                "foreign (or no) claim annotation: "
                f"{annotations_of(pod).get(keys.TPU_WARM_CLAIM)!r}")
    # (b) Pool size converges back to spec after kills/claims/reclaims —
    # below-target is only legitimate while the shape has NO free
    # capacity (the scheduler legitimately cannibalized the reserve).
    if warmpool is not None and warmpool.active and sched.active:
        for pool in warmpool.pools:
            ready = len(await warmpool._claimable_pods(pool))
            if ready >= pool.size:
                continue
            free = sum(
                max(sched.policy.ledger.free_slices(p), 0)
                for p in sched.policy.fleet.matching(
                    pool.accelerator, pool.topology))
            if free > 0:
                problems.append(
                    f"warm pool {pool.slug} not converged: {ready} ready "
                    f"< target {pool.size} with {free} free "
                    f"{pool.accelerator}:{pool.topology} slice(s)")
    for name, queue in mgr._queues.items():
        info = queue.debug_info()
        if info["ready"] or info["in_flight"] or info["dirty"]:
            problems.append(
                f"workqueue {name} not drained: ready={info['ready']} "
                f"in_flight={info['in_flight']} dirty={info['dirty']}")
    return problems


# ---- the soak ------------------------------------------------------------------


class ChaosSoak:
    """One seeded soak. ``device`` is where the drain acks' step trees
    live (a torch device; the host by default): each ``save_async`` then
    snapshots tensors from there, and every checked restore is compared
    bit for bit on it."""

    def __init__(self, config: SoakConfig, *, device=None):
        self.cfg = config
        # The device as its tensors report it ("cuda" reads "cuda:0").
        self.device = torch.empty(0, device=device or "cpu").device
        self.rng = random.Random(config.seed)
        self.kube = FakeKube()
        register_all(self.kube)
        self.plan = FaultPlan(seed=config.seed)
        self.report = SoakReport(seed=config.seed, device=str(self.device))
        self.mgr: Manager | None = None
        self.sched: GpuFleetScheduler | None = None
        self.warmpool: WarmPoolManager | None = None
        self._nb_names: list[tuple] = []
        self._created = 0
        # Live fleet spec (the ConfigMap's data["fleet"]); scale-up
        # grants rewrite it.
        self._fleet_spec = config.fleet
        self._spot_nodes: list[str] = []
        # Checkpoint fabric per notebook — POD-side state rooted on disk,
        # so it survives manager kills like a real pod's tiers would.
        self._fabric_root = tempfile.mkdtemp(prefix="kftpu-chaos-ckpt-")
        self._fabrics: dict[tuple, CheckpointFabric] = {}
        self._fabric_steps: dict[tuple, int] = {}
        # In-flight async saves: key → [(handle, step, raw drain echo)];
        # the SDK loop polls these and stamps the commit mark. A list —
        # rapid drain cycles can overlap uploads (the fabric serializes
        # them, the harness must not lose one).
        self._pending_commits: dict[tuple, list] = {}
        # Last (step, raw) saved per key: an ack retry for the SAME
        # drain re-patches without re-snapshotting (guard semantics).
        self._last_save: dict[tuple, tuple] = {}
        # What the harness KNOWS committed (the invariant's ground truth).
        self._committed_steps: dict[tuple, set[int]] = {}

    # -- stack lifecycle -----------------------------------------------------

    def _build_stack(self) -> None:
        """Fresh Manager + scheduler over the SAME kube/store — what a
        controller pod restart looks like to the cluster. In-memory state
        (ledger, drains, queues, caches) starts empty and must be
        re-derived from the API (reclaim, annotation self-heal)."""
        mgr = Manager(self.kube, registry=Registry(),
                      quarantine_after=self.cfg.quarantine_after)
        sched = GpuFleetScheduler(
            self.kube,
            SchedulerOptions(
                # The safety-net requeue cadence for Queued gangs; kept
                # well above the settle sampling window — admissions
                # re-enqueue winners immediately, so this only paces the
                # steady "still waiting" refresh.
                queued_requeue_seconds=0.5,
                idle_preempt_after_seconds=0.2,
                enable_migration=True,
                drain_grace_seconds=self.cfg.drain_grace_seconds,
                # Elastic fleet under chaos: the spec comes from the
                # fleet ConfigMap (a DYNAMIC source — grants grow it,
                # and a restarted manager re-discovers it through the
                # fault storm), refreshed at soak speed.
                fleet_configmap="kftpu-fleet",
                controller_namespace=self.cfg.controller_namespace,
                fleet_refresh_seconds=0.05,
                enable_elastic=True,
                scale_up_ttl_seconds=5.0,
                defrag_interval_seconds=0.2,
                defrag_idle_seconds=0.3,
            ),
            registry=mgr.registry,
        )
        # Warm pod pools ride the storm too: claims, pool
        # kills, and scheduler cannibalization all replay per seed; a
        # REBUILT manager's fresh pool manager must adopt the running
        # slots (and their CAS state) from the API alone.
        warmpool = (WarmPoolManager(
            self.kube,
            WarmPoolOptions(
                spec=self.cfg.warm_pools,
                controller_namespace=self.cfg.controller_namespace,
                replenish_seconds=0.05),
            registry=mgr.registry)
            if self.cfg.warm_pools else None)
        setup_notebook_controller(mgr, NotebookOptions(), scheduler=sched,
                                  warmpool=warmpool)
        # Soak-speed clocks: tiny workqueue backoff and informer resync so
        # a seeded run converges in seconds, not production minutes.
        for q in mgr._queues.values():
            q.base_delay = 0.002
            q.max_delay = 0.05
        for inf in mgr.informers.values():
            inf.resync_backoff = 0.02
            inf.resync_backoff_max = 0.2
        self.mgr, self.sched, self.warmpool = mgr, sched, warmpool

    async def _start(self) -> None:
        self._build_stack()
        await self.mgr.start()

    async def _kill_manager(self) -> None:
        """Mid-reconcile kill: stop() cancels every worker wherever it is
        awaiting — half-applied child sets, un-stamped admissions and all.
        The dying scheduler's ledger-violation count is harvested FIRST:
        the rebuilt stack starts a fresh counter, and a violation from the
        first half of a round must not vanish with the old instance."""
        self.report.ledger_violations += self.sched.policy.ledger.violations
        await self.mgr.stop()
        self.report.manager_restarts += 1

    # -- storm + churn -------------------------------------------------------

    def _arm_faults(self) -> None:
        cfg = self.cfg
        self.plan.reclaim_spot(rate=cfg.spot_reclaim_rate)
        self.plan.fail("unavailable", rate=cfg.fault_rate)
        self.plan.fail("internal", rate=cfg.fault_rate / 2)
        self.plan.fail("timeout", rate=cfg.fault_rate / 3)
        self.plan.fail("throttle", rate=cfg.fault_rate / 3)
        self.plan.fail("conflict", verbs=("update", "update_status", "patch"),
                       rate=cfg.fault_rate / 2)
        self.plan.reset_watch(rate=cfg.watch_reset_rate)
        self.plan.stale_list(rate=cfg.stale_list_rate)
        # Storage faults ride the same storm (lifted by plan.clear()):
        # the fabrics hold the plan itself, so these windows open and
        # close with the API faults. What a fault LEAVES on disk (a torn
        # manifest, partial chunks, a stale staging pointer) persists
        # into the fault-free restore check — that durable damage is the
        # thing the committed-step invariant interrogates.
        self.plan.crash_upload(rate=cfg.crash_upload_rate)
        self.plan.tear_manifest("remote", rate=cfg.torn_manifest_rate)
        self.plan.corrupt_read(rate=cfg.corrupt_read_rate)
        self.plan.stale_staging(rate=cfg.stale_staging_rate)
        self.kube.use_faults(self.plan)

    def _lift_faults(self) -> None:
        self.plan.clear()
        self.report.injected = dict(self.plan.injected)

    async def _create_notebook(self, ns: str) -> None:
        name = f"soak-{self._created}"
        self._created += 1
        if self.rng.random() < 0.4:
            # Warm-eligible shape/image (single-node 1x4 on the warm
            # pool's image): in team-0 these drive claims through the
            # storm; elsewhere they prove claims stay namespace-local.
            nb = nbapi.new(name, ns, image=self.cfg.warm_image,
                           accelerator="nvidia-h100-80gb", topology="1x4")
        else:
            nb = nbapi.new(name, ns, accelerator="nvidia-h100-80gb",
                           topology="2x8")
        prio = self.rng.choice(["low", "normal", "normal", "high"])
        nb["metadata"].setdefault("annotations", {})[
            nbapi.PRIORITY_ANNOTATION] = prio
        try:
            await self.kube.create("Notebook", nb)
            self._nb_names.append((ns, name))
        except ApiError:
            self._created -= 1  # injected failure: retry the same name later

    async def _seed_cluster(self) -> None:
        """Pre-storm cluster state: the fleet ConfigMap (the scheduler's
        dynamic source), one Node per spot-pool slice (the revocation
        signal's carrier), and — elastic — one never-fits gang whose
        shortfall keeps a scale-up intent alive for the grant/deny
        churn actions to answer."""
        await self.kube.create("ConfigMap", {
            "apiVersion": "v1", "kind": "ConfigMap",
            "metadata": {"name": "kftpu-fleet",
                         "namespace": self.cfg.controller_namespace},
            "data": {"fleet": self._fleet_spec},
        })
        for pool in Fleet.parse(self._fleet_spec).pools:
            if not pool.spot:
                continue
            for i in range(pool.num_slices):
                node_name = f"{pool.name}-node-{i}"
                self._spot_nodes.append(node_name)
                await self.kube.create("Node", {
                    "apiVersion": "v1", "kind": "Node",
                    "metadata": {"name": node_name, "labels": {
                        "cloud.google.com/gke-nodepool": pool.name,
                        "cloud.google.com/gke-spot": "true",
                    }},
                })
        big = nbapi.new("soak-big", "team-0",
                        accelerator="nvidia-h100-80gb", topology="2x8",
                        num_slices=self.cfg.big_gang_slices)
        try:
            await self.kube.create("Notebook", big)
            self._nb_names.append(("team-0", "soak-big"))
        except ApiError:
            pass

    async def _seed_notebooks(self) -> None:
        for n in range(self.cfg.namespaces):
            for _ in range(self.cfg.notebooks_per_namespace):
                await self._create_notebook(f"team-{n}")

    async def _churn_once(self) -> None:
        """One rng-driven user/operator action. Every kube call may take
        an injected fault — the churn shrugs like kubectl's user would."""
        if not self._nb_names:
            return
        key = self.rng.choice(self._nb_names)
        ns, name = key
        action = self.rng.choice(
            ["stop", "start", "suspend", "resume", "idle", "active",
             "edit", "ack", "spot", "scale_up"])
        self.report.actions += 1
        patch = None
        if action == "stop":
            patch = {nbapi.STOP_ANNOTATION: fmt_iso(time.time())}
        elif action == "start":
            patch = {nbapi.STOP_ANNOTATION: None}
        elif action == "suspend":
            patch = {nbapi.SUSPEND_ANNOTATION: "true"}
        elif action == "resume":
            patch = {nbapi.SUSPEND_ANNOTATION: None}
        elif action == "idle":
            patch = {nbapi.LAST_ACTIVITY_ANNOTATION: fmt_iso(
                time.time() - 3600)}
        elif action == "active":
            patch = {nbapi.LAST_ACTIVITY_ANNOTATION: fmt_iso(time.time())}
        elif action == "edit":
            patch = {"chaos-edit": str(self.rng.randrange(1 << 30))}
        elif action == "ack":
            await self._ack_drains(only=key)
            return
        elif action == "spot":
            await self._spot_action()
            return
        elif action == "scale_up":
            await self._scale_up_action()
            return
        try:
            await self.kube.patch(
                "Notebook", name, {"metadata": {"annotations": patch}}, ns)
        except ApiError:
            pass

    async def _kick_elastic(self) -> None:
        """Deterministic elastic exercise, once per soak: revoke one
        spot node and deny the standing scale-up intent (the never-fits
        gang keeps its demand alive, so later churn can still grant).
        The wall-clock-paced churn alone could miss both paths on a
        slow host, and the tier-1 seeds assert they ran."""
        if self._spot_nodes:
            self.report.spot_revocations += 1
            try:
                await self.kube.patch(
                    "Node", self._spot_nodes[0],
                    {"spec": {"taints": [{
                        "key": "cloud.google.com/gke-spot-termination",
                        "effect": "NoSchedule"}]}})
            except ApiError:
                pass
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            intents = (self.sched._intent_book.intents
                       if self.sched is not None
                       and self.sched._intent_book is not None else {})
            if intents:
                intent = sorted(intents.values(),
                                key=lambda i: i.name)[0]
                try:
                    await self.kube.patch(
                        "ProvisioningRequest", intent.name,
                        {"status": {"conditions": [{
                            "type": "Failed", "status": "True",
                            "reason": "ChaosDenied",
                            "message": "injected scale-up denial",
                        }]}},
                        self.cfg.controller_namespace,
                        subresource="status")
                    self.report.scale_up_denials += 1
                    return
                except ApiError:
                    pass  # CR mirror not created yet — retry
            await asyncio.sleep(0.05)

    async def _spot_action(self) -> None:
        """Revoke — or give back — spot capacity. The revocation
        schedule comes from the FaultPlan (seeded, deterministic); the
        signal itself travels as the real GKE taint on the pool's Node,
        through the normal API."""
        if not self._spot_nodes:
            return
        node = self.rng.choice(self._spot_nodes)
        pool = node.rsplit("-node-", 1)[0]
        try:
            if self.plan.should_reclaim_spot(pool):
                self.report.spot_revocations += 1
                await self.kube.patch("Node", node, {"spec": {"taints": [{
                    "key": "cloud.google.com/gke-spot-termination",
                    "effect": "NoSchedule",
                }]}})
            else:
                await self.kube.patch("Node", node,
                                      {"spec": {"taints": None}})
        except ApiError:
            pass

    async def _scale_up_action(self) -> None:
        """Answer a pending scale-up intent: grant (grow the fleet
        ConfigMap — the dynamic source the scheduler re-reads) or deny
        (stamp Failed on the intent's ProvisioningRequest)."""
        intents = (self.sched._intent_book.intents
                   if self.sched is not None
                   and self.sched._intent_book is not None else {})
        if not intents:
            return
        intent = self.rng.choice(sorted(intents.values(),
                                        key=lambda i: i.name))
        if self.rng.random() < 0.5:
            # Grant: +2 slices on pool-a (bounded so a grant-happy seed
            # cannot grow the fleet without limit).
            try:
                parts = self._fleet_spec.split(",")
                name, shape = parts[0].split("=")
                acc, topo, n, *rest = shape.split(":")
                if int(n) >= 8:
                    return
                parts[0] = f"{name}={acc}:{topo}:{int(n) + 2}" + (
                    ":" + ":".join(rest) if rest else "")
                self._fleet_spec = ",".join(parts)
                await self.kube.patch(
                    "ConfigMap", "kftpu-fleet",
                    {"data": {"fleet": self._fleet_spec}},
                    self.cfg.controller_namespace)
                self.report.scale_up_grants += 1
            except (ApiError, ValueError):
                pass
        else:
            try:
                await self.kube.patch(
                    "ProvisioningRequest", intent.name,
                    {"status": {"conditions": [{
                        "type": "Failed", "status": "True",
                        "reason": "ChaosDenied",
                        "message": "injected scale-up denial",
                    }]}},
                    self.cfg.controller_namespace, subresource="status")
                self.report.scale_up_denials += 1
            except ApiError:
                pass

    def _fabric_for(self, key: tuple) -> CheckpointFabric:
        """The notebook's pod-side fabric: on-disk remote + staging tiers
        under the soak's temp root, tiny chunks so every save is
        multi-chunk (the crash-mid-upload window needs chunks to crash
        between), and the soak's FaultPlan as the storage-fault hook."""
        fab = self._fabrics.get(key)
        if fab is None:
            ns, name = key
            base = os.path.join(self._fabric_root, ns, name)
            fab = CheckpointFabric(
                os.path.join(base, "remote"),
                staging_dir=os.path.join(base, "staging"),
                chunk_bytes=64, keep=4, full_interval=3,
                upload_retries=2, backoff_seconds=0.005,
                registry=Registry(), faults=self.plan)
            self._fabrics[key] = fab
        return fab

    def _step_tree(self, key: tuple, step: int) -> dict:
        """Deterministic per-(notebook, step) training state — restored
        content is verified against a regeneration of exactly this, so a
        partial or cross-step mix of chunks cannot pass."""
        offset = (hash(key) & 0xFFFF) / 7.0
        w = torch.arange(48.0, dtype=torch.float64, device=self.device)
        return {"w": w * (step + 1) + offset,
                "step": torch.tensor(step, dtype=torch.int64,
                                     device=self.device)}

    def _save(self, fab, key: tuple, step: int):
        """``fab.save_async`` of the step tree, counted in the report
        when every leaf is on the soak's device."""
        tree = self._step_tree(key, step)
        self.report.saves_on_device += all(
            leaf.device == self.device for leaf in tree.values())
        return fab.save_async(step, tree)

    def _same(self, restored, want) -> bool:
        """Bit-for-bit equality of a restored leaf (a host tensor) with
        the regenerated one, on the regenerated leaf's device (counted in
        the report when that is the soak's device)."""
        if restored is None:
            return False
        self.report.compared_on_device += want.device == self.device
        return torch.equal(torch.as_tensor(restored).to(want.device), want)

    async def _ack_drains(self, only: tuple | None = None) -> None:
        """The simulated in-pod SDK: answer any un-acked drain request
        the way CheckpointGuard-over-the-fabric does — a REAL
        ``save_async`` (host snapshot) then an immediate ack echoing the
        raw request value; the background upload's commit is stamped by
        :meth:`_poll_commits` when (and only when) it durably lands."""
        for ns, name in list(self._nb_names):
            if only is not None and (ns, name) != only:
                continue
            key = (ns, name)
            try:
                nb = await self.kube.get_or_none("Notebook", name, ns)
            except ApiError:
                continue
            if nb is None:
                continue
            ann = annotations_of(nb)
            raw = ann.get(nbapi.DRAIN_REQUESTED_ANNOTATION)
            if not raw or migration.drain_acked(ann):
                continue
            fab = self._fabric_for(key)
            last = self._last_save.get(key)
            if last is not None and last[1] == raw:
                # Ack-patch retry for the same drain: the snapshot is
                # done, only the annotation failed — do NOT re-save.
                step = last[0]
            else:
                # A previous drain's upload may still be in flight — the
                # fabric's queue serializes saves, so snapshot-and-ack
                # again without waiting (exactly what the guard does).
                step = self._fabric_steps.get(key, 0) + 1
                self._fabric_steps[key] = step
                handle = self._save(fab, key, step)
                self._pending_commits.setdefault(key, []).append(
                    (handle, step, raw))
                self._last_save[key] = (step, raw)
            try:
                await self.kube.patch(
                    "Notebook", name,
                    {"metadata": {"annotations": migration.ack_patch(
                        fab.directory, step,
                        time.time(), for_request=raw)}}, ns)
            except ApiError:
                pass  # the next SDK tick re-acks; the save is not redone

    async def _kick_checkpoints(self) -> None:
        """Deterministic fabric exercise, once per storm round: a burst
        of real snapshot-then-ack saves per notebook while the storage
        fault storm is blowing. Drains alone are rng-paced and a seed
        can legitimately schedule almost none — which would leave the
        committed-step invariant vacuous (zero commits, zero restores
        checked). The tier-1 seeds assert the invariant actually ran,
        so the exercise is unconditional, like :meth:`_kick_elastic`."""
        keys = sorted(self._nb_names)[:3]
        for key in keys:
            for _ in range(3):
                fab = self._fabric_for(key)
                step = self._fabric_steps.get(key, 0) + 1
                self._fabric_steps[key] = step
                handle = self._save(fab, key, step)
                self._pending_commits.setdefault(key, []).append(
                    (handle, step, None))
        # A mid-storm restore against each fabric that already has a
        # durable commit: the read-corruption and slow-tier faults are
        # live HERE (the convergence-time check runs fault-free against
        # whatever damage the storm left), so this drives the hash-
        # verify fall-through under fire. A clean refusal is legal;
        # whatever DOES come back must regenerate bit-exact — a torn or
        # cross-step mix of chunks can never leak into the loop.
        for key in keys:
            if not self._committed_steps.get(key):
                continue
            fab = self._fabrics[key]
            try:
                tree = await asyncio.to_thread(fab.restore)
            except (CheckpointIntegrityError, FileNotFoundError):
                continue
            step = int(tree["step"])
            expect = self._step_tree(key, step)
            if not self._same(tree["w"], expect["w"]):
                self.report.problems.append(
                    f"{key[0]}/{key[1]}: mid-storm restore returned a "
                    f"partial for step {step}")
            else:
                self.report.restores_checked += 1

    async def _poll_commits(self) -> None:
        """Resolve finished uploads: committed → stamp the durable-commit
        mark (retrying on injected patch failures) and record the step in
        the harness's committed set; crashed → count it and drop (that
        step must never be restored — the invariant checks exactly
        this)."""
        for key, entries in list(self._pending_commits.items()):
            for entry in list(entries):
                handle, step, raw = entry
                if not handle.done():
                    continue
                if not handle.committed:
                    self.report.checkpoint_crashes += 1
                    entries.remove(entry)
                    continue
                # The fabric's pointer advance IS the ground truth —
                # record it now; the annotation mark below is protocol
                # bookkeeping and must not gate the invariant's
                # committed set (the CR may be deleted, the patch may
                # hit injected faults).
                if step not in self._committed_steps.setdefault(key, set()):
                    self._committed_steps[key].add(step)
                    self.report.checkpoint_commits += 1
                ns, name = key
                try:
                    nb = await self.kube.get_or_none("Notebook", name, ns)
                    if nb is not None:
                        await self.kube.patch(
                            "Notebook", name,
                            {"metadata": {"annotations":
                                          migration.commit_patch(
                                              time.time(),
                                              for_request=raw)}}, ns)
                except ApiError:
                    continue  # retry the mark next tick
                entries.remove(entry)
            if not entries:
                self._pending_commits.pop(key, None)

    async def _sdk_loop(self, stop: asyncio.Event) -> None:
        while not stop.is_set():
            await self._ack_drains()
            await self._poll_commits()
            await asyncio.sleep(0.05)

    async def _check_restores(self) -> list[str]:
        """THE checkpoint-fabric invariant: after convergence,
        every notebook with at least one durably committed step restores
        to a member of its committed set with bit-exact content — a
        crash-mid-upload or torn manifest never yields a restored
        partial; integrity damage falls back to an earlier committed
        step, never raises a partial into the training loop. Runs
        fault-free (the storm is lifted), against whatever damage the
        storm left on disk."""
        problems: list[str] = []
        for key, committed in sorted(self._committed_steps.items()):
            fab = self._fabrics.get(key)
            if fab is None or not committed:
                continue
            await asyncio.to_thread(fab.wait)
            # An upload that committed inside the wait is in the set
            # whether or not the commit poller has ticked since (the
            # pointer advance is the ground truth it records); a crashed
            # one stays out.
            committed = committed | {
                step for handle, step, _ in self._pending_commits.get(key, ())
                if handle.done() and handle.committed}
            try:
                tree = await asyncio.to_thread(fab.restore)
            except CheckpointIntegrityError:
                # Every committed manifest torn: the fabric REFUSED to
                # restore rather than hand back a partial — the
                # invariant is about never restoring damage, and a
                # clean refusal honors it.
                continue
            except FileNotFoundError:
                problems.append(
                    f"{key[0]}/{key[1]}: committed steps "
                    f"{sorted(committed)} but no committed pointer "
                    f"found on restore")
                continue
            except Exception as e:  # noqa: BLE001 — anything else leaked
                problems.append(
                    f"{key[0]}/{key[1]}: restore raised into the "
                    f"training loop: {type(e).__name__}: {e}")
                continue
            self.report.restores_checked += 1
            info = fab.last_restore or {}
            step = info.get("step")
            if step not in committed:
                problems.append(
                    f"{key[0]}/{key[1]}: restored step {step} is not a "
                    f"committed step (committed: {sorted(committed)}) — "
                    f"a partial/crashed checkpoint was restored")
                continue
            want = self._step_tree(key, step)
            if not (self._same(tree.get("w"), want["w"])
                    and int(tree.get("step", -1)) == step):
                problems.append(
                    f"{key[0]}/{key[1]}: restored step {step} content "
                    f"mismatch — torn or cross-step chunk mix passed "
                    f"verification")
        return problems

    # -- convergence ---------------------------------------------------------

    async def _settle_streak(self, deadline: float, *,
                             need_clear: int = 8,
                             interval: float = 0.03) -> bool:
        """Converged = ``need_clear`` consecutive samples with no ready/
        in-flight/dirty workqueue entries and no in-flight drains. The
        streak (240 ms) outlasts every soak-scale retry backoff (max
        50 ms), so the only future-delayed entries it can miss are the
        benign 0.5 s still-Queued refreshes."""
        clear = 0
        while time.monotonic() < deadline:
            busy = any(
                q.ready_count() or info["in_flight"] or info["dirty"]
                for q in self.mgr._queues.values()
                for info in (q.debug_info(),)
            ) or bool(self.sched._draining)
            clear = 0 if busy else clear + 1
            if clear >= need_clear:
                return True
            await asyncio.sleep(interval)
        return False

    def _release_transient_quarantines(self) -> None:
        """Storm-era quarantines are released through the manual escape
        hatch — the operator action POST /debug/queue/requeue models. If
        such a key re-quarantines with no faults active, it is a
        genuinely wedged key and the invariant check reports it."""
        for cname, queue in self.mgr._queues.items():
            for key in queue.quarantined_keys():
                self.report.quarantined_transient += 1
                self.mgr.requeue_quarantined(cname, key)

    async def _converge_and_check(self) -> list[str]:
        """Lift faults, force a global watch reset (every informer relists
        a clean view, the kubelet sim resyncs), settle, release storm-era
        quarantines, and run the invariant checks — retrying the
        settle+check loop until they pass or the timeout expires (a check
        can race the final benign requeues; a REAL violation is stable
        and survives to the timeout)."""
        self._lift_faults()
        # Revocations complete between storms: the dying spot nodes are
        # replaced (taints clear), so reclaimed pools re-open and the
        # drained gangs can re-admit.
        for node in self._spot_nodes:
            try:
                await self.kube.patch("Node", node,
                                      {"spec": {"taints": None}})
            except ApiError:
                pass
        self.kube.close_watches()
        deadline = time.monotonic() + self.cfg.converge_timeout
        released = False
        problems = [f"no convergence within {self.cfg.converge_timeout}s"]
        while time.monotonic() < deadline:
            if not await self._settle_streak(deadline):
                break
            if not released:
                self._release_transient_quarantines()
                released = True
                continue  # settle again after the requeues
            for cname, queue in self.mgr._queues.items():
                for key in queue.quarantined_keys():
                    problems = [
                        f"workqueue {cname}: key re-quarantined with no "
                        f"faults active (permanently wedged): {key}"]
                    return problems
            problems = await check_invariants(self.kube, self.mgr,
                                              self.sched, self.warmpool)
            if not problems:
                return []
            await asyncio.sleep(0.05)
        return problems

    # -- entry point ---------------------------------------------------------

    async def run(self) -> SoakReport:
        cfg = self.cfg
        await self._seed_cluster()   # fleet source exists before the
        await self._start()          # first admission pass runs
        sdk_stop = asyncio.Event()
        sdk_task = asyncio.create_task(self._sdk_loop(sdk_stop))
        sim = PodSimulator(self.kube)
        await sim.start()
        try:
            await self._seed_notebooks()
            for p in await self._converge_and_check():
                self.report.problems.append(f"initial: {p}")
            await self._kick_elastic()
            for round_no in range(cfg.rounds):
                self.report.rounds += 1
                self._arm_faults()
                await self._kick_checkpoints()
                t_end = time.monotonic() + cfg.storm_seconds
                kill_at = time.monotonic() + cfg.storm_seconds * \
                    self.rng.uniform(0.3, 0.7)
                killed = False
                while time.monotonic() < t_end:
                    await self._churn_once()
                    if not killed and time.monotonic() >= kill_at:
                        # Kill mid-reconcile, restart while the fault
                        # storm is still blowing: the new manager's first
                        # lists/reclaims run against a faulty apiserver.
                        await self._kill_manager()
                        self._build_stack()
                        await self.mgr.start()
                        killed = True
                    await asyncio.sleep(self.rng.uniform(0.01, 0.04))
                if not killed:
                    await self._kill_manager()
                    self._build_stack()
                    await self.mgr.start()
                for p in await self._converge_and_check():
                    self.report.problems.append(f"round {round_no}: {p}")
                for p in await self._check_restores():
                    self.report.problems.append(
                        f"round {round_no} restore: {p}")
        finally:
            sdk_stop.set()
            sdk_task.cancel()
            await reap(sdk_task)
            await sim.stop()
            # Each scheduler instance's cumulative counter is harvested
            # exactly once — at its death (_kill_manager for mid-soak
            # instances, here for the last one); summing it per round as
            # well would double-count a violation across round boundaries.
            self.report.ledger_violations += \
                self.sched.policy.ledger.violations
            await self.mgr.stop()
            self.kube.use_faults(None)
            self.kube.close_watches()
            for fab in self._fabrics.values():
                await asyncio.to_thread(fab.close)
            shutil.rmtree(self._fabric_root, ignore_errors=True)
        return self.report


async def run_soak(config: SoakConfig, *, device=None) -> SoakReport:
    """One seeded soak, its step trees on ``device`` (the host by
    default; see :class:`ChaosSoak`)."""
    return await ChaosSoak(config, device=device).run()


# ---- poison-pill scenario ------------------------------------------------------


async def poison_scenario(seed: int = 0, *, quarantine_after: int = 6) -> dict:
    """The deliberate poison pill (acceptance gate): a CR whose children
    can never apply must be quarantined within the retry budget, surface
    the Degraded condition + quarantined debug row, and resume — and
    converge — on the next spec edit once the fault is gone."""
    from kubeflow_tpu_torch.web.common.status import process_status

    kube = FakeKube()
    register_all(kube)
    plan = FaultPlan(seed=seed)
    # The poison: every write to this notebook's StatefulSets fails — an
    # admission webhook black-holing the child, a broken CRD, a bad node
    # selector... the reconcile itself always errors; the CR's own status
    # surface stays writable (as it would be in each of those cases).
    rule = plan.fail("internal", verbs=("create", "update", "patch"),
                    kinds="StatefulSet", names="poison*")
    kube.use_faults(plan)
    mgr = Manager(kube, registry=Registry(), quarantine_after=quarantine_after)
    setup_notebook_controller(mgr, NotebookOptions(), scheduler=None)
    for q in mgr._queues.values():
        q.base_delay = 0.002
        q.max_delay = 0.05
    sim = PodSimulator(kube)
    await mgr.start()
    await sim.start()
    out: dict = {"seed": seed, "quarantine_after": quarantine_after}
    try:
        await kube.create("Notebook", nbapi.new(
            "poison", "ns", accelerator="nvidia-h100-80gb", topology="2x8"))
        queue = mgr._queues["notebook"]
        key = ("ns", "poison")

        deadline = time.monotonic() + 20
        while not queue.is_quarantined(key):
            if time.monotonic() > deadline:
                out["quarantined"] = False
                return out
            await asyncio.sleep(0.02)
        out["quarantined"] = True
        out["failures_at_quarantine"] = queue.poison_streak(key)
        out["within_budget"] = \
            queue.poison_streak(key) == quarantine_after

        await mgr.wait_idle(timeout=10)
        nb = await kube.get("Notebook", "poison", "ns")
        cond = next((c for c in deep_get(
            nb, "status", "conditions", default=[])
            if c.get("type") == "Degraded"), None)
        out["degraded_condition"] = bool(
            cond and cond.get("status") == "True"
            and cond.get("reason") == "ReconcileQuarantined")
        status = process_status(nb)
        out["jwa_message_ok"] = (
            status.phase == "warning"
            and "Reconciliation suspended" in status.message)
        events = await kube.list("Event", "ns")
        out["warning_event"] = any(
            e.get("reason") == "ReconcileQuarantined" for e in events)
        dbg = mgr.debug_queues()["notebook"]
        out["debug_row"] = "('ns', 'poison')" in dbg["quarantined"]

        # The cure: fault gone + spec edit → new informer delta rv →
        # automatic release → clean reconcile → Degraded flips False.
        plan.drop(rule)
        await kube.patch(
            "Notebook", "poison",
            {"metadata": {"annotations": {"fixed": "yes"}}}, "ns")
        deadline = time.monotonic() + 20
        while queue.is_quarantined(key):
            if time.monotonic() > deadline:
                out["released"] = False
                return out
            await asyncio.sleep(0.02)
        out["released"] = True
        await mgr.wait_idle(timeout=20)
        sts = await kube.get_or_none("StatefulSet", "poison", "ns")
        nb = await kube.get("Notebook", "poison", "ns")
        cond = next((c for c in deep_get(
            nb, "status", "conditions", default=[])
            if c.get("type") == "Degraded"), None)
        out["reconciled_after_release"] = sts is not None
        out["degraded_cleared"] = bool(cond) and cond.get("status") == "False"
        out["pass"] = all(out.get(k) for k in (
            "quarantined", "within_budget", "degraded_condition",
            "jwa_message_ok", "warning_event", "debug_row", "released",
            "reconciled_after_release", "degraded_cleared"))
        return out
    finally:
        await sim.stop()
        await mgr.stop()
        kube.use_faults(None)
        kube.close_watches()


# ---- shard-kill scenario -------------------------------------------------------


async def shard_kill_scenario(
    seed: int = 0,
    *,
    shards: int = 4,
    replicas: int = 3,
    notebooks_per_namespace: int = 2,
    lease_seconds: float = 0.6,
    renew_seconds: float = 0.15,
    converge_timeout: float = 30.0,
) -> dict:
    """Kill one shard of N mid-flight: N manager replicas run
    active-active over one FakeKube, each reconciling only the namespace-
    hash shards whose leases it holds. A non-arbiter replica is crash-
    killed — leases left to expire, its queued keys dying with its
    workqueues — the moment fresh work lands on its keyspace. Survivors
    must absorb the orphaned shards within ~lease expiry plus the two-
    tick orphan confirmation, converge EVERY notebook including the ones
    created just before the kill (zero dropped queued keys), and restore
    the global invariants (ledger, timeline continuity, drained queues)
    with shard ownership still disjoint.

    The arbiter replica (preferred owner of shard 0) is never the
    victim: the shared scheduler instance stands in for "per-shard
    admission queues feeding one elected arbiter", and arbiter failover
    is controller-restart semantics the main soak already exercises.

    Deterministic end to end (lease protocol + FakeKube, no fault RNG);
    ``seed`` tags the report so the CI matrix stays uniform.
    """
    from kubeflow_tpu_torch.runtime.sharding import (
        ARBITER_SHARD,
        ShardRing,
        shard_of,
    )

    if replicas < 2 or shards < 2:
        raise ValueError("shard-kill needs >= 2 replicas and >= 2 shards")
    kube = FakeKube()
    register_all(kube)
    await kube.create("ConfigMap", {
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "kftpu-fleet", "namespace": "kubeflow-tpu"},
        "data": {"fleet": "pool-a=nvidia-h100-80gb:1x4:64"},
    })

    # Enough namespaces that every shard owns at least two — the victim's
    # keyspace must be non-trivial for the absorption to prove anything.
    by_shard: dict[int, list] = {s: [] for s in range(shards)}
    namespaces: list[str] = []
    i = 0
    while any(len(v) < 2 for v in by_shard.values()):
        ns = f"team-{i}"
        i += 1
        by_shard[shard_of(ns, shards)].append(ns)
        namespaces.append(ns)
        if i > 64 * shards:  # crc32 would have to be badly broken
            raise RuntimeError("could not cover every shard with namespaces")

    # ONE scheduler for the whole fleet: the in-process arbiter seam
    # (scheduler/runtime.py attach_ring) — every replica's reconcilers
    # feed it, only the arbiter-shard holder's ring activates it.
    sched = GpuFleetScheduler(
        kube,
        SchedulerOptions(
            queued_requeue_seconds=0.5,
            fleet_configmap="kftpu-fleet",
            controller_namespace="kubeflow-tpu",
            fleet_refresh_seconds=0.05,
        ),
        registry=Registry(),
    )

    rings: list[ShardRing] = []
    mgrs: list[Manager] = []
    for r in range(replicas):
        reg = Registry()
        ring = ShardRing(
            kube, shards=shards, replica=r, replicas=replicas,
            lease_seconds=lease_seconds, renew_seconds=renew_seconds,
            registry=reg)
        mgr = Manager(kube, registry=reg, shard_ring=ring)
        setup_notebook_controller(mgr, NotebookOptions(), scheduler=sched)
        for q in mgr._queues.values():
            q.base_delay = 0.002
            q.max_delay = 0.05
        for inf in mgr.informers.values():
            inf.resync_backoff = 0.02
            inf.resync_backoff_max = 0.2
        rings.append(ring)
        mgrs.append(mgr)
    arbiter_replica = ARBITER_SHARD % replicas
    victim = (replicas - 1 if replicas - 1 != arbiter_replica
              else replicas - 2)
    # setup wiring leaves sched._nb_informer pointing at the LAST
    # manager's (filtered) cache; pin it to the arbiter's so the shared
    # scheduler never reads through a dead replica's stopped informer.
    sched._nb_informer = mgrs[arbiter_replica].informer_for("Notebook")
    sched.attach_ring(rings[arbiter_replica])

    sim = PodSimulator(kube)
    out: dict = {
        "seed": seed,
        "shards": shards,
        "replicas": replicas,
        "namespaces": len(namespaces),
        "victim_replica": victim,
    }
    stopped: set[int] = set()
    try:
        for r in range(replicas):
            await rings[r].start()
            await mgrs[r].start()
        await sim.start()

        names: list[tuple] = []
        for ns in namespaces:
            for j in range(notebooks_per_namespace):
                name = f"nb-{j}"
                await kube.create("Notebook", nbapi.new(
                    name, ns, accelerator="nvidia-h100-80gb",
                    topology="1x4"))
                names.append((ns, name))
        out["notebooks"] = len(names)

        async def wait_ready(want_keys, timeout: float) -> set:
            pending = set(want_keys)
            deadline = time.monotonic() + timeout
            while pending and time.monotonic() < deadline:
                for ns, name in sorted(pending):
                    nb = await kube.get_or_none("Notebook", name, ns)
                    if nb is None:
                        continue
                    want = deep_get(
                        nb, "status", "gpu", "hosts", default=1) or 1
                    got = deep_get(
                        nb, "status", "readyReplicas", default=0) or 0
                    if got >= want:
                        pending.discard((ns, name))
                await asyncio.sleep(0.02)
            return pending

        not_ready = await wait_ready(names, converge_timeout)
        out["pre_kill_ready"] = len(names) - len(not_ready)
        out["pre_kill_converged"] = not not_ready

        # The notebooks can converge before the ring has settled on its
        # preferred spread (shard % replicas == replica): a replica that
        # starts late finds its shard absorbed, claims it back, and holds
        # it one tick after the handback. Kill only once every replica
        # holds its own slice, so the victim has shards to lose.
        deadline = time.monotonic() + converge_timeout
        while time.monotonic() < deadline and not all(
                set(rings[r].owned)
                == {s for s in range(shards) if s % replicas == r}
                for r in range(replicas)):
            await asyncio.sleep(renew_seconds / 2)

        victim_shards = set(rings[victim].owned)
        victim_namespaces = [
            ns for ns in namespaces
            if shard_of(ns, shards) in victim_shards]
        out["victim_shards"] = sorted(victim_shards)
        out["victim_namespaces"] = len(victim_namespaces)

        # Fresh keys on the victim's keyspace, then an immediate crash:
        # these land in the victim's workqueues (watch delta → enqueue)
        # and die with them. Zero-dropped-keys means every one still
        # converges, re-discovered by the absorbing survivor's
        # refill-on-acquire and live-predicate filtered watch.
        post_keys: list[tuple] = []
        for ns in victim_namespaces:
            await kube.create("Notebook", nbapi.new(
                "post-kill", ns, accelerator="nvidia-h100-80gb",
                topology="1x4"))
            post_keys.append((ns, "post-kill"))
        out["post_kill_created"] = len(post_keys)

        t_kill = time.monotonic()
        await rings[victim].kill()  # crash: no lease release, no fencing
        await mgrs[victim].stop()   # workers die mid-flight, queues lost
        stopped.add(victim)

        survivors = [r for r in range(replicas) if r != victim]
        deadline = (time.monotonic() + lease_seconds
                    + 20 * renew_seconds + 5)
        absorbed = False
        while time.monotonic() < deadline:
            held: set[int] = set()
            for r in survivors:
                held |= rings[r].owned
            if victim_shards <= held:
                absorbed = True
                break
            await asyncio.sleep(renew_seconds / 2)
        out["absorbed"] = absorbed
        out["failover_seconds"] = round(time.monotonic() - t_kill, 3)

        still_pending = await wait_ready(
            names + post_keys, converge_timeout)
        out["dropped_keys"] = sorted(
            f"{ns}/{name}" for ns, name in still_pending)
        out["all_ready_after_kill"] = not still_pending

        for r in survivors:
            await mgrs[r].wait_idle(timeout=15)

        owned_sets = [set(rings[r].owned) for r in survivors]
        union: set[int] = set().union(*owned_sets)
        disjoint = sum(len(s) for s in owned_sets) == len(union)
        out["ownership_disjoint"] = disjoint
        out["all_shards_owned"] = union == set(range(shards))

        problems: list[str] = []
        for r in survivors:
            for p in await check_invariants(kube, mgrs[r], sched, None):
                problems.append(f"replica {r}: {p}")
        out["invariant_problems"] = problems

        out["pass"] = bool(
            out.get("pre_kill_converged")
            and victim_shards
            and post_keys
            and absorbed
            and out.get("all_ready_after_kill")
            and disjoint
            and out.get("all_shards_owned")
            and not problems)
        return out
    finally:
        await sim.stop()
        for r in range(replicas):
            if r not in stopped:
                await mgrs[r].stop()
                await rings[r].stop()
        kube.close_watches()
