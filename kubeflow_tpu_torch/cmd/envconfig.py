"""Env-var configuration shared by the entrypoints (the port of
``kubeflow_tpu/cmd/envconfig.py``).

The reference scatters four config mechanisms (SURVEY.md §5 "Config/flag
system"); this is the unified one: every knob is an env var with a default,
mapped onto the typed Options dataclasses the controllers take. The port
reads the same names as the reference.
"""

from __future__ import annotations

import os


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    try:
        return float(raw) if raw is not None else default
    except ValueError:
        return default


# Re-exported from runtime so every layer shares one definition without
# importing this cmd wiring module.
from kubeflow_tpu_torch.runtime.deployment import controller_namespace  # noqa: E402,F401


def notebook_options():
    from kubeflow_tpu_torch.controllers.notebook import (
        DEFAULT_MAINTENANCE_TAINTS,
        NotebookOptions,
    )

    from kubeflow_tpu_torch.migration import protocol as migration

    return NotebookOptions(
        use_istio=env_bool("USE_ISTIO", False),
        # Preempt-to-checkpoint (docs/operations.md "Migration"): drives
        # suspend/resume, restore-hint env, and status.migration.
        enable_migration=migration.migration_enabled(),
        drain_grace_seconds=migration.drain_grace_seconds(),
        istio_gateway=env_str("ISTIO_GATEWAY", "kubeflow/kubeflow-gateway"),
        istio_host=env_str("ISTIO_HOST", "*"),
        cluster_domain=env_str("CLUSTER_DOMAIN", "cluster.local"),
        add_fsgroup=env_bool("ADD_FSGROUP", True),
        controller_namespace=controller_namespace(),
        create_network_policies=env_bool("CREATE_NETWORK_POLICIES", False),
        trusted_ca_configmap=os.environ.get("TRUSTED_CA_BUNDLE_CONFIGMAP"),
        auth_proxy_image=os.environ.get("AUTH_PROXY_IMAGE"),
        pipeline_access_role=env_str("PIPELINE_ACCESS_ROLE",
                                     "pipeline-user-access") or None,
        # Comma-separated taint keys; empty string disables the mirror.
        maintenance_taints=tuple(
            t.strip() for t in env_str(
                "MAINTENANCE_TAINTS",
                ",".join(DEFAULT_MAINTENANCE_TAINTS)).split(",")
            if t.strip()
        ),
        # Off for clusters without the ProvisioningRequest CRD.
        enable_queued_provisioning=env_bool("ENABLE_QUEUED_PROVISIONING",
                                            True),
    )


def scheduler_options():
    """Fleet-scheduler env contract (the reference's docs/operations.md
    "TPU fleet scheduler" + "Elastic fleet"). The on/off switch itself is
    KFTPU_SCHEDULER, read by kubeflow_tpu_torch.scheduler.scheduler_enabled;
    the elastic subsystem has its own KFTPU_ELASTIC (and KFTPU_DEFRAG)
    underneath it."""
    from kubeflow_tpu_torch.migration import protocol as migration
    from kubeflow_tpu_torch.scheduler import elastic
    from kubeflow_tpu_torch.scheduler.runtime import SchedulerOptions

    weights: dict[str, float] = {}
    for entry in env_str("KFTPU_SCHEDULER_WEIGHTS", "").split(","):
        name, sep, value = entry.strip().partition("=")
        if not sep or not name:
            continue
        try:
            weights[name] = float(value)
        except ValueError:
            continue
    return SchedulerOptions(
        fleet_spec=env_str("KFTPU_FLEET", "").strip(),
        fleet_configmap=os.environ.get("KFTPU_FLEET_CONFIGMAP") or None,
        controller_namespace=controller_namespace(),
        weights=weights,
        aging_seconds=env_float("KFTPU_SCHEDULER_AGING_SECONDS", 300.0),
        starvation_reserve_seconds=env_float(
            "KFTPU_SCHEDULER_STARVATION_SECONDS", 900.0),
        enable_preemption=env_bool("KFTPU_SCHEDULER_PREEMPTION", True),
        idle_preempt_after_seconds=env_float(
            "KFTPU_SCHEDULER_IDLE_AFTER_SECONDS", 1800.0),
        queued_requeue_seconds=env_float(
            "KFTPU_SCHEDULER_QUEUED_REQUEUE_SECONDS", 10.0),
        # Preempt-to-checkpoint (KFTPU_MIGRATION, default on): preemption
        # drains victims and frees their GPUs only on the checkpoint ack or
        # the KFTPU_DRAIN_GRACE deadline. The dataclass default is off so
        # bare construction keeps immediate-stop semantics; production
        # gets it from here.
        enable_migration=migration.migration_enabled(),
        drain_grace_seconds=migration.drain_grace_seconds(),
        # Checkpoint fabric (KFTPU_COMMIT_GRACE, defaults to the drain
        # grace): how long the post-ack background upload may run before
        # the park is marked commit-dirty.
        commit_grace_seconds=migration.commit_grace_seconds(),
        # Elastic fleet (KFTPU_ELASTIC, default on): scale-up intents,
        # flex placement, spot reclaim, defrag. =off restores the
        # pre-elastic scheduler byte-for-byte; KFTPU_DEFRAG=off disables
        # only the defragmenter.
        enable_elastic=elastic.elastic_enabled(),
        enable_defrag=elastic.defrag_enabled(),
        scale_up_ttl_seconds=env_float(
            "KFTPU_SCALE_UP_TTL", elastic.DEFAULT_SCALE_UP_TTL_SECONDS),
        defrag_interval_seconds=env_float(
            "KFTPU_DEFRAG_INTERVAL",
            elastic.DEFAULT_DEFRAG_INTERVAL_SECONDS),
        defrag_idle_seconds=env_float(
            "KFTPU_DEFRAG_IDLE_SECONDS",
            elastic.DEFAULT_DEFRAG_IDLE_SECONDS),
        defrag_max_moves=int(env_float(
            "KFTPU_DEFRAG_MAX_MOVES", elastic.DEFAULT_DEFRAG_MAX_MOVES)),
        fleet_refresh_seconds=env_float("KFTPU_FLEET_REFRESH_SECONDS",
                                        30.0),
    )


def shard_ring_config() -> tuple[int, int, int, int]:
    """Sharded control plane env contract (docs/operations.md "Sharded
    control plane"): (shards, replica, replicas, handback_ticks).
    KFTPU_SHARDS=1 — the default — keeps the single-writer
    leader-elected control plane byte-for-byte; KFTPU_SHARD_REPLICA is
    the StatefulSet ordinal so the preferred shard spread is stable
    across restarts. A restarted replica reclaims its slice via the
    demand-driven claim protocol (runtime/sharding.py), so the periodic
    KFTPU_SHARD_HANDBACK_TICKS release is off by default — timer-based
    handback churns absorbed shards through unowned windows even when
    the preferred owner is dead and nobody can take them."""
    return (
        int(env_float("KFTPU_SHARDS", 1)),
        int(env_float("KFTPU_SHARD_REPLICA", 0)),
        int(env_float("KFTPU_SHARD_REPLICAS", 1)),
        int(env_float("KFTPU_SHARD_HANDBACK_TICKS", 0)),
    )


def warm_pool_options():
    """Warm pod pools env contract (docs/operations.md "Warm pools &
    cold-start"). No KFTPU_WARM_POOLS spec and no ConfigMap source means
    the whole subsystem is off — the cold path byte-for-byte."""
    from kubeflow_tpu_torch.controllers.warmpool import (
        DEFAULT_REPLENISH_SECONDS,
        WarmPoolOptions,
    )

    return WarmPoolOptions(
        spec=env_str("KFTPU_WARM_POOLS", "").strip(),
        configmap=os.environ.get("KFTPU_WARM_POOLS_CONFIGMAP") or None,
        controller_namespace=controller_namespace(),
        replenish_seconds=env_float("KFTPU_WARM_REPLENISH_SECONDS",
                                    DEFAULT_REPLENISH_SECONDS),
        refresh_seconds=env_float("KFTPU_FLEET_REFRESH_SECONDS", 30.0),
    )


def serving_options():
    """Inference-serving env contract (docs/operations.md "Inference
    serving"). The master switch is KFTPU_SERVING (default on), read by
    kubeflow_tpu_torch.serving.serving_enabled; the ServingOptions
    dataclass default is off so bare construction keeps the
    notebook-only control plane byte-for-byte."""
    from kubeflow_tpu_torch.migration import protocol as migration
    from kubeflow_tpu_torch.serving import serving_enabled
    from kubeflow_tpu_torch.serving.controller import ServingOptions

    return ServingOptions(
        enabled=serving_enabled(),
        cluster_domain=env_str("CLUSTER_DOMAIN", "cluster.local"),
        controller_namespace=controller_namespace(),
        serving_port=int(env_float("KFTPU_SERVING_PORT", 8000)),
        # "low"|"normal"|"high"|"critical" or an int; default high — a
        # serving burst preempts idle notebooks, never the reverse.
        priority=_serving_priority(),
        autoscale_period_seconds=env_float(
            "KFTPU_SERVING_AUTOSCALE_PERIOD", 5.0),
        # The park drain rides the migration grace knob by default.
        park_grace_seconds=env_float(
            "KFTPU_SERVING_PARK_GRACE", migration.drain_grace_seconds()),
        default_target_rate=env_float("KFTPU_SERVING_TARGET_RATE", 8.0),
        default_idle_window=env_float("KFTPU_SERVING_IDLE_WINDOW", 300.0),
        default_stabilization=env_float(
            "KFTPU_SERVING_STABILIZATION", 60.0),
        # SLO-driven autoscaling kill switch: off = the raw
        # rate/concurrency policy byte-for-byte, even with KFTPU_SLO on.
        slo_autoscale=env_bool("KFTPU_SERVING_SLO_AUTOSCALE", True),
    )


def serving_engine_options():
    """Serving data-plane env contract — the paged KV-cache pool,
    chunked-prefill lane, and model-multiplex knobs (docs/operations.md
    "Serving engine v2"). KFTPU_SERVING_KV_BLOCKS=0 (the default) sizes
    the pool from max_batch × seq_len."""
    from kubeflow_tpu_torch.serving.engine import EngineOptions

    kv_blocks = int(env_float("KFTPU_SERVING_KV_BLOCKS", 0))
    return EngineOptions(
        kv_blocks=kv_blocks if kv_blocks > 0 else None,
        kv_block_size=max(1, int(env_float(
            "KFTPU_SERVING_KV_BLOCK_SIZE", 16))),
        prefill_chunk=max(1, int(env_float(
            "KFTPU_SERVING_PREFILL_CHUNK", 32))),
        chunked_prefill=env_bool("KFTPU_SERVING_CHUNKED_PREFILL", True),
        max_resident_models=max(1, int(env_float(
            "KFTPU_SERVING_MAX_MODELS", 2))),
    )


def _serving_priority() -> int:
    from kubeflow_tpu_torch.scheduler import parse_priority

    return parse_priority(env_str("KFTPU_SERVING_PRIORITY", "high"))


def culling_options():
    from kubeflow_tpu_torch.controllers.culling import CullingOptions
    from kubeflow_tpu_torch.migration import protocol as migration

    return CullingOptions(
        enable_culling=env_bool("ENABLE_CULLING", False),
        cull_idle_seconds=env_float("CULL_IDLE_TIME", 1440.0) * 60.0,
        check_period_seconds=env_float("IDLENESS_CHECK_PERIOD", 1.0) * 60.0,
        cluster_domain=env_str("CLUSTER_DOMAIN", "cluster.local"),
        dev_url=os.environ.get("CULLER_DEV_URL"),
        # Checkpoint-then-stop for idle culls: needs BOTH the master
        # migration switch and the culling-specific KFTPU_CULL_DRAIN
        # (default on) — =off restores the bare stop.
        drain_on_cull=(migration.migration_enabled()
                       and migration.cull_drain_enabled()),
        drain_grace_seconds=migration.drain_grace_seconds(),
    )


def profile_options():
    from kubeflow_tpu_torch.controllers.profile import ProfileOptions

    return ProfileOptions(
        use_istio=env_bool("USE_ISTIO", False),
        userid_header=env_str("USERID_HEADER", "kubeflow-userid"),
        userid_prefix=env_str("USERID_PREFIX", ""),
        # Reference: the ConfigMap-mounted, hot-reloaded labels file
        # (profile_controller.go DefaultNamespaceLabelsPath).
        namespace_labels_file=os.environ.get("NAMESPACE_LABELS_PATH"),
    )


def tensorboard_options():
    from kubeflow_tpu_torch.controllers.tensorboard import TensorboardOptions

    return TensorboardOptions(
        image=env_str("TENSORBOARD_IMAGE", "tensorflow/tensorflow:latest"),
        use_istio=env_bool("USE_ISTIO", False),
        cluster_domain=env_str("CLUSTER_DOMAIN", "cluster.local"),
        rwo_pvc_scheduling=env_bool("RWO_PVC_SCHEDULING", True),
        gcp_creds_secret=os.environ.get("TENSORBOARD_GCP_CREDS_SECRET"),
    )


def pvcviewer_options():
    from kubeflow_tpu_torch.controllers.pvcviewer import PVCViewerOptions

    return PVCViewerOptions(
        use_istio=env_bool("USE_ISTIO", False),
        cluster_domain=env_str("CLUSTER_DOMAIN", "cluster.local"),
    )
