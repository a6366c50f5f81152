"""Profile reconciler: one tenant = one namespace + RBAC + quota.

Reference: ``profile-controller/controllers/profile_controller.go``:

- ``Reconcile`` (:105-334): Namespace (istio-injection label, owner
  annotation, :126-198), Istio AuthorizationPolicy (:200-206, 419-556),
  ServiceAccounts ``default-editor``/``default-viewer`` + RoleBindings
  (:208-251, 592-671), owner ``namespaceAdmin`` RoleBinding, ResourceQuota
  ``kf-resource-quota`` from ``spec.resourceQuotaSpec`` (:253-280), plugin
  apply with finalizer-driven revoke (:281-331).
- Default namespace labels hot-reloaded from file (:368-399) → here a plain
  dict option (config-file layer wires it in cmd/).

Accelerator deltas (the port of ``kubeflow_tpu/controllers/profile.py``):
``spec.gpuQuota`` (a card-count ceiling) merges into the quota as
``requests.nvidia.com/gpu`` (``api/profile.quota_spec_of``), where the
reference merges ``spec.tpuQuota`` as ``requests.google.com/tpu``; the
GKE WorkloadIdentity plugin is first-class (GPU pods reach GCS via WI, no
key files).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Protocol

from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.runtime.apply import Stage, apply_set, reconcile_child
from kubeflow_tpu_torch.runtime.errors import AlreadyExists, ApiError, NotFound
from kubeflow_tpu_torch.runtime.events import EventRecorder
from kubeflow_tpu_torch.runtime.manager import Controller, Manager, Result
from kubeflow_tpu_torch.runtime.metrics import Registry, global_registry
from kubeflow_tpu_torch.runtime.objects import (
    deep_get,
    get_meta,
    name_of,
    now_iso,
    set_controller_owner,
)
from kubeflow_tpu_torch.runtime.tracing import span

log = logging.getLogger(__name__)

PROFILE_FINALIZER = "profile-finalizer.kubeflow.org"
DEFAULT_EDITOR = "default-editor"
DEFAULT_VIEWER = "default-viewer"
ADMIN_BINDING = "namespaceAdmin"

# GKE Workload Identity SA annotation (plugin_workload_identity.go:44-166).
WI_ANNOTATION = "iam.gke.io/gcp-service-account"
# AWS IRSA SA annotation (plugin_iam.go:36-120).
IRSA_ANNOTATION = "eks.amazonaws.com/role-arn"


class Plugin(Protocol):
    """Reference plugin interface (profile_controller.go:77-83)."""

    kind: str

    async def apply(self, kube, profile: dict, spec: dict) -> None: ...
    async def revoke(self, kube, profile: dict, spec: dict) -> None: ...


class WorkloadIdentityPlugin:
    """Bind the tenant's default-editor SA to a GCP service account so GPU
    pods reach GCS/Artifact Registry without key files."""

    kind = "WorkloadIdentity"

    async def apply(self, kube, profile: dict, spec: dict) -> None:
        gsa = spec.get("gcpServiceAccount", "")
        if not gsa:
            return
        await _annotate_sa(kube, name_of(profile), DEFAULT_EDITOR, WI_ANNOTATION, gsa)

    async def revoke(self, kube, profile: dict, spec: dict) -> None:
        await _annotate_sa(kube, name_of(profile), DEFAULT_EDITOR, WI_ANNOTATION, None)


class AwsIamForServiceAccountPlugin:
    kind = "AwsIamForServiceAccount"

    async def apply(self, kube, profile: dict, spec: dict) -> None:
        arn = spec.get("awsIamRole", "")
        if not arn:
            return
        await _annotate_sa(kube, name_of(profile), DEFAULT_EDITOR, IRSA_ANNOTATION, arn)

    async def revoke(self, kube, profile: dict, spec: dict) -> None:
        await _annotate_sa(
            kube, name_of(profile), DEFAULT_EDITOR, IRSA_ANNOTATION, None
        )


async def _annotate_sa(kube, ns: str, sa: str, key: str, value: str | None) -> None:
    try:
        await kube.patch(
            "ServiceAccount", sa, {"metadata": {"annotations": {key: value}}}, ns
        )
    except NotFound:
        pass


@dataclass
class ProfileOptions:
    """Reference flags/env (main.go + hot-reloaded label file) as one block."""

    namespace_labels: dict = field(
        default_factory=lambda: {
            "istio-injection": "enabled",
            "app.kubernetes.io/part-of": "kubeflow-profile",
        }
    )
    # Mounted-file override, hot-reloaded (reference: fsnotify on the
    # ConfigMap-mounted labels file, profile_controller.go:368-399 +
    # readDefaultLabelsFromFile :775-790). A flat YAML map; when set it
    # REPLACES namespace_labels, and edits re-reconcile every Profile.
    namespace_labels_file: str | None = None
    use_istio: bool = False
    userid_header: str = "kubeflow-userid"
    userid_prefix: str = ""
    notebook_controller_principal: str = (
        "cluster.local/ns/kubeflow/sa/notebook-controller-service-account"
    )
    edit_cluster_role: str = "kubeflow-edit"
    view_cluster_role: str = "kubeflow-view"
    admin_cluster_role: str = "kubeflow-admin"


class ProfileReconciler:
    def __init__(
        self,
        kube,
        options: ProfileOptions | None = None,
        *,
        plugins: dict[str, Plugin] | None = None,
        registry: Registry | None = None,
    ):
        self.kube = kube
        self.opts = options or ProfileOptions()
        self.plugins: dict[str, Plugin] = plugins or {
            p.kind: p
            for p in (WorkloadIdentityPlugin(), AwsIamForServiceAccountPlugin())
        }
        self.recorder = EventRecorder(kube, "profile-controller")
        registry = registry or global_registry
        # Same metric family as the reference (monitoring.go:24-77).
        self.m_update = registry.counter(
            "profile_update_total", "Profile reconciles applying changes",
            ["profile"],
        )
        self.m_failure = registry.counter(
            "profile_failure_total", "Profile reconcile failures", ["profile"]
        )

    async def reconcile(self, key) -> Result | None:
        _, name = key
        with span("cache_read"):
            profile = await self.kube.get_or_none("Profile", name)
        if profile is None:
            return None
        if get_meta(profile).get("deletionTimestamp"):
            await self._finalize(profile)
            return None

        try:
            with span("apply"):
                await self._ensure_finalizer(profile)
                # Dependency DAG (latency hiding): the Namespace
                # must exist before anything namespaced lands in it; the
                # RBAC/quota children are then independent of each other;
                # plugins patch the ServiceAccounts the rbac stage made.
                await apply_set(self.kube, [
                    Stage("namespace", [self._namespace_obj(profile)]),
                    Stage("rbac", [
                        self._create_service_account(profile, DEFAULT_EDITOR),
                        self._create_service_account(profile, DEFAULT_VIEWER),
                        *self._role_bindings(profile),
                        # Deliberate change from the pre-DAG code: the
                        # policy now carries the Profile ownerReference
                        # like every sibling, so it GC-cascades with the
                        # tenant (one-time drift update on upgrade).
                        (self._authorization_policy(profile)
                         if self.opts.use_istio else None),
                        self._reconcile_quota(profile),
                    ]),
                    Stage("plugins", [self._apply_plugins(profile)]),
                ], owner=profile)
        except ApiError as e:
            self.m_failure.labels(profile=name).inc()
            with span("status"):
                await self._set_condition(profile, profileapi.FAILED, str(e))
            raise
        self.m_update.labels(profile=name).inc()
        with span("status"):
            await self._set_condition(profile, profileapi.SUCCEED, "")
        return None

    # ---- pieces -----------------------------------------------------------------

    async def _ensure_finalizer(self, profile: dict) -> None:
        meta = get_meta(profile)
        finalizers = meta.get("finalizers") or []
        if PROFILE_FINALIZER not in finalizers and deep_get(profile, "spec", "plugins"):
            await self.kube.patch(
                "Profile",
                name_of(profile),
                {"metadata": {"finalizers": finalizers + [PROFILE_FINALIZER]}},
            )

    def current_namespace_labels(self) -> dict:
        """Static option, or the hot-reloaded mounted file when configured
        (mtime-cached read; the setup-time watcher re-enqueues Profiles on
        change, so edits converge without a restart)."""
        path = self.opts.namespace_labels_file
        if not path:
            return dict(self.opts.namespace_labels)
        import os

        import yaml

        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return dict(self.opts.namespace_labels)
        cached = getattr(self, "_labels_cache", None)
        if cached and cached[0] == mtime:
            return dict(cached[1])
        with open(path) as fh:
            labels = yaml.safe_load(fh) or {}
        if not isinstance(labels, dict):
            raise ValueError(f"{path}: namespace labels must be a flat map")
        labels = {str(k): str(v) for k, v in labels.items()}
        self._labels_cache = (mtime, labels)
        return dict(labels)

    def _namespace_obj(self, profile: dict) -> dict:
        name = name_of(profile)
        owner = profileapi.owner_of(profile).get("name", "")
        return {
            "apiVersion": "v1",
            "kind": "Namespace",
            "metadata": {
                "name": name,
                "labels": self.current_namespace_labels(),
                "annotations": {
                    profileapi.OWNER_ANNOTATION: owner,
                    "profile-name": name,
                },
            },
        }

    async def _create_service_account(self, profile: dict, sa_name: str) -> None:
        sa = {
            "apiVersion": "v1",
            "kind": "ServiceAccount",
            "metadata": {"name": sa_name, "namespace": name_of(profile)},
        }
        set_controller_owner(sa, profile)
        try:
            await self.kube.create("ServiceAccount", sa)
        except AlreadyExists:
            pass  # plugin annotations are patched separately

    def _role_bindings(self, profile: dict) -> list[dict]:
        ns = name_of(profile)
        owner = profileapi.owner_of(profile)
        return [
            _role_binding(
                ns, DEFAULT_EDITOR, self.opts.edit_cluster_role,
                {"kind": "ServiceAccount", "name": DEFAULT_EDITOR, "namespace": ns},
            ),
            _role_binding(
                ns, DEFAULT_VIEWER, self.opts.view_cluster_role,
                {"kind": "ServiceAccount", "name": DEFAULT_VIEWER, "namespace": ns},
            ),
            _role_binding(
                ns, ADMIN_BINDING, self.opts.admin_cluster_role,
                {
                    "kind": owner.get("kind", "User"),
                    "name": owner.get("name", ""),
                    "apiGroup": "rbac.authorization.k8s.io",
                },
            ),
        ]

    def _authorization_policy(self, profile: dict) -> dict:
        """Reference getAuthorizationPolicy (:419-504): owner + notebook
        controller may reach the namespace; anyone may reach
        ``*/api/kernels`` (the culler's probe path)."""
        ns = name_of(profile)
        owner = profileapi.owner_of(profile).get("name", "")
        return {
            "apiVersion": "security.istio.io/v1beta1",
            "kind": "AuthorizationPolicy",
            "metadata": {"name": "ns-owner-access-istio", "namespace": ns},
            "spec": {
                "rules": [
                    {
                        "when": [
                            {
                                "key": f"request.headers[{self.opts.userid_header}]",
                                "values": [self.opts.userid_prefix + owner],
                            }
                        ]
                    },
                    {
                        "from": [
                            {
                                "source": {
                                    "principals": [
                                        self.opts.notebook_controller_principal
                                    ]
                                }
                            }
                        ]
                    },
                    {"to": [{"operation": {"paths": ["*/api/kernels"]}}]},
                ]
            },
        }

    async def _reconcile_quota(self, profile: dict) -> None:
        ns = name_of(profile)
        quota_spec = profileapi.quota_spec_of(profile)
        existing = await self.kube.get_or_none(
            "ResourceQuota", profileapi.QUOTA_NAME, ns
        )
        if not quota_spec or not quota_spec.get("hard"):
            if existing is not None:
                await self.kube.delete("ResourceQuota", profileapi.QUOTA_NAME, ns)
            return
        quota = {
            "apiVersion": "v1",
            "kind": "ResourceQuota",
            "metadata": {"name": profileapi.QUOTA_NAME, "namespace": ns},
            "spec": quota_spec,
        }
        set_controller_owner(quota, profile)
        await reconcile_child(self.kube, quota)

    async def _apply_plugins(self, profile: dict) -> None:
        for entry in deep_get(profile, "spec", "plugins", default=[]) or []:
            kind = entry.get("kind", "")
            plugin = self.plugins.get(kind)
            if plugin is None:
                await self.recorder.event(
                    profile, "Warning", "UnknownPlugin", f"no plugin {kind!r}"
                )
                continue
            await plugin.apply(self.kube, profile, entry.get("spec", {}) or {})

    async def _finalize(self, profile: dict) -> None:
        """Deletion path: revoke plugins, then drop our finalizer (:281-331)."""
        for entry in deep_get(profile, "spec", "plugins", default=[]) or []:
            plugin = self.plugins.get(entry.get("kind", ""))
            if plugin is not None:
                try:
                    await plugin.revoke(
                        self.kube, profile, entry.get("spec", {}) or {}
                    )
                except ApiError:
                    log.exception("plugin revoke failed for %s", name_of(profile))
        finalizers = [
            f for f in get_meta(profile).get("finalizers", [])
            if f != PROFILE_FINALIZER
        ]
        try:
            await self.kube.patch(
                "Profile", name_of(profile), {"metadata": {"finalizers": finalizers}}
            )
        except NotFound:
            pass

    async def _set_condition(self, profile: dict, ctype: str, message: str) -> None:
        now = now_iso()
        conditions = [{"type": ctype, "status": "True", "message": message,
                       "lastTransitionTime": now}]
        current = deep_get(profile, "status", "conditions", default=[])
        if current and current[0].get("type") == ctype and \
                current[0].get("message") == message:
            return
        try:
            await self.kube.patch(
                "Profile", name_of(profile),
                {"status": {"conditions": conditions}}, subresource="status",
            )
        except ApiError as exc:
            log.debug("Profile condition write for %s failed (re-set "
                      "next reconcile): %s", name_of(profile), exc)


def _role_binding(ns: str, name: str, cluster_role: str, subject: dict) -> dict:
    return {
        "apiVersion": "rbac.authorization.k8s.io/v1",
        "kind": "RoleBinding",
        "metadata": {
            "name": name,
            "namespace": ns,
            "annotations": {"role": cluster_role, "user": subject.get("name", "")},
        },
        "roleRef": {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole",
            "name": cluster_role,
        },
        "subjects": [subject],
    }


def setup_profile_controller(
    mgr: Manager, options: ProfileOptions | None = None, **kw
) -> ProfileReconciler:
    rec = ProfileReconciler(mgr.kube, options, registry=mgr.registry, **kw)
    mgr.add_controller(
        Controller(name="profile", kind="Profile", reconcile=rec.reconcile)
    )
    if rec.opts.namespace_labels_file:
        # Reference parity: fsnotify on the mounted labels file triggers a
        # reconcile of ALL profiles (profile_controller.go:368-399). The
        # watcher is the native inotify library when available (event-driven
        # wakeups for ConfigMap symlink swaps) and degrades to 2 s mtime
        # polling with the same interface (utils/fswatch.py).
        async def watch_labels_file():
            from kubeflow_tpu_torch.utils.fswatch import FileWatcher

            watcher = FileWatcher(rec.opts.namespace_labels_file)
            try:
                while True:
                    if await watcher.wait(timeout=2.0):
                        for profile in await mgr.kube.list("Profile"):
                            mgr.enqueue("profile", (None, name_of(profile)))
            finally:
                watcher.close()

        mgr.add_background(watch_labels_file)
    return rec
