"""Kind registry: apiVersion/kind ⇄ REST path mapping.

Equivalent of the Go scheme + RESTMapper. Kinds used by the stack are
registered up front; CRDs register alongside built-ins (our CRDs live in the
``kubeflow.org`` group like the reference's, see e.g.
``notebook-controller/api/v1/notebook_types.go``).

The port's copy of ``kubeflow_tpu/runtime/scheme.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GVK:
    group: str
    version: str
    kind: str
    plural: str
    namespaced: bool = True

    @property
    def api_version(self) -> str:
        return f"{self.group}/{self.version}" if self.group else self.version

    @property
    def key(self) -> str:
        """Stable storage/lookup key, version-independent (like a GR)."""
        return f"{self.plural}.{self.group}" if self.group else self.plural

    def rest_base(self, namespace: str | None) -> str:
        root = f"/apis/{self.group}/{self.version}" if self.group else f"/api/{self.version}"
        if self.namespaced and namespace:
            return f"{root}/namespaces/{namespace}/{self.plural}"
        return f"{root}/{self.plural}"


class Scheme:
    def __init__(self) -> None:
        self._by_kind: dict[str, GVK] = {}
        self._by_key: dict[str, GVK] = {}

    def register(self, gvk: GVK) -> GVK:
        # Last registration wins per kind name; CRD versions share storage.
        self._by_kind[gvk.kind] = gvk
        self._by_key[gvk.key] = gvk
        return gvk

    def by_kind(self, kind: str) -> GVK:
        try:
            return self._by_kind[kind]
        except KeyError:
            raise KeyError(f"kind {kind!r} not registered in scheme") from None

    def gvk_of(self, obj: dict) -> GVK:
        return self.by_kind(obj["kind"])

    def kinds(self) -> list[GVK]:
        return list(self._by_kind.values())


DEFAULT_SCHEME = Scheme()

_CORE = [
    GVK("", "v1", "Pod", "pods"),
    GVK("", "v1", "Service", "services"),
    GVK("", "v1", "Namespace", "namespaces", namespaced=False),
    GVK("", "v1", "ServiceAccount", "serviceaccounts"),
    GVK("", "v1", "ConfigMap", "configmaps"),
    GVK("", "v1", "Secret", "secrets"),
    GVK("", "v1", "Event", "events"),
    GVK("", "v1", "PersistentVolumeClaim", "persistentvolumeclaims"),
    GVK("", "v1", "ResourceQuota", "resourcequotas"),
    GVK("", "v1", "Node", "nodes", namespaced=False),
    GVK("", "v1", "PodTemplate", "podtemplates"),
    GVK("autoscaling.x-k8s.io", "v1beta1", "ProvisioningRequest",
        "provisioningrequests"),
    GVK("apps", "v1", "StatefulSet", "statefulsets"),
    GVK("apps", "v1", "Deployment", "deployments"),
    GVK("rbac.authorization.k8s.io", "v1", "Role", "roles"),
    GVK("rbac.authorization.k8s.io", "v1", "RoleBinding", "rolebindings"),
    GVK("rbac.authorization.k8s.io", "v1", "ClusterRole", "clusterroles", namespaced=False),
    GVK("networking.k8s.io", "v1", "NetworkPolicy", "networkpolicies"),
    GVK("storage.k8s.io", "v1", "StorageClass", "storageclasses", namespaced=False),
    GVK("coordination.k8s.io", "v1", "Lease", "leases"),
    GVK("authorization.k8s.io", "v1", "SubjectAccessReview", "subjectaccessreviews", namespaced=False),
    # Istio (used when the mesh is enabled, mirroring the reference's USE_ISTIO)
    GVK("networking.istio.io", "v1beta1", "VirtualService", "virtualservices"),
    GVK("security.istio.io", "v1beta1", "AuthorizationPolicy", "authorizationpolicies"),
    # Our CRDs (kubeflow.org group for drop-in familiarity)
    GVK("kubeflow.org", "v1", "Notebook", "notebooks"),
    GVK("kubeflow.org", "v1", "InferenceService", "inferenceservices"),
    GVK("kubeflow.org", "v1", "Profile", "profiles", namespaced=False),
    GVK("kubeflow.org", "v1alpha1", "PodDefault", "poddefaults"),
    GVK("tensorboard.kubeflow.org", "v1alpha1", "Tensorboard", "tensorboards"),
    GVK("kubeflow.org", "v1alpha1", "PVCViewer", "pvcviewers"),
]

for _gvk in _CORE:
    DEFAULT_SCHEME.register(_gvk)
