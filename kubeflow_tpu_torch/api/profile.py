"""Profile CRD semantics (multi-tenancy).

Reference: ``profile-controller/api/v1/profile_types.go:36-69`` — a
cluster-scoped Profile owns one namespace; spec carries the owner subject,
an optional ResourceQuotaSpec, and a list of cloud plugins.

The accelerator quota is ``spec.gpuQuota``, the port's counterpart of the
JAX package's ``spec.tpuQuota``: a card-count ceiling merged into the
namespace's ResourceQuota as ``requests.nvidia.com/gpu``
(``gpu/topology.GPU_RESOURCE``), which the notebook admission checks a
gang's cards against (``webhooks/notebook.validate_capacity``).

The port's copy of ``kubeflow_tpu/api/profile.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import keys
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get, name_of
from kubeflow_tpu_torch.gpu.topology import GPU_RESOURCE

KIND = "Profile"
API_VERSION = keys.API_V1

# Version lineage, mirroring the reference which serves Profile at v1
# (storage) and v1beta1 with structurally identical schemas
# (profile-controller/api/{v1,v1beta1}/profile_types.go differ only in
# package name and kubebuilder markers).
STORAGE_API_VERSION = API_VERSION
SERVED_API_VERSIONS = (
    keys.API_V1,
    keys.API_V1BETA1,
)


def convert(profile: dict, to_api_version: str) -> dict:
    """Convert a Profile between served versions (identity rewrite — see
    kubeflow_tpu_torch.api.convert for why)."""
    from kubeflow_tpu_torch.api.convert import identity_convert

    return identity_convert(profile, to_api_version,
                            served=SERVED_API_VERSIONS,
                            storage=STORAGE_API_VERSION, kind=KIND)

# Condition types (profile_types.go:47-51)
SUCCEED = "Successful"
FAILED = "Failed"
UNKNOWN = "Unknown"

OWNER_ANNOTATION = "owner"
QUOTA_NAME = "kf-resource-quota"  # profile_controller.go:253-280
GPU_QUOTA_KEY = f"requests.{GPU_RESOURCE}"


def new(
    name: str,
    owner: str,
    *,
    owner_kind: str = "User",
    gpu_quota: int | None = None,
    resource_quota: dict | None = None,
    plugins: list[dict] | None = None,
) -> dict:
    spec: dict = {"owner": {"kind": owner_kind, "name": owner}}
    if gpu_quota is not None:
        spec["gpuQuota"] = gpu_quota
    if resource_quota:
        spec["resourceQuotaSpec"] = resource_quota
    if plugins:
        spec["plugins"] = plugins
    return {
        "apiVersion": API_VERSION,
        "kind": KIND,
        "metadata": {"name": name},
        "spec": spec,
    }


def owner_of(profile: dict) -> dict:
    return deep_get(profile, "spec", "owner", default={}) or {}


def quota_spec_of(profile: dict) -> dict | None:
    """Effective ResourceQuotaSpec: explicit spec merged with gpuQuota."""
    quota = deep_get(profile, "spec", "resourceQuotaSpec")
    gpu_quota = deep_get(profile, "spec", "gpuQuota")
    if gpu_quota is None:
        return quota
    quota = dict(quota or {})
    hard = dict(quota.get("hard") or {})
    hard[GPU_QUOTA_KEY] = str(gpu_quota)
    quota["hard"] = hard
    return quota


def validate(profile: dict) -> None:
    name = name_of(profile)
    if not name:
        raise Invalid("Profile: metadata.name is required")
    owner = owner_of(profile)
    if not owner.get("name"):
        raise Invalid(f"Profile {name}: spec.owner.name is required")
    gpu_quota = deep_get(profile, "spec", "gpuQuota")
    if gpu_quota is not None and (not isinstance(gpu_quota, int) or gpu_quota < 0):
        raise Invalid(f"Profile {name}: spec.gpuQuota must be a non-negative integer")
