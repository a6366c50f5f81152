"""Shared CRD version-conversion helper.

The reference keeps structurally-identical schemas across served versions
(e.g. notebook-controller/api/{v1,v1beta1,v1alpha1}/notebook_types.go and
profile-controller/api/{v1,v1beta1}/profile_types.go differ only in package
name and kubebuilder markers), so conversion is the apiVersion rewrite of a
hub/spoke no-op (api/v1beta1/notebook_conversion.go). Each api module
exposes its own ``convert()`` over this helper — the single place that
would hold real field mappings if a future version diverges.

The port's copy of ``kubeflow_tpu/api/convert.py``: it keeps its own so
that it imports nothing of the JAX package.
"""

from __future__ import annotations

from kubeflow_tpu_torch.runtime.errors import Invalid


def identity_convert(obj: dict, to_api_version: str, *, served: tuple[str, ...],
                     storage: str, kind: str) -> dict:
    """Rewrite ``obj`` to ``to_api_version`` when both ends are served."""
    if to_api_version not in served:
        raise Invalid(
            f"unknown {kind} apiVersion {to_api_version!r}; "
            f"served: {', '.join(served)}"
        )
    have = obj.get("apiVersion", storage)
    if have not in served:
        raise Invalid(f"cannot convert from unknown apiVersion {have!r}")
    out = dict(obj)
    out["apiVersion"] = to_api_version
    return out
