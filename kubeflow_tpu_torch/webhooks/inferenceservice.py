"""InferenceService admission: defaulting + validation + capacity
fast-fail. The port of ``kubeflow_tpu/webhooks/inferenceservice.py``.

Same contract as the Notebook webhook's capacity gate
(webhooks/notebook.py): a service that can NEVER run must die at CREATE
with an actionable message, not sit Queued forever. Two ceilings are
checkable synchronously, through the SAME ``_ttl_cached`` loaders the
notebook gate uses (so the spec key, the cache TTL, and the bad-spec
tolerance cannot drift between the two workload classes):

- the namespace Profile's ``spec.gpuQuota`` — one replica's cards must
  fit under it, and so must the guaranteed floor
  (``minReplicas × cards``: the autoscaler will hold that many replicas
  admitted at all times);
- the declared fleet's shape ceiling — a single replica's gang must fit
  the fleet even fully drained (``maxReplicas`` deliberately is NOT
  checked against the ceiling: the autoscaler queues surplus replicas
  by design, and a burst ceiling above current capacity is exactly what
  scale-up intents exist for).

CREATE-only, like the notebook gate: rejecting UPDATEs against a
later-lowered ceiling would freeze the controller's own status patches.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import inferenceservice as isvcapi
from kubeflow_tpu_torch.runtime.errors import Invalid
from kubeflow_tpu_torch.runtime.objects import deep_get
from kubeflow_tpu_torch.webhooks.notebook import (
    _declared_fleet,
    _profile_cache,
    _ttl_cached,
)


def mutate(isvc: dict, _info: dict) -> None:
    """Full InferenceService mutator: default, then validate."""
    isvcapi.default(isvc)
    isvcapi.validate(isvc)


async def validate_capacity(kube, isvc: dict) -> None:
    """Raise Invalid when the service could never hold its replicas."""
    ms = isvcapi.multi_slice_of(isvc)  # raises Invalid on malformed gpu
    if ms is None:
        return
    name = deep_get(isvc, "metadata", "name")
    ns = deep_get(isvc, "metadata", "namespace")
    cards = ms.num_chips
    floor = max(1, isvcapi.min_replicas(isvc))
    if ns and kube is not None:
        profile = await _ttl_cached(
            _profile_cache, kube, ns,
            lambda: kube.get_or_none("Profile", ns))
        quota = deep_get(profile or {}, "spec", "gpuQuota")
        if isinstance(quota, int) and not isinstance(quota, bool):
            if cards > quota:
                raise Invalid(
                    f"InferenceService {name}: one replica needs {cards} "
                    f"GPUs but the namespace ceiling (Profile {ns} "
                    f"spec.gpuQuota) is {quota} — shrink "
                    "spec.gpu.topology/numSlices or raise the quota")
            if floor * cards > quota:
                raise Invalid(
                    f"InferenceService {name}: the scaling floor needs "
                    f"{floor} replica(s) x {cards} GPUs = "
                    f"{floor * cards}, over the namespace ceiling "
                    f"(Profile {ns} spec.gpuQuota = {quota}) — lower "
                    "spec.scaling.minReplicas or raise the quota")
    from kubeflow_tpu_torch.scheduler import scheduler_enabled
    from kubeflow_tpu_torch.serving import serving_enabled

    if not (scheduler_enabled() and serving_enabled()):
        # Either kill switch restores the pre-gate behavior end to end.
        return
    fleet = await _declared_fleet(kube)
    if fleet is not None and fleet.pools:
        acc = ms.slice.accelerator.name
        topo = ms.slice.topology_str
        ceiling = fleet.total_slices(acc, topo)
        if ceiling < ms.num_slices:
            detail = (
                f"no configured node pool hosts {acc}:{topo} slices"
                if ceiling == 0 else
                f"the fleet holds at most {ceiling} {acc}:{topo} "
                f"slice(s), one replica needs {ms.num_slices}")
            raise Invalid(
                f"InferenceService {name}: no replica can ever be "
                f"scheduled — {detail}. Pick a shape from the configured "
                "fleet (KFTPU_FLEET) or reduce spec.gpu.numSlices")
        if floor * ms.num_slices > ceiling:
            raise Invalid(
                f"InferenceService {name}: the scaling floor needs "
                f"{floor} replica(s) x {ms.num_slices} {acc}:{topo} "
                f"slice(s) = {floor * ms.num_slices}, but the fleet "
                f"ceiling is {ceiling} — lower spec.scaling.minReplicas "
                "or grow the fleet")
