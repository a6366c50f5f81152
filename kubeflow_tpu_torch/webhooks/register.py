"""Wire every admission engine onto an apiserver admission chain: the
port of ``kubeflow_tpu/webhooks/register.py``.

Order matters and is fixed here (the reference's implicit multi-webhook
ordering made explicit): CR defaulting/validation first, then pod-level
PodDefault injection, then the per-node GPU env (which must see the final
pod name and the template annotations, and must win over anything a
PodDefault set for ``TPU_WORKER_ID`` or ``PET_NODE_RANK``).

The chain holds the reference's kinds: Notebook, PodDefault, Profile,
Tensorboard, PVCViewer and (with ``KFTPU_SERVING`` on) InferenceService.
"""

from __future__ import annotations

from kubeflow_tpu_torch.api import notebook as nbapi
from kubeflow_tpu_torch.api import poddefault as pdapi
from kubeflow_tpu_torch.api import profile as profileapi
from kubeflow_tpu_torch.api import pvcviewer as pvcapi
from kubeflow_tpu_torch.api import tensorboard as tbapi
from kubeflow_tpu_torch.webhooks import gpu as gpu_webhook
from kubeflow_tpu_torch.webhooks import notebook as nb_webhook
from kubeflow_tpu_torch.webhooks import poddefault as pd_webhook


def register_all(kube) -> None:
    """Register mutators/validators on a FakeKube-compatible admission chain.

    ``kube.add_mutator(kind_glob, fn)`` / ``add_validator`` — fns may be sync
    or async, called with (obj, request_info).
    """
    # CR defaulting (mutators run before validators). The Notebook mutator
    # also enforces restart blocking (webhooks/notebook.py).
    kube.add_mutator("Notebook", nb_webhook.mutate)

    # Image-alias resolution from the catalog ConfigMap (odh's ImageStream
    # resolution, notebook_webhook.go:539-645, without OpenShift).
    async def image_resolver(nb: dict, info: dict) -> None:
        if info.get("operation") in (None, "CREATE", "UPDATE"):
            await nb_webhook.resolve_image_from_catalog(kube, nb)

    kube.add_mutator("Notebook", image_resolver)
    kube.add_mutator("PVCViewer", lambda v, _i: pvcapi.default(v))

    # Profiles applied at an old served version are normalized to storage at
    # admission (same contract as the Notebook mutator's normalization).
    def profile_normalizer(p: dict, _info: dict) -> None:
        if p.get("apiVersion") in profileapi.SERVED_API_VERSIONS:
            p["apiVersion"] = profileapi.STORAGE_API_VERSION

    kube.add_mutator("Profile", profile_normalizer)

    # CR validation. Notebooks additionally fast-fail (CREATE only) when
    # the card request can never fit the namespace gpuQuota ceiling or
    # the configured GPU fleet (webhooks/notebook.py validate_capacity)
    # — an impossible gang must be rejected with an actionable message,
    # not queue forever.
    async def notebook_validator(nb: dict, info: dict) -> None:
        nbapi.validate(nb)
        if info.get("operation") in (None, "CREATE"):
            await nb_webhook.validate_capacity(kube, nb)

    kube.add_validator("Notebook", notebook_validator)

    # Serving workload class (KFTPU_SERVING, kubeflow_tpu_torch/serving):
    # the InferenceService mutator/validator register only with the
    # switch on, so =off keeps the notebook-only admission chain
    # byte-for-byte. Capacity fast-fail mirrors the Notebook gate
    # (CREATE only) through the same TTL-cached Profile/fleet loaders.
    from kubeflow_tpu_torch.serving import serving_enabled

    if serving_enabled():
        from kubeflow_tpu_torch.webhooks import inferenceservice as isvc_webhook

        kube.add_mutator("InferenceService", isvc_webhook.mutate)

        async def isvc_validator(isvc: dict, info: dict) -> None:
            from kubeflow_tpu_torch.api import inferenceservice as isvcapi

            isvcapi.validate(isvc)
            if info.get("operation") in (None, "CREATE"):
                await isvc_webhook.validate_capacity(kube, isvc)

        kube.add_validator("InferenceService", isvc_validator)
    kube.add_validator("PodDefault", lambda pd, _i: pdapi.validate(pd))
    kube.add_validator("Profile", lambda p, _i: profileapi.validate(p))
    kube.add_validator("Tensorboard", lambda tb, _i: tbapi.validate(tb))
    kube.add_validator("PVCViewer", lambda v, _i: pvcapi.validate(v))

    # Pod mutation: PodDefault injection, then the per-node GPU env.
    async def poddefault_mutator(pod: dict, info: dict) -> None:
        if info.get("operation") == "CREATE":
            await pd_webhook.mutate_pod(kube, pod)

    def gpu_mutator(pod: dict, info: dict) -> None:
        if info.get("operation") == "CREATE":
            gpu_webhook.mutate_pod(pod)

    kube.add_mutator("Pod", poddefault_mutator)
    kube.add_mutator("Pod", gpu_mutator)
