"""Admission layer: pure mutation/validation engines + their registrations
(the port of ``kubeflow_tpu.webhooks``).

Each engine is a pure function over dict-shaped objects, registered on the
apiserver's admission chain (FakeKube in tests, the wire server
``server.create_webhook_app`` in deployment): Notebook defaulting,
validation, the card quota and the fleet ceiling (``notebook``), the
same for InferenceServices (``inferenceservice``), PodDefault injection
(``poddefault``) and the per-node GPU env (``gpu``), wired in order by
``register_all`` — one admission layer, no cross-webhook races (SURVEY.md
§7 hard-part (c)).
"""

from kubeflow_tpu_torch.webhooks.poddefault import (
    apply_poddefaults,
    filter_poddefaults,
    safe_to_apply,
)
from kubeflow_tpu_torch.webhooks.register import register_all

__all__ = [
    "apply_poddefaults",
    "filter_poddefaults",
    "safe_to_apply",
    "register_all",
]
