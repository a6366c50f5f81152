"""Reconcilers of the port's notebook control plane (the counterpart of
``kubeflow_tpu.controllers``: the notebook, profile, culling, Tensorboard
and PVCViewer controllers and the warm pod pools; the InferenceService
controller lives in ``kubeflow_tpu_torch.serving.controller``, as in the
reference).

One module per controller, mirroring the reference's component split
(SURVEY.md §2.1) but collapsed to a single manager process — the reference's
two-controller lock dance (notebook-controller + odh-notebook-controller) is
deliberately absent (SURVEY.md §7 hard-part (c): one controller + one webhook
deletes that entire class of races).

The port's copy of ``kubeflow_tpu/controllers/__init__.py``: it keeps its
own so that it imports nothing of the JAX package.
"""

from kubeflow_tpu_torch.controllers.culling import (
    CullingOptions,
    CullingReconciler,
    setup_culling_controller,
)
from kubeflow_tpu_torch.controllers.notebook import NotebookReconciler, setup_notebook_controller

__all__ = ["CullingOptions", "CullingReconciler", "NotebookReconciler",
           "setup_culling_controller", "setup_notebook_controller"]
