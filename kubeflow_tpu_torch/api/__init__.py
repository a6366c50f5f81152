"""API types of the port's notebook control plane (the counterpart of
``kubeflow_tpu.api``).

Objects are plain dicts shaped like their Kubernetes wire form; this
package holds the *semantics*: constants, defaulting, validation, and
typed accessors for each CRD the port serves, and the wire keys
(``keys``) the controllers, the webhooks and the SDK share.

CRDs (all in the ``kubeflow.org`` family, registered in
``kubeflow_tpu_torch.runtime.scheme``):

- ``Notebook``      — reference: notebook-controller/api/v1/notebook_types.go,
  with its ``spec.gpu`` block
- ``Profile``       — reference: profile-controller/api/v1/profile_types.go,
  with ``spec.gpuQuota``
- ``PodDefault``    — reference: admission-webhook/pkg/apis/settings/v1alpha1/
- ``Tensorboard``   — reference: tensorboard-controller/api/v1alpha1/
- ``PVCViewer``     — reference: pvcviewer-controller/api/v1alpha1/
- ``InferenceService`` (``serving.kubeflow.org``) — the serving workload
  class, with its ``spec.gpu`` block
"""

from kubeflow_tpu_torch.api import (
    inferenceservice,
    notebook,
    poddefault,
    profile,
    pvcviewer,
    tensorboard,
)

__all__ = ["inferenceservice", "notebook", "poddefault", "profile",
           "tensorboard", "pvcviewer"]
