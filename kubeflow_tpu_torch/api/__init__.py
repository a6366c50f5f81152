"""API types of the port's notebook control plane (the counterpart of
``kubeflow_tpu.api``).

Objects are plain dicts shaped like their Kubernetes wire form; this
package holds the *semantics*: constants, defaulting, validation, and
typed accessors for each CRD the port serves — ``Notebook`` (with its
``spec.gpu`` block), ``Profile`` (with ``spec.gpuQuota``) and
``PodDefault`` — the wire keys (``keys``) the controller, the webhooks
and the SDK share, and ``InferenceService`` (with its ``spec.gpu``
block), the serving workload class.
"""

from kubeflow_tpu_torch.api import inferenceservice, notebook, poddefault, profile

__all__ = ["inferenceservice", "notebook", "poddefault", "profile"]
