"""Controller runtime, built from scratch for this stack.

The reference leans on controller-runtime (Go); this package is its
asyncio-native equivalent: a typed scheme, list/watch informers with local
caches, rate-limited workqueues, reconciler workers, create-or-update apply
helpers with drift detection, an event recorder, and Prometheus-text metrics.
Controllers talk to any object implementing the ``KubeApi`` protocol — the
real apiserver over HTTPS (``httpclient.HttpKube``) or the in-memory fake
(``kubeflow_tpu_torch.testing.fakekube.FakeKube``, our envtest).

The port's copy of ``kubeflow_tpu/runtime/__init__.py``: it keeps its own
so that it imports nothing of the JAX package.
"""

from kubeflow_tpu_torch.runtime.errors import ApiError, Conflict, Forbidden, NotFound
from kubeflow_tpu_torch.runtime.objects import (
    controller_owner,
    get_meta,
    new_object,
    owned_by,
    set_controller_owner,
)
from kubeflow_tpu_torch.runtime.scheme import Scheme, GVK, DEFAULT_SCHEME

__all__ = [
    "ApiError",
    "Conflict",
    "Forbidden",
    "NotFound",
    "Scheme",
    "GVK",
    "DEFAULT_SCHEME",
    "controller_owner",
    "get_meta",
    "new_object",
    "owned_by",
    "set_controller_owner",
]
