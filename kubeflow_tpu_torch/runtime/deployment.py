"""Deployment-identity facts shared across layers.

The one value every layer needs to agree on regardless of which process it
runs in (controller manager, webhook server, web apps): the namespace this
stack is installed in, from the downward-API ``POD_NAMESPACE``. Lives in
runtime/ so web/ and webhooks/ never import the cmd wiring layer.

The port's copy of ``kubeflow_tpu/runtime/deployment.py``: it keeps its
own so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import os


def controller_namespace() -> str:
    return os.environ.get("POD_NAMESPACE", "kubeflow-tpu")
