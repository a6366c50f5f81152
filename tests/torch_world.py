"""Run a function in 4 CPU processes joined by ``torch.distributed``
(gloo), for the tests of the port's sequence parallelism: a thin wrapper
over the package's launcher, ``kubeflow_tpu_torch.parallel.launch``.

``run_world(fn, *args)`` returns ``[fn(0, *args), ..., fn(world - 1,
*args)]``, each computed in its own process of one gloo world. ``fn``
must be a top-level function of a module the children can import: they
load torch and the port, and no JAX. The processes share one deadline and
are killed on overrun, so a hung collective fails its test instead of
stalling the suite.
"""

from __future__ import annotations

from kubeflow_tpu_torch.parallel import launch


def run_world(fn, *args, world: int = 4, timeout: float = 240.0) -> list:
    return launch.run_world(fn, world, *args, timeout=timeout)
