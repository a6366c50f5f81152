"""Registered named sections around the parallel stack's collectives.

The counterpart of ``kubeflow_tpu/telemetry/sections.py``, trimmed to the
sections the ported slices run. Every collective in ``parallel/ring.py``,
``parallel/ulysses.py``, ``parallel/moe.py`` and ``parallel/pipeline.py``
goes through
:func:`collective`, which rejects a name that is not registered in
``SECTION_SPECS`` and runs the op inside
``torch.profiler.record_function("kftpu." + name)``, so a profiler trace
books communication time under the same names as the JAX package's
traces. The JAX module's serialize mode (collectives fenced from compute
for the overlap A/B) is not ported yet.
"""

from __future__ import annotations

import torch

# (name, module, description): the JAX package's names for these sections.
SECTION_SPECS = (
    ("ring_kv_hop", "kubeflow_tpu_torch/parallel/ring",
     "K/V block send to the next ring neighbor (xla block impl)"),
    ("ring_flash_kv_hop", "kubeflow_tpu_torch/parallel/ring",
     "K/V block send in the flash-kernel ring forward"),
    ("ring_flash_grad_hop", "kubeflow_tpu_torch/parallel/ring",
     "K/V + dK/dV accumulator send in the flash ring backward"),
    ("ulysses_all_to_all", "kubeflow_tpu_torch/parallel/ulysses",
     "heads<->sequence all_to_all (both directions of the exchange)"),
    ("moe_dispatch_all_to_all", "kubeflow_tpu_torch/parallel/moe",
     "token-slot all_to_all scattering tokens to their experts"),
    ("moe_combine_all_to_all", "kubeflow_tpu_torch/parallel/moe",
     "expert-output all_to_all returning tokens to their home shard"),
    ("pipeline_stage_hop", "kubeflow_tpu_torch/parallel/pipeline",
     "activation send to the next pipeline stage (and its cotangent "
     "back)"),
)

SECTION_NAMES = frozenset(spec[0] for spec in SECTION_SPECS)


def collective(name: str, op, *args, **kwargs):
    """``op(*args, **kwargs)`` inside the registered section ``name``."""
    if name not in SECTION_NAMES:
        raise ValueError(
            f"unregistered telemetry section {name!r}; add it to "
            f"telemetry/sections.py SECTION_SPECS")
    with torch.profiler.record_function("kftpu." + name):
        return op(*args, **kwargs)
