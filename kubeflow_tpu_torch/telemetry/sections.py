"""Registered named sections around the parallel stack's collectives, and
serialize mode.

The port of ``kubeflow_tpu/telemetry/sections.py``. Every collective in
``parallel/ring.py``, ``parallel/ulysses.py``, ``parallel/moe.py`` and
``parallel/pipeline.py`` goes through :func:`collective`, which rejects a
name that is not registered in ``SECTION_SPECS`` and runs the op inside
``torch.profiler.record_function("kftpu." + name)``, so a profiler trace
books communication time under the same names as the JAX package's
traces.

*Serialize mode* (:func:`set_serialize_collectives`) fences every
registered collective from compute, for the overlap A/B
(``telemetry.overlap_fraction`` of the same step run both ways): before
the op, the current CUDA stream's queued work finishes; after it, the
collective itself finishes. Both waits are
``torch.cuda.current_stream().synchronize()`` once the process has
started CUDA; on the CPU, where an op runs to its end before it returns,
there is nothing to wait for. It is the eager counterpart of the JAX
module's ``optimization_barrier`` fences. The backward of every ported
collective calls :func:`collective` again (``ring.shift`` backwards, the
pipeline's stage hop), so both directions are fenced with no custom VJP.
Unlike the JAX module's trace-time flag, the mode takes effect per call:
flipping it changes the next collective a step issues, with no rebuild.
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

_serialize = False


def set_serialize_collectives(on: bool) -> None:
    """Fence every registered collective from compute (see the module's
    docstring); takes effect at the next collective issued."""
    global _serialize
    _serialize = bool(on)


def serialize_collectives() -> bool:
    return _serialize


def _fence() -> None:
    """Wait for the current CUDA stream's queued work where this process
    has started CUDA; nothing on the CPU."""
    if torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()


def collective(name: str, op, *operands, **kwargs):
    """``op(*operands, **kwargs)`` inside the registered section ``name``;
    in serialize mode fenced on both sides (:func:`_fence`)."""
    if name not in SECTION_NAMES:
        raise ValueError(
            f"unregistered telemetry section {name!r}; add it to "
            f"telemetry/sections.py SECTION_SPECS")
    with torch.profiler.record_function("kftpu." + name):
        if not _serialize:
            return op(*operands, **kwargs)
        _fence()
        out = op(*operands, **kwargs)
        _fence()
        return out
