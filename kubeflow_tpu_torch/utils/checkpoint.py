"""Compatibility shim, as ``kubeflow_tpu/utils/checkpoint.py``: the
checkpoint stack lives in :mod:`kubeflow_tpu_torch.checkpoint`; import
:class:`CheckpointManager` from there."""

from kubeflow_tpu_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
