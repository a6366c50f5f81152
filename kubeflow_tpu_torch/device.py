"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the current CUDA device; with no CUDA device that
    raises instead of running on the CPU. Only an explicit ``"cpu"``
    (what the CPU tests pass) runs the plain PyTorch versions there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: kubeflow_tpu_torch runs on the GPU unless "
                "the caller passes device='cpu'")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
