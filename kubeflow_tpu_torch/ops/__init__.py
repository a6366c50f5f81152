"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``flash_attention`` (the forward and the dQ and dK/dV backward
kernels of ``kubeflow_tpu/ops/flash_attention.py``). Sources live in
``csrc/`` and build at first use (``_build``)."""
