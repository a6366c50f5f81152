"""The benchmark of the PyTorch and CUDA port (``kubeflow_tpu_torch``):
``python3 -m perfbench.run``; see README.md."""
