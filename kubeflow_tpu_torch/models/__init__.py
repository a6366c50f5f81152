"""The burn-in transformer on PyTorch (forward, loss, SGD train step) and
the training harness (``trainer``)."""

from kubeflow_tpu_torch.models.burnin import (
    BurninConfig,
    forward,
    init_params,
    loss_fn,
    make_train_step,
    map_params,
    param_shapes,
)
from kubeflow_tpu_torch.models.convert import params_from_jax

__all__ = ["BurninConfig", "forward", "init_params", "loss_fn",
           "make_train_step", "map_params", "param_shapes",
           "params_from_jax"]
