"""The burn-in transformer on PyTorch (the serving slice's model)."""

from kubeflow_tpu_torch.models.burnin import (
    BurninConfig,
    forward,
    init_params,
    map_params,
    param_shapes,
)
from kubeflow_tpu_torch.models.convert import params_from_jax

__all__ = ["BurninConfig", "forward", "init_params", "map_params",
           "param_shapes", "params_from_jax"]
