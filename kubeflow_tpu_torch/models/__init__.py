"""The burn-in transformer on PyTorch (forward, loss, SGD train step),
its long-context sequence-parallel variant (``longctx``), its
mixture-of-experts variant (``moe``), its pipelined variant
(``pipelined``), the residual convnet (``vision``), and the training
harness (``trainer``)."""

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
from kubeflow_tpu_torch.models.longctx import LongContextConfig
from kubeflow_tpu_torch.models.moe import MoEConfig
from kubeflow_tpu_torch.models.pipelined import PipelinedConfig
from kubeflow_tpu_torch.models.vision import VisionConfig

__all__ = ["BurninConfig", "LongContextConfig", "MoEConfig",
           "PipelinedConfig", "VisionConfig", "forward", "init_params",
           "loss_fn", "make_train_step", "map_params", "param_shapes",
           "params_from_jax"]
