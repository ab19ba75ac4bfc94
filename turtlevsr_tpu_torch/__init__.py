"""turtlevsr_tpu_torch: the PyTorch/CUDA port of turtlevsr_tpu for NVIDIA
Hopper. The serving and training paths of the Turtle models with
hand-written CUDA kernels, and their command lines; imports torch, never
jax, and nothing of the JAX package."""

from turtlevsr_tpu_torch.config.options import (  # noqa: F401
    ModelConfig,
    OptionsError,
    load_options,
    model_config_from_options,
)

__version__ = "0.1.0"
