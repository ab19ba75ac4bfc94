from turtlevsr_tpu_torch.io.torch_convert import (  # noqa: F401
    jax_tree_from_model,
    load_jax_params,
)
