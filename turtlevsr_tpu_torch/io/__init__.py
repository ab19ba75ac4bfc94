from turtlevsr_tpu_torch.io.checkpoint import load_state_dict_file  # noqa: F401
from turtlevsr_tpu_torch.io.torch_convert import (  # noqa: F401
    jax_tree_from_model,
    load_jax_params,
)
