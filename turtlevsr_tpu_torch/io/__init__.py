from turtlevsr_tpu_torch.io.checkpoint import (  # noqa: F401
    latest_checkpoint_step,
    load_state_dict_file,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
)
from turtlevsr_tpu_torch.io.torch_convert import (  # noqa: F401
    jax_tree_from_model,
    load_jax_params,
)
