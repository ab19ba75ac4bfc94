from turtlevsr_tpu_torch.core.cache import (  # noqa: F401
    fhr_slot_append,
    fhr_slot_init,
    token_valid_mask,
)
