from turtlevsr_tpu_torch.ops.attn_utils import (  # noqa: F401
    acc_dtype,
    masked_softmax,
    posenc2d,
)
from turtlevsr_tpu_torch.ops.conv import conv2d, conv_init  # noqa: F401
from turtlevsr_tpu_torch.ops.norm import layer_norm  # noqa: F401
from turtlevsr_tpu_torch.ops.resize import pixel_shuffle, pixel_unshuffle  # noqa: F401
