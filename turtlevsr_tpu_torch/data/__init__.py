"""The training data: frame-folder video datasets, the sampler, the
prefetching batch loader (host side, numpy)."""

from turtlevsr_tpu_torch.data.dataset import (  # noqa: F401
    VideoImageDataset,
    VideoSuperImageDataset,
    create_dataset,
)
from turtlevsr_tpu_torch.data.sampler import EnlargedSampler  # noqa: F401
from turtlevsr_tpu_torch.data.loader import PrefetchLoader  # noqa: F401
