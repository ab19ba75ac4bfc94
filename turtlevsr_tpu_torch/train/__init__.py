"""Training: the losses, the learning-rate schedules and the BPTT train
step over a clip (``step.py``)."""

from turtlevsr_tpu_torch.train.lr_schedule import build_schedule  # noqa: F401
from turtlevsr_tpu_torch.train.step import (  # noqa: F401
    TrainState,
    make_optimizer,
    make_train_step,
)
