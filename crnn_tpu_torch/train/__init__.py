"""Losses, optimizer and training loop (port of crnn_tpu.train)."""

from crnn_tpu_torch.train.lm import levenberg_marquardt  # noqa: F401
from crnn_tpu_torch.train.loop import (  # noqa: F401
    EpochMetrics,
    Trainer,
    TrainState,
)
from crnn_tpu_torch.train.loss import make_trajectory_loss  # noqa: F401
from crnn_tpu_torch.train.optimizers import (  # noqa: F401
    adamw_like,
    expdecay_adamw,
    nadam_like,
)
