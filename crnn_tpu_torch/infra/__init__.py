"""Run infrastructure (port of crnn_tpu.infra): metrics, checkpoints,
figures, mechanism export, profiling and runtime scopes."""

from crnn_tpu_torch.infra.checkpoint import (  # noqa: F401
    load_checkpoint,
    save_checkpoint,
)
from crnn_tpu_torch.infra.metrics import MetricsLogger  # noqa: F401
