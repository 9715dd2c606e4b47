"""Data parallelism over ``torch.distributed`` ranks (port of
crnn_tpu/parallel/). The process group takes the place of JAX's
``make_mesh``."""

from crnn_tpu_torch.parallel.dp import (  # noqa: F401
    make_dp_eval,
    make_dp_train_step,
)
from crnn_tpu_torch.parallel.mesh import pad_to_multiple  # noqa: F401
