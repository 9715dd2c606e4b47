"""Truth models and synthetic datasets (port of crnn_tpu.data)."""

from crnn_tpu_torch.data.generate import (  # noqa: F401
    Dataset,
    generate_dataset,
    latin_hypercube,
    max_min_scale,
)
from crnn_tpu_torch.data.truth import TRUTH_REGISTRY  # noqa: F401
