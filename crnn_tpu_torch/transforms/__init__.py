"""Parameter-vector -> weight transforms (port of crnn_tpu.transforms)."""

from crnn_tpu_torch.transforms.p2vec import (  # noqa: F401
    CRNNWeights,
    init_params_case1,
    init_params_case2,
    init_params_case3,
    init_params_cathode,
    init_params_reversible,
    init_params_robertson,
    init_params_yeast,
    p2vec_case1,
    p2vec_case2,
    p2vec_case3,
    p2vec_cathode,
    p2vec_reversible,
    p2vec_robertson,
    p2vec_yeast,
)
from crnn_tpu_torch.transforms.pruning import (  # noqa: F401
    hard_threshold,
    prune_case2_params,
    relative_threshold,
)
