"""CRNN right-hand sides and their closed-form Jacobians (port of
crnn_tpu.models)."""

from crnn_tpu_torch.models.crnn import (  # noqa: F401
    R_KCAL,
    cathode_hrr,
    make_cathode_rhs,
    make_crnn_arrhenius_rhs,
    make_crnn_qssa_rhs,
    make_crnn_reversible_rhs,
    make_crnn_rhs,
    make_crnn_scaled_rhs,
    make_crnn_yeast_rhs,
)
from crnn_tpu_torch.models.mlp import mlp_apply, mlp_init  # noqa: F401
