"""Hand-written Hopper kernels and their plain PyTorch versions. Importing
builds and loads nothing: a kernel is built at its first CUDA call."""

from crnn_tpu_torch.ops.crnn_kernels import (  # noqa: F401
    crnn_rhs_batched,
    crnn_rhs_batched_reference,
    crnn_rhs_jac_batched,
    crnn_rhs_jac_batched_reference,
)
