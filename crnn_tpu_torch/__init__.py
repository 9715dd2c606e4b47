"""crnn_tpu_torch — the PyTorch/CUDA port of crnn_tpu for one NVIDIA H100.

The package mirrors ``crnn_tpu``'s module tree (``ode/``, ``ops/``,
``train/``, ...). Plain tensor code is PyTorch; every Pallas kernel of the
JAX package becomes a kernel written by hand for Hopper (``ops/csrc``).
The JAX package is the reference: ``tests/test_torch_*.py`` hold each
ported piece against it on the same numpy inputs.

Device rule: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for ``cuda`` without a card raises, and nothing
falls back to the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Solver arithmetic needs true f32 matmuls: a reduced-precision matmul
# shifted the dense output by ~0.5% (crnn_tpu/ops/rb23_solve_kernel.py,
# the reason crnn_tpu/__init__.py forces "highest" precision in JAX).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The torch device for an entry point; raises if CUDA is asked for and
    absent (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "crnn_tpu_torch: device 'cuda' requested but torch.cuda is not "
            "available; pass device='cpu' to run the plain CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r}")
    return dev


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip`` semantics: ``minimum(maximum(x, lo), hi)`` with tensor
    bounds. At a tie the gradient is 0.5, as in JAX; ``torch.clamp`` gives 1.
    NaN propagates. Python-number bounds become 0-d tensors made on x's
    device (a fill, no host-to-device copy)."""
    if not isinstance(lo, torch.Tensor):
        lo = x.new_full((), lo)
    if not isinstance(hi, torch.Tensor):
        hi = x.new_full((), hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs`` semantics: the gradient at 0 is 1, as JAX's
    ``select(x >= 0, g, -g)`` gives it; ``torch.abs`` gives 0 there."""
    return torch.where(x >= 0, x, -x)
