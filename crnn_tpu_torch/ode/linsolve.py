"""Small batched inverses for the W-solve (port of
crnn_tpu/ode/linsolve.py:inv_small_nopivot_minpiv, pivot_ok)."""

from __future__ import annotations

import math

import torch


def inv_small_nopivot_minpiv(a: torch.Tensor):
    """Gauss-Jordan inverse WITHOUT pivoting of a batch ``a (B, n, n)``.

    Returns ``(inv (B, n, n), min_abs_pivot (B,))``; a pivot that crosses ~0
    gives a finite but wrong inverse, which ``pivot_ok`` detects. Written
    out of place so that autograd differentiates through it.
    """
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a)
    aug = torch.cat([a, eye], dim=-1)                      # (B, n, 2n)
    rows = torch.arange(n, device=a.device)
    min_piv = torch.full(a.shape[:-2], math.inf, dtype=a.dtype,
                         device=a.device)
    for col in range(n):
        pivval = aug[..., col, col]
        min_piv = torch.minimum(min_piv, torch.abs(pivval))
        pivrow = aug[..., col, :] / pivval[..., None]
        factors = torch.where(rows == col, torch.zeros_like(aug[..., col]),
                              aug[..., col])
        aug = aug - factors[..., :, None] * pivrow[..., None, :]
        aug = torch.where((rows == col)[:, None], pivrow[..., None, :], aug)
    return aug[..., n:], min_piv


def pivot_ok(a: torch.Tensor, min_piv: torch.Tensor) -> torch.Tensor:
    """True iff no pivot fell below sqrt(eps) * max(1, ||a||_max)."""
    eps = torch.finfo(a.dtype).eps
    scale = torch.clamp(torch.amax(torch.abs(a), dim=(-2, -1)), min=1.0)
    return min_piv > math.sqrt(eps) * scale
