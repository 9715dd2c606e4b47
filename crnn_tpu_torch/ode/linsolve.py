"""Small batched inverses for the W-solve (port of
crnn_tpu/ode/linsolve.py): Gauss-Jordan with partial pivoting
(``inv_small``, ``solve_small``) and without (``inv_small_nopivot_minpiv``
with its ``pivot_ok`` guard, the solvers' W-solve). Every function takes a
batch ``(..., n, n)`` and unrolls the elimination over the small n."""

from __future__ import annotations

import math

import torch


def inv_small(a: torch.Tensor) -> torch.Tensor:
    """Gauss-Jordan inverse with partial pivoting of ``a (..., n, n)``: each
    matrix picks its own pivot row (the largest |entry| on or below the
    diagonal, the first of ties) and the row swap is a gather, so a batch
    needs no branch. A singular matrix gives inf/nan entries, never an
    error."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a)
    aug = torch.cat([a, eye], dim=-1)                      # (..., n, 2n)
    rows = torch.arange(n, device=a.device)
    for col in range(n):
        col_vals = torch.where(rows >= col, torch.abs(aug[..., col]),
                               -math.inf)
        piv = torch.argmax(col_vals, dim=-1, keepdim=True)  # (..., 1)
        perm = torch.where(rows == col, piv,
                           torch.where(rows == piv, col, rows))
        aug = torch.gather(aug, -2, perm[..., None].expand_as(aug))
        pivrow = aug[..., col, :] / aug[..., col, col, None]
        factors = torch.where(rows == col, torch.zeros_like(aug[..., col]),
                              aug[..., col])
        aug = aug - factors[..., :, None] * pivrow[..., None, :]
        aug = torch.where((rows == col)[:, None], pivrow[..., None, :], aug)
    return aug[..., n:]


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


def inv_small_nopivot(a: torch.Tensor) -> torch.Tensor:
    """``inv_small_nopivot_minpiv`` without the pivot diagnostic."""
    return inv_small_nopivot_minpiv(a)[0]


def solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a @ x = b`` for one right-hand side ``b (..., n)``."""
    return torch.einsum("...ij,...j->...i", inv_small(a), b)
