"""case2 ground truth, batched (port of crnn_tpu/data/truth.py:case2_truth).

The JAX package writes the truth per lane and lets ``vmap`` batch it; here
it is written for a batch ``y (B, 7)`` with per-lane rate constants
``k (B, 3)``, together with its closed-form Jacobian for the dense W-solve
of ``ode/batch_solve.py``.
"""

from __future__ import annotations

import torch

# Biodiesel transesterification constants (case2/case2.jl:55-59).
CASE2_LOGA = (18.60, 19.13, 7.93)
CASE2_EA = (14.54, 14.42, 6.47)  # kcal/mol
_R_KCAL = 1.98720425864083e-3


def case2_arrhenius(log_a: torch.Tensor, ea: torch.Tensor,
                    temp: torch.Tensor) -> torch.Tensor:
    """k = exp(logA) * exp(-Ea/(R T)); temp (B,) -> k (B, 3)."""
    return torch.exp(log_a)[None, :] * torch.exp(-ea[None, :] / _R_KCAL
                                                 / temp[:, None])


def _rates(y, k):
    r1 = k[:, 0] * y[:, 0] * y[:, 1]
    r2 = k[:, 1] * y[:, 2] * y[:, 1]
    r3 = k[:, 2] * y[:, 3] * y[:, 1]
    return r1, r2, r3


def case2_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """6 species + T (case2/case2.jl:37-51): y (B, 7), k (B, 3) -> (B, 7);
    dT/dt = 0."""
    r1, r2, r3 = _rates(y, k)
    return torch.stack([
        -r1,
        -r1 - r2 - r3,
        r1 - r2,
        r2 - r3,
        r3,
        r1 + r2 + r3,
        torch.zeros_like(r1),
    ], dim=1)


def case2_truth_jac(t, y: torch.Tensor, k: torch.Tensor):
    """(du (B, 7), J (B, 7, 7)): the closed-form Jacobian, row by row the
    same combination of the rate gradients dr_i/dy as du is of the r_i."""
    b = y.shape[0]
    dr = torch.zeros((3, b, 7), dtype=y.dtype, device=y.device)
    dr[0, :, 0] = k[:, 0] * y[:, 1]
    dr[0, :, 1] = k[:, 0] * y[:, 0]
    dr[1, :, 1] = k[:, 1] * y[:, 2]
    dr[1, :, 2] = k[:, 1] * y[:, 1]
    dr[2, :, 1] = k[:, 2] * y[:, 3]
    dr[2, :, 3] = k[:, 2] * y[:, 1]
    d1, d2, d3 = dr
    jac = torch.stack([-d1, -d1 - d2 - d3, d1 - d2, d2 - d3, d3,
                       d1 + d2 + d3, torch.zeros_like(d1)], dim=1)
    return case2_truth(t, y, k), jac
