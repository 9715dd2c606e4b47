"""Ground-truth mass-action systems, batched (port of crnn_tpu/data/truth.py:
case1, case2 and robertson).

The JAX package writes each truth per lane and lets ``vmap`` batch it; here
each is written for a batch ``y (B, ns)`` with per-lane rate constants
``k (B, nk)``. case2 has its closed-form Jacobian too, for the dense W-solve
of ``ode/batch_solve.py``.
"""

from __future__ import annotations

import torch

# case1 rate constants (case1/case1.jl:38-44).
CASE1_K = (0.1, 0.2, 0.13, 0.3)
# Robertson rate constants (robertson/rober_crnn.jl:54-61).
ROBERTSON_K = (4e-2, 3e7, 1e4)
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


def case1_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """5 species / 4 reactions, isothermal (case1/case1.jl:38-44):
    2A->B (r~A^2), A->C, C->D, B+D->E. y (B, 5), k (B, 4) -> (B, 5)."""
    r1 = k[:, 0] * y[:, 0] ** 2
    r2 = k[:, 1] * y[:, 0]
    r3 = k[:, 2] * y[:, 2]
    r4 = k[:, 3] * y[:, 1] * y[:, 3]
    return torch.stack([-2.0 * r1 - r2, r1 - r4, r2 - r3, r3 - r4, r4], dim=1)


def robertson_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Robertson's stiff problem (robertson/rober_crnn.jl:54-61):
    y (B, 3), k (B, 3) -> (B, 3)."""
    r1 = k[:, 0] * y[:, 0]
    r2 = k[:, 1] * y[:, 1] * y[:, 1]
    r3 = k[:, 2] * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=1)
