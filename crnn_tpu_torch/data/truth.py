"""Ground-truth mass-action systems, batched (port of crnn_tpu/data/truth.py:
case1, case2, case3, robertson, case1 rev, the GRN and yeast).

The JAX package writes each truth per lane and lets ``vmap`` batch it; here
each is written for a batch ``y (B, ns)`` with per-lane rate constants
``k (B, nk)``, and is declared autonomous (``ode/base.py:autonomous``).
case2 has its closed-form Jacobian too, for the dense W-solve of
``ode/batch_solve.py``.
"""

from __future__ import annotations

import torch

from crnn_tpu_torch.ode.base import autonomous

# case1 rate constants (case1/case1.jl:38-44).
CASE1_K = (0.1, 0.2, 0.13, 0.3)
# Robertson rate constants (robertson/rober_crnn.jl:54-61).
ROBERTSON_K = (4e-2, 3e7, 1e4)
# MAPK cascade rate constants (case3/case3.jl:83-103).
CASE3_K = (1.0,) * 8
# case1 rev: every forward and backward rate 1 (case1 rev/case1.jl:37-43).
REVERSIBLE_K = (1.0,) * 8
# gene regulatory network (gene-regulatory.jl:77-129).
GRN_K = (1.8, 2.1, 1.3, 1.5, 2.2, 2.0, 2.0, 2.5, 3.2, 3.0, 2.3, 2.5, 6.0, 4.0,
         3.0)
# yeast glycolysis rate constants and the per-species box of initial
# conditions (yeast_glycolysis.jl:41-74).
YEAST_K = (100.0, 6.0, 16.0, 100.0, 1.28, 12.0)
YEAST_IC_LB = (0.15, 1.19, 0.04, 0.10, 0.08, 0.14, 0.05)
YEAST_IC_UB = (1.60, 2.16, 0.20, 0.35, 0.30, 2.67, 0.10)
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


@autonomous
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


@autonomous
def case1_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """5 species / 4 reactions, isothermal (case1/case1.jl:38-44):
    2A->B (r~A^2), A->C, C->D, B+D->E. y (B, 5), k (B, 4) -> (B, 5)."""
    r1 = k[:, 0] * y[:, 0] ** 2
    r2 = k[:, 1] * y[:, 0]
    r3 = k[:, 2] * y[:, 2]
    r4 = k[:, 3] * y[:, 1] * y[:, 3]
    return torch.stack([-2.0 * r1 - r2, r1 - r4, r2 - r3, r3 - r4, r4], dim=1)


@autonomous
def robertson_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Robertson's stiff problem (robertson/rober_crnn.jl:54-61):
    y (B, 3), k (B, 3) -> (B, 3)."""
    r1 = k[:, 0] * y[:, 0]
    r2 = k[:, 1] * y[:, 1] * y[:, 1]
    r3 = k[:, 2] * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=1)


@autonomous
def case3_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """MAPK cascade, 9 species / 8 reactions (case3/case3.jl:83-103):
    y (B, 9), k (B, 8) -> (B, 9); species 0 is constant."""
    r1 = k[:, 0] * y[:, 0] * y[:, 1]
    r2 = k[:, 1] * y[:, 2] * y[:, 3]
    r3 = k[:, 2] * y[:, 4] * y[:, 5]
    r4 = k[:, 3] * y[:, 6] * y[:, 7]
    r5 = k[:, 4] * y[:, 2]
    r6 = k[:, 5] * y[:, 4]
    r7 = k[:, 6] * y[:, 6]
    r8 = k[:, 7] * y[:, 8]
    return torch.stack([torch.zeros_like(r1), -r1 + r5, r1 - r5, -r2 + r6,
                        r2 - r6, -r3 + r7, r3 - r7, -r4 + r8, r4 - r8], dim=1)


@autonomous
def reversible_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """case1 rev: A<->B, B<->C, C<->D, 2C<->D+E, mass action
    (case1 rev/case1.jl:37-43): y (B, 5), k (B, 8) -> (B, 5)."""
    a, b, c, d, e = y.unbind(dim=1)
    r1 = k[:, 0] * a - k[:, 1] * b
    r2 = k[:, 2] * b - k[:, 3] * c
    r3 = k[:, 4] * c - k[:, 5] * d
    r4 = k[:, 6] * c ** 2 - k[:, 7] * d * e
    return torch.stack([-r1, r1 - r2, r2 - r3 - 2.0 * r4, r3 + r4, r4], dim=1)


@autonomous
def grn_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Repressilator-like gene regulatory network, 9 species / 15 reactions
    (gene-regulatory.jl:77-129): y (B, 9), k (B, 15) -> (B, 9). The DNA
    species 0, 3 and 6 are constant: their rows are exact zeros."""
    r = [k[:, 0] * y[:, 0], k[:, 1] * y[:, 1], k[:, 2] * y[:, 1],
         k[:, 3] * y[:, 2], k[:, 4] * y[:, 3], k[:, 5] * y[:, 4],
         k[:, 6] * y[:, 4], k[:, 7] * y[:, 5], k[:, 8] * y[:, 6],
         k[:, 9] * y[:, 7], k[:, 10] * y[:, 7], k[:, 11] * y[:, 8],
         k[:, 12] * y[:, 7] * y[:, 2],     # mRNA_C + A -> A
         k[:, 13] * y[:, 4] * y[:, 8],     # mRNA_B + C -> C
         k[:, 14] * y[:, 1] * y[:, 5]]     # mRNA_A + B -> B
    z = torch.zeros_like(r[0])
    return torch.stack([z, r[0] - r[2] - r[14], r[1] - r[3], z,
                        r[4] - r[6] - r[13], r[5] - r[7], z,
                        r[8] - r[10] - r[12], r[9] - r[11]], dim=1)


@autonomous
def yeast_truth(t, y: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Yeast glycolysis, 7-species reduced model (yeast_glycolysis.jl:41-66),
    the constants q, K1, A, N, J0 and phi inline: y (B, 7), k (B, 6) ->
    (B, 7)."""
    q, big_k1, big_a, big_n, j0, phi = 4.0, 0.52, 4.0, 1.0, 2.5, 0.1
    r1 = k[:, 0] * y[:, 0] * y[:, 5] / (1.0 + (y[:, 5] / big_k1) ** q)
    r2 = k[:, 1] * y[:, 1] * (big_n - y[:, 4])
    r3 = k[:, 2] * y[:, 2] * (big_a - y[:, 5])
    r4 = k[:, 3] * y[:, 3] * y[:, 4]
    r5 = k[:, 4] * y[:, 5]
    r6 = k[:, 5] * y[:, 1] * y[:, 4]
    r7 = 13.0 * y[:, 6]
    r8 = 13.0 * (y[:, 3] - y[:, 6])
    return torch.stack([j0 - r1, 2.0 * r1 - r2 - r6, r2 - r3, r3 - r4 - r8,
                        r2 - r4 - r6, -2.0 * r1 + 2.0 * r3 - r5,
                        phi * r8 - r7], dim=1)
