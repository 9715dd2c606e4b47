"""CRNN right-hand sides, lane-batched (port of crnn_tpu/models/crnn.py:
make_crnn_rhs, make_crnn_scaled_rhs, make_crnn_arrhenius_rhs and
make_crnn_reversible_rhs).

    du = w_out @ exp(min(w_in^T @ log(clip(y, lb, ub)) + w_b, exp_cap))

The JAX package writes each RHS for one lane and batches it with ``vmap``;
here ``rhs(t, y (B, ns), w) -> (B, ns)`` takes the lane axis first, which is
the shape of the isothermal kernel (``ops/csrc/crnn_rhs.cu``) and of the
Arrhenius kernel (``ops/csrc/arrhenius_rhs.cu``, y (B, ns+1) with T last):
every call on a CUDA tensor is one kernel launch, with the backward by
autograd of the plain version. The exponent cap of 32 keeps the rates of wild trial steps
finite, so reverse-mode gradients are not poisoned by inf * 0. Every RHS
here is independent of t and is declared so (``ode/base.py:autonomous``).
The reversible RHS has no kernel in either package: it is plain torch on
every device.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import autonomous
from crnn_tpu_torch.ops.crnn_kernels import (make_arrhenius_ops,
                                             make_crnn_rhs_op)


def make_crnn_rhs(lb: float, ub: float, exp_cap: float = 32.0,
                  plain: bool = False) -> Callable:
    """Isothermal mass-action CRNN (case1). ``plain=True`` runs the plain
    version in place of the kernel on any device."""
    op = make_crnn_rhs_op(lb, ub, exp_cap, plain)

    @autonomous
    def rhs(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)

    return rhs


def make_crnn_scaled_rhs(lb: float, ub: float, dydt_scale: torch.Tensor,
                         exp_cap: float = 32.0, plain: bool = False) -> Callable:
    """CRNN with per-species dy/dt rescaling (robertson/rober_crnn.jl:113-116):
    the isothermal RHS times ``dydt_scale = yscale / t_end`` (ns,)."""
    op = make_crnn_rhs_op(lb, ub, exp_cap, plain)

    @autonomous
    def rhs(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out) * dydt_scale

    return rhs


def make_crnn_arrhenius_rhs(lb: float, ub: float, exp_cap: float = 32.0,
                            plain: bool = False) -> Callable:
    """Arrhenius CRNN (case2): temperature rides as the constant last state,
    the features are [log X; -1/(R*T)] (case2/case2.jl:113-118) and dT/dt =
    0. ``rhs(t, y (B, ns+1), w) -> (B, ns+1)`` runs the Arrhenius RHS kernel
    on a CUDA tensor; ``plain=True`` runs the plain version on any device."""
    op = make_arrhenius_ops(lb, ub, exp_cap, plain)[0]

    @autonomous
    def rhs(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)

    return rhs


def _capped_exp(z, exp_cap):
    return torch.exp(torch.minimum(z, z.new_full((), exp_cap)))


def make_crnn_reversible_rhs(lb: float, order_clip: float = 2.5,
                             exp_cap: float = 32.0) -> Callable:
    """Reversible CRNN with Kc = 1 (case1 rev/case1.jl:81-90): the forward
    and backward orders come from the shared w_out, ``clip(-w_out, 0,
    order_clip)`` and ``clip(w_out, 0, order_clip)``, and ``du = w_out @
    (exp(f) - exp(b))`` with the biases ``w_b`` and ``w_kb``; y is clipped
    to [lb, inf). ``rhs(t, y (B, ns), w) -> (B, ns)``."""

    @autonomous
    def rhs(t, y, w):
        w_in_f = clip(-w.w_out, 0.0, order_clip)
        w_in_b = clip(w.w_out, 0.0, order_clip)
        logx = torch.log(clip(y, lb, math.inf))
        fwd = _capped_exp(logx @ w_in_f + w.w_b, exp_cap)
        bwd = _capped_exp(logx @ w_in_b + w.w_kb, exp_cap)
        return (fwd - bwd) @ w.w_out.T

    return rhs
