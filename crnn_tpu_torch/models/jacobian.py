"""Closed-form Jacobians of the CRNN RHS, lane-batched (port of
crnn_tpu/models/jacobian.py:make_crnn_jac, make_crnn_scaled_jac and
make_crnn_arrhenius_jac).

    J[b] = (w_out . rates[b]) @ w_in^T . dlog[b],
    dlog = 1{lb < y < ub} / clip(y, lb, ub)   (strict bounds)

``jac(t, y (B, ns), w) -> (B, ns, ns)`` is the J of the isothermal
value+Jacobian kernel (``ops/csrc/crnn_rhs_jac.cu``), one launch per call on
a CUDA tensor; the Arrhenius J (B, ns+1, ns+1) is the J of the Arrhenius
value+Jacobian kernel (``ops/csrc/arrhenius_rhs_jac.cu``). Their gradient is
autograd of the plain version, as JAX differentiates its plain code.
"""

from __future__ import annotations

from typing import Callable

import torch

from crnn_tpu_torch.ops.crnn_kernels import (make_arrhenius_ops,
                                             make_crnn_rhs_jac_op)


def make_crnn_jac(lb: float, ub: float, exp_cap: float = 32.0,
                  plain: bool = False) -> Callable:
    """Jacobian of the isothermal CRNN RHS (pairs with make_crnn_rhs)."""
    op = make_crnn_rhs_jac_op(lb, ub, exp_cap, plain)

    def jac(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)[1]

    return jac


def make_crnn_scaled_jac(lb: float, ub: float, dydt_scale: torch.Tensor,
                         exp_cap: float = 32.0, plain: bool = False) -> Callable:
    """Jacobian of the scaled CRNN RHS (pairs with make_crnn_scaled_rhs): row
    i scaled by ``dydt_scale[i]``."""
    base = make_crnn_jac(lb, ub, exp_cap, plain)

    def jac(t, y, w):
        return base(t, y, w) * dydt_scale[:, None]

    return jac


def make_crnn_arrhenius_jac(lb: float, ub: float, exp_cap: float = 32.0,
                            plain: bool = False) -> Callable:
    """Jacobian of the Arrhenius CRNN RHS (pairs with
    make_crnn_arrhenius_rhs). State = [species..., T]; the x-block
    ``(w_out . rates) @ w_in_x^T . dlog``, the T column the rates'
    sensitivity through the -1/(R T) feature, the T row 0."""
    op = make_arrhenius_ops(lb, ub, exp_cap, plain)[1]

    def jac(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)[1]

    return jac
