"""Rosenbrock23: Shampine's 2(3) Rosenbrock W-method, lane-batched (port of
crnn_tpu/ode/rosenbrock.py:Rosenbrock23).

    d  = 1/(2 + sqrt(2)),  W = I - dt*d*J,   J = df/dy at (t, y)
    k1 = W^-1 (f0 + dt*d*ft)
    f1 = f(t + dt/2, y + dt/2 * k1)
    k2 = W^-1 (f1 - k1) + k1
    y1 = y + dt*k2
    f2 = f(t + dt, y1)
    k3 = W^-1 (f2 - e32*(k2 - f1) - 2*(k1 - f0) + dt*d*ft),  e32 = 6 + sqrt(2)
    err = dt/6 * (k1 - 2 k2 + k3)

Each lane has its own W, inverted once per step by the port's no-pivot
Gauss-Jordan (``ode/linsolve.py``) and shared by the three W-solves. The RHS
is autonomous in every case of the port so far, so ``ft`` (the JAX
package's ``jax.jvp`` in t) is exactly 0 and is left out;
``nonautonomous=True`` raises until a case needs it.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import (RHS, Solver, StepResult,
                                     hermite_interp_matrix_from_endpoints)
from crnn_tpu_torch.ode.linsolve import inv_small_nopivot_minpiv, pivot_ok

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)


def lane_jacfwd(fn, y: torch.Tensor) -> torch.Tensor:
    """Per-lane Jacobian ``J (B, ns, ns)`` of a lane-batched ``fn: y (B, ns)
    -> (B, ns)`` whose lanes are independent, by forward mode: ``jacfwd``'s
    ns basis tangents (the same unit vector in every lane) pushed through
    ``torch.func.jvp`` under ``torch.func.vmap``. ``fn`` must be plain torch
    (the kernel ops have no forward-mode rule)."""
    ns = y.shape[-1]
    basis = torch.eye(ns, dtype=y.dtype, device=y.device)[:, None, :]
    cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (y,), (v,))[1])(
        basis.expand(ns, *y.shape))                       # (ns_j, B, ns_i)
    return cols.permute(1, 2, 0)


class Rosenbrock23(Solver):
    """Adaptive 2(3) Rosenbrock-W method.

    ``jac(t (B,), y (B, ns), args) -> (B, ns, ns)`` gives a closed-form
    Jacobian (e.g. ``models/jacobian.py``); without it J is computed by
    forward mode (``lane_jacfwd``), the counterpart of ``jax.jacfwd``.
    """

    order = 2
    n_stages = 3  # Hermite dense: [f0, f_end, (y1-y0)/dt]

    def __init__(self, jac=None, nonautonomous: bool = False):
        if nonautonomous:
            raise NotImplementedError(
                "Rosenbrock23 with a nonautonomous RHS (df/dt) is not ported "
                "yet (crnn_tpu/ode/rosenbrock.py: ft by jax.jvp in t)")
        self.jac = jac

    def init(self, f: RHS, t0, y0, args) -> Any:
        return f(t0, y0, args)  # slope at (t, y): reused as f0

    def step(self, f: RHS, t, y, dt, args, state) -> StepResult:
        f0 = state
        if self.jac is not None:
            jac = self.jac(t, y, args)
        else:
            jac = lane_jacfwd(lambda yy: f(t, yy, args), y)

        eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
        w = eye[None] - (dt * _D)[:, None, None] * jac
        # clamp the inverse: a near-singular W from a huge trial dt must not
        # inject inf into the (rejected) step's gradient graph
        w_inv_raw, min_piv = inv_small_nopivot_minpiv(w)
        w_inv = clip(torch.nan_to_num(w_inv_raw, nan=0.0, posinf=1e18,
                                      neginf=-1e18), -1e18, 1e18)

        def wsolve(v):
            return torch.einsum("bij,bj->bi", w_inv, v)

        h = dt[:, None]
        k1 = wsolve(f0)
        f1 = f(t + 0.5 * dt, y + (0.5 * h) * k1, args)
        k2 = wsolve(f1 - k1) + k1
        y1 = y + h * k2
        f2 = f(t + dt, y1, args)
        k3 = wsolve(f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0))
        y_err = (h / 6.0) * (k1 - 2.0 * k2 + k3)

        dense = torch.stack([f0, f2, (y1 - y) / h], dim=1)
        # pivot_ok: the no-pivot inverse can be finite but wrong when a
        # diagonal pivot of W crosses ~0, so the lane's step is rejected
        ok = (torch.all(torch.isfinite(y1), dim=-1)
              & torch.all(torch.isfinite(y_err), dim=-1) & pivot_ok(w, min_piv))
        return StepResult(y1=y1, y_err=y_err, dense=dense, state=f2, ok=ok)

    def interp_matrix(self, theta: torch.Tensor) -> torch.Tensor:
        return hermite_interp_matrix_from_endpoints(theta)
