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
Gauss-Jordan (``ode/linsolve.py``) and shared by the three W-solves.
``ft = df/dt`` at (t, y) comes from forward mode in t (``lane_dfdt``, the
JAX package's ``jax.jvp``), unless the RHS is declared autonomous where it
is written (``ode/base.py:autonomous``): then ft is exactly 0 and its two
terms are left out.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import (RHS, Solver, StepResult,
                                     hermite_interp_matrix_from_endpoints,
                                     is_autonomous)
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


def give_jac(solver: Solver, jac) -> Solver:
    """Give ``solver`` (or an AutoSwitch's stiff solver) the Jacobian
    ``jac(t, y, args)`` where it would take J by forward mode of the RHS it
    solves. A case whose f runs the kernel ops passes forward mode of the
    plain twin (``jac_by_forward_mode``), the function JAX's ``jacfwd``
    differentiates, as the kernel ops have no forward-mode rule; the f
    evaluations stay on the kernels. Returns ``solver``."""
    stiff = getattr(solver, "stiff", solver)
    if stiff.implicit and stiff.jac is None:
        stiff.jac = jac
    return solver


def jac_by_forward_mode(f: RHS):
    """``jac(t, y, args)``: ``lane_jacfwd`` of the plain-torch ``f`` in y."""
    return lambda t, y, args: lane_jacfwd(lambda yy: f(t, yy, args), y)


def lane_dfdt(f: RHS, t: torch.Tensor, y: torch.Tensor, args) -> torch.Tensor:
    """Per-lane ``df/dt (B, ns)`` at ``(t (B,), y (B, ns))``: one
    ``torch.func.jvp`` in t with a tangent of ones, which gives every lane's
    own df/dt because lanes are independent. ``f`` must be plain torch: the
    kernel ops have no forward-mode rule, and through them this raises."""
    try:
        return torch.func.jvp(lambda tt: f(tt, y, args), (t,),
                              (torch.ones_like(t),))[1]
    except RuntimeError as err:
        raise RuntimeError(
            "Rosenbrock23 takes df/dt of an RHS that is not declared "
            "autonomous by forward mode in t, which failed. An RHS on the "
            "kernel ops has no forward-mode rule: declare a t-independent "
            "RHS with crnn_tpu_torch.ode.base.autonomous where it is "
            f"written. ({err})") from err


class Rosenbrock23(Solver):
    """Adaptive 2(3) Rosenbrock-W method.

    ``jac(t (B,), y (B, ns), args) -> (B, ns, ns)`` gives a closed-form
    Jacobian (e.g. ``models/jacobian.py``); without it J is computed by
    forward mode (``lane_jacfwd``), the counterpart of ``jax.jacfwd``.
    df/dt is computed by forward mode for every RHS not declared autonomous
    (``lane_dfdt``).
    """

    order = 2
    n_stages = 3  # Hermite dense: [f0, f_end, (y1-y0)/dt]
    implicit = True

    def __init__(self, jac=None):
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
        # the non-autonomous term dt*d*ft, in JAX's order; exactly 0 for a
        # declared-autonomous RHS, so left out there
        dtd_ft = (None if is_autonomous(f)
                  else (dt * _D)[:, None] * lane_dfdt(f, t, y, args))
        k1 = wsolve(f0 if dtd_ft is None else f0 + dtd_ft)
        f1 = f(t + 0.5 * dt, y + (0.5 * h) * k1, args)
        k2 = wsolve(f1 - k1) + k1
        y1 = y + h * k2
        f2 = f(t + dt, y1, args)
        rhs3 = f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0)
        k3 = wsolve(rhs3 if dtd_ft is None else rhs3 + dtd_ft)
        y_err = (h / 6.0) * (k1 - 2.0 * k2 + k3)

        dense = torch.stack([f0, f2, (y1 - y) / h], dim=1)
        # pivot_ok: the no-pivot inverse can be finite but wrong when a
        # diagonal pivot of W crosses ~0, so the lane's step is rejected
        ok = (torch.all(torch.isfinite(y1), dim=-1)
              & torch.all(torch.isfinite(y_err), dim=-1) & pivot_ok(w, min_piv))
        return StepResult(y1=y1, y_err=y_err, dense=dense, state=f2, ok=ok)

    def interp_matrix(self, theta: torch.Tensor) -> torch.Tensor:
        return hermite_interp_matrix_from_endpoints(theta)
