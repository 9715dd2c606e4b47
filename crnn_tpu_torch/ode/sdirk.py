"""ESDIRK stiff solvers, TRBDF2 and Kvaerno3, with simplified Newton,
lane-batched (port of crnn_tpu/ode/sdirk.py).

An ESDIRK method has an explicit first stage (the FSAL slope at (t, y)) and
implicit stages that share one diagonal coefficient gamma, so one Jacobian
and one inverse of ``W = I - dt*gamma*J`` a step serve every stage's Newton
iterations. Each lane has its own W ``(B, ns, ns)``, inverted once a step by
the port's no-pivot Gauss-Jordan (``ode/linsolve.py``). Every stage runs
exactly ``max_newton_iters`` iterations, as the JAX ``fori_loop`` does, and
the gradient goes through all of them; a lane whose last increment is not
below 1 reports ``ok=False`` and the driver retries it with a smaller dt.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import (RHS, Solver, StepResult,
                                     hermite_interp_matrix_from_endpoints)
from crnn_tpu_torch.ode.linsolve import inv_small_nopivot_minpiv, pivot_ok
from crnn_tpu_torch.ode.rosenbrock import lane_jacfwd


class ESDIRKTableau(NamedTuple):
    a: tuple          # full lower-triangular matrix rows, a[i][j]
    c: tuple          # stage times
    b_err: tuple      # (b - bhat) error weights
    gamma: float      # shared diagonal coefficient of implicit stages
    order: int


def _trbdf2_tableau() -> ESDIRKTableau:
    # Hosea & Shampine (1996): gamma = 2 - sqrt(2), d = gamma/2, w = sqrt(2)/4
    g = 2.0 - math.sqrt(2.0)
    d = g / 2.0
    w = math.sqrt(2.0) / 4.0
    a = (
        (0.0, 0.0, 0.0),
        (d, d, 0.0),
        (w, w, d),  # stiffly accurate: b == last row
    )
    c = (0.0, g, 1.0)
    # bhat = [(1-w)/3, (3w+1)/3, d/3]  =>  b - bhat:
    b_err = ((4.0 * w - 1.0) / 3.0, -1.0 / 3.0, 2.0 * d / 3.0)
    return ESDIRKTableau(a=a, c=c, b_err=b_err, gamma=d, order=2)


def _kvaerno3_tableau() -> ESDIRKTableau:
    # Kvaerno (2004) ESDIRK 4/3 with gamma = 0.435866521508459. Row 3
    # (c3 = 1) is the embedded 2nd-order method; row 4 solves the
    # third-order conditions sum(b)=1, sum(b*c)=1/2, sum(b*c^2)=1/3
    g = 0.435866521508459
    a31 = (-4.0 * g * g + 6.0 * g - 1.0) / (4.0 * g)
    a32 = (-2.0 * g + 1.0) / (4.0 * g)
    a42 = 1.0 / (12.0 * g * (1.0 - 2.0 * g))
    a43 = 0.5 - g - 2.0 * g * a42
    a41 = 1.0 - g - a42 - a43
    a = (
        (0.0, 0.0, 0.0, 0.0),
        (g, g, 0.0, 0.0),
        (a31, a32, g, 0.0),
        (a41, a42, a43, g),  # stiffly accurate
    )
    c = (0.0, 2.0 * g, 1.0, 1.0)
    # embedded 2nd order bhat = row 3: [a31, a32, g, 0]
    b_err = (a41 - a31, a42 - a32, a43 - g, g)
    return ESDIRKTableau(a=a, c=c, b_err=b_err, gamma=g, order=3)


def _matvec(m, v):
    return torch.einsum("bij,bj->bi", m, v)


class ESDIRK(Solver):
    """Stiffly accurate ESDIRK with simplified-Newton stage solves.

    ``jac(t (B,), y (B, ns), args) -> (B, ns, ns)`` gives the Jacobian;
    without it J is taken by forward mode (``lane_jacfwd``), which needs a
    plain-torch RHS (the kernel ops have no forward-mode rule).
    """

    n_stages = 3  # Hermite dense: [f0, f_end, (y1-y0)/dt]
    implicit = True

    def __init__(self, tableau: ESDIRKTableau, max_newton_iters: int = 8,
                 newton_rtol: float = 1e-7, newton_atol: float = 1e-10,
                 jac=None):
        self.tab = tableau
        self.order = tableau.order
        self.max_newton_iters = max_newton_iters
        self.newton_rtol = newton_rtol
        self.newton_atol = newton_atol
        self.jac = jac

    def init(self, f: RHS, t0, y0, args) -> Any:
        return f(t0, y0, args)

    def step(self, f: RHS, t, y, dt, args, state) -> StepResult:
        tab = self.tab
        n_stage = len(tab.c)
        h = dt[:, None]
        dtg = (dt * tab.gamma)[:, None]

        if self.jac is not None:
            jac = self.jac(t, y, args)
        else:
            jac = lane_jacfwd(lambda yy: f(t, yy, args), y)
        eye = torch.eye(y.shape[-1], dtype=y.dtype, device=y.device)
        w = eye[None] - dtg[:, :, None] * jac
        # a near-singular W (huge trial dt) can overflow the inverse: clamp
        # it, so the rejected step's gradient stays finite
        w_inv_raw, min_piv = inv_small_nopivot_minpiv(w)
        w_inv = clip(torch.nan_to_num(w_inv_raw, nan=0.0, posinf=1e18,
                                      neginf=-1e18), -1e18, 1e18)
        scale = self.newton_atol + self.newton_rtol * torch.abs(y)

        def newton_stage(t_stage, y_base, k):
            """Solve k = f(t_stage, y_base + dt*gamma*k) per lane."""
            inc = torch.full_like(dt, math.inf)
            for _ in range(self.max_newton_iters):
                resid = k - f(t_stage, y_base + dtg * k, args)
                delta = _matvec(w_inv, resid)
                # bound the iterate: a diverging Newton must not overflow,
                # or the backward pass meets inf*0 of a discarded step
                k = clip(k - delta, -1e16, 1e16)
                # convergence monitor only, kept out of the gradient
                inc = torch.sqrt(torch.mean((delta * h / scale) ** 2,
                                            dim=-1)).detach()
            converged = (inc < 1.0) & torch.all(torch.isfinite(k), dim=-1)
            return k, converged

        ks = [state]  # explicit first stage: the FSAL slope at (t, y)
        ok = torch.all(torch.isfinite(state), dim=-1)
        for i in range(1, n_stage):
            y_base = y + h * sum(tab.a[i][j] * ks[j] for j in range(i))
            k_i, conv = newton_stage(t + tab.c[i] * dt, y_base, ks[-1])
            ks.append(k_i)
            ok = ok & conv

        # stiffly accurate: y1 = the last stage's Y
        y1 = y + h * sum(tab.a[-1][j] * ks[j] for j in range(n_stage))
        f_end = ks[-1]  # slope at (t+dt, y1): the FSAL carry
        err_raw = h * sum(tab.b_err[j] * ks[j] for j in range(n_stage))
        # the error filtered through W^-1 (no order reduction of the
        # estimate on very stiff modes)
        y_err = _matvec(w_inv, err_raw)

        dense = torch.stack([ks[0], f_end, (y1 - y) / h], dim=1)
        # pivot_ok: a finite but wrong no-pivot inverse rejects the step
        ok = ok & torch.all(torch.isfinite(y1), dim=-1) & pivot_ok(w, min_piv)
        return StepResult(y1=y1, y_err=y_err, dense=dense, state=f_end, ok=ok)

    def interp_matrix(self, theta: torch.Tensor) -> torch.Tensor:
        return hermite_interp_matrix_from_endpoints(theta)


def TRBDF2(**kwargs) -> ESDIRK:
    """TR-BDF2 ESDIRK 2(3), the reference's ``TRBDF2(autodiff=true)``."""
    return ESDIRK(_trbdf2_tableau(), **kwargs)


def Kvaerno3(**kwargs) -> ESDIRK:
    """Kvaerno's ESDIRK 3(2), stiffly accurate and L-stable."""
    return ESDIRK(_kvaerno3_tableau(), **kwargs)
