"""Compensated-f32 batch Rosenbrock23 (port of crnn_tpu/ode/compensated.py).

The method, controller and dense output of ``batch_odesolve_rb23``
(``ode/batch_solve.py``, dense J), with the state carried as an unevaluated
pair ``y_hi + y_lo`` and the step update ``y1 = y + dt*k2`` done in
error-free two-sum arithmetic. The stages stay plain arithmetic at
``y = y_hi + y_lo``. Its one caller is the robertson f32 experiment
(``scripts/robertson_comp32_torch.py``): it asks whether the f32 training
floor comes from the accumulation of ~192 steps (which compensation
removes) or from the stage math (which it does not reach).

Autonomous systems only; ``f_jac(t, y, args) -> (f0 (B, ns), J (B, ns,
ns))``. The fixed ``max_steps`` loop recomputes every step in the backward
pass (``torch.utils.checkpoint``, JAX's ``jax.checkpoint`` under
``lax.scan``); gradients flow through the compensated update (two-sum is
piecewise linear).
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import hermite_interp_matrix_from_endpoints
from crnn_tpu_torch.ode.batch_solve import BatchODESolution
from crnn_tpu_torch.ode.controller import error_norm, first_step, propose_dt
from crnn_tpu_torch.ode.linsolve import inv_small_nopivot_minpiv, pivot_ok

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)

_RUNNING = 0
_DONE = 1
_FAILED = 2


def two_sum(a, b):
    """Error-free transform (Knuth, Moller): ``a + b = s + e`` exactly, each
    add rounded on its own."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def batch_odesolve_rb23_comp(
    f,
    f_jac,
    y0: torch.Tensor,
    t0,
    t1,
    saveat: torch.Tensor,
    args: Any = None,
    rtol=1e-3,
    atol=1e-6,
    dt0=None,
    max_steps: int = 4096,
    safety: float = 0.9,
    factor_min: float = 0.2,
    factor_max: float = 10.0,
    dtmin_frac: float = 1e-12,
) -> BatchODESolution:
    """``batch_odesolve_rb23`` with the compensated (hi, lo) state update."""
    dtype, device = y0.dtype, y0.device
    b, ns = y0.shape
    t0, t1 = float(t0), float(t1)
    saveat = saveat.to(dtype)
    if isinstance(atol, torch.Tensor):
        atol = atol.to(dtype)
    dtmin = dtmin_frac * (t1 - t0)
    order = 2

    dt_init = first_step(dt0, f, t0, t1, y0, args, order, rtol, atol)
    ys0 = torch.where((saveat <= t0)[None, :, None], y0[:, None, :],
                      torch.zeros((b, saveat.shape[0], ns), dtype=dtype,
                                  device=device))
    zero = torch.zeros((), dtype=dtype, device=device)
    eye = torch.eye(ns, dtype=dtype, device=device)

    def body(t, y_hi, y_lo, dt_s, ys, status, n_steps):
        running = status == _RUNNING
        t_rem = t1 - t
        clipped = dt_s >= t_rem
        dt = torch.where(running, torch.minimum(dt_s, t_rem), dt_s)
        dt = torch.maximum(dt, zero)

        # the stages are evaluated at the best rounding of the (hi, lo) state
        y = y_hi + y_lo
        hd = dt * _D
        f0, jac = f_jac(t, y, args)
        w = eye[None] - hd[:, None, None] * jac
        w_inv_raw, min_piv = inv_small_nopivot_minpiv(w)
        piv_good = pivot_ok(w, min_piv)
        w_inv = clip(torch.nan_to_num(w_inv_raw, nan=0.0, posinf=1e18,
                                      neginf=-1e18), -1e18, 1e18)

        def wsolve(v):
            return torch.einsum("bij,bj->bi", w_inv, v)

        k1 = wsolve(f0)
        f1 = f(t + 0.5 * dt, y + (0.5 * dt)[:, None] * k1, args)
        k2 = wsolve(f1 - k1) + k1
        # ---- compensated update: y1 = y + dt*k2 with its rounding error kept.
        # two_sum is error-free only if every add and the product dt*k2 are
        # rounded on their own. Eager PyTorch runs each op as its own kernel,
        # so nothing contracts dt*k2 into the add as an FMA: do not
        # torch.compile or fuse these lines; a fused kernel would have to use
        # __fmul_rn / __fadd_rn.
        inc = dt[:, None] * k2
        s_hi, e = two_sum(y_hi, inc)
        lo_acc = y_lo + e
        y1_hi, y1_lo = two_sum(s_hi, lo_acc)     # renormalise the pair
        y1 = y1_hi + y1_lo
        f2 = f(t + dt, y1, args)
        k3 = wsolve(f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0))
        y_err = (dt / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)

        ok = (torch.all(torch.isfinite(y1), dim=-1)
              & torch.all(torch.isfinite(y_err), dim=-1) & piv_good.detach())
        err = error_norm(y_err, y, y1, rtol, atol).detach()
        err = torch.where(ok, err, torch.full_like(err, math.inf))
        accept = err <= 1.0
        t_new = t + dt

        theta = clip((saveat[None, :] - t[:, None])
                     / torch.clamp(dt, min=1e-30)[:, None], 0.0, 1.0)
        bmat = hermite_interp_matrix_from_endpoints(theta)
        dense = torch.stack([f0, f2, (y1 - y) / dt[:, None]], dim=1)
        y_interp = y[:, None, :] + dt[:, None, None] * torch.einsum(
            "bsk,bkn->bsn", bmat, dense)
        y_interp = torch.where(torch.isfinite(y_interp), y_interp,
                               torch.zeros_like(y_interp))
        fill = (running & accept)[:, None] & (
            (saveat[None, :] > t[:, None]) & (saveat[None, :] <= t_new[:, None]))
        ys = torch.where(fill[:, :, None], y_interp, ys)

        dt_next = propose_dt(dt, err, accept, order, safety, factor_min,
                             factor_max).detach()
        adv = running & accept
        finished = accept & clipped
        too_small = dt_next < dtmin
        new_status = torch.where(
            finished, _DONE, torch.where(too_small, _FAILED, _RUNNING)
        ).to(status.dtype)

        hi_safe = torch.where(torch.isfinite(y1_hi), y1_hi,
                              torch.zeros_like(y1_hi))
        lo_safe = torch.where(torch.isfinite(y1_lo), y1_lo,
                              torch.zeros_like(y1_lo))
        return (
            torch.where(adv, t_new.detach(), t),
            torch.where(adv[:, None], hi_safe, y_hi),
            torch.where(adv[:, None], lo_safe, y_lo),
            torch.where(running, dt_next, dt_s),
            ys,
            torch.where(running, new_status, status),
            n_steps + running.to(n_steps.dtype),
        )

    carry = (
        torch.full((b,), t0, dtype=dtype, device=device),
        y0,
        torch.zeros_like(y0),
        dt_init,
        ys0,
        torch.zeros((b,), dtype=torch.int32, device=device),
        torch.zeros((b,), dtype=torch.int32, device=device),
    )
    for _ in range(max_steps):
        carry = checkpoint(body, *carry, use_reentrant=False)

    t_f, y_hi, y_lo, _, ys, status, n_steps = carry
    return BatchODESolution(ts=saveat, ys=ys, success=status == _DONE,
                            n_steps=n_steps, final_t=t_f, final_y=y_hi + y_lo)
