"""Batch-major adaptive Rosenbrock23 (port of crnn_tpu/ode/batch_solve.py).

The carry is batch-major, ``(B, ...)``, and each step issues one
whole-batch evaluation of the RHS and its Jacobian. Semantics are those of
the JAX solve: Shampine 2(3) W-method, per-lane I-controller whose step
decisions carry no gradient (``.detach()`` exactly where JAX applies
``stop_gradient``), cubic-Hermite ``saveat`` output, and status masking of
finished and failed lanes.

``jac_mode='dense'``: ``f_jac(t, y, args) -> (du (B, ns), J (B, ns, ns))``.
``jac_mode='lowrank'``: ``f_jac -> (du, U (ns, nr), V (B, nr, ns))`` with
J = U @ V, and the W-solve uses the Woodbury identity
``(I - h d U V)^-1 v = v + h d U (I_nr - h d V U)^-1 V v``.

``nonautonomous=True`` (a t-dependent RHS, e.g. the cathode's heating
ramp): ``f_jac`` returns ``ft = df/dt (B, ns)`` as one more, last element,
and Shampine's ``dt*d*ft`` term is added to the k1 and k3 stage RHS, as the
per-lane Rosenbrock23 adds it. ``f`` is then called with a ``(B,)`` t.

``unroll='scan'`` runs a fixed ``max_steps`` loop whose every step is
recomputed in the backward pass (``torch.utils.checkpoint``, the
counterpart of ``jax.checkpoint``). ``unroll='while'`` stops as soon as no
lane is running, which costs one host sync per step.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import hermite_interp_matrix_from_endpoints
from crnn_tpu_torch.ode.controller import (error_norm, first_step,
                                           propose_dt)
from crnn_tpu_torch.ode.linsolve import inv_small_nopivot_minpiv, pivot_ok

_D = 1.0 / (2.0 + math.sqrt(2.0))
_E32 = 6.0 + math.sqrt(2.0)

_RUNNING = 0
_DONE = 1
_FAILED = 2


class BatchODESolution(NamedTuple):
    ts: torch.Tensor       # (n_save,)
    ys: torch.Tensor       # (B, n_save, ns)
    success: torch.Tensor  # (B,) bool
    n_steps: torch.Tensor  # (B,)
    final_t: torch.Tensor  # (B,)
    final_y: torch.Tensor  # (B, ns)


def batch_odesolve_rb23(
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
    unroll: str = "scan",
    safety: float = 0.9,
    factor_min: float = 0.2,
    factor_max: float = 10.0,
    dtmin_frac: float = 1e-12,
    jac_mode: str = "dense",
    nonautonomous: bool = False,
) -> BatchODESolution:
    """Integrate all B lanes from t0 to t1 with one f/J evaluation per step.
    ``dt0``: the first step, a scalar or per lane ``(B,)``; None takes
    Hairer's ``initial_step``."""
    if jac_mode not in ("dense", "lowrank"):
        raise ValueError(f"unknown jac_mode: {jac_mode!r}")
    if unroll not in ("scan", "while"):
        raise ValueError(f"unknown unroll mode: {unroll!r}")
    dtype, device = y0.dtype, y0.device
    b, ns = y0.shape
    t0, t1 = float(t0), float(t1)
    saveat = saveat.to(dtype)
    dtmin = dtmin_frac * (t1 - t0)
    order = 2

    # f_jac's outputs: (du, J) or (du, U, V), then ft when t-dependent
    n_out = (2 if jac_mode == "dense" else 3) + int(nonautonomous)

    def jac_outputs(t, y):
        out = f_jac(t, y, args)
        if len(out) != n_out:
            raise ValueError(
                f"f_jac returned {len(out)} outputs; jac_mode={jac_mode!r} "
                f"with nonautonomous={nonautonomous} needs {n_out}"
                + (" (the last one df/dt)" if nonautonomous else ""))
        return out

    dt_init = first_step(dt0, f, t0, t1, y0, args, order, rtol, atol)

    ys0 = torch.where((saveat <= t0)[None, :, None], y0[:, None, :],
                      torch.zeros((b, saveat.shape[0], ns), dtype=dtype,
                                  device=device))
    zero = torch.zeros((), dtype=dtype, device=device)
    eye = torch.eye(ns, dtype=dtype, device=device)

    def body(t, y, dt_s, ys, status, n_steps):
        running = status == _RUNNING
        t_rem = t1 - t
        clipped = dt_s >= t_rem
        dt = torch.where(running, torch.minimum(dt_s, t_rem), dt_s)
        dt = torch.maximum(dt, zero)

        # ---- one whole-batch value + Jacobian evaluation -----------------
        hd = dt * _D
        jac_out = jac_outputs(t, y)
        if jac_mode == "lowrank":
            f0, u_fac, v_fac = jac_out[:3]
            nr = u_fac.shape[1]
            # inner matrix M = I_nr - h*d * V U, shared by all three solves
            m = torch.eye(nr, dtype=dtype, device=device)[None] \
                - hd[:, None, None] * torch.einsum("brj,jq->brq", v_fac, u_fac)
            m_inv_raw, min_piv = inv_small_nopivot_minpiv(m)
            piv_good = pivot_ok(m, min_piv)
            m_inv = clip(torch.nan_to_num(m_inv_raw, nan=0.0, posinf=1e18,
                                          neginf=-1e18), -1e18, 1e18)

            def wsolve(v):  # Woodbury: v + h*d*U M^-1 V v
                s_r = torch.einsum("brj,bj->br", v_fac, v)
                return v + hd[:, None] * torch.einsum(
                    "jq,bq->bj", u_fac, torch.einsum("bqr,br->bq", m_inv, s_r))
        else:
            f0, jac = jac_out[:2]
            w = eye[None] - hd[:, None, None] * jac
            w_inv_raw, min_piv = inv_small_nopivot_minpiv(w)
            piv_good = pivot_ok(w, min_piv)
            w_inv = clip(torch.nan_to_num(w_inv_raw, nan=0.0, posinf=1e18,
                                          neginf=-1e18), -1e18, 1e18)

            def wsolve(v):
                return torch.einsum("bij,bj->bi", w_inv, v)

        # Shampine's dt*d*ft stage term, in JAX's order of additions
        dtd_ft = hd[:, None] * jac_out[-1] if nonautonomous else None
        k1 = wsolve(f0 if dtd_ft is None else f0 + dtd_ft)
        f1 = f(t + 0.5 * dt, y + (0.5 * dt)[:, None] * k1, args)
        k2 = wsolve(f1 - k1) + k1
        y1 = y + dt[:, None] * k2
        f2 = f(t + dt, y1, args)
        rhs3 = f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0)
        k3 = wsolve(rhs3 if dtd_ft is None else rhs3 + dtd_ft)
        y_err = (dt / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)

        # piv_good: a near-zero no-pivot diagonal gives a finite but wrong
        # inverse and error estimate, so the lane's step is rejected
        ok = (torch.all(torch.isfinite(y1), dim=-1)
              & torch.all(torch.isfinite(y_err), dim=-1) & piv_good)
        err = error_norm(y_err, y, y1, rtol, atol).detach()
        err = torch.where(ok, err, torch.full_like(err, math.inf))
        accept = err <= 1.0
        t_new = t + dt

        # ---- dense saveat fill over (t, t_new] per lane ------------------
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

        y1_safe = torch.where(torch.isfinite(y1), y1, torch.zeros_like(y1))
        return (
            torch.where(adv, t_new.detach(), t),
            torch.where(adv[:, None], y1_safe, y),
            torch.where(running, dt_next, dt_s),
            ys,
            torch.where(running, new_status, status),
            n_steps + running.to(n_steps.dtype),
        )

    carry = (
        torch.full((b,), t0, dtype=dtype, device=device),
        y0,
        dt_init,
        ys0,
        torch.zeros((b,), dtype=torch.int32, device=device),
        torch.zeros((b,), dtype=torch.int32, device=device),
    )
    if unroll == "while":
        while bool(torch.any((carry[4] == _RUNNING) & (carry[5] < max_steps))):
            carry = body(*carry)
    else:
        for _ in range(max_steps):
            carry = checkpoint(body, *carry, use_reentrant=False)

    t_f, y_f, _, ys, status, n_steps = carry
    return BatchODESolution(ts=saveat, ys=ys, success=status == _DONE,
                            n_steps=n_steps, final_t=t_f, final_y=y_f)
