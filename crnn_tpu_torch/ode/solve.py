"""odesolve: fixed-shape adaptive integration of a batch of lanes (port of
crnn_tpu/ode/solve.py:odesolve).

The JAX package writes ``odesolve`` for one lane and batches it with
``jax.vmap``. This port writes that batch out: ``y0 (B, ns)`` is B
independent lanes, and every lane carries its own ``(t, y, dt, solver
state, status)``. Finished and failed lanes keep running the step body with
their last stable dt and have its results masked, as the vmapped JAX loop
does. Every reduction is over a lane's state axis, never over lanes.

- ``saveat`` output is filled during stepping: after each accepted step of a
  lane, the save times in ``(t, t + dt]`` are filled from the solver's dense
  interpolant (``ys (B, n_save, ns)``).
- ``unroll='scan'`` runs a fixed ``max_steps`` loop whose every step is
  recomputed in the backward pass (``torch.utils.checkpoint``, the
  counterpart of ``jax.checkpoint`` under ``lax.scan``): the reverse-mode
  training path.
- ``unroll='while'`` stops as soon as no lane is running, which costs one
  host sync per step: the evaluation and data-generation path.
- Step-size decisions are ``.detach()``-ed where JAX applies
  ``stop_gradient``: gradients see a fixed accepted-step sequence.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import RHS, Solver
from crnn_tpu_torch.ode.controller import (error_norm, first_step,
                                           propose_dt, propose_dt_pi)

_RUNNING = 0
_DONE = 1
_FAILED = 2


class ODESolution(NamedTuple):
    ts: torch.Tensor               # (n_save,) requested save times
    ys: torch.Tensor               # (B, n_save, ns) interpolated solution
    success: torch.Tensor          # (B,) bool: reached t1 (or an event)
    n_steps: torch.Tensor          # (B,) attempted steps
    n_accepted: torch.Tensor       # (B,)
    n_rejected: torch.Tensor       # (B,)
    final_t: torch.Tensor          # (B,)
    final_y: torch.Tensor          # (B, ns)
    event_triggered: torch.Tensor  # (B,) bool: terminated early by event_fn


class _Carry(NamedTuple):
    t: torch.Tensor
    y: torch.Tensor
    dt: torch.Tensor
    solver_state: Any
    ys: torch.Tensor
    status: torch.Tensor
    n_steps: torch.Tensor
    n_accepted: torch.Tensor
    n_rejected: torch.Tensor
    prev_err: torch.Tensor
    event: torch.Tensor


def _lane_select(pred, a, b):
    """``where(pred, a, b)`` per lane for the solver state: a tensor whose
    leading axis is the lane axis, or a tuple of them (AutoSwitch's
    NamedTuple), selected field by field as JAX's ``_tree_select`` maps."""
    if isinstance(a, tuple):
        return type(a)(*(_lane_select(pred, x, y) for x, y in zip(a, b)))
    return torch.where(pred.view(-1, *([1] * (a.dim() - 1))), a, b)


def _finite_or_zero(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def odesolve(
    f: RHS,
    solver: Solver,
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
    controller: str = "i",
    event_fn=None,
) -> ODESolution:
    """Integrate dy/dt = f(t, y, args) for every lane of ``y0 (B, ns)`` from
    the shared ``t0`` to ``t1``, saving at ``saveat (n_save,)``.

    ``f(t (B,), y (B, ns), args) -> (B, ns)``. ``atol`` may be a per-species
    vector (ns,).
    ``dt0``: the first step, a scalar or per lane ``(B,)``; None takes
    Hairer's ``initial_step``. It carries no gradient.
    ``controller``: 'i' (integral) or 'pi' (proportional-integral).
    ``event_fn(t (B,), y (B, ns), args) -> (B,) bool`` terminates a lane
    after an accepted step; its later save times are forward-filled with
    the state at the event.
    """
    if unroll not in ("scan", "while"):
        raise ValueError(f"unknown unroll mode: {unroll!r}")
    if controller not in ("i", "pi"):
        raise ValueError(f"unknown controller: {controller!r}")
    dtype, device = y0.dtype, y0.device
    b, ns = y0.shape
    t0, t1 = float(t0), float(t1)
    saveat = saveat.to(dtype)
    if isinstance(atol, torch.Tensor):
        atol = atol.to(dtype)
    dtmin = dtmin_frac * (t1 - t0)

    dt_init = first_step(dt0, f, t0, t1, y0, args, solver.order, rtol,
                         atol)

    t_init = torch.full((b,), t0, dtype=dtype, device=device)
    solver_state0 = solver.init(f, t_init, y0, args)
    # save times at or before t0 start as y0
    ys0 = torch.where((saveat <= t0)[None, :, None], y0[:, None, :],
                      torch.zeros((b, saveat.shape[0], ns), dtype=dtype,
                                  device=device))
    zeros_i = torch.zeros((b,), dtype=torch.int32, device=device)
    carry = _Carry(
        t=t_init, y=y0, dt=dt_init, solver_state=solver_state0, ys=ys0,
        status=zeros_i, n_steps=zeros_i, n_accepted=zeros_i,
        n_rejected=zeros_i,
        prev_err=torch.ones((b,), dtype=dtype, device=device),
        event=torch.zeros((b,), dtype=torch.bool, device=device))
    zero = torch.zeros((), dtype=dtype, device=device)

    def body(s: _Carry) -> _Carry:
        running = s.status == _RUNNING
        t_rem = t1 - s.t
        clipped = s.dt >= t_rem
        # masked (finished/failed) lanes still execute the step body with
        # their own last stable dt: an arbitrary constant could overflow in
        # the discarded stage math and poison reverse-mode gradients
        dt = torch.where(running, torch.minimum(s.dt, t_rem), s.dt)
        dt = torch.maximum(dt, zero)

        res = solver.step(f, s.t, s.y, dt, args, s.solver_state)
        err = error_norm(res.y_err, s.y, res.y1, rtol, atol).detach()
        err = torch.where(res.ok, err, torch.full_like(err, math.inf))
        accept = err <= 1.0
        t_new = s.t + dt

        # ---- dense saveat fill over (t, t_new] per lane -------------------
        theta = clip((saveat[None, :] - s.t[:, None])
                     / torch.clamp(dt, min=1e-30)[:, None], 0.0, 1.0)
        bmat = solver.interp_matrix(theta).to(dtype)   # (B, n_save, n_stages)
        y_interp = s.y[:, None, :] + dt[:, None, None] * torch.einsum(
            "bsk,bkn->bsn", bmat, res.dense)
        y_interp = _finite_or_zero(y_interp)
        fill = ((running & accept)[:, None] & (saveat[None, :] > s.t[:, None])
                & (saveat[None, :] <= t_new[:, None]))
        ys = torch.where(fill[:, :, None], y_interp, s.ys)

        # ---- controller (no gradient) ------------------------------------
        order = solver.order_for(s.solver_state)
        if controller == "pi":
            dt_prop, prev_err = propose_dt_pi(dt, err, s.prev_err, accept,
                                              order, safety, factor_min,
                                              factor_max)
        else:
            dt_prop = propose_dt(dt, err, accept, order, safety, factor_min,
                                 factor_max)
            prev_err = s.prev_err
        dt_next = dt_prop.detach()
        adv = running & accept

        # ---- terminate on an event (after accepted steps) ----------------
        if event_fn is not None:
            triggered = adv & event_fn(t_new, res.y1, args)
            fill_rest = triggered[:, None] & (saveat[None, :] > t_new[:, None])
            ys = torch.where(fill_rest[:, :, None],
                             _finite_or_zero(res.y1)[:, None, :], ys)
        else:
            triggered = torch.zeros_like(adv)

        finished = (accept & clipped) | triggered
        too_small = dt_next < dtmin
        new_status = torch.where(
            finished, _DONE, torch.where(too_small, _FAILED, _RUNNING)
        ).to(s.status.dtype)

        return _Carry(
            t=torch.where(adv, t_new.detach(), s.t),
            y=torch.where(adv[:, None], _finite_or_zero(res.y1), s.y),
            dt=torch.where(running, dt_next, s.dt),
            solver_state=_lane_select(adv, res.state, s.solver_state),
            ys=ys,
            status=torch.where(running, new_status, s.status),
            n_steps=s.n_steps + running.to(torch.int32),
            n_accepted=s.n_accepted + adv.to(torch.int32),
            n_rejected=s.n_rejected + (running & ~accept).to(torch.int32),
            prev_err=torch.where(running, prev_err, s.prev_err).detach(),
            event=s.event | triggered,
        )

    if unroll == "while":
        while bool(torch.any((carry.status == _RUNNING)
                             & (carry.n_steps < max_steps))):
            carry = body(carry)
    else:
        for _ in range(max_steps):
            carry = checkpoint(body, carry, use_reentrant=False)

    return ODESolution(
        ts=saveat, ys=carry.ys, success=carry.status == _DONE,
        n_steps=carry.n_steps, n_accepted=carry.n_accepted,
        n_rejected=carry.n_rejected, final_t=carry.t, final_y=carry.y,
        event_triggered=carry.event)
