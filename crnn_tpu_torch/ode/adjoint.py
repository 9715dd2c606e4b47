"""Continuous (backsolve) adjoint with saveat checkpoints, lane-batched
(port of crnn_tpu/ode/adjoint.py:odesolve_adjoint).

The reverse-mode analogue of the reference's
``BacksolveAdjoint(checkpointing=true)``: instead of storing the forward
pass (the ``unroll='scan'`` discrete adjoint), the backward pass integrates
the augmented ODE

    dy/dt = f,   da/dt = -a^T df/dy,   dg/dt = -a^T df/dp

backwards from each save point to the one before, adding the output
cotangent to ``a`` at every save point. Memory is O(n_save) checkpoints
instead of O(max_steps) carries.

``odesolve_adjoint`` is a ``torch.autograd.Function`` (JAX's ``custom_vjp``):

- forward: the early-exit ``while`` driver with the given solver and RHS,
  so a CRNN RHS on a CUDA tensor runs its kernel in every f evaluation;
- backward: one lane-batched early-exit solve of ``z = (y, a, g)``,
  ``(B, 2*ny + P)`` with P the number of weight entries, per save segment.
  ``g`` is per lane, as under JAX's ``vmap``, where each lane integrates
  its own parameter cotangent under its own step control and the lanes are
  summed only at the end: the augmented RHS is ``torch.func.vmap`` over
  lanes of ``torch.func.vjp`` of one lane's RHS, the weights unbatched.

The backward differentiates ``f_plain``, the plain-torch twin of ``f``
(default ``f``): its Rosenbrock23 takes J of the augmented RHS by forward
mode over that vjp, and the kernel ops have no forward-mode rule. The
augmented RHS is declared autonomous exactly when ``f`` is.
"""

from __future__ import annotations

import copy
from types import SimpleNamespace
from typing import Any

import torch

from crnn_tpu_torch.ode.base import Solver, autonomous, is_autonomous
from crnn_tpu_torch.ode.solve import odesolve


def _flatten_args(args):
    """``(leaves, unflatten)`` for ``args``: one tensor, or a (named) tuple
    whose tensor fields are the leaves (None fields pass through)."""
    if isinstance(args, torch.Tensor):
        return [args], lambda leaves: leaves[0]
    if not isinstance(args, tuple):
        raise TypeError("odesolve_adjoint: args must be a tensor or a tuple "
                        f"of tensors, got {type(args).__name__}")
    idx = [i for i, x in enumerate(args) if isinstance(x, torch.Tensor)]

    def unflatten(leaves):
        vals = list(args)
        for i, leaf in zip(idx, leaves):
            vals[i] = leaf
        return type(args)(*vals) if hasattr(args, "_fields") else tuple(vals)

    return [args[i] for i in idx], unflatten


def _aug_rhs(f_plain, t_hi, leaves, unflatten, ny, declared):
    """The augmented RHS of one backward segment in ``tau = t_hi - t``:
    ``z (B, 2*ny + P) -> (-f, a^T df/dy, a^T df/dp)``, per lane."""

    def lane(t_l, y_l, a_l):
        def f_lane(yy, *ps):
            return f_plain(t_l[None], yy[None], unflatten(ps))[0]

        fy, vjp_fn = torch.func.vjp(f_lane, y_l, *leaves)
        cot = vjp_fn(a_l)
        return fy, cot[0], torch.cat([c.reshape(-1) for c in cot[1:]])

    def aug(tau, z, _):
        fy, a_dot, g_dot = torch.func.vmap(lane)(
            t_hi - tau, z[:, :ny], z[:, ny:2 * ny])
        return torch.cat([-fy, a_dot, g_dot], dim=-1)

    return autonomous(aug) if declared else aug


class _Adjoint(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, y0, *leaves):
        sol = odesolve(spec.f, spec.solver, y0, spec.t0, spec.t1, spec.saveat,
                       args=spec.unflatten(leaves), rtol=spec.rtol,
                       atol=spec.atol, max_steps=spec.max_steps,
                       unroll="while")
        ctx.spec = spec
        ctx.save_for_backward(y0, sol.ys, sol.success, *leaves)
        return sol.ys

    @staticmethod
    def backward(ctx, ys_bar):
        spec = ctx.spec
        y0, ys, fwd_ok, *leaves = ctx.saved_tensors
        leaves = [x.detach() for x in leaves]
        b, ny = y0.shape
        dtype = ys.dtype
        saveat = spec.saveat.to(dtype)
        n_save = saveat.shape[0]
        sizes = [x.numel() for x in leaves]
        a = torch.zeros_like(y0)
        g = torch.zeros((b, sum(sizes)), dtype=dtype, device=y0.device)
        # segment boundaries t0, saveat[0], ..., saveat[-1], walked backwards
        lo = torch.cat([saveat.new_full((1,), spec.t0), saveat[:-1]])
        for i in reversed(range(n_save)):
            a = a + ys_bar[:, i]        # the cotangent jump at the save point
            span = float(saveat[i] - lo[i])
            z0 = torch.cat([ys[:, i], a, g], dim=-1)
            aug = _aug_rhs(spec.f_plain, saveat[i], leaves, spec.unflatten,
                           ny, is_autonomous(spec.f))
            # a degenerate segment (saveat[0] == t0) finishes in one step
            # of dt = 0
            sol = odesolve(aug, spec.bwd_solver, z0, 0.0, span,
                           saveat.new_full((1,), span), rtol=spec.bwd_rtol,
                           atol=spec.bwd_atol, max_steps=spec.bwd_max_steps,
                           unroll="while")
            a = sol.final_y[:, ny:2 * ny]
            g = sol.final_y[:, 2 * ny:]
        # a failed forward solve leaves unfilled (zero) checkpoints, so the
        # backsolve through them is garbage: gate the lane to zero
        ok = fwd_ok.to(dtype)[:, None]
        a = a * ok
        g_sum = (g * ok).sum(dim=0)
        grads = [part.reshape(x.shape)
                 for part, x in zip(torch.split(g_sum, sizes), leaves)]
        return (None, a, *grads)


def odesolve_adjoint(
    f,
    solver: Solver,
    y0: torch.Tensor,
    t0,
    t1,
    saveat: torch.Tensor,
    args: Any = None,
    rtol=1e-3,
    atol=1e-6,
    max_steps: int = 4096,
    bwd_rtol=None,
    bwd_atol=None,
    bwd_max_steps: int = None,
    f_plain=None,
) -> torch.Tensor:
    """Like ``odesolve(...).ys`` (``(B, n_save, ny)``) with a
    continuous-adjoint backward pass: differentiable w.r.t. ``y0`` and the
    tensors of ``args`` (a tensor or a NamedTuple such as ``CRNNWeights``).
    ``saveat`` must be ascending. ``f_plain`` is the plain-torch twin of
    ``f`` that the backward differentiates (default ``f``).
    """
    bwd_rtol = rtol if bwd_rtol is None else bwd_rtol
    bwd_atol = atol if bwd_atol is None else bwd_atol
    # the backward state (y, a, g) is longer than y: a per-species atol
    # cannot broadcast there, so it collapses to its strictest entry
    if isinstance(bwd_atol, torch.Tensor):
        bwd_atol = float(bwd_atol.min())
    # a closed-form model Jacobian does not apply to the augmented system:
    # copy the solver (keeping its options) with the forward-mode J
    bwd_solver = solver
    if getattr(solver, "jac", None) is not None:
        bwd_solver = copy.copy(solver)
        bwd_solver.jac = None
    leaves, unflatten = _flatten_args(args)
    # the non-tensor inputs of the call
    spec = SimpleNamespace(
        f=f, f_plain=f if f_plain is None else f_plain, solver=solver,
        bwd_solver=bwd_solver, t0=float(t0), t1=float(t1), saveat=saveat,
        unflatten=unflatten, rtol=rtol, atol=atol, max_steps=max_steps,
        bwd_rtol=bwd_rtol, bwd_atol=bwd_atol,
        bwd_max_steps=max_steps if bwd_max_steps is None else bwd_max_steps)
    return _Adjoint.apply(spec, y0, *leaves)
