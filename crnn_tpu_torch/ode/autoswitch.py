"""AutoSwitch: runtime stiffness detection and explicit/implicit switching,
lane-batched (port of crnn_tpu/ode/autoswitch.py), the reference's
``AutoTsit5(Rosenbrock23())`` and ``AutoTsit5(TRBDF2())``.

Tsit5's last two stages are both evaluated at ``t + dt`` (c6 = c7 = 1), so

    rho ~= ||k7 - k6|| / ||z7 - z6||

estimates the local Jacobian's dominant eigenvalue, and ``dt * rho`` is
held against Tsit5's stability radius (~3.25 on the negative real axis).
A run of "stiff" votes flips a lane to the implicit solver; a run of
"non-stiff" votes, estimated from the implicit step's endpoint slopes,
flips it back. Both solvers carry the same FSAL slope, and the dense output
is cubic Hermite in both.

Every lane runs both steps and selects its own per lane with
``torch.where``, as JAX's ``lax.cond`` does under ``vmap`` (it lowers to a
select): a step costs a Tsit5 step plus a stiff step. ``ode/stiffness.py``
classifies lanes once up front when the regime of a batch is fixed.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from crnn_tpu_torch.ode import tsit5 as _t5
from crnn_tpu_torch.ode.base import (RHS, Solver, StepResult,
                                     hermite_interp_matrix_from_endpoints)
from crnn_tpu_torch.ode.solve import _lane_select
from crnn_tpu_torch.ode.tsit5 import Tsit5


class _AutoState(NamedTuple):
    is_stiff: torch.Tensor        # (B,) int32: 0 = explicit, 1 = implicit
    slope: torch.Tensor           # (B, ns) shared FSAL slope f(t, y)
    stiff_votes: torch.Tensor     # (B,) int32 consecutive stiff votes
    nonstiff_votes: torch.Tensor  # (B,) int32


def _rms(x):
    return torch.sqrt(torch.mean(x**2, dim=-1))


class AutoSwitch(Solver):
    """Composite non-stiff/stiff solver with per-lane switching."""

    n_stages = 3
    implicit = True

    def __init__(
        self,
        nonstiff: Solver = None,
        stiff: Solver = None,
        stability_radius: float = 3.25,
        switch_to_stiff_after: int = 3,
        switch_to_nonstiff_after: int = 25,
        nonstiff_recheck_rho: float = 0.5,
    ):
        if nonstiff is None:
            nonstiff = Tsit5()
        if stiff is None:
            from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23

            stiff = Rosenbrock23()
        if not isinstance(nonstiff, Tsit5):
            raise TypeError("AutoSwitch's stiffness estimate needs Tsit5 stages")
        self.nonstiff = nonstiff
        self.stiff = stiff
        self.order = stiff.order  # static default: initial_step reads it
        self.stability_radius = stability_radius
        self.switch_to_stiff_after = switch_to_stiff_after
        self.switch_to_nonstiff_after = switch_to_nonstiff_after
        self.nonstiff_recheck_rho = nonstiff_recheck_rho

    def init(self, f: RHS, t0, y0, args) -> Any:
        slope = f(t0, y0, args)
        zero = torch.zeros(y0.shape[0], dtype=torch.int32, device=y0.device)
        return _AutoState(is_stiff=zero, slope=slope, stiff_votes=zero,
                          nonstiff_votes=zero)

    def order_for(self, state) -> torch.Tensor:
        """Per-lane order ``(B,)`` in float32, as JAX's."""
        return torch.where(
            state.is_stiff == 1,
            state.is_stiff.new_full((), self.stiff.order, dtype=torch.float32),
            state.is_stiff.new_full((), self.nonstiff.order,
                                    dtype=torch.float32))

    def step(self, f: RHS, t, y, dt, args, state: _AutoState) -> StepResult:
        one = torch.ones_like(state.is_stiff)
        zero = torch.zeros_like(state.is_stiff)
        h = dt[:, None]

        # -- the explicit branch
        ex = self.nonstiff.step(f, t, y, dt, args, state.slope)
        k = ex.dense  # (B, 7, ns)
        z6 = y + h * (_t5.A61 * k[:, 0] + _t5.A62 * k[:, 1]
                      + _t5.A63 * k[:, 2] + _t5.A64 * k[:, 3]
                      + _t5.A65 * k[:, 4])
        rho = dt * _rms(k[:, 6] - k[:, 5]) / torch.clamp(
            _rms(ex.y1 - z6), min=1e-30)
        new_sv = torch.where(rho > self.stability_radius,
                             state.stiff_votes + 1, zero)
        flip = new_sv >= self.switch_to_stiff_after
        ex_dense = torch.stack([k[:, 0], k[:, 6], (ex.y1 - y) / h], dim=1)
        ex_state = _AutoState(
            is_stiff=torch.where(flip, one, zero), slope=ex.state,
            stiff_votes=torch.where(flip, zero, new_sv), nonstiff_votes=zero)

        # -- the implicit branch: vote to go back when dt has grown so large
        # that an explicit method would likely be stable again
        im = self.stiff.step(f, t, y, dt, args, state.slope)
        rho = dt * _rms(im.state - state.slope) / torch.clamp(
            _rms(im.y1 - y), min=1e-30)
        new_nv = torch.where(
            rho < self.nonstiff_recheck_rho * self.stability_radius,
            state.nonstiff_votes + 1, zero)
        flip = new_nv >= self.switch_to_nonstiff_after
        im_state = _AutoState(
            is_stiff=torch.where(flip, zero, one), slope=im.state,
            stiff_votes=zero, nonstiff_votes=torch.where(flip, zero, new_nv))

        explicit = state.is_stiff == 0
        return StepResult(
            y1=_lane_select(explicit, ex.y1, im.y1),
            y_err=_lane_select(explicit, ex.y_err, im.y_err),
            dense=_lane_select(explicit, ex_dense, im.dense),
            state=_lane_select(explicit, ex_state, im_state),
            ok=torch.where(explicit, ex.ok, im.ok))

    def interp_matrix(self, theta: torch.Tensor) -> torch.Tensor:
        return hermite_interp_matrix_from_endpoints(theta)
