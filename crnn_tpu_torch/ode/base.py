"""Solver interface and dense-output weights (port of crnn_tpu/ode/base.py).

Every solver of the port works on a batch of independent lanes: the state is
``y (B, ns)``, the time ``t (B,)`` and the step ``dt (B,)``, which is what
``jax.vmap`` of the JAX package's per-lane solvers computes. A solver
provides:

- ``init``: the carried solver state (e.g. the FSAL slope);
- ``step``: one attempted step ``(t, y, dt) -> StepResult`` for every lane;
- ``interp_matrix``: dense-output weights ``B(theta)`` such that
  ``y(t + theta*dt) = y + dt * B(theta) @ ks`` for the stage slopes in
  ``StepResult.dense``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

# RHS signature: f(t (B,), y (B, ns), args) -> dy/dt (B, ns). ``args`` is any
# structure of parameters; gradients flow through it.
RHS = Callable[[Any, Any, Any], Any]


def autonomous(f: RHS) -> RHS:
    """Declare the RHS ``f`` independent of t, where it is written. A solver
    that needs df/dt (Rosenbrock23) takes it as exactly 0 for a declared RHS
    and computes it by forward mode in t for any other."""
    f.autonomous = True
    return f


def is_autonomous(f: RHS) -> bool:
    return getattr(f, "autonomous", False)


class StepResult(NamedTuple):
    """Outcome of one attempted step of size ``dt`` from ``(t, y)``."""

    y1: torch.Tensor     # (B, ns) proposed state at t + dt
    y_err: torch.Tensor  # (B, ns) local error estimate
    dense: torch.Tensor  # (B, n_stages, ns) stage slopes for interpolation
    state: Any           # next solver state (a tensor with a leading B axis)
    ok: torch.Tensor     # (B,) bool: internal solve converged / finite


class Solver:
    """Base class. Subclasses define a Runge-Kutta-like attempted step."""

    #: classical order of the advancing method (controls step-size exponent)
    order: int = 1
    #: number of stage slopes stored in ``dense``
    n_stages: int = 1
    #: True if the method handles stiff problems
    implicit: bool = False

    def init(self, f: RHS, t0, y0, args) -> Any:
        return None

    def order_for(self, state) -> Any:
        """Effective order for step-size control."""
        return self.order

    def step(self, f: RHS, t, y, dt, args, state) -> StepResult:
        raise NotImplementedError

    def interp_matrix(self, theta: torch.Tensor) -> torch.Tensor:
        """Dense-output weights (..., n_stages) for positions theta (...) in
        [0, 1]: ``y(theta) = y0 + dt * B @ ks``."""
        raise NotImplementedError


def hermite_interp_matrix_from_endpoints(theta: torch.Tensor) -> torch.Tensor:
    """Cubic-Hermite weights (..., 3) for ``dense = [f0, f1, (y1 - y0)/dt]``
    so that ``y(theta) = y0 + dt * B @ dense``."""
    t = theta
    b_f0 = t - 2.0 * t**2 + t**3
    b_f1 = -(t**2) + t**3
    b_dy = 3.0 * t**2 - 2.0 * t**3
    return torch.stack([b_f0, b_f1, b_dy], dim=-1)
