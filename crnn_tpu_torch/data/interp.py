"""Linear interpolation on a frozen grid (port of crnn_tpu/data/interp.py).

HyChem's RHS reads T(t) and P(t) from its trajectory table
(crnn_pyrolysis_mass.jl:44-51,103-104). ``make_interpolant`` computes what
``jnp.interp`` computes, in its order:

- the segment ``i = clip(searchsorted(xs, x, side='right'), 1, n-1)``, so
  at a knot the slope is the one of the segment to its right (the last
  knot takes the last segment's);
- ``ys[i-1] + (x - xs[i-1]) / dx * dy``, with a segment no wider than
  ``spacing(eps)`` giving ``ys[i-1]``;
- constant values left and right of the grid, where the slope is 0.

It works under ``torch.func.jvp`` in x, which the per-lane Rosenbrock23
takes for df/dt (``ode/rosenbrock.py:lane_dfdt``).
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch


def make_interpolant(xs: torch.Tensor, ys: torch.Tensor) -> Callable:
    """``f(x)``: the piecewise-linear interpolant of ``(xs, ys)``, constant
    beyond both ends, elementwise over ``x`` of any shape."""
    n = xs.shape[0]
    eps = float(np.spacing(np.finfo(
        np.float64 if xs.dtype == torch.float64 else np.float32).eps))

    def f(x):
        # the segment index carries no tangent: searchsorted on the primal
        i = torch.clamp(torch.searchsorted(xs, x.detach(), right=True), 1,
                        n - 1)
        x_lo, y_lo = xs[i - 1], ys[i - 1]
        dx = xs[i] - x_lo
        dy = ys[i] - y_lo
        dx0 = torch.abs(dx) <= eps
        out = torch.where(dx0, y_lo,
                          y_lo + ((x - x_lo) / torch.where(dx0, 1.0, dx)) * dy)
        out = torch.where(x < xs[0], ys[0], out)
        return torch.where(x > xs[-1], ys[-1], out)

    return f


def resample_log_grid(t_end: float, n: int, lo_frac: float = 1e-2,
                      hi_frac: float = 1.0 / 1.01,
                      dtype=torch.float64) -> torch.Tensor:
    """Log-spaced grid of ``n`` points from ``t_end * lo_frac`` to ``t_end *
    hi_frac`` with t[0] forced to 0 (crnn_pyrolysis_mass.jl:42-43); the
    exponents are spaced as ``jnp.linspace`` spaces them."""
    lo, hi = math.log10(t_end * lo_frac), math.log10(t_end * hi_frac)
    step = torch.arange(n - 1, dtype=torch.float64) / (n - 1)
    expo = torch.cat([lo * (1 - step) + hi * step,
                      torch.tensor([hi], dtype=torch.float64)])
    ts = (10.0 ** expo).to(dtype)
    ts[0] = 0.0
    return ts
