"""Tsitouras 5(4) explicit Runge-Kutta pair with its free 4th-order
interpolant, lane-batched (port of crnn_tpu/ode/tsit5.py).

The tableau is the published one of Tsitouras (2011), the same constants as
the JAX package. FSAL: the 7th stage slope equals f(t1, y1) and is the next
step's first stage. A step makes six RHS calls on ``(B, ns)``; with a CRNN
RHS on a CUDA tensor each is one launch of the isothermal kernel.
"""

from __future__ import annotations

from typing import Any

import torch

from crnn_tpu_torch.ode.base import RHS, Solver, StepResult

# -- Tsitouras 2011 tableau ---------------------------------------------------
C2 = 0.161
C3 = 0.327
C4 = 0.9
C5 = 0.9800255409045097
C6 = 1.0
C7 = 1.0

A21 = 0.161
A31 = -0.008480655492356989
A32 = 0.335480655492357
A41 = 2.8971530571054935
A42 = -6.359448489975075
A43 = 4.3622954328695815
A51 = 5.325864828439257
A52 = -11.748883564062828
A53 = 7.4955393428898365
A54 = -0.09249506636175525
A61 = 5.86145544294642
A62 = -12.92096931784711
A63 = 8.159367898576159
A64 = -0.071584973281401
A65 = -0.028269050394068383
# 5th-order weights (also row 7 of A: FSAL)
B1 = 0.09646076681806523
B2 = 0.01
B3 = 0.4798896504144996
B4 = 1.379008574103742
B5 = -3.290069515436081
B6 = 2.324710524099774
# error weights: y1 - yhat1 = dt * sum(BTILDE_i * k_i)
BT1 = -0.00178001105222577714
BT2 = -0.0008164344596567469
BT3 = 0.007880878010261995
BT4 = -0.1447110071732629
BT5 = 0.5823571654525552
BT6 = -0.45808210592918697
BT7 = 0.015151515151515152


class Tsit5(Solver):
    """Adaptive 5(4) explicit RK with FSAL and 4th-order dense output."""

    order = 5
    n_stages = 7

    def init(self, f: RHS, t0, y0, args) -> Any:
        # FSAL carry: slope at the current (t, y)
        return f(t0, y0, args)

    def step(self, f: RHS, t, y, dt, args, state) -> StepResult:
        h = dt[:, None]
        k1 = state  # FSAL from the previous accepted step (or init)
        k2 = f(t + C2 * dt, y + h * (A21 * k1), args)
        k3 = f(t + C3 * dt, y + h * (A31 * k1 + A32 * k2), args)
        k4 = f(t + C4 * dt, y + h * (A41 * k1 + A42 * k2 + A43 * k3), args)
        k5 = f(
            t + C5 * dt,
            y + h * (A51 * k1 + A52 * k2 + A53 * k3 + A54 * k4),
            args,
        )
        k6 = f(
            t + dt,
            y + h * (A61 * k1 + A62 * k2 + A63 * k3 + A64 * k4 + A65 * k5),
            args,
        )
        y1 = y + h * (
            B1 * k1 + B2 * k2 + B3 * k3 + B4 * k4 + B5 * k5 + B6 * k6
        )
        k7 = f(t + dt, y1, args)  # FSAL slope for the next step
        y_err = h * (
            BT1 * k1
            + BT2 * k2
            + BT3 * k3
            + BT4 * k4
            + BT5 * k5
            + BT6 * k6
            + BT7 * k7
        )
        dense = torch.stack([k1, k2, k3, k4, k5, k6, k7], dim=1)
        ok = torch.all(torch.isfinite(y1), dim=-1)
        return StepResult(y1=y1, y_err=y_err, dense=dense, state=k7, ok=ok)

    def interp_matrix(self, theta: torch.Tensor) -> torch.Tensor:
        """Tsitouras' free 4th-order interpolant b_i(theta), (..., 7)."""
        t = theta
        b1 = (
            -1.0530884977290216
            * t
            * (t - 1.3299890189751412)
            * (t**2 - 1.4364028541716351 * t + 0.7139816917074209)
        )
        b2 = 0.1017 * t**2 * (t**2 - 2.1966568338249754 * t + 1.2949852507374631)
        b3 = (
            2.490627285651252793
            * t**2
            * (t**2 - 2.38535645472061657 * t + 1.57803468208092486)
        )
        b4 = (
            -16.54810288924490272
            * (t - 1.21712927295533244)
            * (t - 0.61620406037800089)
            * t**2
        )
        b5 = (
            47.37952196281928122
            * (t - 1.203071208372362603)
            * (t - 0.658047292653547382)
            * t**2
        )
        b6 = (
            -34.87065786149660974
            * (t - 1.2)
            * (t - 0.666666666666666667)
            * t**2
        )
        b7 = 2.5 * (t - 1.0) * (t - 0.6) * t**2
        return torch.stack([b1, b2, b3, b4, b5, b6, b7], dim=-1)
