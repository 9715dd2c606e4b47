"""Dense-output weights (port of
crnn_tpu/ode/base.py:hermite_interp_matrix_from_endpoints)."""

from __future__ import annotations

import torch


def hermite_interp_matrix_from_endpoints(theta: torch.Tensor) -> torch.Tensor:
    """Cubic-Hermite weights (..., 3) for ``dense = [f0, f1, (y1 - y0)/dt]``
    so that ``y(theta) = y0 + dt * B @ dense``."""
    t = theta
    b_f0 = t - 2.0 * t**2 + t**3
    b_f1 = -(t**2) + t**3
    b_dy = 3.0 * t**2 - 2.0 * t**3
    return torch.stack([b_f0, b_f1, b_dy], dim=-1)
