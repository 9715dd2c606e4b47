"""Step-size proposal (port of crnn_tpu/ode/controller.py:propose_dt)."""

from __future__ import annotations

import torch

from crnn_tpu_torch import clip


def propose_dt(dt, err, accept, order, safety=0.9, factor_min=0.2,
               factor_max=10.0):
    """I-controller with limiter: dt * clip(safety*err^(-1/(order+1)), ...).
    After a rejection the growth factor is capped at 1."""
    err = torch.maximum(err, dt.new_full((), 1e-10))
    factor = safety * err ** (-1.0 / (order + 1.0))
    fmax = torch.where(accept, dt.new_full((), factor_max), dt.new_ones(()))
    return dt * clip(factor, factor_min, fmax)
