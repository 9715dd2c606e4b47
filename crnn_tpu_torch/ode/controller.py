"""Step-size control, lane-batched (port of crnn_tpu/ode/controller.py):
error norm, dt proposal (I and PI controllers) and the initial-step
heuristic.

Every function reduces over the state axis only: under ``jax.vmap`` the
JAX package's norms are per lane, and a reduction over lanes would couple
them. The callers ``.detach()`` the results where JAX applies
``stop_gradient``: the step sequence carries no gradient.
"""

from __future__ import annotations

import math

import torch

from crnn_tpu_torch import clip


def error_norm(y_err, y0, y1, rtol, atol):
    """Per-lane Hairer scaled RMS norm over the state axis; accept iff <= 1.
    ``atol`` may be a per-species vector."""
    scale = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    ratio = torch.nan_to_num(y_err / scale, nan=math.inf, posinf=math.inf,
                             neginf=math.inf)
    return torch.sqrt(torch.mean(ratio**2, dim=-1))


def propose_dt(dt, err, accept, order, safety=0.9, factor_min=0.2,
               factor_max=10.0):
    """I-controller with limiter: dt * clip(safety*err^(-1/(order+1)), ...).
    After a rejection the growth factor is capped at 1."""
    err = torch.maximum(err, dt.new_full((), 1e-10))
    factor = safety * err ** (-1.0 / (order + 1.0))
    fmax = torch.where(accept, dt.new_full((), factor_max), dt.new_ones(()))
    return dt * clip(factor, factor_min, fmax)


def propose_dt_pi(dt, err, prev_err, accept, order, safety=0.9,
                  factor_min=0.2, factor_max=10.0, beta1: float = 0.7,
                  beta2: float = 0.4):
    """PI controller: ``safety * err^(-beta1/k) * prev_err^(beta2/k)``,
    k = order+1, falling back to I control after a rejection. Returns
    (dt_next, new_prev_err)."""
    k = order + 1.0
    floor = dt.new_full((), 1e-10)
    err = torch.maximum(err, floor)
    prev = torch.maximum(prev_err, floor)
    factor_pi = safety * err ** (-beta1 / k) * prev ** (beta2 / k)
    factor_i = safety * err ** (-1.0 / k)
    factor = torch.where(accept, factor_pi, factor_i)
    fmax = torch.where(accept, dt.new_full((), factor_max), dt.new_ones(()))
    factor = clip(factor, factor_min, fmax)
    return dt * factor, torch.where(accept, err, prev_err)


def initial_step(f, t0, t1, y0, args, order, rtol, atol):
    """Hairer/Norsett/Wanner automatic initial step (Solving ODEs I, II.4)
    for every lane of ``y0 (B, ns)``; ``t0``, ``t1`` are shared scalars."""
    b = y0.shape[0]
    t0v = torch.full((b,), float(t0), dtype=y0.dtype, device=y0.device)
    scale = atol + rtol * torch.abs(y0)
    f0 = f(t0v, y0, args)
    d0 = torch.sqrt(torch.mean((y0 / scale) ** 2, dim=-1))
    d1 = torch.sqrt(torch.mean((f0 / scale) ** 2, dim=-1))
    tiny = y0.new_full((), 1e-30)
    small = y0.new_full((), 1e-6)
    span = abs(float(t1) - float(t0))
    h0 = torch.where((d0 < 1e-5) | (d1 < 1e-5), small,
                     0.01 * d0 / torch.maximum(d1, tiny))
    h0 = torch.clamp(h0, max=span)
    y1 = y0 + h0[:, None] * f0
    f1 = f(t0v + h0, y1, args)
    d2 = torch.sqrt(torch.mean(((f1 - f0) / scale) ** 2, dim=-1)) \
        / torch.maximum(h0, tiny)
    dmax = torch.maximum(d1, d2)
    h1 = torch.where(dmax <= 1e-15, torch.maximum(small, h0 * 1e-3),
                     (0.01 / torch.maximum(dmax, tiny)) ** (1.0 / (order + 1.0)))
    return torch.clamp(torch.minimum(100.0 * h0, h1), max=span)
