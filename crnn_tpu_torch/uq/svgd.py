"""SVGD: Stein Variational Gradient Descent over CRNN parameters (port of
crnn_tpu/uq/svgd.py).

A particle ensemble approximates the Bayesian posterior over kinetic
parameters (Cathode_NCM333_UQ/src_333/network.jl:48-87); each iteration
smooths the per-particle score gradients with an RBF kernel (median-trick
bandwidth) and adds the kernel-gradient repulsion:

    phi(x_i) = (1/n) sum_j [k(x_j, x_i) grad_logp(x_j)
                            + grad_{x_j} k(x_j, x_i)]
    x_i <- x_i + stepsize * phi(x_i)

The particle axis is the lane axis: one batched solve scores every
particle, and the kernel algebra is two small matmuls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch


@dataclass
class SVGDConfig:
    stepsize: float = 1e-3
    # None: the median trick (network.jl:71-76)
    bandwidth: Optional[float] = None


def median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of all of ``x``: the mean of the two middle values of
    an even count (``(lo + hi) * 0.5``, JAX's 'midpoint'), where
    ``torch.median`` returns the lower one."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def rbf_kernel(particles: torch.Tensor, bandwidth: Optional[float] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RBF kernel matrix and its gradient sum.

    particles: (n, d). Returns (Kxy (n, n), dxkxy (n, d)) where
    ``dxkxy[i] = sum_j grad_{x_j} k(x_j, x_i)``, the repulsion term.
    Bandwidth: the median trick ``h = median(d^2) / log(n + 1)`` (the
    median over the whole pairwise matrix, its zero diagonal included, as
    the reference takes it) when not given.
    """
    n = particles.shape[0]
    diffs = particles[:, None, :] - particles[None, :, :]       # (n, n, d)
    sq_dists = torch.sum(diffs ** 2, dim=-1)                     # (n, n)
    if bandwidth is None:
        h = median(sq_dists) / math.log(n + 1.0)
        h = torch.clamp(h, min=1e-12)
    else:
        h = particles.new_full((), bandwidth)
    kxy = torch.exp(-sq_dists / (2.0 * h))                       # (n, n)
    # sum_j grad_{x_j} k(x_j, x_i) = (1/h) [x_i sum_j k_ji - sum_j k_ji x_j]
    sumk = torch.sum(kxy, dim=0)                                 # (n,)
    dxkxy = (particles * sumk[:, None] - kxy.T @ particles) / h  # (n, d)
    return kxy, dxkxy


def svgd_phi(particles: torch.Tensor, grad_logp: torch.Tensor,
             bandwidth: Optional[float] = None) -> torch.Tensor:
    """The SVGD direction phi (n, d) given per-particle score gradients."""
    kxy, dxkxy = rbf_kernel(particles, bandwidth)
    return (kxy @ grad_logp + dxkxy) / particles.shape[0]


def svgd_step(particles: torch.Tensor, grad_logp: torch.Tensor,
              stepsize: float, bandwidth: Optional[float] = None
              ) -> torch.Tensor:
    """One SVGD update given per-particle score gradients (n, d)."""
    return particles + stepsize * svgd_phi(particles, grad_logp, bandwidth)


def make_svgd_step(grad_logp_fn: Callable,
                   cfg: SVGDConfig = SVGDConfig()) -> Callable:
    """An SVGD iteration ``step(particles) -> particles``;
    ``grad_logp_fn(particles) -> (n, d)`` scores every particle at once (a
    batched solve over the particle lanes)."""

    def step(particles):
        return svgd_step(particles, grad_logp_fn(particles), cfg.stepsize,
                         cfg.bandwidth)

    return step


def svgd_step_tolerant(particles: torch.Tensor, losses: torch.Tensor,
                       lnpgrad: torch.Tensor, stepsize
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SVGD update of the UQ case (crnn_tpu/cases/cathode_uq.py:252-267,
    crnn_tpu/parallel/svgd_dp.py), tolerant of failed solves (UQ
    network.jl:214): a particle whose score went non-finite feels no data
    force this iteration, only the kernel repulsion, and a non-finite phi
    entry moves nothing. Returns (new particles, the mean of the finite
    losses)."""
    finite = torch.isfinite(lnpgrad).all(dim=1, keepdim=True)
    lnpgrad = torch.where(finite, lnpgrad, torch.zeros_like(lnpgrad))
    phi = svgd_phi(particles, lnpgrad)
    phi = torch.where(torch.isfinite(phi), phi, torch.zeros_like(phi))
    mean_loss = torch.nanmean(torch.where(
        torch.isfinite(losses), losses, torch.full_like(losses, math.nan)))
    return particles + stepsize * phi, mean_loss
