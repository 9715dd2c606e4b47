"""Synthetic datasets: batched truth solve + noise + scales
(port of crnn_tpu/data/generate.py).

All experiments integrate together, so no JAX is needed to make the data:
``generate_dataset`` solves with the port's batch-major Rosenbrock23 (dense
W-solve with the truth's closed-form Jacobian; case2), and
``generate_dataset_odesolve`` with the per-lane ``odesolve`` and any solver
(case1: Tsit5; robertson: Rosenbrock23 with a forward-mode Jacobian), both
with ``unroll='while'``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from crnn_tpu_torch.ode.base import Solver
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ode.solve import odesolve


class Dataset(NamedTuple):
    u0: torch.Tensor        # (n_exp, n_state) initial conditions
    ys: torch.Tensor        # (n_exp, n_save, n_obs) noisy observations
    ys_clean: torch.Tensor  # (n_exp, n_save, n_obs) noiseless truth
    ts: torch.Tensor        # (n_save,)
    yscale: torch.Tensor    # (n_obs,) global normalisation scale
    success: torch.Tensor   # (n_exp,) truth-solve health


def max_min_scale(ys: torch.Tensor, lb: float) -> torch.Tensor:
    """Per-species (max - min) over time, max over experiments, + lb
    (case2/case2.jl:68-73,83). ys: (n_exp, n_save, ns)."""
    per_exp = ys.amax(dim=1) - ys.amin(dim=1)
    return per_exp.amax(dim=0) + lb


def std_scale(ys: torch.Tensor, lb: float) -> torch.Tensor:
    """Yeast: per-species standard deviation over time (ddof 0, as
    ``jnp.std``), max over experiments, + lb (yeast_glycolysis.jl:96-101)."""
    return ys.std(dim=1, correction=0).amax(dim=0) + lb


def _scale(ys: torch.Tensor, mode: str, lb: float) -> torch.Tensor:
    if mode == "max_min":
        return max_min_scale(ys, lb)
    if mode == "std":
        return std_scale(ys, lb)
    if mode == "none":
        return torch.ones(ys.shape[-1], dtype=ys.dtype, device=ys.device)
    raise ValueError(f"unknown scale_mode {mode!r}")


def latin_hypercube(gen: torch.Generator, n: int, d: int,
                    dtype=torch.float32) -> torch.Tensor:
    """Integer Latin hypercube / n (the reference's ``randomLHC(n, d) ./ n``,
    robertson/rober_crnn.jl:46): each column an independent permutation of
    {1..n}/n. ``gen`` is a CPU generator."""
    cols = [torch.randperm(n, generator=gen) + 1 for _ in range(d)]
    return torch.stack(cols, dim=1).to(dtype) / n


def _noisy_dataset(gen, u0_list, ys_clean, success, saveat, noise, obs_dim,
                   scale_lb, scale_mode="max_min") -> Dataset:
    """Multiplicative Gaussian noise ``ys_clean * (1 + noise * eps)`` and
    the scales of ``scale_mode``: 'max_min', 'std' (yeast) or 'none'
    (ones). ``gen`` is a CPU generator, so the noise is the same on
    every device."""
    if obs_dim is not None:
        ys_clean = ys_clean[..., :obs_dim]
    eps = torch.randn(ys_clean.shape, generator=gen, dtype=ys_clean.dtype)
    ys = ys_clean + eps.to(ys_clean.device) * ys_clean * noise
    return Dataset(u0=u0_list, ys=ys, ys_clean=ys_clean, ts=saveat,
                   yscale=_scale(ys, scale_mode, scale_lb), success=success)


def generate_dataset(
    gen: torch.Generator,
    rhs,
    rhs_jac,
    u0_list: torch.Tensor,
    k: torch.Tensor,
    t0,
    t1,
    saveat: torch.Tensor,
    rtol,
    atol,
    noise: float,
    obs_dim: Optional[int] = None,
    scale_lb: float = 0.0,
    max_steps: int = 16384,
) -> Dataset:
    """Solve the truth for every experiment with the batch-major
    Rosenbrock23, add noise, compute max-min scales.

    ``rhs(t, y (B, n), k (B, nk))`` and ``rhs_jac -> (du, J (B, n, n))`` are
    batched; ``k`` holds per-experiment constants. ``obs_dim`` truncates the
    state before noise and scales (case2 drops T).
    """
    with torch.no_grad():
        sol = batch_odesolve_rb23(
            rhs, rhs_jac, u0_list, t0, t1, saveat, args=k, rtol=rtol,
            atol=atol, max_steps=max_steps, unroll="while", jac_mode="dense")
    return _noisy_dataset(gen, u0_list, sol.ys, sol.success, saveat, noise,
                          obs_dim, scale_lb)


def generate_dataset_odesolve(
    gen: torch.Generator,
    rhs,
    solver: Solver,
    u0_list: torch.Tensor,
    k: torch.Tensor,
    t0,
    t1,
    saveat: torch.Tensor,
    rtol,
    atol,
    noise: float,
    scale_lb: float = 0.0,
    max_steps: int = 16384,
    scale_mode: str = "max_min",
) -> Dataset:
    """``generate_dataset`` of the JAX package: the truth of every
    experiment through the per-lane ``odesolve`` with ``solver``
    (``unroll='while'``), then noise and the scales of ``scale_mode``
    ('max_min', 'std' or 'none'). ``k`` (nk,) is shared or (n_exp, nk) per
    experiment."""
    if k.dim() == 1:
        k = k.expand(u0_list.shape[0], -1)
    with torch.no_grad():
        sol = odesolve(rhs, solver, u0_list, t0, t1, saveat, args=k,
                       rtol=rtol, atol=atol, max_steps=max_steps,
                       unroll="while")
    return _noisy_dataset(gen, u0_list, sol.ys, sol.success, saveat, noise,
                          None, scale_lb, scale_mode)
