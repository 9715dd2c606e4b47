"""Synthetic datasets: batched truth solve + noise + scales
(port of crnn_tpu/data/generate.py).

All experiments integrate together through the port's own
``batch_odesolve_rb23`` (dense W-solve with the truth's closed-form
Jacobian, ``unroll='while'``), so no JAX is needed to make case2's data.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23


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
    """Solve the truth for every experiment, add multiplicative Gaussian
    noise ``ys_clean * (1 + noise * eps)``, compute max-min scales.

    ``rhs(t, y (B, n), k (B, nk))`` and ``rhs_jac -> (du, J (B, n, n))`` are
    batched; ``k`` holds per-experiment constants. ``gen`` is a CPU
    generator, so the noise is the same on every device. ``obs_dim``
    truncates the state before noise and scales (case2 drops T).
    """
    with torch.no_grad():
        sol = batch_odesolve_rb23(
            rhs, rhs_jac, u0_list, t0, t1, saveat, args=k, rtol=rtol,
            atol=atol, max_steps=max_steps, unroll="while", jac_mode="dense")
    ys_clean = sol.ys if obs_dim is None else sol.ys[..., :obs_dim]
    eps = torch.randn(ys_clean.shape, generator=gen, dtype=ys_clean.dtype)
    ys = ys_clean + eps.to(ys_clean.device) * ys_clean * noise
    return Dataset(u0=u0_list, ys=ys, ys_clean=ys_clean, ts=saveat,
                   yscale=max_min_scale(ys, scale_lb), success=sol.success)
