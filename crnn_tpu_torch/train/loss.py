"""Trajectory losses (port of crnn_tpu/train/loss.py: the scaled MAE and
MSE, the log-space MAE, an observed-species subset, and prefix masks)."""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch

from crnn_tpu_torch import absolute, clip


def make_trajectory_loss(
    kind: str = "mae",
    yscale: Optional[torch.Tensor] = None,
    i_obs: Optional[Sequence[int]] = None,
    clip_lb: Optional[float] = None,
    clip_ub: Optional[float] = None,
) -> Callable:
    """Build ``loss_fn(pred, data, horizon_mask=None)``.

    pred/data: (..., n_save, n_obs_total), horizon_mask (..., n_save);
    returns one loss per leading index, a mean over the observed species
    ``i_obs`` and the masked save points of:
      - 'mae':     |pred/ys - data/ys|
      - 'mse':     (pred/ys - data/ys)^2
      - 'log_mae': |log(clip(pred)) - log(clip(data))| with the bounds
        ``clip_lb``/``clip_ub`` (None: unbounded); ``yscale`` is ignored,
        as in the JAX package (case3)
    """
    if kind not in ("mae", "mse", "log_mae"):
        raise ValueError(f"unknown loss kind {kind!r}")
    obs = None if i_obs is None else list(i_obs)
    lo = -math.inf if clip_lb is None else clip_lb
    hi = math.inf if clip_ub is None else clip_ub

    def loss_fn(pred, data, horizon_mask=None):
        p, d = pred, data
        if obs is not None:
            p = p[..., obs]
            d = d[..., obs]
        if kind == "log_mae":
            p = torch.log(clip(p, lo, hi))
            d = torch.log(clip(d, lo, hi))
        elif yscale is not None:
            ys = yscale if obs is None else yscale[obs]
            p = p / ys
            d = d / ys
        err = absolute(p - d) if kind != "mse" else (p - d) ** 2
        if horizon_mask is None:
            return err.mean(dim=(-2, -1))
        w = horizon_mask[..., :, None]
        return (err * w).sum(dim=(-2, -1)) / (w.sum(dim=(-2, -1)) * err.shape[-1])

    return loss_fn


def prefix_mask(n_save: int, sample: torch.Tensor,
                dtype=torch.float32) -> torch.Tensor:
    """0/1 mask selecting the first ``sample`` save points; ``sample`` (...,)
    gives (..., n_save) (rober_crnn.jl:218)."""
    sample = torch.as_tensor(sample)
    idx = torch.arange(n_save, device=sample.device)
    return (idx < sample[..., None]).to(dtype)
