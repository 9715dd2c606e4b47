"""Trajectory loss (port of crnn_tpu/train/loss.py: the scaled MAE with an
observed-species subset, and prefix masks)."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch


def make_trajectory_loss(
    yscale: Optional[torch.Tensor] = None,
    i_obs: Optional[Sequence[int]] = None,
) -> Callable:
    """Build the scaled-MAE ``loss_fn(pred, data, horizon_mask=None)``
    (JAX's ``kind='mae'``; the other kinds are not ported yet).

    pred/data: (..., n_save, n_obs_total), horizon_mask (..., n_save);
    returns one loss per leading index: mean |pred/ys - data/ys| over the
    observed species ``i_obs`` and the masked save points.
    """
    obs = None if i_obs is None else list(i_obs)

    def loss_fn(pred, data, horizon_mask=None):
        p, d = pred, data
        if obs is not None:
            p = p[..., obs]
            d = d[..., obs]
        if yscale is not None:
            ys = yscale if obs is None else yscale[obs]
            p = p / ys
            d = d / ys
        err = torch.abs(p - d)
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
