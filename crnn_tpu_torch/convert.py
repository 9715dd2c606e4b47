"""Carry weights, optimizer state and data across from the JAX package.

Each function takes numpy arrays (``np.asarray`` of the JAX values) and
returns the port's tensors on the chosen device, so that a test or a user
can continue a JAX run in the port on the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from crnn_tpu_torch import resolve_device
from crnn_tpu_torch.data.generate import Dataset
from crnn_tpu_torch.train.optimizers import AdamState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def params_from_jax(p: np.ndarray, device="cuda") -> torch.Tensor:
    """A flat parameter vector."""
    return _tensor(p, device)


def opt_state_from_jax(mu: np.ndarray, nu: np.ndarray, count,
                       device="cuda") -> AdamState:
    """optax's ``ScaleByAdamState`` (mu, nu, count) of ``expdecay_adamw``."""
    return AdamState(_tensor(mu, device), _tensor(nu, device),
                     int(np.asarray(count)))


def dataset_from_jax(u0: np.ndarray, ys: np.ndarray, ys_clean: np.ndarray,
                     ts: np.ndarray, yscale: np.ndarray,
                     device="cuda") -> Dataset:
    """A ``Dataset``; every truth solve is taken as successful."""
    u0_t = _tensor(u0, device)
    return Dataset(u0=u0_t, ys=_tensor(ys, device),
                   ys_clean=_tensor(ys_clean, device), ts=_tensor(ts, device),
                   yscale=_tensor(yscale, device),
                   success=torch.ones(u0_t.shape[0], dtype=torch.bool,
                                      device=u0_t.device))
