"""Carry weights, optimizer state and data across from the JAX package.

Each function takes numpy arrays (``np.asarray`` of the JAX values) and
returns the port's tensors on the chosen device, so that a test or a user
can continue a JAX run in the port on the same numbers. A params tree of
the JAX package (the hybrid cases' ``{"crnn", "mlp": [{"w", "b"}, ...]}``)
and its optax moments become one flat tensor, raveled in
``jax.flatten_util.ravel_pytree``'s order (``transforms/ravel.py``), which
is the order of the port's cases.
"""

from __future__ import annotations

import numpy as np
import torch

from crnn_tpu_torch import resolve_device
from crnn_tpu_torch.data.generate import Dataset
from crnn_tpu_torch.train.optimizers import AdamState
from crnn_tpu_torch.transforms.ravel import tree_leaves


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(resolve_device(device))


def _flat(tree) -> np.ndarray:
    """A params tree (or a flat vector) raveled in JAX's leaf order."""
    return np.concatenate([np.asarray(x).reshape(-1)
                           for x in tree_leaves(tree)])


def params_from_jax(p, device="cuda") -> torch.Tensor:
    """A flat parameter vector, or a params tree raveled in JAX's order."""
    return _tensor(_flat(p), device)


def opt_state_from_jax(mu, nu, count, device="cuda") -> AdamState:
    """optax's ``ScaleByAdamState`` (mu, nu, count); trees of moments are
    raveled as ``params_from_jax`` ravels the params."""
    return AdamState(_tensor(_flat(mu), device), _tensor(_flat(nu), device),
                     int(np.asarray(count)))


def _find_adam_state(state):
    if all(hasattr(state, k) for k in ("mu", "nu", "count")):
        return state
    if isinstance(state, (tuple, list)):
        for sub in state:
            found = _find_adam_state(sub)
            if found is not None:
                return found
    return None


def adam_state_from_optax(opt_state, device="cuda") -> AdamState:
    """The Adam moments of an optax state of the JAX package's optimizers,
    whatever its chain: ``adamw_like`` nests them as ``(decay, (adam,
    scale))`` or, with a clip, ``(clip, (decay, (adam, scale)))``, and
    ``expdecay_adamw`` as ``(clip, (decay, (adam, schedule)))``. The state
    is walked as plain tuples, without importing optax."""
    adam = _find_adam_state(opt_state)
    if adam is None:
        raise ValueError("no (mu, nu, count) Adam state in the optax state")
    return opt_state_from_jax(adam.mu, adam.nu, adam.count, device=device)


def dataset_from_jax(u0: np.ndarray, ys: np.ndarray, ys_clean: np.ndarray,
                     ts: np.ndarray, yscale: np.ndarray, success=None,
                     device="cuda") -> Dataset:
    """A ``Dataset``. ``success`` (n_exp,) is the JAX truth solve's health;
    without it every truth solve is taken as successful."""
    u0_t = _tensor(u0, device)
    if success is None:
        ok = torch.ones(u0_t.shape[0], dtype=torch.bool, device=u0_t.device)
    else:
        ok = _tensor(np.asarray(success, dtype=bool), device)
    return Dataset(u0=u0_t, ys=_tensor(ys, device),
                   ys_clean=_tensor(ys_clean, device), ts=_tensor(ts, device),
                   yscale=_tensor(yscale, device), success=ok)
