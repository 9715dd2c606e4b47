"""One flat tensor for a params tree, in ``jax.flatten_util.ravel_pytree``'s
order.

The port's optimizer, ``TrainState`` and checkpoint take one flat tensor;
the hybrid cases keep their params as JAX does, ``{"crnn": vec, "mlp":
[{"w", "b"}, ...]}``. ``ravel_pytree`` lays the leaves out as JAX does:
dict keys sorted (``crnn`` before ``mlp``, ``b`` before ``w``), lists and
tuples in order, each leaf raveled in C order. So the flat vector is JAX's
own, and a global-norm clip or a weight decay over it is optax's over the
leaves.
"""

from __future__ import annotations

from typing import Any, Callable

import torch


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples, in JAX's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def _rebuild(tree: Any, leaves: list) -> Any:
    """``tree``'s structure with its leaves taken in order from ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves) for sub in tree)
    return leaves.pop(0)


def ravel_pytree(tree: Any) -> tuple[torch.Tensor, Callable]:
    """(flat, unravel): ``flat`` the leaves raveled and concatenated in
    JAX's order; ``unravel(flat)`` the tree again, each leaf a view of
    ``flat`` in its shape, so gradients flow through it."""
    leaves = tree_leaves(tree)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [x.numel() for x in leaves]
    flat = torch.cat([x.reshape(-1) for x in leaves])

    def unravel(v: torch.Tensor) -> Any:
        parts = [p.reshape(s) for p, s in zip(torch.split(v, sizes), shapes)]
        return _rebuild(tree, parts)

    return flat, unravel
