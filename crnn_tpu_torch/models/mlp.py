"""Tiny MLP, lane-batched (port of crnn_tpu/models/mlp.py): the hybrid
cases' building block (yeast_glycolysis.jl:129-136,
rober_crnn_qssa.jl:112-120).

The params are a list of ``{"w": (fan_out, fan_in), "b": (fan_out,)}``
dicts, as in the JAX package; ``mlp_apply`` maps lanes ``x (B, in) ->
(B, out)``. The activations are JAX's: ``gelu`` is the tanh approximation
(``jax.nn.gelu``'s default, where ``torch.nn.functional.gelu`` is the erf
form) and ``softplus`` is ``logaddexp(x, 0)`` (torch's returns x above its
threshold of 20). The port's optimizer takes one flat tensor: the cases
ravel the params dict with ``transforms/ravel.py``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from crnn_tpu_torch import resolve_device

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (approximate=True), in its expression order."""
    cdf = 0.5 * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x ** 3)))
    return x * cdf


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(x) = logaddexp(x, 0)``, with no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


ACTIVATIONS = {
    "gelu": gelu,
    "softplus": softplus,
    "exp": torch.exp,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def mlp_init(gen: torch.Generator, sizes: Sequence[int],
             activations: Sequence[str], dtype=torch.float32,
             device="cuda"):
    """Glorot-uniform weights and zero biases. ``sizes = [in, h1, ...,
    out]``; ``activations`` has ``len(sizes) - 1`` entries, one after each
    layer. ``gen`` is a CPU generator, so the draw is the same on every
    device. Returns (params, activations)."""
    if len(activations) != len(sizes) - 1:
        raise ValueError("one activation per layer")
    dev = resolve_device(device)
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        lim = math.sqrt(6.0 / (fan_in + fan_out))
        w = (torch.rand((fan_out, fan_in), generator=gen, dtype=dtype)
             * 2.0 - 1.0) * lim
        params.append({"w": w.to(dev),
                       "b": torch.zeros(fan_out, dtype=dtype, device=dev)})
    return params, tuple(activations)


def mlp_apply(params_and_acts, x: torch.Tensor) -> torch.Tensor:
    """``x (B, in) -> (B, out)``: each layer ``act(x @ w^T + b)``."""
    params, acts = params_and_acts
    h = x
    for layer, act in zip(params, acts):
        h = ACTIVATIONS[act](h @ layer["w"].T + layer["b"])
    return h


def make_mlp(gen: torch.Generator, sizes: Sequence[int],
             activations: Sequence[str], dtype=torch.float32, device="cuda"):
    """(params, apply_fn) with ``apply_fn(params, x)`` closing over the
    activations."""
    params, acts = mlp_init(gen, sizes, activations, dtype, device)

    def apply_fn(p, x):
        return mlp_apply((p, acts), x)

    return params, apply_fn
