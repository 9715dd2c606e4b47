"""Parameter vector -> physical CRNN weights (port of crnn_tpu/transforms/p2vec.py).

Only the case2 (Arrhenius) variant is ported so far. JAX's ``clip`` is
written as ``minimum(maximum(x, lo), hi)`` with tensor bounds
(``crnn_tpu_torch.clip``): at a tie such as ``w_out == 0`` its gradient is
0.5, as in JAX, where ``torch.clamp`` would give 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from crnn_tpu_torch import clip, resolve_device


class CRNNWeights(NamedTuple):
    """Physical CRNN weights."""

    w_in: torch.Tensor   # (n_features, nr) reaction orders (+ the Ea row)
    w_b: torch.Tensor    # (nr,) log rate-constant bias
    w_out: torch.Tensor  # (ns, nr) stoichiometric coefficients


def p2vec_case2(p: torch.Tensor, ns: int, nr: int,
                w_in_clip: float = 4.0) -> CRNNWeights:
    """p = [w_b(nr) | w_out(ns*nr) | w_in_Ea(nr) | slope] (case2/case2.jl:91-99)."""
    slope = p[nr * (ns + 2)] * 100.0
    w_b = p[:nr] * slope
    w_out = p[nr:nr * (ns + 1)].reshape(ns, nr)
    w_in_ea = torch.abs(p[nr * (ns + 1):nr * (ns + 2)] * slope)
    w_in = clip(-w_out, 0.0, w_in_clip)
    w_in = torch.cat([w_in, w_in_ea[None, :]], dim=0)  # (ns+1, nr)
    return CRNNWeights(w_in=w_in, w_b=w_b, w_out=w_out)


def init_params_case2(gen: torch.Generator, ns: int, nr: int,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """Reference init: N(0, 0.1), +0.8 on the w_b and w_in_Ea blocks,
    slope 0.1 (case2/case2.jl:85-89). ``gen`` is a CPU generator, so the
    draw is the same on every device."""
    n = nr * (ns + 2) + 1
    p = 0.1 * torch.randn(n, generator=gen, dtype=dtype)
    p[:nr] += 0.8
    p[nr * (ns + 1):nr * (ns + 2)] += 0.8
    p[-1] = 0.1
    return p.to(resolve_device(device))
