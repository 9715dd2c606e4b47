"""Parameter vector -> physical CRNN weights (port of crnn_tpu/transforms/p2vec.py).

The case1, case2 (Arrhenius), case3/GRN, robertson, case1 rev
(reversible), yeast (hidden species and influx) and cathode (extended
Arrhenius) variants are ported. JAX's ``clip`` is
written as ``minimum(maximum(x, lo), hi)`` with tensor bounds
(``crnn_tpu_torch.clip``): at a tie such as ``w_out == 0`` its gradient is
0.5, as in JAX, where ``torch.clamp`` would give 1; likewise ``abs`` is
``crnn_tpu_torch.absolute``, whose gradient at 0 is JAX's 1, not 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from crnn_tpu_torch import absolute, clip, resolve_device


class CRNNWeights(NamedTuple):
    """Physical CRNN weights."""

    w_in: torch.Tensor   # (n_features, nr) reaction orders (+ the Ea row)
    w_b: torch.Tensor    # (nr,) log rate-constant bias
    w_out: torch.Tensor  # (ns, nr) stoichiometric coefficients
    w_kb: Optional[torch.Tensor] = None  # (nr,) reversible: backward log-k
    w_J: Optional[torch.Tensor] = None   # (ns,) yeast: learned constant influx
    extra: Optional[dict] = None         # cathode: named scalar groups


def p2vec_case2(p: torch.Tensor, ns: int, nr: int,
                w_in_clip: float = 4.0) -> CRNNWeights:
    """p = [w_b(nr) | w_out(ns*nr) | w_in_Ea(nr) | slope] (case2/case2.jl:91-99)."""
    slope = p[nr * (ns + 2)] * 100.0
    w_b = p[:nr] * slope
    w_out = p[nr:nr * (ns + 1)].reshape(ns, nr)
    w_in_ea = absolute(p[nr * (ns + 1):nr * (ns + 2)] * slope)
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


def p2vec_case1(p: torch.Tensor, ns: int, nr: int, b0: float = -10.0,
                w_in_clip: float = 2.5) -> CRNNWeights:
    """Sign-tied: p = [w_b(nr) | w_out(ns*nr)], w_b + b0, w_in =
    clip(-w_out, 0, 2.5) (case1/case1.jl:70-78)."""
    w_b = p[:nr] + b0
    w_out = p[nr:].reshape(ns, nr)
    return CRNNWeights(w_in=clip(-w_out, 0.0, w_in_clip), w_b=w_b, w_out=w_out)


def init_params_case1(gen: torch.Generator, ns: int, nr: int,
                      scale: float = 0.1, dtype=torch.float32,
                      device="cuda") -> torch.Tensor:
    """N(0, scale^2) of length nr*(ns+1). ``gen`` is a CPU generator."""
    p = scale * torch.randn(nr * (ns + 1), generator=gen, dtype=dtype)
    return p.to(resolve_device(device))


def p2vec_robertson(p: torch.Tensor, ns: int, nr: int,
                    w_in_clip: float = 2.5) -> CRNNWeights:
    """Product-tied: p = [w_b(nr) | w_out_raw(ns*nr) | w_in(ns*nr) | slope],
    w_b * 10|slope|, w_out = -w_in * 10^w_out_raw, w_in clipped to
    [0, 2.5] (robertson/rober_crnn.jl:80-92)."""
    slope = absolute(p[-1])
    w_b = p[:nr] * (10.0 * slope)
    w_in = p[nr * (ns + 1):nr * (2 * ns + 1)].reshape(ns, nr)
    w_out_raw = p[nr:nr * (ns + 1)].reshape(ns, nr)
    w_out = -w_in * 10.0 ** w_out_raw
    return CRNNWeights(w_in=clip(w_in, 0.0, w_in_clip), w_b=w_b, w_out=w_out)


def init_params_robertson(gen: torch.Generator, ns: int, nr: int,
                          dtype=torch.float64, device="cuda") -> torch.Tensor:
    """U(-1, 1) * sqrt(6/(ns+nr)) of length nr*(2ns+1)+1, slope 0.1
    (rober_crnn.jl:37-39). ``gen`` is a CPU generator."""
    n = nr * (2 * ns + 1) + 1
    lim = (6.0 / (ns + nr)) ** 0.5
    p = (torch.rand(n, generator=gen, dtype=dtype) * 2.0 - 1.0) * lim
    p[-1] = 0.1
    return p.to(resolve_device(device))


def p2vec_case3(p: torch.Tensor, ns: int, nr: int, w_in_clip: float = 4.0,
                frozen_rows: Optional[Sequence[int]] = None) -> CRNNWeights:
    """Product-tied: p = [w_b(nr) | w_out_raw(ns*nr) | w_in(ns*nr) | slope
    (unused)], w_out = -w_in * |w_out_raw| from the unclipped w_in, then
    w_in clipped to [0, 4] (case3/case3.jl:42-53). ``frozen_rows`` (the
    GRN's DNA species, gene-regulatory.jl:44) zeroes those rows of
    w_out_raw before the tie, so they are never produced or consumed."""
    w_b = p[:nr]
    w_out_raw = p[nr:nr * (ns + 1)].reshape(ns, nr)
    w_in = p[nr * (ns + 1):nr * (2 * ns + 1)].reshape(ns, nr)
    if frozen_rows is not None:
        mask = torch.ones((ns, 1), dtype=p.dtype, device=p.device)
        mask[list(frozen_rows)] = 0.0
        w_out_raw = w_out_raw * mask
    w_out = -w_in * absolute(w_out_raw)
    return CRNNWeights(w_in=clip(w_in, 0.0, w_in_clip), w_b=w_b, w_out=w_out)


def init_params_case3(gen: torch.Generator, ns: int, nr: int,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """case3/case3.jl:34-36: robertson's layout and law (U(-1, 1) *
    sqrt(6/(ns+nr)) of length nr*(2ns+1)+1, the slope 0.1 last), f32 by
    default. ``gen`` is a CPU generator."""
    return init_params_robertson(gen, ns, nr, dtype=dtype, device=device)


def p2vec_reversible(p: torch.Tensor, ns: int, nr: int,
                     w_out_clip: float = 2.5) -> CRNNWeights:
    """Reversible pairs sharing w_out with Kc = 1: p = [w_kf(nr) |
    w_out(ns*nr)], w_out clipped to [-2.5, 2.5], w_kb = w_kf (case1
    rev/case1.jl:72-78). The RHS derives both order matrices from w_out;
    ``w_in`` carries w_out as in the JAX package."""
    w_kf = p[:nr]
    w_out = clip(p[nr:].reshape(ns, nr), -w_out_clip, w_out_clip)
    return CRNNWeights(w_in=w_out, w_b=w_kf, w_out=w_out, w_kb=w_kf)


def init_params_reversible(gen: torch.Generator, ns: int, nr: int,
                           dtype=torch.float32, device="cuda") -> torch.Tensor:
    """N(0, 0.25) of length nr*(ns+1). ``gen`` is a CPU generator."""
    p = 0.5 * torch.randn(nr * (ns + 1), generator=gen, dtype=dtype)
    return p.to(resolve_device(device))


def p2vec_yeast(p: torch.Tensor, ns: int, ns_: int, nr: int,
                w_in_clip: float = 4.0) -> CRNNWeights:
    """Hidden species and influx: p = [w_b(nr) | w_out(ns_*nr) | w_J(ns) |
    slope], w_b * 100 slope, w_in = clip(-w_out, 0, 4) over all ns_
    species (yeast_glycolysis.jl:108-115)."""
    np_ = nr * (ns_ + 1) + ns + 1
    slope = p[np_ - 1] * 100.0
    w_b = p[:nr] * slope
    w_out = p[nr:nr * (ns_ + 1)].reshape(ns_, nr)
    w_J = p[nr * (ns_ + 1):np_ - 1]
    return CRNNWeights(w_in=clip(-w_out, 0.0, w_in_clip), w_b=w_b,
                       w_out=w_out, w_J=w_J)


def init_params_yeast(gen: torch.Generator, ns: int, ns_: int, nr: int,
                      dtype=torch.float32, device="cuda") -> torch.Tensor:
    """U(-1, 1) * sqrt(6/(ns_+nr)) of length nr*(ns_+1)+ns+1, slope 0.1
    (yeast_glycolysis.jl:104-106). ``gen`` is a CPU generator."""
    n = nr * (ns_ + 1) + ns + 1
    lim = (6.0 / (ns_ + nr)) ** 0.5
    p = (torch.rand(n, generator=gen, dtype=dtype) * 2.0 - 1.0) * lim
    p[-1] = 0.1
    return p.to(resolve_device(device))


def p2vec_cathode(p: torch.Tensor) -> CRNNWeights:
    """17 named kinetic scalars and a slope: p = [lnA(3) | Ea(3) | b(3) |
    delH(3) | order(3) | nu(2) | slope] (Cathode/src/network.jl:27-50).
    ``w_in`` holds the reaction orders, ``w_b`` lnA, ``w_out`` the
    stoichiometry [1, nu], ``extra`` Ea, b and delH. Lane-batched for
    ``p (B, 18)``: every leaf (B, 3), JAX's ``vmap(p2vec_cathode)``."""
    slope = p[..., 17:18] * 10.0
    w_a = clip(p[..., 0:3] * (slope * 20.0), 0.0, 50.0)
    w_in_ea = clip(absolute(p[..., 3:6]), 0.0, 3.0)
    w_delh = clip(absolute(p[..., 9:12]) * 100.0, 10.0, 300.0)
    w_in_order = clip(p[..., 12:15], 0.01, 10.0)
    w_out_nu = clip(torch.cat([p.new_ones(p.shape[:-1] + (1,)),
                               p[..., 15:17]], dim=-1), 0.01, 5.0)
    return CRNNWeights(w_in=w_in_order, w_b=w_a, w_out=w_out_nu,
                       extra={"Ea": w_in_ea, "b": p[..., 6:9],
                              "delH": w_delh})


def init_params_cathode(gen: torch.Generator, dtype=torch.float64,
                        device="cuda") -> torch.Tensor:
    """N(0, 1e-4) with physically informed offsets
    (Cathode/src/network.jl:9-25). ``gen`` is a CPU generator."""
    p = 0.01 * torch.randn(18, generator=gen, dtype=dtype)
    p[0:3] += 1.0                                           # lnA
    p[3:6] += torch.tensor([1.0, 1.1, 1.2], dtype=dtype)    # Ea ordering
    p[9] += 1.0                                             # delH
    p[10] += 0.2
    p[11] += 0.3
    p[12:15] += 1.0                                         # reaction orders
    p[15:17] += 1.0                                         # stoich nu
    p[17] = 0.1                                             # slope
    return p.to(resolve_device(device))
