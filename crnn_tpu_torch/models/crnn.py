"""CRNN right-hand sides, lane-batched (port of crnn_tpu/models/crnn.py:
make_crnn_rhs, make_crnn_scaled_rhs, make_crnn_arrhenius_rhs,
make_crnn_reversible_rhs, the hybrid make_crnn_yeast_rhs and
make_crnn_qssa_rhs, and make_cathode_rhs with its closed-form Jacobian,
make_cathode_rhs_batch and cathode_hrr).

    du = w_out @ exp(min(w_in^T @ log(clip(y, lb, ub)) + w_b, exp_cap))

The JAX package writes each RHS for one lane and batches it with ``vmap``;
here ``rhs(t, y (B, ns), w) -> (B, ns)`` takes the lane axis first, which is
the shape of the isothermal kernel (``ops/csrc/crnn_rhs.cu``) and of the
Arrhenius kernel (``ops/csrc/arrhenius_rhs.cu``, y (B, ns+1) with T last):
every call on a CUDA tensor is one kernel launch, with the backward by
autograd of the plain version. The exponent cap of 32 keeps the rates of wild trial steps
finite, so reverse-mode gradients are not poisoned by inf * 0. Every RHS
here but the cathode's is independent of t and is declared so
(``ode/base.py:autonomous``). The reversible and the cathode RHS have no
kernel in either package: they are plain torch on every device. The hybrid
RHSs run their MLP in plain torch and their CRNN core on the isothermal
kernel, at ``u_full`` (B, ns_) with the hidden species appended.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.base import autonomous
from crnn_tpu_torch.ops.crnn_kernels import (make_arrhenius_ops,
                                             make_crnn_rhs_op)

# gas constant, kcal/(mol K): the Arrhenius feature is -1/(R_KCAL * T)
R_KCAL = 1.98720425864083e-3


def make_crnn_rhs(lb: float, ub: float, exp_cap: float = 32.0,
                  plain: bool = False) -> Callable:
    """Isothermal mass-action CRNN (case1). ``plain=True`` runs the plain
    version in place of the kernel on any device."""
    op = make_crnn_rhs_op(lb, ub, exp_cap, plain)

    @autonomous
    def rhs(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)

    return rhs


def make_crnn_scaled_rhs(lb: float, ub: float, dydt_scale: torch.Tensor,
                         exp_cap: float = 32.0, plain: bool = False) -> Callable:
    """CRNN with per-species dy/dt rescaling (robertson/rober_crnn.jl:113-116):
    the isothermal RHS times ``dydt_scale = yscale / t_end`` (ns,)."""
    op = make_crnn_rhs_op(lb, ub, exp_cap, plain)

    @autonomous
    def rhs(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out) * dydt_scale

    return rhs


def make_crnn_arrhenius_rhs(lb: float, ub: float, exp_cap: float = 32.0,
                            plain: bool = False) -> Callable:
    """Arrhenius CRNN (case2): temperature rides as the constant last state,
    the features are [log X; -1/(R*T)] (case2/case2.jl:113-118) and dT/dt =
    0. ``rhs(t, y (B, ns+1), w) -> (B, ns+1)`` runs the Arrhenius RHS kernel
    on a CUDA tensor; ``plain=True`` runs the plain version on any device."""
    op = make_arrhenius_ops(lb, ub, exp_cap, plain)[0]

    @autonomous
    def rhs(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)

    return rhs


def _capped_exp(z, exp_cap):
    return torch.exp(torch.minimum(z, z.new_full((), exp_cap)))


def make_crnn_reversible_rhs(lb: float, order_clip: float = 2.5,
                             exp_cap: float = 32.0) -> Callable:
    """Reversible CRNN with Kc = 1 (case1 rev/case1.jl:81-90): the forward
    and backward orders come from the shared w_out, ``clip(-w_out, 0,
    order_clip)`` and ``clip(w_out, 0, order_clip)``, and ``du = w_out @
    (exp(f) - exp(b))`` with the biases ``w_b`` and ``w_kb``; y is clipped
    to [lb, inf). ``rhs(t, y (B, ns), w) -> (B, ns)``."""

    @autonomous
    def rhs(t, y, w):
        w_in_f = clip(-w.w_out, 0.0, order_clip)
        w_in_b = clip(w.w_out, 0.0, order_clip)
        logx = torch.log(clip(y, lb, math.inf))
        fwd = _capped_exp(logx @ w_in_f + w.w_b, exp_cap)
        bwd = _capped_exp(logx @ w_in_b + w.w_kb, exp_cap)
        return (fwd - bwd) @ w.w_out.T

    return rhs


def make_crnn_yeast_rhs(lb: float, ub: float, ns: int,
                        mlp_apply_fn: Callable, exp_cap: float = 32.0,
                        plain: bool = False) -> Callable:
    """Hybrid CRNN with hidden species (yeast_glycolysis.jl:138-142): an MLP
    infers the hidden species from the ns observed ones, the CRNN core runs
    on the concatenated ``u_full (B, ns_)``, and the learned influx ``w_J``
    is added to the observed rows. ``args = (weights, mlp_params)``;
    ``mlp_apply_fn(params, y (B, ns)) -> (B, ns_ - ns)``."""
    op = make_crnn_rhs_op(lb, ub, exp_cap, plain)

    @autonomous
    def rhs(t, y, args):
        w, mlp_params = args
        u_full = torch.cat([y, mlp_apply_fn(mlp_params, y)], dim=1)
        return op(u_full, w.w_in, w.w_b, w.w_out)[:, :ns] + w.w_J

    return rhs


def make_crnn_qssa_rhs(lb: float, ub: float, mlp_apply_fn: Callable,
                       exp_cap: float = 32.0, plain: bool = False) -> Callable:
    """QSSA hybrid for Robertson (rober_crnn_qssa.jl:122-126): the fast
    radical y2 is replaced inside the RHS by an MLP of (y1, y3), and the
    CRNN core runs on ``u_full = [y1, MLP(y1, y3), y3]``. ``args =
    (weights, mlp_params)``."""
    op = make_crnn_rhs_op(lb, ub, exp_cap, plain)

    @autonomous
    def rhs(t, y, args):
        w, mlp_params = args
        y2 = mlp_apply_fn(mlp_params, y[:, 0::2])
        u_full = torch.cat([y[:, 0:1], y2, y[:, 2:3]], dim=1)
        return op(u_full, w.w_in, w.w_b, w.w_out)

    return rhs


# Gas constant J/(mol K) of the cathode model (network.jl:66: R = -1.0/8.314).
R_J = 8.314


def _cathode_exponent(logx, temp, w):
    """The extended Arrhenius exponent lnA + b ln T - Ea*1e5/(R T) + n log x;
    logx (..., 3), temp broadcast against it."""
    temp_term = (torch.log(temp) * w.extra["b"]
                 - (w.extra["Ea"] * 1e5) / (R_J * temp))
    return temp_term + w.w_in * logx + w.w_b


def _cathode_rates(logx, temp, w, exp_cap: float):
    return _capped_exp(_cathode_exponent(logx, temp, w), exp_cap)


def _cathode_parts(t, y, args, lb, t0_kelvin, exp_cap):
    """(weights, beta, T (B, 1), clipped y, exponent z, rates) at (t, y)."""
    w, beta = args
    temp = (t0_kelvin + beta / 60.0 * t)[:, None]
    yc = clip(y, lb, 10.0)
    z = _cathode_exponent(torch.log(yc), temp, w)
    return w, beta, temp, yc, z, _capped_exp(z, exp_cap)


def _cathode_chain(w, r):
    """``A @ r`` for the sequential chain c1 -> c2 -> c3, A's entries
    [-1; nu2, -1; nu3, -1]; ``w.w_out[..., k]`` is one stoichiometry for
    all lanes or, with lane-batched weights, one per lane."""
    return torch.stack([-r[:, 0],
                        w.w_out[..., 1] * r[:, 0] - r[:, 1],
                        w.w_out[..., 2] * r[:, 1] - r[:, 2]], dim=1)


def _cathode_jac(w, y, yc, z, lb, exp_cap):
    """``J = A diag(g)``, ``g_i = r_i n_i / y_i``, zeroed outside the y clip
    window and past the exp cap (the derivative of the clipped RHS)."""
    live = (y > lb) & (y < 10.0) & (z < exp_cap)
    g = torch.where(live, _capped_exp(z, exp_cap) * w.w_in / yc,
                    torch.zeros_like(z))
    zero = torch.zeros_like(g[:, 0])
    return torch.stack([
        torch.stack([-g[:, 0], zero, zero], dim=-1),
        torch.stack([w.w_out[..., 1] * g[:, 0], -g[:, 1], zero], dim=-1),
        torch.stack([zero, w.w_out[..., 2] * g[:, 1], -g[:, 2]], dim=-1),
    ], dim=1)


def make_cathode_rhs(lb: float, t0_kelvin: float = 373.15,
                     exp_cap: float = 32.0) -> Callable:
    """Sequential decomposition c1 -> c2 -> c3 under a linear heating ramp
    T = t0_kelvin + beta/60 * t (Cathode/src/network.jl:60-80); y is clipped
    to [lb, 10]. ``args = (weights, beta [K/min])``; the weights are one set
    for every lane or lane-batched (every leaf (B, 3), from
    ``p2vec_cathode`` of (B, 18) params); depends on t."""

    def rhs(t, y, args):
        w, _, _, _, _, rates = _cathode_parts(t, y, args, lb, t0_kelvin,
                                              exp_cap)
        return _cathode_chain(w, rates)

    return rhs


def make_cathode_jac(lb: float, t0_kelvin: float = 373.15,
                     exp_cap: float = 32.0) -> Callable:
    """The closed-form Jacobian of ``make_cathode_rhs``, the J of
    crnn_tpu/models/crnn.py:make_cathode_rhs_batch: each rate touches one
    species, so ``J = A diag(g)`` with ``g_i = r_i n_i / y_i`` (A the
    sequential stoichiometry), zeroed outside the y clip window and past the
    exp cap, as the derivative of the clipped RHS is. It equals forward mode
    of the RHS (``tests/test_torch_cathode.py``) at a fraction of its cost.
    ``jac(t (B,), y (B, 3), (weights, beta)) -> (B, 3, 3)``."""

    def jac(t, y, args):
        w, _, _, yc, z, _ = _cathode_parts(t, y, args, lb, t0_kelvin,
                                           exp_cap)
        return _cathode_jac(w, y, yc, z, lb, exp_cap)

    return jac


def make_cathode_rhs_batch(lb: float, t0_kelvin: float = 373.15,
                           exp_cap: float = 32.0):
    """The cathode RHS for the batch-major driver
    (``ode/batch_solve.py:batch_odesolve_rb23(..., nonautonomous=True)``),
    port of crnn_tpu/models/crnn.py:make_cathode_rhs_batch: every lane is
    one particle with weights of its own (``args = (w, beta)``, each leaf of
    ``w`` (B, 3); ``beta`` 0-d or (B,) [K/min]).

    Returns ``(f, f_jac)``: ``f(t (B,), y (B, 3), args) -> (B, 3)`` and
    ``f_jac -> (du, J (B, 3, 3), ft (B, 3))`` from one evaluation of the
    rates. J is ``make_cathode_jac``'s closed form; ``ft = df/dt = A (r
    dz/dT) dT/dt`` with ``dz/dT = b/T + Ea 1e5/(R T^2)``, ``dT/dt =
    beta/60``, zeroed past the exp cap."""
    f = make_cathode_rhs(lb, t0_kelvin, exp_cap)

    def f_jac(t, y, args):
        w, beta, temp, yc, z, rates = _cathode_parts(t, y, args, lb,
                                                     t0_kelvin, exp_cap)
        du = _cathode_chain(w, rates)
        jac = _cathode_jac(w, y, yc, z, lb, exp_cap)
        dz_dt = ((w.extra["b"] / temp
                  + (w.extra["Ea"] * 1e5) / (R_J * temp ** 2))
                 * (beta / 60.0 * torch.ones_like(t))[:, None])
        # a multiply by the mask, as JAX writes it
        dr_dt = rates * dz_dt * (z < exp_cap).to(y.dtype)
        return du, jac, _cathode_chain(w, dr_dt)

    return f, f_jac


def cathode_hrr(ts: torch.Tensor, ys: torch.Tensor, w, beta, lb: float,
                t0_kelvin: float = 373.15,
                exp_cap: float = 32.0) -> torch.Tensor:
    """Heat-release rate HRR(t) = rates(t) @ delH
    (Cathode/src/network.jl:82-91,121): ts (n_t,), ys (n_t, 3) -> (n_t,)."""
    temp = (t0_kelvin + beta / 60.0 * ts)[:, None]
    rates = _cathode_rates(torch.log(clip(ys, lb, 10.0)), temp, w, exp_cap)
    return rates @ w.extra["delH"]


def cathode_hrr_batch(ts: torch.Tensor, ys: torch.Tensor, w, beta, lb: float,
                      t0_kelvin: float = 373.15,
                      exp_cap: float = 32.0) -> torch.Tensor:
    """``cathode_hrr`` for every particle at once, JAX's ``vmap`` of it over
    (ys, w): ts (n_t,), ys (B, n_t, 3), lane-batched weights (leaves
    (B, 3)) -> (B, n_t)."""
    temp = (t0_kelvin + beta / 60.0 * ts)[:, None]
    w_lanes = w._replace(w_in=w.w_in[:, None], w_b=w.w_b[:, None],
                         extra={k: v[:, None] for k, v in w.extra.items()})
    rates = _cathode_rates(torch.log(clip(ys, lb, 10.0)), temp, w_lanes,
                           exp_cap)
    return (rates @ w.extra["delH"][:, :, None])[..., 0]
