"""Levenberg-Marquardt finisher on a residual vector (port of
crnn_tpu/train/lm.py:levenberg_marquardt).

After ADAM, polish with LM where the residuals are the per-experiment
losses and the Jacobian comes from forward mode (``torch.func.jacfwd``, the
reference's ``ForwardDiff.jacobian``): the residual and parameter counts are
both small. The damped normal equations use the Marquardt scaling
``lambda * diag(JtJ)`` and are solved by conjugate gradients written as
``jax.scipy.sparse.linalg.cg`` runs them, so that the iterates follow the
JAX package's; lambda follows a multiplicative trust-region rule.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def cg(matvec: Callable, b: torch.Tensor, maxiter: int, tol: float = 1e-5,
       atol: float = 0.0) -> torch.Tensor:
    """Conjugate gradients for an SPD operator, as
    ``jax.scipy.sparse.linalg.cg`` with ``x0 = 0`` and no preconditioner:
    stop when the squared residual norm is at most ``max(tol^2 |b|^2,
    atol^2)`` or after ``maxiter`` iterations (one host read each)."""
    atol2 = max(tol**2 * float(torch.dot(b, b)), atol**2)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    gamma = torch.dot(r, r)
    k = 0
    while float(gamma) > atol2 and k < maxiter:
        ap = matvec(p)
        alpha = gamma / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        gamma_new = torch.dot(r, r)
        p = r + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x


def levenberg_marquardt(
    residual_fn: Callable,
    p0: torch.Tensor,
    max_iters: int = 100,
    lam0: float = 1e-3,
    lam_up: float = 3.0,
    lam_down: float = 3.0,
    x_tol: float = 1e-8,
    g_tol: float = 1e-12,
    verbose: bool = False,
) -> Tuple[torch.Tensor, dict]:
    """Minimise ``0.5*||r(p)||^2`` for ``residual_fn(p) -> (n_res,)``, which
    must be plain torch (forward mode). Host-driven outer loop. Returns
    ``(p_opt, {"cost", "history", "converged"})``."""

    def lm_step(p, lam):
        jac, r = torch.func.jacfwd(lambda q: (residual_fn(q),) * 2,
                                   has_aux=True)(p)
        jtj = jac.T @ jac
        jtr = jac.T @ r
        damped = (jtj + lam * torch.diag(torch.diag(jtj))
                  + 1e-12 * torch.eye(p.shape[0], dtype=p.dtype,
                                      device=p.device))
        # CG on the SPD damped normal equations, as the JAX package solves
        # them; the system is tiny, so CG ends within np iterations
        delta = cg(lambda x: damped @ x, -jtr, maxiter=4 * p.shape[0],
                   tol=1e-12)
        return r, jtr, delta

    with torch.no_grad():
        p = p0.detach()
        lam = lam0
        cost = float(0.5 * torch.sum(residual_fn(p) ** 2))
        history = [cost]
        converged = False
        for it in range(max_iters):
            _, jtr, delta = lm_step(p, lam)
            if float(torch.max(torch.abs(jtr))) < g_tol:
                converged = True
                break
            p_new = p + delta
            cost_new = float(0.5 * torch.sum(residual_fn(p_new) ** 2))
            if cost_new < cost:
                rel_step = float(torch.linalg.norm(delta)
                                 / (torch.linalg.norm(p) + 1e-30))
                p, cost = p_new, cost_new
                lam = max(lam / lam_down, 1e-12)
                history.append(cost)
                if verbose:
                    print(f"LM iter {it}: cost {cost:.6e} lam {lam:.2e}")
                if rel_step < x_tol:
                    converged = True
                    break
            else:
                lam = min(lam * lam_up, 1e12)
                if lam >= 1e12:
                    break
    return p, {"cost": cost, "history": np.asarray(history),
               "converged": converged}
