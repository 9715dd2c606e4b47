"""The continuous backsolve adjoint (ode/adjoint.py) against the JAX
package's ``odesolve_adjoint`` under ``jax.vmap``, in f64.

- the closed form of d/dlam sum(y(t)^2) for y = y0 exp(-lam t);
- two lanes whose step counts differ, the loss summed over both: each lane
  integrates its own parameter cotangent g under its own step control, as
  under JAX's vmap, so the gradient equals JAX's at rtol 1e-6 at a loose
  backward tolerance (rtol 1e-3), where a g summed over the lanes inside
  the integrand would move the step sizes and the result;
- a lane whose forward solve fails contributes exactly zero;
- the adjoint against the port's own discrete (scan) adjoint at rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.ode import Rosenbrock23 as JRosenbrock23
from crnn_tpu.ode import Tsit5 as JTsit5
from crnn_tpu.ode.adjoint import odesolve_adjoint as j_adjoint
from crnn_tpu_torch import clip
from crnn_tpu_torch.ode import Rosenbrock23, Tsit5
from crnn_tpu_torch.ode.adjoint import odesolve_adjoint
from crnn_tpu_torch.ode.base import autonomous
from crnn_tpu_torch.ode.solve import odesolve

NS, NR = 3, 2
SOLVERS = {"tsit5": (JTsit5, Tsit5), "rosenbrock23": (JRosenbrock23,
                                                      Rosenbrock23)}
# lane 1 takes 3-15x the steps of lane 0
Y0 = np.array([[1.0, 0.8, 0.4], [3.0, 0.1, 2.0]])
SAVEAT = np.linspace(0.0, 2.0, 5)   # saveat[0] == t0: a degenerate segment


def _params():
    p = 0.1 * np.random.default_rng(0).normal(size=2 * NS * NR + NR)
    p[2 * NS * NR:] -= 1.0
    return p


def _j_rhs(t, y, p):
    w_in = jnp.abs(p[:NS * NR].reshape(NS, NR))
    w_out = p[NS * NR:2 * NS * NR].reshape(NS, NR)
    logx = jnp.log(jnp.clip(y, 1e-8, 1e1))
    return w_out @ jnp.exp(w_in.T @ logx + p[2 * NS * NR:])


@autonomous
def _t_rhs(t, y, p):
    w_in = torch.abs(p[:NS * NR].reshape(NS, NR))
    w_out = p[NS * NR:2 * NS * NR].reshape(NS, NR)
    logx = torch.log(clip(y, 1e-8, 1e1))
    return torch.exp(logx @ w_in + p[2 * NS * NR:]) @ w_out.T


def _both(solver, rtol, atol, max_steps=4096):
    """(JAX value and grads, port value and grads) of a loss summed over
    the two lanes, w.r.t. p and y0."""
    j_solver, t_solver = SOLVERS[solver]
    kw = dict(rtol=rtol, atol=atol, max_steps=max_steps)

    def j_loss(p, u):
        ys = jax.vmap(lambda ui: j_adjoint(
            _j_rhs, j_solver(), ui, 0.0, 2.0, jnp.asarray(SAVEAT), args=p,
            **kw))(u)
        return jnp.mean(ys**2) + jnp.sum(ys[:, :, 0])

    j_val, (j_gp, j_gy) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(_params()), jnp.asarray(Y0))
    p = torch.from_numpy(_params()).requires_grad_(True)
    u = torch.from_numpy(Y0.copy()).requires_grad_(True)
    ys = odesolve_adjoint(_t_rhs, t_solver(), u, 0.0, 2.0,
                          torch.from_numpy(SAVEAT), args=p, **kw)
    loss = torch.mean(ys**2) + torch.sum(ys[:, :, 0])
    gp, gy = torch.autograd.grad(loss, (p, u))
    return ((float(j_val), np.asarray(j_gp), np.asarray(j_gy)),
            (loss.item(), gp.numpy(), gy.numpy()))


def test_backsolve_matches_closed_form():
    y0 = torch.tensor([[2.0, 1.0]], dtype=torch.float64)
    saveat = torch.linspace(0.5, 3.0, 6, dtype=torch.float64)
    lam = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    ys = odesolve_adjoint(autonomous(lambda t, y, a: -a * y), Tsit5(), y0,
                          0.0, 3.0, saveat, args=lam, rtol=1e-10, atol=1e-12)
    (g,) = torch.autograd.grad(torch.sum(ys**2), lam)
    expected = torch.sum(2.0 * (y0[0][None, :] * torch.exp(
        -0.7 * saveat)[:, None]) ** 2 * (-saveat)[:, None])
    np.testing.assert_allclose(g.item(), expected.item(), rtol=1e-6)
    j_g = jax.grad(lambda a: jnp.sum(j_adjoint(
        lambda t, y, aa: -aa * y, JTsit5(), jnp.asarray([2.0, 1.0]), 0.0, 3.0,
        jnp.asarray(saveat.numpy()), args=a, rtol=1e-10, atol=1e-12) ** 2))(
            jnp.asarray(0.7))
    np.testing.assert_allclose(g.item(), float(j_g), rtol=1e-9)


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_per_lane_cotangents_match_jax_vmap(solver):
    (j_val, j_gp, j_gy), (val, gp, gy) = _both(solver, 1e-3, 1e-6)
    np.testing.assert_allclose(val, j_val, rtol=1e-12)
    np.testing.assert_allclose(gp, j_gp, rtol=1e-6,
                               atol=1e-6 * np.abs(j_gp).max())
    np.testing.assert_allclose(gy, j_gy, rtol=1e-6,
                               atol=1e-6 * np.abs(j_gy).max())
    steps = odesolve(_t_rhs, SOLVERS[solver][1](), torch.from_numpy(Y0), 0.0,
                     2.0, torch.from_numpy(SAVEAT),
                     args=torch.from_numpy(_params()), rtol=1e-3,
                     atol=1e-6, unroll="while").n_steps
    assert int(steps[1]) >= 3 * int(steps[0])


def test_failed_forward_solve_gates_the_lane_to_zero():
    """Rosenbrock23 with max_steps 5: lane 0 finishes in 3 steps, lane 1
    does not, and its y0 gradient and its share of the p gradient are 0."""
    (_, j_gp, j_gy), (_, gp, gy) = _both("rosenbrock23", 1e-3, 1e-6,
                                         max_steps=5)
    assert np.all(gy[1] == 0.0) and np.all(j_gy[1] == 0.0)
    assert np.all(gy[0] != 0.0)
    np.testing.assert_allclose(gy, j_gy, rtol=1e-6)
    np.testing.assert_allclose(gp, j_gp, rtol=1e-6,
                               atol=1e-6 * np.abs(j_gp).max())
    # the p gradient is lane 0's alone
    p = torch.from_numpy(_params()).requires_grad_(True)
    ys = odesolve_adjoint(_t_rhs, Rosenbrock23(), torch.from_numpy(Y0[:1]),
                          0.0, 2.0, torch.from_numpy(SAVEAT), args=p,
                          rtol=1e-3, atol=1e-6, max_steps=5)
    (g0,) = torch.autograd.grad(torch.mean(ys**2) / 2.0
                                + torch.sum(ys[:, :, 0]), p)
    np.testing.assert_allclose(gp, g0.numpy(), rtol=1e-12, atol=1e-15)


def test_backsolve_matches_discrete_adjoint():
    """The continuous adjoint against reverse mode through the port's scan,
    for both the p and the y0 cotangents (tests/test_adjoint.py's check)."""
    saveat = torch.from_numpy(SAVEAT)
    kw = dict(rtol=1e-10, atol=1e-12)
    grads = []
    for adjoint in (True, False):
        p = torch.from_numpy(_params()).requires_grad_(True)
        u = torch.from_numpy(Y0[:1].copy()).requires_grad_(True)
        if adjoint:
            ys = odesolve_adjoint(_t_rhs, Tsit5(), u, 0.0, 2.0, saveat,
                                  args=p, **kw)
        else:
            ys = odesolve(_t_rhs, Tsit5(), u, 0.0, 2.0, saveat, args=p,
                          max_steps=160, unroll="scan", **kw).ys
        loss = torch.mean(ys**2) + torch.sum(ys[:, :, 0])
        grads.append(torch.autograd.grad(loss, (p, u)))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-10)
