"""``dt0`` (a caller-given first step) on crnn_tpu_torch's drivers,
``ode/solve.py:odesolve`` and ``ode/batch_solve.py:batch_odesolve_rb23``,
against crnn_tpu's on the same numpy inputs (f64, n_steps exact), and the
port's fixed-step convergence order for every solver that
tests/test_solvers.py checks: adaptivity off by huge tolerances, ``dt0``
and factor caps of 1, one lane per step size (``dt0`` per lane), against
the closed-form solution of y' = -y + sin(3t), y(0) = 1.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.models.crnn import make_crnn_scaled_rhs as j_make_scaled_rhs
from crnn_tpu.models.jacobian import make_crnn_scaled_jac as j_make_scaled_jac
from crnn_tpu.ode import Rosenbrock23 as JRosenbrock23
from crnn_tpu.ode import Tsit5 as JTsit5
from crnn_tpu.ode import odesolve as j_odesolve
from crnn_tpu.ode.batch_solve import batch_odesolve_rb23 as j_batch
from crnn_tpu.transforms.p2vec import init_params_robertson as j_init
from crnn_tpu.transforms.p2vec import p2vec_robertson as j_p2vec
from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs
from crnn_tpu_torch.ode import TRBDF2, Kvaerno3, Rosenbrock23, Tsit5
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ops.crnn_kernels import make_crnn_rhs_jac_op
from crnn_tpu_torch.transforms.p2vec import p2vec_robertson

Y0 = np.array([[1.0], [0.4], [2.0]])
DT0 = np.array([0.3, 1e-3, 0.05])


def _j_forced(t, y, args):
    return -y + jnp.sin(3.0 * t)


def _forced(t, y, args):
    return -y + torch.sin(3.0 * t)[:, None]


@pytest.mark.parametrize("name", ["tsit5", "rosenbrock23"])
def test_odesolve_dt0_per_lane_matches_jax(name):
    """Adaptive solves started from a per-lane dt0 (and a shared one)."""
    j_solver, solver = {"tsit5": (JTsit5(), Tsit5()),
                        "rosenbrock23": (JRosenbrock23(), Rosenbrock23())}[name]
    saveat = np.linspace(0.0, 4.0, 9)
    kw = dict(rtol=1e-4, atol=1e-7, max_steps=400, unroll="while")

    def j_one(y0, dt0):
        sol = j_odesolve(_j_forced, j_solver, y0, 0.0, 4.0,
                         jnp.asarray(saveat), dt0=dt0, **kw)
        return sol.ys, sol.n_steps

    for dt0 in (DT0, 0.02):
        j_ys, j_n = jax.vmap(j_one, in_axes=(0, 0 if np.ndim(dt0) else None))(
            jnp.asarray(Y0), jnp.asarray(dt0))
        sol = odesolve(_forced, solver, torch.from_numpy(Y0), 0.0, 4.0,
                       torch.from_numpy(saveat),
                       dt0=torch.from_numpy(DT0) if np.ndim(dt0) else dt0,
                       **kw)
        assert bool(sol.success.all())
        np.testing.assert_array_equal(sol.n_steps.numpy(), np.asarray(j_n))
        np.testing.assert_allclose(sol.ys.numpy(), np.asarray(j_ys),
                                   rtol=1e-9, atol=1e-12)
    # dt0 is used: the default start takes another step sequence
    default = odesolve(_forced, solver, torch.from_numpy(Y0), 0.0, 4.0,
                       torch.from_numpy(saveat), **kw)
    assert not torch.equal(default.n_steps, sol.n_steps)


def test_batch_odesolve_dt0_matches_jax():
    """The batch-major Rosenbrock23 on robertson's scaled CRNN (dense J)
    from a shared and a per-lane dt0; the first step carries no
    gradient."""
    ns, nr = 3, 6
    p = np.array(j_init(jax.random.PRNGKey(0), ns, nr))
    rng = np.random.default_rng(1)
    u0 = np.abs(rng.normal(size=(4, ns))) * 0.5 + 0.3
    saveat = 10.0 ** np.linspace(0.0, 2.0, 12)
    kw = dict(rtol=1e-3, atol=1e-6, max_steps=128)
    rhs = j_make_scaled_rhs(1e-8, jnp.inf, jnp.ones(ns))
    jac = j_make_scaled_jac(1e-8, jnp.inf, jnp.ones(ns))
    f_b = lambda t, y, w: jax.vmap(lambda ti, yi: rhs(ti, yi, w))(t, y)
    fj_b = lambda t, y, w: jax.vmap(
        lambda ti, yi: (rhs(ti, yi, w), jac(ti, yi, w)))(t, y)

    f = make_crnn_scaled_rhs(1e-8, math.inf, torch.ones(ns, dtype=torch.float64))
    op = make_crnn_rhs_jac_op(1e-8, math.inf)

    def f_jac(t, y, w):
        return op(y, w.w_in, w.w_b, w.w_out)

    for dt0 in (0.5, np.array([1e-3, 0.5, 2.0, 1e-2])):
        js = j_batch(f_b, fj_b, jnp.asarray(u0), 0.0, 100.0,
                     jnp.asarray(saveat), args=j_p2vec(jnp.asarray(p), ns, nr),
                     dt0=jnp.asarray(dt0), unroll="scan", **kw)
        dt0_t = torch.tensor(dt0, dtype=torch.float64, requires_grad=True)
        sol = batch_odesolve_rb23(
            f, f_jac, torch.from_numpy(u0), 0.0, 100.0,
            torch.from_numpy(saveat),
            args=p2vec_robertson(torch.from_numpy(p), ns, nr), dt0=dt0_t,
            unroll="scan", **kw)
        np.testing.assert_array_equal(sol.n_steps.numpy(),
                                      np.asarray(js.n_steps))
        np.testing.assert_allclose(sol.ys.numpy(), np.asarray(js.ys),
                                   rtol=1e-9, atol=1e-12)
        assert not sol.ys.requires_grad


def _exact(t):
    """y' = -y + sin(3t), y(0) = 1."""
    return 1.3 * math.exp(-t) + (math.sin(3.0 * t) - 3.0 * math.cos(3.0 * t)) / 10.0


@pytest.mark.parametrize("solver_cls,expected_order",
                         [(Tsit5, 5), (Kvaerno3, 3), (TRBDF2, 2),
                          (Rosenbrock23, 2)])
def test_convergence_order(solver_cls, expected_order):
    """Fixed-step global convergence rate matches the advertised order
    (the port of tests/test_solvers.py:test_convergence_order)."""
    dts = np.array([0.05, 0.025, 0.0125])
    t1 = 1.0
    sol = odesolve(_forced, solver_cls(), torch.ones((3, 1), dtype=torch.float64),
                   0.0, t1, torch.tensor([t1], dtype=torch.float64),
                   rtol=1e30, atol=1e30, dt0=torch.from_numpy(dts),
                   max_steps=int(t1 / dts[-1]) + 10, factor_min=1.0,
                   factor_max=1.0, safety=1.0, unroll="while")
    assert bool(sol.success.all())
    # t1 / dt steps, and at most one more for the rounding of their sum
    assert np.all(np.abs(sol.n_steps.numpy() - t1 / dts) <= 1)
    errs = np.abs(sol.final_y[:, 0].numpy() - _exact(t1))
    rate = np.log2(errs[0] / errs[-1]) / 2.0
    assert rate > expected_order - 0.55, f"observed order {rate:.2f}"
