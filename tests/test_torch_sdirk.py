"""The lane-batched ESDIRK solvers (TRBDF2, Kvaerno3) against the JAX
package's ``jax.vmap`` of its per-lane ``odesolve``, in f64: exponential
decay, van der Pol and Robertson with n_steps exact and ys at rtol 1e-6,
reverse mode through the scan at rtol 1e-6, and a per-lane case2 epoch with
``solver='trbdf2'`` (J by forward mode of the plain twin) at rtol 1e-6.

The case2 epoch is reduced to 4 training and 2 held-out experiments and
max_steps 32 (its lanes take 8-9 steps); ns=6, nr=3 and 50 save points as
shipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import case2 as jcase2
from crnn_tpu.ode import Kvaerno3 as JKvaerno3
from crnn_tpu.ode import TRBDF2 as JTRBDF2
from crnn_tpu.ode import odesolve as j_odesolve
from crnn_tpu.ode import sdirk as jsdirk
from crnn_tpu_torch.cases import case2 as tcase2
from crnn_tpu_torch.ode import ESDIRK, Kvaerno3, TRBDF2, get_solver
from crnn_tpu_torch.ode import sdirk as tsdirk
from crnn_tpu_torch.ode.base import autonomous
from crnn_tpu_torch.ode.solve import odesolve

SOLVERS = {"trbdf2": (JTRBDF2, TRBDF2), "kvaerno3": (JKvaerno3, Kvaerno3)}


def _j_decay(t, y, lam):
    return -lam * y


@autonomous
def _t_decay(t, y, lam):
    return -lam * y


def _j_vdp(t, y, mu):
    return jnp.array([y[1], mu * ((1 - y[0] ** 2) * y[1]) - y[0]])


@autonomous
def _t_vdp(t, y, mu):
    return torch.stack([y[:, 1], mu * ((1 - y[:, 0] ** 2) * y[:, 1])
                        - y[:, 0]], dim=-1)


def _j_robertson(t, y, k):
    r1 = k[0] * y[0]
    r2 = k[1] * y[1] * y[1]
    r3 = k[2] * y[1] * y[2]
    return jnp.array([-r1 + r3, r1 - r2 - r3, r2])


@autonomous
def _t_robertson(t, y, k):
    r1 = k[0] * y[:, 0]
    r2 = k[1] * y[:, 1] * y[:, 1]
    r3 = k[2] * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=-1)


# name: (JAX RHS, port RHS, lanes y0, args, t1, saveat, rtol, atol)
PROBLEMS = {
    "decay": (_j_decay, _t_decay, [[2.0, 1.0], [0.3, -1.5]], 0.7, 5.0,
              np.linspace(0.0, 5.0, 21), 1e-8, 1e-10),
    "van_der_pol": (_j_vdp, _t_vdp, [[2.0, 0.0], [0.5, 1.0]], 5.0, 3.0,
                    np.linspace(0.0, 3.0, 13), 1e-6, 1e-9),
    "robertson": (_j_robertson, _t_robertson,
                  [[1.0, 0.0, 0.0], [0.5, 1e-8, 0.9]],
                  np.array([4e-2, 3e7, 1e4]), 1e3,
                  np.concatenate([[0.0], 10 ** np.linspace(-2, 3, 16)]), 1e-5,
                  np.array([1e-8, 1e-12, 1e-8])),
}


def _solve_both(problem, solver, max_steps=4096, unroll="while"):
    jf, tf, y0, args, t1, saveat, rtol, atol = PROBLEMS[problem]
    jsolver, tsolver = SOLVERS[solver]
    y0 = np.asarray(y0, dtype=np.float64)
    args = np.asarray(args, dtype=np.float64)
    atol_j = jnp.asarray(atol) if np.ndim(atol) else atol
    atol_t = torch.tensor(atol) if np.ndim(atol) else atol
    j_sol = jax.vmap(lambda u: j_odesolve(
        jf, jsolver(), u, 0.0, t1, jnp.asarray(saveat), args=jnp.asarray(args),
        rtol=rtol, atol=atol_j, max_steps=max_steps, unroll=unroll))(
            jnp.asarray(y0))
    t_sol = odesolve(tf, tsolver(), torch.from_numpy(y0), 0.0, t1,
                     torch.from_numpy(saveat), args=torch.tensor(args),
                     rtol=rtol, atol=atol_t, max_steps=max_steps,
                     unroll=unroll)
    return j_sol, t_sol


@pytest.mark.parametrize("solver", sorted(SOLVERS))
@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_esdirk_matches_jax_f64(solver, problem):
    j_sol, t_sol = _solve_both(problem, solver)
    assert bool(np.all(np.asarray(j_sol.success)))
    np.testing.assert_array_equal(t_sol.n_steps.numpy(),
                                  np.asarray(j_sol.n_steps))
    np.testing.assert_array_equal(t_sol.n_accepted.numpy(),
                                  np.asarray(j_sol.n_accepted))
    np.testing.assert_array_equal(t_sol.success.numpy(),
                                  np.asarray(j_sol.success))
    want = np.asarray(j_sol.ys)
    np.testing.assert_allclose(t_sol.ys.numpy(), want, rtol=1e-6,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("solver", sorted(SOLVERS))
def test_esdirk_scan_gradient_matches_jax_f64(solver):
    """d/d(mu, y0) of a loss over van der Pol lanes, reverse mode through
    the checkpointed scan, every Newton iteration in the graph."""
    jsolver, tsolver = SOLVERS[solver]
    y0 = np.array([[2.0, 0.0], [0.5, 1.0]])
    saveat = np.linspace(0.0, 1.0, 7)
    kw = dict(rtol=1e-4, atol=1e-7, max_steps=64, unroll="scan")

    def j_loss(mu, u):
        ys = jax.vmap(lambda ui: j_odesolve(
            _j_vdp, jsolver(), ui, 0.0, 1.0, jnp.asarray(saveat), args=mu,
            **kw).ys)(u)
        return jnp.sum(ys**2) + jnp.sum(ys[:, :, 0])

    j_val, (j_gmu, j_gy) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        jnp.asarray(5.0), jnp.asarray(y0))
    mu = torch.tensor(5.0, dtype=torch.float64, requires_grad=True)
    u = torch.from_numpy(y0).requires_grad_(True)
    sol = odesolve(_t_vdp, tsolver(), u, 0.0, 1.0, torch.from_numpy(saveat),
                   args=mu, **kw)
    assert bool(sol.success.all())
    ys = sol.ys
    loss = torch.sum(ys**2) + torch.sum(ys[:, :, 0])
    g_mu, g_y = torch.autograd.grad(loss, (mu, u))
    np.testing.assert_allclose(loss.item(), float(j_val), rtol=1e-6)
    np.testing.assert_allclose(g_mu.item(), float(j_gmu), rtol=1e-6)
    np.testing.assert_allclose(g_y.numpy(), np.asarray(j_gy), rtol=1e-6)


def test_tableaux_and_registry_match_jax():
    for name in ("_trbdf2_tableau", "_kvaerno3_tableau"):
        assert getattr(tsdirk, name)() == getattr(jsdirk, name)()
    for name, cls in (("trbdf2", TRBDF2), ("kvaerno3", Kvaerno3)):
        s = get_solver(name)
        j = {"trbdf2": JTRBDF2, "kvaerno3": JKvaerno3}[name]()
        assert isinstance(s, ESDIRK) and s.tab == j.tab
        assert (s.order, s.max_newton_iters, s.newton_rtol, s.newton_atol) \
            == (j.order, j.max_newton_iters, j.newton_rtol, j.newton_atol)
        assert s.jac is None
        assert cls(max_newton_iters=3).max_newton_iters == 3


def test_case2_per_lane_trbdf2_epoch_matches_jax_f64():
    """One whole per-lane case2 epoch under TRBDF2: JAX takes jacfwd of its
    RHS, the port forward mode of the plain twin."""
    kw = dict(n_exp_train=4, n_exp_test=2, dtype="float64",
              batch_major=False, solver="trbdf2", max_steps=32)
    jsetup = jcase2.build(jcase2.Case2Config(**kw))
    check_epoch_vs_jax(
        jsetup, lambda ds: tcase2.build(tcase2.Case2Config(device="cpu", **kw),
                                        dataset=ds), 4, rtol=1e-6)
