"""crnn_tpu_torch/ode/solve.py (the lane-batched per-lane driver) with Tsit5
and Rosenbrock23 against ``jax.vmap`` of crnn_tpu/ode/solve.py:odesolve, on
the same numpy inputs, f64.

Both packages run the same arithmetic up to the summation order of the small
matmuls, so step decisions are identical: ``n_steps`` and ``success`` must
match exactly and ``ys`` at rtol 1e-9; gradients through the checkpointed
scan at rtol 1e-9.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.data import truth as jt
from crnn_tpu.models.crnn import make_crnn_rhs as j_make_rhs
from crnn_tpu.models.crnn import make_crnn_scaled_rhs as j_make_scaled_rhs
from crnn_tpu.models.jacobian import make_crnn_scaled_jac as j_make_scaled_jac
from crnn_tpu.ode import Rosenbrock23 as JRosenbrock23
from crnn_tpu.ode import Tsit5 as JTsit5
from crnn_tpu.ode import controller as jc
from crnn_tpu.ode import odesolve as j_odesolve
from crnn_tpu.transforms.p2vec import p2vec_case1 as j_p2vec_case1
from crnn_tpu.transforms.p2vec import p2vec_robertson as j_p2vec_robertson
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.models.crnn import make_crnn_rhs, make_crnn_scaled_rhs
from crnn_tpu_torch.models.jacobian import make_crnn_scaled_jac
from crnn_tpu_torch.ode import controller as tc
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23, lane_jacfwd
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5
from crnn_tpu_torch.transforms.p2vec import p2vec_case1, p2vec_robertson

NS1, NR1, LB1, UB1 = 5, 4, 1e-5, 10.0
NS_R, NR_R, LB_R = 3, 6, 1e-8
RTOL = 1e-9


def _case1_problem(b=4, seed=0):
    """Lanes of case1's CRNN at trained-like weights: kinetics fast enough
    that Tsit5 rejects steps (2-9 of 16-37 per lane at seed 0). Solved at
    rtol 1e-3 / atol 1e-6, where the step sequence is well conditioned: one
    ulp of p moves ys by ~2e-13. (At case1's rtol 1e-2 with rates ~e^-1 the
    same ulp moves ys by ~2e-7, so no two implementations could agree at
    1e-9 there.)"""
    rng = np.random.default_rng(seed)
    u0 = np.zeros((b, NS1))
    u0[:, :2] = rng.uniform(size=(b, 2)) + 0.2
    p = 0.3 * rng.normal(size=NR1 * (NS1 + 1))
    p[:NR1] += 8.0               # w_b = p + b0: rates ~ e^-2
    saveat = np.linspace(0.0, 20.0, 12)
    return u0, p, saveat


def _robertson_problem(b=4, seed=1):
    """Lanes of robertson's scaled CRNN at the reference init."""
    rng = np.random.default_rng(seed)
    u0 = rng.uniform(size=(b, NS_R)) + 0.5
    u0[:, 1] = LB_R
    lim = (6.0 / (NS_R + NR_R)) ** 0.5
    p = rng.uniform(-lim, lim, size=NR_R * (2 * NS_R + 1) + 1)
    p[-1] = 0.1
    saveat = 10.0 ** np.linspace(0.0, 5.0, 10)
    dydt_scale = np.array([1.0, 3.6e-5, 1.0]) / saveat[-1]
    return u0, p, saveat, dydt_scale


def _jax_case1(u0, p, saveat, unroll, max_steps, controller="i"):
    rhs = j_make_rhs(LB1, UB1)
    w = j_p2vec_case1(jnp.asarray(p), NS1, NR1)
    return jax.vmap(lambda u: j_odesolve(
        rhs, JTsit5(), u, 0.0, float(saveat[-1]), jnp.asarray(saveat), args=w,
        rtol=1e-3, atol=1e-6, max_steps=max_steps, unroll=unroll,
        controller=controller))(jnp.asarray(u0))


def _torch_case1(u0, p, saveat, unroll, max_steps, controller="i"):
    w = p2vec_case1(torch.as_tensor(p), NS1, NR1)
    return odesolve(make_crnn_rhs(LB1, UB1), Tsit5(), torch.from_numpy(u0),
                    0.0, float(saveat[-1]), torch.from_numpy(saveat), args=w,
                    rtol=1e-3, atol=1e-6, max_steps=max_steps, unroll=unroll,
                    controller=controller)


def _check(got, want):
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.n_accepted.numpy(),
                                  np.asarray(want.n_accepted))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t),
                               rtol=RTOL)


@pytest.mark.parametrize("unroll,max_steps", [("scan", 40), ("while", 4096),
                                              ("while", 6)])
@pytest.mark.parametrize("controller", ["i", "pi"])
def test_tsit5_solve_matches_vmapped_jax(unroll, max_steps, controller):
    u0, p, saveat = _case1_problem()
    want = _jax_case1(u0, p, saveat, unroll, max_steps, controller)
    got = _torch_case1(u0, p, saveat, unroll, max_steps, controller)
    _check(got, want)
    assert int(got.n_rejected.sum()) == int(np.asarray(want.n_rejected).sum())
    if max_steps == 4096:
        assert bool(got.success.all())
    if max_steps == 6:     # lanes out of steps: JAX reports them unfinished
        assert not bool(got.success.any())


def _jax_robertson(u0, p, saveat, dydt_scale, unroll, max_steps, jac=True):
    ds = jnp.asarray(dydt_scale)
    rhs = j_make_scaled_rhs(LB_R, jnp.inf, ds)
    solver = JRosenbrock23(jac=j_make_scaled_jac(LB_R, jnp.inf, ds)
                           if jac else None)
    w = j_p2vec_robertson(jnp.asarray(p), NS_R, NR_R)
    return jax.vmap(lambda u: j_odesolve(
        rhs, solver, u, 0.0, float(saveat[-1]), jnp.asarray(saveat), args=w,
        rtol=1e-3, atol=jnp.array([1e-6, 1e-8, 1e-6]), max_steps=max_steps,
        unroll=unroll))(jnp.asarray(u0))


def _torch_robertson(u0, p, saveat, dydt_scale, unroll, max_steps, jac=True):
    ds = torch.from_numpy(dydt_scale)
    rhs = make_crnn_scaled_rhs(LB_R, math.inf, ds)
    solver = Rosenbrock23(jac=make_crnn_scaled_jac(LB_R, math.inf, ds)
                          if jac else None)
    w = p2vec_robertson(torch.as_tensor(p), NS_R, NR_R)
    return odesolve(rhs, solver, torch.from_numpy(u0), 0.0,
                    float(saveat[-1]), torch.from_numpy(saveat), args=w,
                    rtol=1e-3, atol=torch.tensor([1e-6, 1e-8, 1e-6],
                                                 dtype=torch.float64),
                    max_steps=max_steps, unroll=unroll)


@pytest.mark.parametrize("unroll,max_steps", [("scan", 48), ("while", 4096),
                                              ("while", 10)])
@pytest.mark.parametrize("jac", [True, False])
def test_rosenbrock23_solve_matches_vmapped_jax(unroll, max_steps, jac):
    u0, p, saveat, dydt_scale = _robertson_problem()
    want = _jax_robertson(u0, p, saveat, dydt_scale, unroll, max_steps, jac)
    if jac:
        got = _torch_robertson(u0, p, saveat, dydt_scale, unroll, max_steps)
    else:   # jacfwd of the plain RHS: the kernel op has no forward mode
        rhs = make_crnn_scaled_rhs(LB_R, math.inf,
                                   torch.from_numpy(dydt_scale), plain=True)
        w = p2vec_robertson(torch.from_numpy(p), NS_R, NR_R)
        got = odesolve(rhs, Rosenbrock23(), torch.from_numpy(u0), 0.0,
                       float(saveat[-1]), torch.from_numpy(saveat), args=w,
                       rtol=1e-3, atol=torch.tensor([1e-6, 1e-8, 1e-6],
                                                    dtype=torch.float64),
                       max_steps=max_steps, unroll=unroll)
    _check(got, want)
    if max_steps == 4096:
        assert bool(got.success.all())


@pytest.mark.parametrize("problem", ["tsit5", "rosenbrock23"])
def test_scan_gradient_matches_jax(problem):
    """Reverse mode through the checkpointed scan, params -> sum of ys."""
    if problem == "tsit5":
        u0, p, saveat = _case1_problem(3, seed=4)

        def j_loss(p_):
            return jnp.sum(_jax_case1(u0, p_, saveat, "scan", 30).ys ** 2)

        def t_ys(p_):
            return _torch_case1(u0, p_, saveat, "scan", 30).ys
    else:
        u0, p, saveat, ds = _robertson_problem(3, seed=5)

        def j_loss(p_):
            return jnp.sum(_jax_robertson(u0, p_, saveat, ds, "scan", 40).ys
                           ** 2)

        def t_ys(p_):
            return _torch_robertson(u0, p_, saveat, ds, "scan", 40).ys
    want = np.asarray(jax.grad(j_loss)(jnp.asarray(p)))
    pt = torch.from_numpy(p).requires_grad_(True)
    (got,) = torch.autograd.grad(torch.sum(t_ys(pt) ** 2), pt)
    assert np.all(np.isfinite(want)) and np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_lanes_do_not_couple():
    """Each lane solved alone equals the same lane inside the batch: every
    norm and test reduces over the state axis only (a global reduction
    would pass a one-lane comparison with JAX and fail here)."""
    u0, p, saveat = _case1_problem(4, seed=6)
    u0[1] *= 5.0                 # lanes of different scales and step counts
    pt = torch.from_numpy(p)
    batch = _torch_case1(u0, pt, saveat, "while", 4096)
    for i in range(u0.shape[0]):
        alone = _torch_case1(u0[i:i + 1], pt, saveat, "while", 4096)
        assert int(alone.n_steps[0]) == int(batch.n_steps[i])
        torch.testing.assert_close(alone.ys[0], batch.ys[i], rtol=0, atol=0)
    assert len(set(batch.n_steps.tolist())) > 1


def test_event_terminates_lanes_and_forward_fills():
    """``event_fn`` stops a lane after the accepted step where it fires and
    fills its later save times with that state, as the JAX driver does."""
    u0, p, saveat = _case1_problem(3, seed=7)
    w_j = j_p2vec_case1(jnp.asarray(p), NS1, NR1)
    t_ev = np.array([3.0, 1e9, 8.0])      # lane 1 never fires
    want = jax.vmap(lambda u, te: j_odesolve(
        j_make_rhs(LB1, UB1), JTsit5(), u, 0.0, 20.0, jnp.asarray(saveat),
        args=w_j, rtol=1e-2, atol=1e-5, max_steps=200, unroll="while",
        event_fn=lambda t, y, a: t > te))(jnp.asarray(u0), jnp.asarray(t_ev))
    te_t = torch.from_numpy(t_ev)
    got = odesolve(make_crnn_rhs(LB1, UB1), Tsit5(), torch.from_numpy(u0), 0.0,
                   20.0, torch.from_numpy(saveat),
                   args=p2vec_case1(torch.from_numpy(p), NS1, NR1), rtol=1e-2,
                   atol=1e-5, max_steps=200, unroll="while",
                   event_fn=lambda t, y, a: t > te_t)
    _check(got, want)
    np.testing.assert_array_equal(got.event_triggered.numpy(),
                                  np.asarray(want.event_triggered))
    assert got.event_triggered.tolist() == [True, False, True]


def test_controllers_match_jax():
    rng = np.random.default_rng(8)
    y0, y1, y_err = rng.normal(size=(3, 6, 3))
    y_err[2, 1] = np.nan
    atol = np.array([1e-6, 1e-8, 1e-6])
    got = tc.error_norm(*map(torch.from_numpy, (y_err, y0, y1)), 1e-3,
                        torch.from_numpy(atol))
    want = jax.vmap(lambda e, a, b: jc.error_norm(e, a, b, 1e-3,
                                                  jnp.asarray(atol)))(
        jnp.asarray(y_err), jnp.asarray(y0), jnp.asarray(y1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    assert math.isinf(float(got[2]))

    dt = rng.uniform(0.01, 1.0, size=8)
    err = np.array([0.0, 1e-12, 0.3, 0.99, 1.0, 1.5, 40.0, np.inf])
    prev = rng.uniform(0.1, 2.0, size=8)
    accept = err <= 1.0
    got_dt, got_prev = tc.propose_dt_pi(*map(torch.from_numpy,
                                             (dt, err, prev, accept)), 5)
    want_dt, want_prev = jc.propose_dt_pi(*map(jnp.asarray,
                                               (dt, err, prev, accept)), 5)
    np.testing.assert_allclose(got_dt.numpy(), np.asarray(want_dt), rtol=1e-14)
    np.testing.assert_allclose(got_prev.numpy(), np.asarray(want_prev),
                               rtol=1e-14)

    u0, p, _ = _case1_problem(4, seed=9)
    w_j = j_p2vec_case1(jnp.asarray(p), NS1, NR1)
    want = jax.vmap(lambda u: jc.initial_step(
        j_make_rhs(LB1, UB1), 0.0, 20.0, u, w_j, 5, 1e-2, 1e-5))(
            jnp.asarray(u0))
    got = tc.initial_step(make_crnn_rhs(LB1, UB1), 0.0, 20.0,
                          torch.from_numpy(u0),
                          p2vec_case1(torch.from_numpy(p), NS1, NR1), 5, 1e-2,
                          1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def test_lane_jacfwd_matches_jax_jacfwd():
    rng = np.random.default_rng(10)
    y = rng.uniform(0.1, 2.0, size=(5, 3))
    k = np.array(tt.ROBERTSON_K)
    want = jax.vmap(jax.jacfwd(lambda yy: jt.robertson_truth(
        0.0, yy, jnp.asarray(k))))(jnp.asarray(y))
    kt = torch.from_numpy(k).expand(5, -1)
    got = lane_jacfwd(lambda yy: tt.robertson_truth(0.0, yy, kt),
                      torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)


def test_nonautonomous_rosenbrock_raises():
    """An RHS on the kernel ops that is not declared autonomous makes
    Rosenbrock23 take df/dt by forward mode, which the kernel ops refuse:
    the step raises and names the declaration (it never computes a wrong
    ft). The declared RHS, the same op, solves."""
    u0, p, saveat, dydt_scale = _robertson_problem(2)
    ds = torch.from_numpy(dydt_scale)
    rhs = make_crnn_scaled_rhs(LB_R, math.inf, ds)
    solver = Rosenbrock23(jac=make_crnn_scaled_jac(LB_R, math.inf, ds))
    w = p2vec_robertson(torch.as_tensor(p), NS_R, NR_R)
    kw = dict(args=w, rtol=1e-3, atol=1e-6, max_steps=4, unroll="while")
    with pytest.raises(RuntimeError, match="not declared autonomous"):
        odesolve(lambda t, y, a: rhs(t, y, a), solver, torch.from_numpy(u0),
                 0.0, float(saveat[-1]), torch.from_numpy(saveat), **kw)
    sol = odesolve(rhs, solver, torch.from_numpy(u0), 0.0, float(saveat[-1]),
                   torch.from_numpy(saveat), **kw)
    assert bool((sol.n_steps == 4).all())
