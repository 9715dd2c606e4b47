"""df/dt in the port's per-lane Rosenbrock23 (crnn_tpu_torch/ode/rosenbrock.py)
against ``jax.vmap`` of crnn_tpu/ode/rosenbrock.py, f64.

JAX's step always adds Shampine's ``dt*d*ft`` term, ``ft = df/dt`` from
``jax.jvp`` in t. The port computes it by ``torch.func.jvp`` for every RHS
not declared autonomous (``ode/base.py:autonomous``). The RHS here depends
on t through a temperature ramp in its Arrhenius rates, as a DSC model does
(``temp = t0 + beta * t``): n_steps must match exactly and ys within 1e-9
of each component's largest value. A witness solves the same RHS with ft
forced to 0 (declared autonomous although it is not, the behaviour before
ft was ported) and must miss JAX by more than 1e-6, so the gate sees the
term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.ode import Rosenbrock23 as JRosenbrock23
from crnn_tpu.ode import odesolve as j_odesolve
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.models.crnn import make_crnn_rhs
from crnn_tpu_torch.ode.base import autonomous, is_autonomous
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23, lane_dfdt
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.transforms.p2vec import p2vec_case1

T0, BETA, T1 = 300.0, 40.0, 5.0
RTOL, ATOL = 1e-3, 1e-6


def j_ramp_rhs(t, y, k):
    """A -> B -> C with Arrhenius rates on the ramp T = T0 + BETA t, one
    lane: k = (log A1, E1, log A2, E2)."""
    temp = T0 + BETA * t
    r1 = jnp.exp(k[0] - k[1] / temp) * y[0]
    r2 = jnp.exp(k[2] - k[3] / temp) * y[1]
    return jnp.stack([-r1, r1 - r2, r2])


def t_ramp_rhs(t, y, k):
    """``j_ramp_rhs`` for lanes: t (B,), y (B, 3), k (B, 4)."""
    temp = T0 + BETA * t
    r1 = torch.exp(k[:, 0] - k[:, 1] / temp) * y[:, 0]
    r2 = torch.exp(k[:, 2] - k[:, 3] / temp) * y[:, 1]
    return torch.stack([-r1, r1 - r2, r2], dim=1)


def _problem(b=4, seed=0):
    rng = np.random.default_rng(seed)
    u0 = np.zeros((b, 3))
    u0[:, 0] = rng.uniform(0.5, 1.5, size=b)
    k = np.stack([10.0 + rng.uniform(-0.5, 0.5, size=b),
                  np.full(b, 3000.0),
                  12.0 + rng.uniform(-0.5, 0.5, size=b),
                  np.full(b, 3000.0)], axis=1)
    return u0, k, np.linspace(0.0, T1, 12)


def _jax_solve(u0, k, saveat, unroll, max_steps):
    return jax.vmap(lambda u, kk: j_odesolve(
        j_ramp_rhs, JRosenbrock23(), u, 0.0, T1, jnp.asarray(saveat),
        args=kk, rtol=RTOL, atol=ATOL, max_steps=max_steps,
        unroll=unroll))(jnp.asarray(u0), jnp.asarray(k))


def _torch_solve(rhs, u0, k, saveat, unroll, max_steps):
    return odesolve(rhs, Rosenbrock23(), torch.from_numpy(u0), 0.0, T1,
                    torch.from_numpy(saveat), args=torch.from_numpy(k),
                    rtol=RTOL, atol=ATOL, max_steps=max_steps, unroll=unroll)


def _err_per_component(got, want):
    """Largest |got - want| over each state component's largest |want|."""
    scale = np.abs(want).max(axis=(0, 1))
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("unroll,max_steps", [("while", 4096), ("scan", 64)])
def test_t_dependent_rosenbrock23_matches_jax(unroll, max_steps):
    u0, k, saveat = _problem()
    want = _jax_solve(u0, k, saveat, unroll, max_steps)
    got = _torch_solve(t_ramp_rhs, u0, k, saveat, unroll, max_steps)
    assert not is_autonomous(t_ramp_rhs)
    np.testing.assert_array_equal(got.n_steps.numpy(),
                                  np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    assert bool(got.success.all())
    assert _err_per_component(got.ys.numpy(), np.asarray(want.ys)) <= 1e-9

    # the witness: ft forced to 0 misses JAX by far more than the gate
    old = _torch_solve(autonomous(lambda t, y, kk: t_ramp_rhs(t, y, kk)),
                       u0, k, saveat, unroll, max_steps)
    assert _err_per_component(old.ys.numpy(), np.asarray(want.ys)) > 1e-6


def test_lane_dfdt_matches_jax_jvp_in_t():
    rng = np.random.default_rng(3)
    u0, k, _ = _problem(5)
    y = u0 + rng.uniform(0.1, 0.5, size=u0.shape)
    t = rng.uniform(0.0, T1, size=5)
    want = jax.vmap(lambda tt_, yy, kk: jax.jvp(
        lambda s: j_ramp_rhs(s, yy, kk), (tt_,), (1.0,))[1])(
            jnp.asarray(t), jnp.asarray(y), jnp.asarray(k))
    got = lane_dfdt(t_ramp_rhs, torch.from_numpy(t), torch.from_numpy(y),
                    torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13)


def test_gradient_through_dfdt_matches_jax():
    """Reverse mode through the checkpointed scan reaches the params through
    ft as JAX's does: the gradient of the intermediate's trajectory (the
    total of the three species is conserved) w.r.t. k at rtol 1e-7."""
    u0, k, saveat = _problem(3)

    def j_loss(kk):
        return jnp.sum(_jax_solve(u0, kk, saveat, "scan", 64).ys[..., 1])

    want = jax.grad(j_loss)(jnp.asarray(k))
    k_t = torch.from_numpy(k).requires_grad_(True)
    sol = odesolve(t_ramp_rhs, Rosenbrock23(), torch.from_numpy(u0), 0.0, T1,
                   torch.from_numpy(saveat), args=k_t, rtol=RTOL, atol=ATOL,
                   max_steps=64, unroll="scan")
    (got,) = torch.autograd.grad(sol.ys[..., 1].sum(), k_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=1e-7 * float(np.abs(want).max()))


@pytest.mark.parametrize("name", ["truth", "crnn"])
def test_declared_autonomous_rhs_gives_the_same_bits(name):
    """For a t-independent RHS, df/dt is exactly 0, so the step that skips
    it (declared) and the step that computes it (the same function, not
    declared) give the same bits: skipping changes no result."""
    rng = np.random.default_rng(4)
    if name == "truth":
        rhs, rtol, atol = tt.robertson_truth, 1e-6, 1e-10
        u0 = rng.uniform(0.5, 1.5, size=(3, 3))
        u0[:, 1] = 0.0
        args = torch.tensor(tt.ROBERTSON_K, dtype=torch.float64).expand(3, -1)
        saveat = np.linspace(0.0, 10.0, 6)
    else:                               # case1's CRNN on the plain ops
        rhs, rtol, atol = make_crnn_rhs(1e-5, 10.0, plain=True), 1e-3, 1e-6
        u0 = np.zeros((3, 5))
        u0[:, :2] = rng.uniform(size=(3, 2)) + 0.2
        p = 0.3 * rng.normal(size=4 * 6)
        p[:4] += 8.0
        args = p2vec_case1(torch.from_numpy(p), 5, 4)
        saveat = np.linspace(0.0, 20.0, 6)
    assert is_autonomous(rhs)
    sols = [odesolve(f, Rosenbrock23(), torch.from_numpy(u0), 0.0,
                     float(saveat[-1]), torch.from_numpy(saveat), args=args,
                     rtol=rtol, atol=atol, max_steps=4096, unroll="while")
            for f in (rhs, lambda t, y, a: rhs(t, y, a))]
    assert torch.equal(sols[0].n_steps, sols[1].n_steps)
    assert torch.equal(sols[0].ys, sols[1].ys)
    assert bool(sols[0].success.all())
