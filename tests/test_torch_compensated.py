"""crnn_tpu_torch/ode/compensated.py (the compensated-f32 batch
Rosenbrock23) against crnn_tpu/ode/compensated.py, and the optimizer of
scripts/robertson_comp32_torch.py against optax, on the same numpy inputs.

Robertson's shape, as tests/test_batch_solve.py runs the JAX driver: 4
lanes of the scaled CRNN (ns=3, nr=6, dy/dt scale 1) from t=0 to 100, 12
log-spaced save points, 128 steps. The port's f and f_jac are the kernel
ops (their plain versions on the CPU): f0 and J from one value+Jacobian
call, as on the card. f64: n_steps exact, ys at rtol 1e-9, the gradient at
rtol 1e-6. f32: XLA and eager torch round differently, so each state
component is gated at 3x how far one ulp of the params moves the JAX run
(measured here 0.3-1.4x that move at seeds 0-2).
"""

import importlib.util
from fractions import Fraction
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crnn_tpu.models.crnn import make_crnn_scaled_rhs as j_make_scaled_rhs
from crnn_tpu.models.jacobian import make_crnn_scaled_jac as j_make_scaled_jac
from crnn_tpu.ode.compensated import batch_odesolve_rb23_comp as j_comp
from crnn_tpu.transforms.p2vec import init_params_robertson as j_init
from crnn_tpu.transforms.p2vec import p2vec_robertson as j_p2vec
from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ode.compensated import batch_odesolve_rb23_comp, two_sum
from crnn_tpu_torch.ops.crnn_kernels import make_crnn_rhs_jac_op
from crnn_tpu_torch.transforms.p2vec import p2vec_robertson

NS, NR, LB = 3, 6, 1e-8
T1, MAX_STEPS = 100.0, 128
KW = dict(rtol=1e-3, atol=1e-6, max_steps=MAX_STEPS)
ROOT = Path(__file__).resolve().parent.parent


def _problem(dtype):
    p = np.asarray(j_init(jax.random.PRNGKey(0), NS, NR)).astype(dtype)
    rng = np.random.default_rng(1)
    u0 = (np.abs(rng.normal(size=(4, NS))) * 0.5 + 0.3).astype(dtype)
    saveat = (10.0 ** np.linspace(0.0, 2.0, 12)).astype(dtype)
    return p, u0, saveat


def _jax_solve(p, u0, saveat):
    """JAX's compensated solve, jitted, and the mean |ys| loss on it."""
    ds = jnp.ones((NS,), u0.dtype)
    rhs = j_make_scaled_rhs(LB, jnp.inf, ds)
    jac = j_make_scaled_jac(LB, jnp.inf, ds)
    f_b = lambda t, y, w: jax.vmap(lambda ti, yi: rhs(ti, yi, w))(t, y)
    fj_b = lambda t, y, w: jax.vmap(
        lambda ti, yi: (rhs(ti, yi, w), jac(ti, yi, w)))(t, y)

    @jax.jit
    def solve(q):
        return j_comp(f_b, fj_b, jnp.asarray(u0), 0.0, T1, jnp.asarray(saveat),
                      args=j_p2vec(q, NS, NR), **KW)

    def loss(q):
        return jnp.mean(jnp.abs(solve(q).ys))

    return solve, loss


def _torch_pair(dtype):
    """(f, f_jac): the kernel ops' RHS and one value+Jacobian call."""
    ds = torch.ones(NS, dtype=dtype)
    f = make_crnn_scaled_rhs(LB, float("inf"), ds)
    op = make_crnn_rhs_jac_op(LB, float("inf"))

    def f_jac(t, y, w):
        du, jac = op(y, w.w_in, w.w_b, w.w_out)
        return du * ds, jac * ds[:, None]

    return f, f_jac


def _torch_solve(p, u0, saveat, driver=batch_odesolve_rb23_comp, **extra):
    f, f_jac = _torch_pair(p.dtype)
    return driver(f, f_jac, torch.from_numpy(u0), 0.0, T1,
                  torch.from_numpy(saveat), args=p2vec_robertson(p, NS, NR),
                  **KW, **extra)


def test_two_sum_is_error_free():
    """For f32 pairs across 60 binades, s + e equals a + b exactly: in
    rationals on a sample, and in f64 on every pair (both round the same
    real number)."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    a, b = ((rng.standard_normal(n) * 2.0 ** rng.integers(-30, 30, n))
            .astype(np.float32) for _ in range(2))
    s, e = two_sum(torch.from_numpy(a), torch.from_numpy(b))
    s64, e64 = s.double().numpy(), e.double().numpy()
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_array_equal(s64 + e64, a64 + b64)
    for i in range(4096):
        assert (Fraction(s64[i]) + Fraction(e64[i])
                == Fraction(a64[i]) + Fraction(b64[i]))
    assert np.any(e64 != 0.0)
    # the scalar case of the JAX package's test
    s1, e1 = two_sum(torch.tensor(1.0), torch.tensor(1e-8))
    assert float(s1) + float(e1) == 1.0 + float(np.float32(1e-8))


def test_comp_matches_jax_f64_values_and_gradient():
    p, u0, saveat = _problem(np.float64)
    j_solve, j_loss = _jax_solve(p, u0, saveat)
    js = j_solve(jnp.asarray(p))
    jg = np.asarray(jax.grad(j_loss)(jnp.asarray(p)))

    pt = torch.tensor(p, requires_grad=True)
    sol = _torch_solve(pt, u0, saveat)
    (g,) = torch.autograd.grad(sol.ys.abs().mean(), pt)

    np.testing.assert_array_equal(sol.n_steps.numpy(), np.asarray(js.n_steps))
    assert bool(sol.success.all()) and bool(np.all(np.asarray(js.success)))
    np.testing.assert_allclose(sol.ys.detach().numpy(), np.asarray(js.ys),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(sol.final_y.detach().numpy(),
                               np.asarray(js.final_y), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-6,
                               atol=1e-6 * np.max(np.abs(jg)))


def test_comp_matches_plain_batch_driver_f64():
    """At f64 the lo half stays ~0: the compensated driver reproduces the
    plain batch driver (the JAX package's own check)."""
    p, u0, saveat = _problem(np.float64)
    pt = torch.from_numpy(p)
    comp = _torch_solve(pt, u0, saveat)
    plain = _torch_solve(pt, u0, saveat, batch_odesolve_rb23, unroll="scan")
    np.testing.assert_array_equal(comp.n_steps.numpy(), plain.n_steps.numpy())
    np.testing.assert_allclose(comp.ys.numpy(), plain.ys.numpy(), rtol=1e-10,
                               atol=1e-12)


def test_comp_f32_matches_jax_within_one_ulp_witness():
    p, u0, saveat = _problem(np.float32)
    j_solve, _ = _jax_solve(p, u0, saveat)
    ys_j = np.asarray(j_solve(jnp.asarray(p)).ys)
    p_ulp = np.nextafter(p, np.float32(np.inf))
    witness = np.max(np.abs(np.asarray(j_solve(jnp.asarray(p_ulp)).ys) - ys_j),
                     axis=(0, 1))
    assert np.all(witness > 0)
    sol = _torch_solve(torch.from_numpy(p), u0, saveat)
    assert sol.ys.dtype == torch.float32 and bool(sol.success.all())
    diff = np.max(np.abs(sol.ys.numpy() - ys_j), axis=(0, 1))
    assert np.all(diff <= 3.0 * witness), (diff, witness)
    # compensation acts: the f32 plain driver's ys differ
    plain = _torch_solve(torch.from_numpy(p), u0, saveat, batch_odesolve_rb23,
                         unroll="scan")
    assert float((plain.ys - sol.ys).abs().max()) > 0.0


@pytest.fixture(scope="module")
def comp32_script():
    spec = importlib.util.spec_from_file_location(
        "robertson_comp32_torch", ROOT / "scripts" / "robertson_comp32_torch.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_script_optimizer_matches_optax(comp32_script):
    """Three updates of the script's ClipAdamW against optax's
    chain(clip_by_global_norm, adamw), the first gradient above the clip
    norm and the others below it."""
    rng = np.random.default_rng(3)
    n = NR * (2 * NS + 1) + 1
    p0 = rng.normal(size=n)
    grads = [rng.normal(size=n) * s for s in (20.0, 0.5, 1.0)]
    opt = optax.chain(optax.clip_by_global_norm(10.0),
                      optax.adamw(5e-3, weight_decay=1e-6))
    pj, state = jnp.asarray(p0), opt.init(jnp.asarray(p0))
    mine = comp32_script.ClipAdamW(5e-3, 1e-6, 10.0)
    pt = torch.from_numpy(p0)
    st = mine.init(pt)
    for g in grads:
        up, state = opt.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, up)
        pt, st = mine.update(torch.from_numpy(g), st, pt)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-13,
                                   atol=1e-15)
    adam = state[1][0]
    np.testing.assert_allclose(st.mu.numpy(), np.asarray(adam.mu), rtol=1e-13)
    np.testing.assert_allclose(st.nu.numpy(), np.asarray(adam.nu), rtol=1e-13)
    assert st.count == int(adam.count) == 3
