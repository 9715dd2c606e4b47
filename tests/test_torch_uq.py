"""The cathode UQ case in the port against the JAX package (f64).

- lane-batched ``p2vec_cathode`` against ``vmap(p2vec_cathode)``, exactly;
- ``make_cathode_rhs_batch``'s f, J and ft against JAX's at 1e-13, and J
  and ft against forward mode of the port's own f (in y, and in t);
- the non-autonomous batch-major Rosenbrock23 against JAX's: n_steps exact,
  ys within 1e-9; a zero ft gives the autonomous solve bit for bit; a
  missing ft raises;
- one ``build_uq`` SVGD iteration on the batch-major and the per-lane
  likelihood, and two ``run_uq`` iterations, on JAX's particles and
  replicate curves: particles and losses at rtol 1e-9;
- the port's own paths (chunks, resume, f32, the CLI) are in
  tests/test_torch_uq_run.py.

Reduced size: 8 particles, ``maxiters`` 64-96 at rtol 1e-3 (the JAX
package's own UQ tests run 8 particles at 96); the data as shipped
(``synthetic_dsc``, 5 heating rates, 49 temperatures, 100 replicates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.cases import cathode_uq as J
from crnn_tpu.models.crnn import make_cathode_rhs_batch as j_rhs_batch
from crnn_tpu.ode import batch_solve as jbs
from crnn_tpu.transforms.p2vec import p2vec_cathode as j_p2vec
from crnn_tpu_torch.cases import cathode_uq as T
from crnn_tpu_torch.models.crnn import make_cathode_rhs_batch
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.transforms.p2vec import p2vec_cathode

SMALL = dict(num_particles=8, maxiters=64, rtol=1e-3)


def _raw(b=6, seed=0):
    """(b, 18) raw cathode params around the warm start, one at a clip."""
    rng = np.random.default_rng(seed)
    p = np.r_[np.ones(17), 0.1][None] + 0.05 * rng.normal(size=(b, 18))
    p[:, 3:6] += [0.0, 0.1, 0.2]
    p[0, 13] = 0.01                       # an order at its clip bound
    p[:, 17] = 0.1
    return p


def _state(b=6, seed=1):
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 2000.0, size=b)
    y = rng.uniform(0.05, 1.0, size=(b, 3))
    y[1, 2] = 1e-9                        # below the clip: J and ft zeroed
    return t, y


def test_p2vec_cathode_lane_batched_matches_vmap():
    p = _raw()
    got = p2vec_cathode(torch.from_numpy(p))
    want = jax.vmap(j_p2vec)(jnp.asarray(p))
    for name in ("w_in", "w_b", "w_out"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for k in ("Ea", "b", "delH"):
        np.testing.assert_array_equal(got.extra[k].numpy(),
                                      np.asarray(want.extra[k]))


@pytest.mark.parametrize("beta_shape", ["scalar", "lanes"])
def test_cathode_rhs_batch_matches_jax_and_forward_mode(beta_shape):
    p = _raw()
    t, y = _state()
    beta = 10.0 if beta_shape == "scalar" else np.linspace(5.0, 20.0, 6)
    f, f_jac = make_cathode_rhs_batch(1e-8)
    w = p2vec_cathode(torch.from_numpy(p))
    beta_t = torch.as_tensor(beta, dtype=torch.float64)
    args = (w, beta_t)
    tt, yt = torch.from_numpy(t), torch.from_numpy(y)
    du, jac, ft = f_jac(tt, yt, args)
    jf, jfj = j_rhs_batch(1e-8)
    j_args = (jax.vmap(j_p2vec)(jnp.asarray(p)), jnp.asarray(beta))
    j_du, j_jac, j_ft = jfj(jnp.asarray(t), jnp.asarray(y), j_args)
    for a, b in ((du, j_du), (jac, j_jac), (ft, j_ft)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-13,
                                   atol=1e-13 * np.abs(b).max())
    np.testing.assert_array_equal(f(tt, yt, args).numpy(), du.numpy())
    np.testing.assert_allclose(
        du.numpy(), np.asarray(jf(jnp.asarray(t), jnp.asarray(y), j_args)),
        rtol=1e-13, atol=1e-13 * np.abs(np.asarray(j_du)).max())
    # J and ft against forward mode of the port's f, lane by lane
    lanes = torch.arange(6)
    j_fwd = torch.func.jacfwd(lambda yy: f(tt, yy, args))(yt)[
        lanes, :, lanes, :]
    np.testing.assert_allclose(jac.numpy(), j_fwd.numpy(), rtol=1e-12,
                               atol=1e-12 * j_fwd.abs().max().item())
    ft_fwd = torch.func.jvp(lambda ti: f(ti, yt, args), (tt,),
                            (torch.ones_like(tt),))[1]
    np.testing.assert_allclose(ft.numpy(), ft_fwd.numpy(), rtol=1e-12,
                               atol=1e-12 * ft_fwd.abs().max().item())
    assert jac[1, 2, 2].item() == 0.0 and ft.abs().max().item() > 0.0


def _solve_inputs():
    p = _raw(5, seed=2)
    u0 = np.zeros((5, 3))
    u0[:, 0] = 1.0
    saveat = np.linspace(0.0, 2400.0, 13)
    return p, u0, saveat


@pytest.mark.parametrize("unroll,max_steps", [("scan", 96), ("while", 4096)])
def test_nonautonomous_batch_solve_matches_jax(unroll, max_steps):
    p, u0, saveat = _solve_inputs()
    jf, jfj = j_rhs_batch(1e-8)
    want = jbs.batch_odesolve_rb23(
        jf, jfj, jnp.asarray(u0), 0.0, 2400.0, jnp.asarray(saveat),
        args=(jax.vmap(j_p2vec)(jnp.asarray(p)), jnp.asarray(10.0)),
        rtol=1e-4, atol=1e-8, max_steps=max_steps, unroll=unroll,
        nonautonomous=True)
    f, f_jac = make_cathode_rhs_batch(1e-8)
    args = (p2vec_cathode(torch.from_numpy(p)),
            torch.tensor(10.0, dtype=torch.float64))
    got = batch_odesolve_rb23(f, f_jac, torch.from_numpy(u0), 0.0, 2400.0,
                              torch.from_numpy(saveat), args=args, rtol=1e-4,
                              atol=1e-8, max_steps=max_steps, unroll=unroll,
                              nonautonomous=True)
    np.testing.assert_array_equal(got.n_steps.numpy(),
                                  np.asarray(want.n_steps))
    assert got.n_steps.min().item() > 10
    # the early-exit run finishes; the 96-step scan stops short of t1
    assert bool(got.success.all()) == (unroll == "while")
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(want.success))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys),
                               rtol=1e-9, atol=1e-12)


def test_zero_ft_is_the_autonomous_solve_and_arity_is_checked():
    p, u0, saveat = _solve_inputs()
    f, f_jac = make_cathode_rhs_batch(1e-8)
    args = (p2vec_cathode(torch.from_numpy(p)),
            torch.tensor(10.0, dtype=torch.float64))

    def f_jac_zero_ft(t, y, a):
        du, jac, ft = f_jac(t, y, a)
        return du, jac, torch.zeros_like(ft)

    kw = dict(args=args, rtol=1e-4, atol=1e-8, max_steps=96)
    u0_t, s_t = torch.from_numpy(u0), torch.from_numpy(saveat)
    zero = batch_odesolve_rb23(f, f_jac_zero_ft, u0_t, 0.0, 2400.0, s_t,
                               nonautonomous=True, **kw)
    auto = batch_odesolve_rb23(f, lambda t, y, a: f_jac(t, y, a)[:2], u0_t,
                               0.0, 2400.0, s_t, **kw)
    full = batch_odesolve_rb23(f, f_jac, u0_t, 0.0, 2400.0, s_t,
                               nonautonomous=True, **kw)
    assert torch.equal(zero.ys, auto.ys)
    assert torch.equal(zero.n_steps, auto.n_steps)
    assert not torch.equal(full.ys, auto.ys)   # ft matters on the ramp
    with pytest.raises(ValueError, match="df/dt"):
        batch_odesolve_rb23(f, lambda t, y, a: f_jac(t, y, a)[:2], u0_t,
                            0.0, 2400.0, s_t, nonautonomous=True, **kw)
    with pytest.raises(ValueError, match="needs 2"):
        batch_odesolve_rb23(f, f_jac, u0_t, 0.0, 2400.0, s_t, **kw)


# --- build_uq / run_uq against JAX -------------------------------------------

def _jax_inputs(**cfg):
    """JAX's particles, replicate curves and warm start for ``cfg``."""
    jcfg = J.CathodeUQConfig(**SMALL, **cfg)
    p_opt = np.asarray(J.init_params_cathode(jax.random.PRNGKey(1),
                                             jnp.float64))
    particles, step, ex = J.build_uq(jcfg, p_opt)
    return jcfg, p_opt, particles, step, ex


@pytest.mark.parametrize("path", [
    dict(), dict(batch_major=False), dict(solver="trbdf2")],
    ids=["batch_major", "per_lane", "per_lane_trbdf2"])
def test_build_uq_iteration_matches_jax(path):
    maxiters = {"solver": 96}.get(next(iter(path), ""), 64)
    jcfg, p_opt, jp, jstep, jex = _jax_inputs(**path)
    if maxiters != 64:
        jcfg = J.CathodeUQConfig(**{**SMALL, "maxiters": maxiters}, **path)
        jp, jstep, jex = J.build_uq(jcfg, p_opt)
    tcfg = T.CathodeUQConfig(**{**SMALL, "maxiters": maxiters}, **path,
                             device="cpu")
    tp, tstep, tex = T.build_uq(tcfg, p_opt, particles=np.asarray(jp),
                                reps=np.asarray(jex["reps"]))
    np.testing.assert_allclose(tex["normalizer"].numpy(),
                               np.asarray(jex["normalizer"]), rtol=1e-15)
    np.testing.assert_allclose(tex["p_scales"].numpy(),
                               np.asarray(jex["p_scales"]), rtol=1e-15)
    for i_exp in (0, 2):
        want_p, want_l = jstep(jp, jnp.asarray(i_exp), 1e-4)
        got_p, got_l = tstep(tp, i_exp, 1e-4)
        np.testing.assert_allclose(got_l.item(), float(want_l), rtol=1e-9)
        np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                                   rtol=1e-9)
        assert not np.array_equal(got_p.numpy(), tp.numpy())
    np.testing.assert_allclose(
        tex["loss_all"](tp, 3).numpy(),
        np.asarray(jex["loss_all"](jp, jnp.asarray(3))), rtol=1e-9)


@pytest.mark.parametrize("batch_major", [True, False])
def test_run_uq_two_iterations_match_jax(batch_major):
    jcfg, p_opt, jp, _, jex = _jax_inputs(n_iters=2, batch_major=batch_major,
                                          gap=1)
    want_p, want = J.run_uq(jcfg, p_opt, verbose=False)
    tcfg = T.CathodeUQConfig(**SMALL, n_iters=2, batch_major=batch_major,
                             gap=1, device="cpu")
    got_p, got = T.run_uq(tcfg, p_opt, verbose=False,
                          particles=np.asarray(jp),
                          reps=np.asarray(jex["reps"]))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-9)
    for k in ("loss_train", "loss_val"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9)
    np.testing.assert_allclose(got["history"], np.asarray(want["history"]),
                               rtol=1e-9)
    assert got["history"].shape == (2, 8, 17)
