"""Cathode in the port against the JAX package: ``p2vec_cathode`` with its
clips and ``init_params_cathode``'s layout, the heating-ramp RHS and
``cathode_hrr`` with their gradients in f64 at 1e-12, a TRBDF2 solve of a
curve (n_steps exact), the gradient of the early-exit driver's loss by
reverse mode (the port's ``grad_mode='rev_while'``) against
``torch.func.jacfwd`` (JAX's way), the closed-form J against forward mode
of the RHS (JAX's per-lane J) and JAX's batch-major closed form, and one
whole sequential epoch against JAX's forward-mode epoch at rtol 1e-6.

Reduced size: three heating rates (5, 15, 20 K/min) of ``synthetic_dsc``,
15 K/min held out, so two updates an epoch; the rest as shipped (TRBDF2 at
rtol 1e-4, atol = lb = 1e-8, 49 temperatures a curve, max 2048 steps).
The loaders, the YAML flow and ``run_cathode`` are held in
tests/test_torch_cathode_run.py.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.cases import cathode as jc
from crnn_tpu.data.loaders import synthetic_dsc as j_synthetic_dsc
from crnn_tpu.models.crnn import cathode_hrr as j_cathode_hrr
from crnn_tpu.models.crnn import make_cathode_rhs as j_make_cathode_rhs
from crnn_tpu.transforms.p2vec import init_params_cathode as j_init
from crnn_tpu.transforms.p2vec import p2vec_cathode as j_p2vec
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import cathode as tc
from crnn_tpu_torch.data.loaders import synthetic_dsc
from crnn_tpu_torch.models.crnn import (cathode_hrr, make_cathode_jac,
                                        make_cathode_rhs)
from crnn_tpu_torch.train.loop import TrainState
from crnn_tpu_torch.transforms.p2vec import init_params_cathode, p2vec_cathode

RATES = (5.0, 15.0, 20.0)
SMALL = dict(val_index=1)


def _p(seed=0):
    p = np.asarray(j_init(jax.random.PRNGKey(seed)))
    p = p + np.random.default_rng(seed).normal(size=18) * 0.05
    p[4] = 0.0                  # an Ea at 0: the |.| kink
    p[13] = 0.01                # an order at its clip bound
    return p


def test_p2vec_cathode_matches_jax_with_gradients():
    p = _p()
    got = p2vec_cathode(torch.from_numpy(p))
    want = j_p2vec(jnp.asarray(p))
    for name in ("w_in", "w_b", "w_out"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for k in ("Ea", "b", "delH"):
        np.testing.assert_array_equal(got.extra[k].numpy(),
                                      np.asarray(want.extra[k]))
    assert got.w_out[0].item() == 1.0

    def j_f(p_):
        w = j_p2vec(p_)
        return (jnp.sum(w.w_in ** 2) + jnp.sum(w.w_b ** 2)
                + jnp.sum(jnp.sin(w.w_out))
                + sum(jnp.sum(v ** 3) for v in w.extra.values()))

    pt = torch.from_numpy(p).requires_grad_(True)
    w = p2vec_cathode(pt)
    (g,) = torch.autograd.grad(
        torch.sum(w.w_in ** 2) + torch.sum(w.w_b ** 2)
        + torch.sum(torch.sin(w.w_out))
        + sum(torch.sum(v ** 3) for v in w.extra.values()), pt)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(j_f)(jnp.asarray(p))),
                               rtol=1e-15, atol=0)


def test_init_params_cathode_layout():
    p = init_params_cathode(torch.Generator().manual_seed(0), device="cpu")
    want = np.asarray(j_init(jax.random.PRNGKey(0)))
    assert p.shape == (18,) and p.dtype == torch.float64
    # the offsets are JAX's; the N(0, 1e-4) draws differ
    np.testing.assert_allclose(p.numpy(), want, atol=0.06)
    assert p[17].item() == want[17] == 0.1


def test_synthetic_dsc_equals_jax():
    for kw in ({}, dict(seed=3, heating_rates=RATES, dT=12.0)):
        got, want = synthetic_dsc(**kw), j_synthetic_dsc(**kw)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name))


def test_cathode_rhs_and_hrr_match_jax_with_gradients():
    """The RHS on lanes (t and y of each lane, one beta) and the HRR of a
    trajectory against JAX's, values and gradients w.r.t. y, t and the
    params, f64 1e-12 (of each array's largest entry near 0); y carries
    entries below lb and above 10."""
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 1.0, size=(6, 3))
    y[0, 1], y[1, 2] = 1e-12, 12.0
    t = rng.uniform(0.0, 3000.0, size=6)
    p = _p(2)
    beta = 10.0
    j_rhs = j_make_cathode_rhs(1e-8)

    def j_total(yy, tt, pp):
        w = j_p2vec(pp)
        du = jax.vmap(lambda ti, v: j_rhs(ti, v, (w, beta)))(tt, yy)
        hrr = j_cathode_hrr(tt, yy, w, beta, 1e-8)
        return jnp.sum(jnp.tanh(du)) + jnp.sum(jnp.tanh(hrr)), (du, hrr)

    _, (du_j, hrr_j) = j_total(jnp.asarray(y), jnp.asarray(t), jnp.asarray(p))
    j_grads = jax.grad(lambda *a: j_total(*a)[0], argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(t), jnp.asarray(p))
    yt, tt, pt = (torch.from_numpy(a).requires_grad_(True) for a in (y, t, p))
    w = p2vec_cathode(pt)
    beta_t = torch.tensor(beta, dtype=torch.float64)
    du = make_cathode_rhs(1e-8)(tt, yt, (w, beta_t))
    hrr = cathode_hrr(tt, yt, w, beta_t, 1e-8)
    for got, want in ((du, du_j), (hrr, hrr_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    grads = torch.autograd.grad(torch.tanh(du).sum() + torch.tanh(hrr).sum(),
                                (yt, tt, pt))
    for g, jg in zip(grads, j_grads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12,
                                   atol=1e-12 * np.abs(jg).max())


def test_cathode_closed_form_jac_equals_forward_mode_and_jax():
    """``make_cathode_jac`` against forward mode of the RHS
    (``lane_jacfwd``, the J the JAX package's per-lane cathode takes) and
    against the J of JAX's ``make_cathode_rhs_batch``, f64 1e-14 of the
    largest entry; y carries entries below lb and above 10 (their columns
    0), and a bias past the exp cap zeroes a rate's column."""
    from crnn_tpu.models.crnn import make_cathode_rhs_batch
    from crnn_tpu_torch.ode.rosenbrock import lane_jacfwd

    rng = np.random.default_rng(3)
    y = rng.uniform(0.01, 1.0, size=(7, 3))
    y[0, 1], y[1, 2] = 1e-12, 12.0
    t = rng.uniform(0.0, 3000.0, size=7)
    p = _p(4)
    w = p2vec_cathode(torch.from_numpy(p))
    beta = torch.tensor(10.0, dtype=torch.float64)
    args = (w, beta)
    got = make_cathode_jac(1e-8)(torch.from_numpy(t), torch.from_numpy(y),
                               args)
    rhs = make_cathode_rhs(1e-8)
    fwd = lane_jacfwd(lambda yy: rhs(torch.from_numpy(t), yy, args),
                      torch.from_numpy(y))
    scale = float(fwd.abs().max())
    np.testing.assert_allclose(got.numpy(), fwd.numpy(), rtol=1e-14,
                               atol=1e-14 * scale)
    assert got[0, :, 1].abs().max() == 0 and got[1, :, 2].abs().max() == 0
    wj = j_p2vec(jnp.asarray(p))
    wb = jax.tree.map(lambda a: jnp.broadcast_to(a, (7,) + a.shape), wj)
    _, j_jac, _ = make_cathode_rhs_batch(1e-8)[1](
        jnp.asarray(t), jnp.asarray(y), (wb, 10.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(j_jac), rtol=1e-14,
                               atol=1e-14 * scale)
    w_cap = w._replace(w_b=w.w_b + 60.0)
    capped = make_cathode_jac(1e-8)(torch.from_numpy(t), torch.from_numpy(y),
                                    (w_cap, beta))
    assert float(capped.abs().max()) == 0.0


@pytest.fixture(scope="module")
def both():
    dsc = synthetic_dsc(heating_rates=RATES)
    saved = jc.synthetic_dsc
    jc.synthetic_dsc = lambda seed=0: j_synthetic_dsc(seed=seed,
                                                      heating_rates=RATES)
    try:
        jsetup = jc.build(jc.CathodeConfig(**SMALL))
    finally:
        jc.synthetic_dsc = saved
    setup = tc.build(tc.CathodeConfig(device="cpu", **SMALL), dsc=dsc)
    return jsetup, setup


def _nonlocal(fn, *names):
    """A variable of ``fn``'s closure, through nested closures."""
    for name in names:
        fn = getattr(fn, "__wrapped__", fn)
        fn = inspect.getclosurevars(fn).nonlocals[name]
    return fn


@pytest.mark.parametrize("closed_form", [True, False])
def test_curve_solve_matches_jax(both, closed_form):
    """The validation curve (15 K/min, moved last) at JAX's initial params:
    its time span and save row, the TRBDF2 solve with the case's
    closed-form J and with forward mode's (n_steps exact, ys within 1e-9
    of each species' largest) against JAX's (forward mode), and the
    predicted HRR."""
    from crnn_tpu.ode import TRBDF2 as JTRBDF2
    from crnn_tpu.ode import odesolve as j_odesolve
    from crnn_tpu_torch.ode.sdirk import TRBDF2
    from crnn_tpu_torch.ode.solve import odesolve

    jsetup, setup = both
    p = np.array(jsetup.init_params)
    ts = _nonlocal(setup.extras["predict_hrr"], "ts")
    betas = _nonlocal(setup.extras["predict_hrr"], "betas")
    np.testing.assert_array_equal(
        ts.numpy(), np.asarray(_nonlocal(jsetup.extras["predict_hrr"], "ts")))
    np.testing.assert_array_equal(betas.numpy(), [5.0, 20.0, 15.0])
    row = ts[2]
    w = p2vec_cathode(torch.from_numpy(p))
    jac = make_cathode_jac(1e-8) if closed_form else None
    sol = odesolve(make_cathode_rhs(1e-8), TRBDF2(jac=jac),
                   torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64),
                   float(row[0]), float(row[-1]), row, args=(w, betas[2]),
                   rtol=1e-4, atol=1e-8, max_steps=2048, unroll="while")
    jsol = j_odesolve(j_make_cathode_rhs(1e-8), JTRBDF2(),
                      jnp.asarray([1.0, 0.0, 0.0]), row[0].item(),
                      row[-1].item(), jnp.asarray(row.numpy()),
                      args=(j_p2vec(jnp.asarray(p)), 15.0), rtol=1e-4,
                      atol=1e-8, max_steps=2048, unroll="while")
    assert int(sol.n_steps[0]) == int(jsol.n_steps) > 0
    assert bool(sol.success[0]) and bool(jsol.success)
    want = np.asarray(jsol.ys)
    err = np.abs(sol.ys[0].numpy() - want).max(0) / np.abs(want).max(0)
    assert err.max() <= 1e-9, err
    hrr = setup.extras["predict_hrr"](torch.from_numpy(p), 2)
    j_hrr = np.asarray(jsetup.extras["predict_hrr"](jnp.asarray(p), 2))
    np.testing.assert_allclose(hrr.numpy(), j_hrr, rtol=1e-9,
                               atol=1e-9 * np.abs(j_hrr).max())


def test_rev_while_gradient_equals_jacfwd():
    """The port's reverse mode through the early-exit driver against
    ``torch.func.jacfwd`` through it, the way the JAX package takes the
    gradient (forward mode over 18 params), on one short 20 K/min curve:
    the same derivative to 1e-10."""
    dsc = synthetic_dsc(heating_rates=(20.0, 20.0), t0_celsius=150.0,
                        t1_celsius=250.0, dT=10.0)
    grads = []
    for mode in ("rev_while", "fwd"):
        s = tc.build(tc.CathodeConfig(device="cpu", val_index=1), dsc=dsc)
        assert s.trainer.grad_mode == "rev_while"
        s.trainer.grad_mode = mode
        loss, g = s.trainer.value_and_grad(
            s.init_params, torch.tensor([0]),
            torch.ones((1, dsc.ts.shape[1]), dtype=torch.float64))
        grads.append(g)
        assert torch.isfinite(loss)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-10,
                               atol=1e-10 * float(grads[1].abs().max()))


def test_epoch_matches_jax_f64(both):
    """The second sequential epoch, continued in the port from JAX's first
    (params and optax state through ``convert``) on JAX's permutation: the
    gradient of the first update against JAX's ``jacfwd``, the updated
    params, the eval losses and the metrics at rtol 1e-6."""
    jsetup, setup = both
    jtrainer = jsetup.trainer
    assert jtrainer.mode == setup.trainer.mode == "sequential"
    assert jtrainer.grad_mode == "fwd"
    assert setup.trainer.grad_mode == "rev_while"
    epoch = jtrainer.epoch_fn()
    state1, _ = epoch(jtrainer.init(jsetup.init_params, seed=0))
    state2, jm = epoch(state1)
    _, k_perm, _ = jax.random.split(state1.key, 3)
    perm = jax.random.permutation(k_perm, 2)
    n_save = jsetup.dataset.ys.shape[1]
    ones = jnp.ones((n_save,), jnp.float64)
    j_loss_fn = jtrainer.loss_i_exp_eval
    j_grad = jax.jacfwd(lambda p: j_loss_fn(p, perm[0], ones))(state1.params)
    state = TrainState(
        convert.params_from_jax(np.asarray(state1.params), device="cpu"),
        convert.adam_state_from_optax(state1.opt_state, device="cpu"), 1,
        torch.Generator().manual_seed(0))
    perm_t = torch.from_numpy(np.array(perm))
    masks = torch.ones((2, n_save), dtype=torch.float64)
    loss, g = setup.trainer.value_and_grad(state.params, perm_t[:1],
                                           masks[:1])
    np.testing.assert_allclose(loss.item(), float(j_loss_fn(
        state1.params, perm[0], ones)), rtol=1e-6)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(g.numpy(), j_grad, rtol=1e-6,
                               atol=1e-6 * np.abs(j_grad).max())
    new_state, m = setup.trainer.epoch(state, perm=perm_t, masks=masks)
    np.testing.assert_allclose(new_state.params.numpy(),
                               np.asarray(state2.params), rtol=1e-6)
    np.testing.assert_allclose(m.loss_exp.numpy(), np.asarray(jm.loss_exp),
                               rtol=1e-6)
    for name in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(getattr(jm, name)), rtol=1e-6)
    assert new_state.opt_state.count == 4 == int(
        convert.adam_state_from_optax(state2.opt_state, device="cpu").count)
