"""HyChem and its interpolant in the port against the JAX package:
``make_interpolant`` against ``jnp.interp`` (values and ``jvp`` in x at the
knots, inside segments and beyond both ends, f64 1e-12), the interpolant
under the per-lane Rosenbrock23's ``lane_dfdt``, ``resample_log_grid``,
``synthetic_pyrolysis`` equal to JAX's bit for bit (both numpy and
scipy), the case's data and RHS, the t-dependent Rosenbrock23 solve
(n_steps exact), one whole f64 training epoch at rtol 1e-6, and
``load_trajectory`` on a table the test writes with ``np.savetxt``, as
tests/test_cases.py:197 does.

Reduced size: nr=2 and 16 save points (horizons 16-16, the whole grid),
Rosenbrock23 at rtol 1e-3 / atol 1e-8 and max_steps 256 as shipped.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mlp import capture_build

from crnn_tpu.cases import hychem as jh
from crnn_tpu.data.interp import make_interpolant as j_make_interpolant
from crnn_tpu.data.interp import resample_log_grid as j_resample
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import hychem as th
from crnn_tpu_torch.data.interp import make_interpolant, resample_log_grid
from crnn_tpu_torch.train.loop import TrainState

SMALL = dict(nr=2, ntotal=16)
XS = np.array([0.0, 1e-4, 4e-4, 4e-4, 1.1e-3, 2.5e-3, 5e-3])   # a zero-width
YS = np.array([1300.0, 1301.5, 1290.0, 1295.0, 1310.0, 1420.0, 1450.0])
X = np.array([-1e-3, 0.0, 5e-5, 1e-4, 3e-4, 4e-4, 8e-4, 1.1e-3, 2e-3,
              2.5e-3, 4.9e-3, 5e-3, 7e-3])


def test_interpolant_matches_jnp_interp_with_jvp():
    """Values and d/dx at every kind of point, the repeated knot (a
    zero-width segment) among them: at a knot the slope is the segment to
    its right's (``side='right'``), the last knot takes the last segment's,
    and beyond both ends the value is constant with slope 0."""
    f = make_interpolant(torch.from_numpy(XS), torch.from_numpy(YS))
    g = j_make_interpolant(jnp.asarray(XS), jnp.asarray(YS))
    v, dv = torch.func.jvp(f, (torch.from_numpy(X),),
                           (torch.ones(len(X), dtype=torch.float64),))
    jv, jdv = jax.jvp(g, (jnp.asarray(X),), (jnp.ones(len(X)),))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-12)
    np.testing.assert_allclose(dv.numpy(), np.asarray(jdv), rtol=1e-12,
                               atol=1e-12 * float(np.abs(jdv).max()))
    slope = np.diff(YS) / np.where(np.diff(XS) == 0, 1.0, np.diff(XS))
    assert dv[1].item() == pytest.approx(slope[0])       # knot 0: right
    assert dv[3].item() == pytest.approx(slope[1])       # knot 1: right
    assert dv[11].item() == pytest.approx(slope[-1])     # last knot
    assert dv[0].item() == dv[12].item() == 0.0          # beyond the ends
    assert v[0].item() == YS[0] and v[12].item() == YS[-1]


def test_interpolant_under_lane_dfdt():
    """The per-lane Rosenbrock23's df/dt (one ``torch.func.jvp`` in t) of
    an RHS that reads the interpolant equals ``jax.jvp`` of JAX's."""
    from crnn_tpu_torch.ode.rosenbrock import lane_dfdt

    f = make_interpolant(torch.from_numpy(XS), torch.from_numpy(YS))
    g = j_make_interpolant(jnp.asarray(XS), jnp.asarray(YS))
    y = np.random.default_rng(0).uniform(0.5, 1.5, size=(len(X), 2))

    def rhs(t, yy, a):
        return yy * f(t)[:, None] * a

    got = lane_dfdt(rhs, torch.from_numpy(X), torch.from_numpy(y), 2.0)
    want = jax.vmap(lambda t, yy: jax.jvp(
        lambda tt: yy * g(tt) * 2.0, (t,), (1.0,))[1])(
        jnp.asarray(X), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12 * float(np.abs(want).max()))


def test_resample_log_grid_matches_jax():
    for t_end, n in ((5e-3, 40), (5e-3, 16), (2.0, 7)):
        got = resample_log_grid(t_end, n)
        want = np.asarray(j_resample(t_end, n))
        assert got.dtype == torch.float64 and got[0].item() == 0.0
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14)


def test_synthetic_pyrolysis_equals_jax_bit_for_bit():
    got = th.synthetic_pyrolysis()
    np.testing.assert_array_equal(got, jh.synthetic_pyrolysis())
    assert got.shape == (50, 12)
    np.testing.assert_allclose(got[:, 3:].sum(1), 1.0, rtol=1e-12)
    for name in ("MW", "E_C", "E_H", "E_N"):
        np.testing.assert_array_equal(getattr(th, name), getattr(jh, name))
    assert th.VARNAMES == jh.VARNAMES and th.R_KCAL == jh.R_KCAL


@pytest.fixture(scope="module")
def both():
    jsetup = jh.build(jh.HyChemConfig(**SMALL))
    setup = th.build(th.HyChemConfig(device="cpu", **SMALL))
    return jsetup, setup


def test_data_and_weights_match_jax(both):
    jsetup, setup = both
    jds, ds = jsetup.dataset, setup.dataset
    np.testing.assert_allclose(ds.ts.numpy(), np.asarray(jds.ts), rtol=1e-14)
    np.testing.assert_allclose(ds.ys.numpy(), np.asarray(jds.ys), rtol=1e-12)
    np.testing.assert_allclose(ds.yscale.numpy(), np.asarray(jds.yscale),
                               rtol=1e-12)
    np.testing.assert_allclose(setup.extras["e_null"].numpy(),
                               np.asarray(jsetup.extras["e_null"]),
                               rtol=1e-14, atol=1e-15)
    p = np.random.default_rng(3).normal(size=setup.init_params.shape) * 0.1
    got = setup.weights_fn(torch.from_numpy(p))
    want = jsetup.weights_fn(jnp.asarray(p))
    for name in ("w_in", "w_b", "w_out"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=1e-15)
    assert setup.init_params.shape == jsetup.init_params.shape
    assert setup.init_params[-1].item() == 0.1


def test_project_elements_conserves_elements():
    setup = th.build(th.HyChemConfig(device="cpu", project_elements=True,
                                     **SMALL))
    w = setup.weights_fn(setup.init_params)
    e_mat = np.stack([th.E_C, th.E_H, th.E_N], axis=1).astype(float)
    # every reaction's stoichiometry conserves C, H and N
    np.testing.assert_allclose(e_mat.T @ w.w_out.numpy(), 0.0, atol=1e-12)


def test_solve_matches_jax(both):
    """The t-dependent Rosenbrock23 solve (J by forward mode in y, df/dt by
    forward mode in t through the interpolants) at JAX's initial params,
    through each case's prediction: the trajectory within 1e-9 of each
    species' largest value."""
    jsetup, setup = both
    p = np.array(jsetup.init_params)
    want = np.asarray(jsetup.predict(jnp.asarray(p), 0))
    got = setup.predict(torch.from_numpy(p), 0)
    err = np.abs(got.numpy() - want) / np.abs(want).max(0)
    assert err.max() <= 1e-9, err.max()


def _nonlocal(fn, *names):
    """A variable of ``fn``'s closure, following ``names`` through nested
    closures: the case's RHS is local to its build in both packages."""
    for name in names:
        fn = getattr(fn, "__wrapped__", fn)
        fn = inspect.getclosurevars(fn).nonlocals[name]
    return fn


def test_n_steps_match_jax(both):
    """n_steps exact on the t-dependent solve at JAX's initial params: the
    port's odesolve on its case's RHS against JAX's on its own."""
    from crnn_tpu.ode import Rosenbrock23 as JRb23
    from crnn_tpu.ode import odesolve as j_odesolve
    from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
    from crnn_tpu_torch.ode.solve import odesolve

    jsetup, setup = both
    p = np.asarray(jsetup.init_params)
    ts = setup.dataset.ts
    u0 = setup.dataset.ys[0, :1]
    rhs = _nonlocal(setup.predict, "predict_lanes", "rhs")
    j_rhs = _nonlocal(jsetup.predict, "predict", "rhs")
    sol = odesolve(rhs, Rosenbrock23(), u0, 0.0, float(ts[-1]), ts,
                   args=setup.weights_fn(torch.from_numpy(p)), rtol=1e-3,
                   atol=1e-8, max_steps=256, unroll="while")
    jsol = j_odesolve(j_rhs, JRb23(), jnp.asarray(u0[0].numpy()), 0.0,
                      float(ts[-1]), jnp.asarray(ts.numpy()),
                      args=jsetup.weights_fn(jnp.asarray(p)), rtol=1e-3,
                      atol=1e-8, max_steps=256, unroll="while")
    assert int(sol.n_steps[0]) == int(jsol.n_steps) > 0
    assert int(sol.n_accepted[0]) == int(jsol.n_accepted)
    assert bool(sol.success[0]) and bool(jsol.success)
    want = np.asarray(jsol.ys)
    err = np.abs(sol.ys[0].numpy() - want) / np.abs(want).max(0)
    assert err.max() <= 1e-9, err.max()


def test_epoch_matches_jax_f64(both):
    """The second epoch, continued in the port from JAX's first (params and
    optax state through ``convert``), on the same masks: loss, gradient,
    updated params and eval loss at rtol 1e-6."""
    jsetup, setup = both
    jtrainer = jsetup.trainer
    epoch = jtrainer.epoch_fn()
    state1, _ = epoch(jtrainer.init(jsetup.init_params, seed=0))
    state2, jm = epoch(state1)
    _, _, k_hor = jax.random.split(state1.key, 3)
    masks = jtrainer._sample_masks(k_hor, 1, jnp.float64)
    j_loss, j_grad = jax.value_and_grad(lambda p: jtrainer.loss_i_exp(
        p, jnp.asarray(0), masks[0]))(state1.params)
    trainer = setup.trainer
    state = TrainState(
        convert.params_from_jax(np.asarray(state1.params), device="cpu"),
        convert.adam_state_from_optax(state1.opt_state, device="cpu"), 1,
        torch.Generator().manual_seed(0))
    perm = torch.zeros(1, dtype=torch.long)
    masks_t = torch.from_numpy(np.array(masks))
    loss, grad = trainer.value_and_grad(state.params, perm, masks_t)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-6)
    j_grad = np.asarray(j_grad)
    np.testing.assert_allclose(grad.numpy(), j_grad, rtol=1e-6,
                               atol=1e-6 * np.abs(j_grad).max())
    new_state, m = trainer.epoch(state, perm=perm, masks=masks_t)
    np.testing.assert_allclose(new_state.params.numpy(),
                               np.asarray(state2.params), rtol=1e-6)
    for name in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(getattr(jm, name)), rtol=1e-6)


def test_load_trajectory_and_the_cli_on_a_file(tmp_path, monkeypatch):
    """``load_trajectory`` reads the table as the reference writes it, and
    the CLI (``--data``, ``--device cpu``, the reduced size) builds the
    same data as the JAX case from it, trains one epoch and writes
    ``p_opt.npy``."""
    raw = th.synthetic_pyrolysis()
    path = tmp_path / "data_1"
    np.savetxt(path, raw)          # the reference's own writer call
    np.testing.assert_array_equal(th.load_trajectory(str(path)),
                                  jh.load_trajectory(str(path)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            th.build(th.HyChemConfig(**SMALL))
    seen = capture_build(monkeypatch, th, "HyChemConfig", **SMALL)
    state, hist = th.main(["--epochs", "1", "--data", str(path), "--device",
                           "cpu", "--out", str(tmp_path), "--grad-max",
                           "5.0"])
    (setup,) = seen
    jsetup = jh.build(jh.HyChemConfig(data_path=str(path), **SMALL))
    np.testing.assert_allclose(setup.dataset.ys.numpy(),
                               np.asarray(jsetup.dataset.ys), rtol=1e-12)
    assert setup.extras["config"].grad_max == 5.0
    assert state.epoch == 1 and np.isfinite(hist["loss_train"][0])
    assert np.load(tmp_path / "hychem" / "p_opt.npy").shape == (
        setup.init_params.shape)
