"""crnn_tpu_torch/data against crnn_tpu/data (f64).

The port generates case2's truth with its own batch-major Rosenbrock23
(dense W-solve, closed-form Jacobian); the JAX package with a per-lane
Rosenbrock23. Both solve at rtol 1e-6 / atol 1e-9 but take different
steps, so the clean trajectories agree to the solvers' accuracy: 1e-4 of
each species' scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crnn_tpu.data import generate as jg
from crnn_tpu.data import truth as jt
from crnn_tpu.ode import Rosenbrock23
from crnn_tpu_torch.data import generate as tg
from crnn_tpu_torch.data import truth as tt


def _u0(n=4, seed=0):
    rng = np.random.default_rng(seed)
    u0 = np.zeros((n, 7))
    u0[:, :2] = rng.uniform(size=(n, 2)) * 2.0 + 0.2
    u0[:, 6] = rng.uniform(size=n) * 20.0 + 323.0
    return u0


def _k(u0):
    return np.array(jax.vmap(lambda temp: jt.case2_arrhenius(
        jt.CASE2_LOGA, jt.CASE2_EA, temp))(jnp.asarray(u0[:, -1])))


def test_constants_and_arrhenius_match_jax():
    np.testing.assert_array_equal(np.asarray(tt.CASE2_LOGA), np.asarray(jt.CASE2_LOGA))
    np.testing.assert_array_equal(np.asarray(tt.CASE2_EA), np.asarray(jt.CASE2_EA))
    u0 = _u0(6)
    k = tt.case2_arrhenius(torch.tensor(tt.CASE2_LOGA, dtype=torch.float64),
                           torch.tensor(tt.CASE2_EA, dtype=torch.float64),
                           torch.from_numpy(u0[:, -1]))
    np.testing.assert_allclose(k.numpy(), _k(u0), rtol=1e-14)


def test_truth_and_jacobian_match_jax():
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 2.0, size=(5, 7))
    k = rng.uniform(0.01, 3.0, size=(5, 3))
    du, jac = tt.case2_truth_jac(0.0, torch.from_numpy(y), torch.from_numpy(k))
    want_du = jax.vmap(jt.case2_truth, in_axes=(None, 0, 0))(
        0.0, jnp.asarray(y), jnp.asarray(k))
    want_jac = jax.vmap(jax.jacfwd(jt.case2_truth, argnums=1),
                        in_axes=(None, 0, 0))(0.0, jnp.asarray(y), jnp.asarray(k))
    np.testing.assert_array_equal(du.numpy(), np.asarray(want_du))
    np.testing.assert_allclose(jac.numpy(), np.asarray(want_jac), rtol=1e-15)
    np.testing.assert_array_equal(
        tt.case2_truth(0.0, torch.from_numpy(y), torch.from_numpy(k)).numpy(),
        du.numpy())


def test_max_min_scale_matches_jax():
    ys = np.random.default_rng(2).normal(size=(4, 9, 6))
    np.testing.assert_allclose(
        tg.max_min_scale(torch.from_numpy(ys), 1e-6).numpy(),
        np.asarray(jg.max_min_scale(jnp.asarray(ys), 1e-6)), rtol=1e-15)


def test_generated_truth_matches_jax():
    u0 = _u0()
    t1, n_save = 50.0, 50
    saveat = np.linspace(0.0, t1, n_save)
    k = _k(u0)
    want = jg.generate_dataset(
        jax.random.PRNGKey(0), jt.case2_truth, Rosenbrock23(), jnp.asarray(u0),
        jnp.asarray(k), 0.0, t1, jnp.asarray(saveat), rtol=1e-6, atol=1e-9,
        noise=0.05, obs_dim=6, scale_mode="max_min", scale_lb=1e-6)
    got = tg.generate_dataset(
        torch.Generator().manual_seed(0), tt.case2_truth, tt.case2_truth_jac,
        torch.from_numpy(u0), torch.from_numpy(k), 0.0, t1,
        torch.from_numpy(saveat), rtol=1e-6, atol=1e-9, noise=0.05,
        obs_dim=6, scale_lb=1e-6)
    assert bool(got.success.all()) and bool(np.asarray(want.success).all())
    want_clean = np.asarray(want.ys_clean)
    scale = np.abs(want_clean).max(axis=(0, 1))
    err = np.abs(got.ys_clean.numpy() - want_clean) / scale
    assert err.max() < 1e-4, err.max()
    # noise model and scales: ys = ys_clean * (1 + noise * eps), eps ~ N(0, 1)
    rel = (got.ys / got.ys_clean - 1.0)[got.ys_clean.abs() > 1e-3] / 0.05
    assert 0.8 < float(rel.std()) < 1.2 and abs(float(rel.mean())) < 0.1
    np.testing.assert_allclose(got.yscale.numpy(),
                               tg.max_min_scale(got.ys, 1e-6).numpy())
    assert got.ys.shape == (4, n_save, 6)


def test_noise_free_dataset_is_the_clean_truth():
    u0 = _u0(3, seed=4)
    saveat = np.linspace(0.0, 10.0, 6)
    got = tg.generate_dataset(
        torch.Generator().manual_seed(0), tt.case2_truth, tt.case2_truth_jac,
        torch.from_numpy(u0), torch.from_numpy(_k(u0)), 0.0, 10.0,
        torch.from_numpy(saveat), rtol=1e-6, atol=1e-9, noise=0.0)
    assert torch.equal(got.ys, got.ys_clean) and got.ys.shape == (3, 6, 7)
    np.testing.assert_allclose(got.ys[:, 0].numpy(), u0)
