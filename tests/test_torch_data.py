"""crnn_tpu_torch/data against crnn_tpu/data (f64).

The port generates case2's truth with its own batch-major Rosenbrock23
(dense W-solve, closed-form Jacobian); the JAX package with a per-lane
Rosenbrock23. Both solve at rtol 1e-6 / atol 1e-9 but take different
steps, so the clean trajectories agree to the solvers' accuracy: 1e-4 of
each species' scale. case1's and robertson's truths go through the per-lane
driver in both packages, with the same steps: rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.data import generate as jg
from crnn_tpu.data import truth as jt
from crnn_tpu.ode import Rosenbrock23
from crnn_tpu.ode import Tsit5 as JTsit5
from crnn_tpu_torch.data import generate as tg
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23 as TRosenbrock23
from crnn_tpu_torch.ode.tsit5 import Tsit5


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


# ---- case1 and robertson: truth, Latin hypercube, per-lane generation -----

def test_case1_and_robertson_truth_match_jax():
    rng = np.random.default_rng(5)
    for j_fn, t_fn, k, ns in ((jt.case1_truth, tt.case1_truth, tt.CASE1_K, 5),
                              (jt.robertson_truth, tt.robertson_truth,
                               tt.ROBERTSON_K, 3)):
        y = rng.uniform(0.0, 2.0, size=(6, ns))
        want = jax.vmap(j_fn, in_axes=(None, 0, None))(0.0, jnp.asarray(y),
                                                       jnp.asarray(k))
        got = t_fn(0.0, torch.from_numpy(y),
                   torch.tensor(k, dtype=torch.float64).expand(6, -1))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(tt.CASE1_K), np.asarray(jt.CASE1_K))
    np.testing.assert_array_equal(np.asarray(tt.ROBERTSON_K),
                                  np.asarray(jt.ROBERTSON_K))


def test_latin_hypercube_is_a_permutation_per_column():
    lhc = tg.latin_hypercube(torch.Generator().manual_seed(3), 25, 2,
                             torch.float64)
    want = jg.latin_hypercube(jax.random.PRNGKey(0), 25, 2, jnp.float64)
    assert lhc.shape == want.shape == (25, 2) and lhc.dtype == torch.float64
    for col in range(2):   # each column is {1..n}/n in some order
        np.testing.assert_allclose(np.sort(lhc[:, col].numpy()),
                                   np.sort(np.asarray(want[:, col])),
                                   rtol=1e-15)
    assert not torch.equal(lhc[:, 0], lhc[:, 1])


@pytest.mark.parametrize("case", ["case1", "robertson"])
def test_generate_dataset_odesolve_matches_jax(case):
    """The per-lane truth solve with u0 passed across: case1 through Tsit5
    (rtol 1e-6 / atol 1e-8, 40 save points), robertson through Rosenbrock23
    with the forward-mode Jacobian (rtol 1e-8, per-species atol, 12
    log-spaced save points to 1e5, ~1100-1600 steps a lane). Same step
    sequence as JAX, so success exact and ys_clean at rtol 1e-9 plus, for
    robertson, the solve's own atol (1e-12 on y2): over ~1500 stiff steps
    one ulp of u0 moves y2 by 1.3e-13, and the port is 1.8e-13 from JAX."""
    rng = np.random.default_rng(6)
    if case == "case1":
        u0 = np.zeros((4, 5))
        u0[:, :2] = rng.uniform(size=(4, 2)) + 0.2
        saveat = np.linspace(0.0, 40.0, 40)
        k, rtol, atol = tt.CASE1_K, 1e-6, 1e-8
        gate_atol = 1e-15
        j_rhs, t_rhs, j_solver, t_solver = (jt.case1_truth, tt.case1_truth,
                                            JTsit5(), Tsit5())
        lb = 1e-5
    else:
        u0 = rng.uniform(size=(2, 3)) + 0.5
        u0[:, 1] = 1e-8
        saveat = 10.0 ** np.linspace(0.0, 5.0, 12)
        k, rtol = tt.ROBERTSON_K, 1e-8
        atol = np.array([1e-10, 1e-12, 1e-10])
        gate_atol = atol
        j_rhs, t_rhs, j_solver, t_solver = (jt.robertson_truth,
                                            tt.robertson_truth,
                                            Rosenbrock23(), TRosenbrock23())
        lb = 0.0
    want = jg.generate_dataset(
        jax.random.PRNGKey(0), j_rhs, j_solver, jnp.asarray(u0),
        jnp.asarray(k), 0.0, float(saveat[-1]), jnp.asarray(saveat),
        rtol=rtol, atol=jnp.asarray(atol), noise=0.05, scale_lb=lb)
    got = tg.generate_dataset_odesolve(
        torch.Generator().manual_seed(0), t_rhs, t_solver,
        torch.from_numpy(u0), torch.tensor(k, dtype=torch.float64), 0.0,
        float(saveat[-1]), torch.from_numpy(saveat), rtol=rtol,
        atol=torch.as_tensor(atol, dtype=torch.float64), noise=0.05,
        scale_lb=lb)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    assert bool(got.success.all())
    want_clean = np.asarray(want.ys_clean)
    err = np.abs(got.ys_clean.numpy() - want_clean)
    assert np.all(err <= 1e-9 * np.abs(want_clean) + gate_atol), err.max()
    np.testing.assert_allclose(got.yscale.numpy(),
                               tg.max_min_scale(got.ys, lb).numpy())
    assert got.ys.shape == got.ys_clean.shape == (u0.shape[0], len(saveat),
                                                  u0.shape[1])
