"""case2 on the per-lane driver (``batch_major=False``) against the JAX
package, in f64: the lane-batched Arrhenius RHS and closed-form Jacobian
(crnn_tpu/models/crnn.py:make_crnn_arrhenius_rhs,
crnn_tpu/models/jacobian.py:make_crnn_arrhenius_jac) on conditioned inputs
with species at and beyond the clip bounds, and one whole training epoch
(reverse mode through the scan) at rtol 1e-6 with the eval solve's step
counts exact.

The epoch is reduced to 4 training and 2 held-out experiments; ns=6, nr=3,
50 save points and max_steps 128 as shipped."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import case2 as jcase2
from crnn_tpu.models.crnn import make_crnn_arrhenius_rhs as j_rhs
from crnn_tpu.models.jacobian import make_crnn_arrhenius_jac as j_jac
from crnn_tpu.ode import Rosenbrock23 as JRosenbrock23
from crnn_tpu.ode import odesolve as j_odesolve
from crnn_tpu.transforms.p2vec import p2vec_case2 as j_p2vec
from crnn_tpu_torch.cases import case2 as tcase2
from crnn_tpu_torch.models.crnn import make_crnn_arrhenius_rhs
from crnn_tpu_torch.models.jacobian import make_crnn_arrhenius_jac
from crnn_tpu_torch.ode import Rosenbrock23
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.transforms.p2vec import p2vec_case2

NS, NR, LB, UB = 6, 3, 1e-6, 10.0
N_TRAIN, N_TEST = 4, 2


def _close_per_component(got, want, rtol):
    """|got - want| <= rtol * (|want| + the component's largest |want|):
    each output component is gated on its own scale."""
    scale = np.abs(want).max(axis=0, keepdims=True)
    assert np.all(np.isfinite(got) == np.isfinite(want))
    np.testing.assert_array_less(np.abs(got - want),
                                 rtol * (np.abs(want) + scale) + 1e-300)


def test_arrhenius_rhs_and_jac_match_jax_f64():
    """Lanes with species inside (lb, ub), exactly at lb and ub, below lb
    (0 and negative) and above ub, at temperatures of case2's range. The
    weights are case2's init with its +0.8 log rate constants, so the
    uncapped exponents stay far below the cap: one ulp of the inputs moves
    the outputs by ~1e-15 of their scale."""
    rng = np.random.default_rng(11)
    p = rng.normal(0.0, 0.1, NR * (NS + 2) + 1)
    p[:NR] += 0.8
    p[NR * (NS + 1):NR * (NS + 2)] += 0.8
    p[-1] = 0.1
    y = np.empty((12, NS + 1))
    y[:, :NS] = rng.uniform(0.01, 2.0, (12, NS))
    y[:, NS] = rng.uniform(323.0, 343.0, 12)
    y[0, :NS] = LB
    y[1, :NS] = UB
    y[2, :3] = (0.0, -0.5, 1e-9)
    y[3, 3:NS] = (12.0, 1e3, UB * (1 + 1e-12))
    y[4, 1] = LB * (1 + 1e-9)
    w_j = j_p2vec(jnp.asarray(p), NS, NR)
    want_du = np.asarray(jax.vmap(lambda yy: j_rhs(LB, UB)(0.0, yy, w_j))(
        jnp.asarray(y)))
    want_j = np.asarray(jax.vmap(lambda yy: j_jac(LB, UB)(0.0, yy, w_j))(
        jnp.asarray(y)))
    w_t = p2vec_case2(torch.from_numpy(p), NS, NR)
    yt = torch.from_numpy(y)
    for plain in (False, True):       # on the CPU both are the plain version
        du = make_crnn_arrhenius_rhs(LB, UB, plain=plain)(None, yt, w_t)
        jac = make_crnn_arrhenius_jac(LB, UB, plain=plain)(None, yt, w_t)
        _close_per_component(du.numpy(), want_du, 1e-12)
        _close_per_component(jac.numpy(), want_j, 1e-12)
    assert np.all(want_j[:, NS, :] == 0) and np.all(jac[:, NS, :].numpy() == 0)
    # the clip bounds are strict: no species sensitivity at or beyond them
    assert np.all(jac[0, :NS, :NS].numpy() == 0)
    assert np.all(jac[1, :NS, :NS].numpy() == 0)
    assert np.all(jac[3, :NS, 3:NS].numpy() == 0)


def test_case2_per_lane_epoch_matches_jax_f64():
    """The epoch after a JAX epoch, in the port from its params, optax state
    and dataset, on the same permutation: loss, gradient, updated params,
    eval losses and metrics at rtol 1e-6; then the early-exit solve of every
    experiment at params moved off the init, n_steps exact."""
    cfg_kw = dict(n_exp_train=N_TRAIN, n_exp_test=N_TEST, dtype="float64",
                  batch_major=False)
    jsetup = jcase2.build(jcase2.Case2Config(**cfg_kw))
    assert jsetup.trainer.loss_batch is None
    ports = []

    def build_port(dataset):
        ports.append(tcase2.build(tcase2.Case2Config(device="cpu", **cfg_kw),
                                  dataset=dataset))
        return ports[-1]

    check_epoch_vs_jax(jsetup, build_port, N_TRAIN, rtol=1e-6)
    setup = ports[0]
    assert setup.trainer.loss_i_exp is not None
    cfg = tcase2.Case2Config(device="cpu", **cfg_kw)
    p = np.asarray(jax.random.normal(jax.random.PRNGKey(3),
                                     (NR * (NS + 2) + 1,))) * 0.05 \
        + np.asarray(jsetup.init_params)
    ds = jsetup.dataset
    w_j = j_p2vec(jnp.asarray(p), NS, NR)
    j_sol = jax.vmap(lambda u: j_odesolve(
        j_rhs(LB, UB), JRosenbrock23(jac=j_jac(LB, UB)), u, 0.0,
        float(cfg.datasize), ds.ts, args=w_j, rtol=cfg.rtol, atol=cfg.atol,
        max_steps=cfg.max_steps, unroll="while"))(ds.u0)
    t_sol = odesolve(
        make_crnn_arrhenius_rhs(LB, UB),
        Rosenbrock23(jac=make_crnn_arrhenius_jac(LB, UB)),
        setup.dataset.u0, 0.0, float(cfg.datasize), setup.dataset.ts,
        args=p2vec_case2(torch.from_numpy(p), NS, NR), rtol=cfg.rtol,
        atol=cfg.atol, max_steps=cfg.max_steps, unroll="while")
    np.testing.assert_array_equal(t_sol.n_steps.numpy(),
                                  np.asarray(j_sol.n_steps))
    np.testing.assert_array_equal(t_sol.success.numpy(),
                                  np.asarray(j_sol.success))
    _close_per_component(t_sol.ys.numpy().reshape(-1, NS + 1),
                         np.asarray(j_sol.ys).reshape(-1, NS + 1), 1e-6)
    # predict (the figures' solve, one lane) is that solve's clipped
    # species up to the summation order of a one-lane batch
    torch.testing.assert_close(
        setup.predict(torch.from_numpy(p), 1),
        torch.clamp(t_sol.ys[1, :, :NS], -UB, UB), rtol=1e-12, atol=1e-14)
