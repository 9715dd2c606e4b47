"""crnn_tpu_torch/ode against crnn_tpu/ode on the same numpy inputs (f64).

The batch-major solve is the same arithmetic in both packages up to the
summation order of the small matmuls, so trajectories, success flags and
step counts agree at rtol 1e-9 (step decisions are identical) and
gradients through the checkpointed scan at rtol 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.ode import batch_solve as jbs
from crnn_tpu.ode.base import hermite_interp_matrix_from_endpoints as j_herm
from crnn_tpu.ode.controller import propose_dt as j_propose_dt
from crnn_tpu.ode.linsolve import inv_small_nopivot_minpiv as j_inv
from crnn_tpu.ode.linsolve import pivot_ok as j_pivot_ok
from crnn_tpu.ops import crnn_kernels as jk
from crnn_tpu.transforms.p2vec import p2vec_case2 as j_p2vec
from crnn_tpu_torch.ode import batch_solve as tbs
from crnn_tpu_torch.ode.base import hermite_interp_matrix_from_endpoints as t_herm
from crnn_tpu_torch.ode.controller import propose_dt as t_propose_dt
from crnn_tpu_torch.ode.linsolve import inv_small_nopivot_minpiv as t_inv
from crnn_tpu_torch.ode.linsolve import pivot_ok as t_pivot_ok
from crnn_tpu_torch.ops import crnn_kernels as tk
from crnn_tpu_torch.transforms.p2vec import p2vec_case2 as t_p2vec

NS, NR, LB, UB = 6, 3, 1e-6, 10.0
T1 = 20.0


def _params(seed=0):
    rng = np.random.default_rng(seed)
    p = 0.1 * rng.normal(size=NR * (NS + 2) + 1)
    p[:NR] += 0.8
    p[NR * (NS + 1):NR * (NS + 2)] += 0.8
    p[-1] = 0.1
    return p


def _u0(b=5, seed=1):
    rng = np.random.default_rng(seed)
    u0 = np.zeros((b, NS + 1))
    u0[:, :2] = rng.uniform(size=(b, 2)) * 2.0 + 0.2
    u0[:, NS] = rng.uniform(size=b) * 20.0 + 323.0
    return u0


def test_inverse_and_pivot_check_match_jax():
    rng = np.random.default_rng(0)
    a = np.eye(4)[None] + 0.3 * rng.normal(size=(7, 4, 4))
    a[3, 0, 0] = 1e-12   # a pivot near 0: pivot_ok must say False
    inv, mp = t_inv(torch.from_numpy(a))
    j_inv_b, j_mp = jax.vmap(j_inv)(jnp.asarray(a))
    np.testing.assert_allclose(inv.numpy(), np.asarray(j_inv_b), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(mp.numpy(), np.asarray(j_mp), rtol=1e-15)
    ok = t_pivot_ok(torch.from_numpy(a), mp).numpy()
    np.testing.assert_array_equal(ok, np.asarray(j_pivot_ok(jnp.asarray(a), j_mp)))
    assert not ok[3] and ok[0]


def test_controller_and_dense_output_match_jax():
    rng = np.random.default_rng(2)
    dt = rng.uniform(0.01, 1.0, size=9)
    err = np.array([0.0, 1e-12, 0.3, 0.99, 1.0, 1.5, 40.0, np.inf, 2.0])
    accept = err <= 1.0
    got = t_propose_dt(torch.from_numpy(dt), torch.from_numpy(err),
                       torch.from_numpy(accept), 2)
    want = j_propose_dt(jnp.asarray(dt), jnp.asarray(err), jnp.asarray(accept), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)
    theta = np.linspace(0.0, 1.0, 11)
    np.testing.assert_allclose(t_herm(torch.from_numpy(theta)).numpy(),
                               np.asarray(j_herm(jnp.asarray(theta))),
                               rtol=1e-14, atol=1e-15)


def _jax_solve(p, u0, saveat, jac_mode, unroll, max_steps):
    w = j_p2vec(jnp.asarray(p), NS, NR)
    rhs = lambda t, y, w_: jk.arrhenius_rhs_batched_reference(
        y, w_.w_in, w_.w_b, w_.w_out, LB, UB)
    if jac_mode == "lowrank":
        fjac = lambda t, y, w_: jk.arrhenius_rhs_jac_factors_reference(
            y, w_.w_in, w_.w_b, w_.w_out, LB, UB)
    else:
        fjac = lambda t, y, w_: jk.arrhenius_rhs_jac_batched_reference(
            y, w_.w_in, w_.w_b, w_.w_out, LB, UB)
    return jbs.batch_odesolve_rb23(
        rhs, fjac, jnp.asarray(u0), 0.0, T1, jnp.asarray(saveat), args=w,
        rtol=1e-3, atol=1e-6, max_steps=max_steps, unroll=unroll,
        jac_mode=jac_mode)


def _torch_solve(p, u0, saveat, jac_mode, unroll, max_steps):
    w = t_p2vec(p, NS, NR)
    rhs_op, rhs_jac_op = tk.make_arrhenius_ops(LB, UB)
    factors = tk.make_arrhenius_factor_op(LB, UB)
    if jac_mode == "lowrank":
        fjac = lambda t, y, w_: factors(y, w_.w_in, w_.w_b, w_.w_out)
    else:
        fjac = lambda t, y, w_: rhs_jac_op(y, w_.w_in, w_.w_b, w_.w_out)
    return tbs.batch_odesolve_rb23(
        lambda t, y, w_: rhs_op(y, w_.w_in, w_.w_b, w_.w_out), fjac,
        torch.from_numpy(u0), 0.0, T1, torch.from_numpy(saveat), args=w,
        rtol=1e-3, atol=1e-6, max_steps=max_steps, unroll=unroll,
        jac_mode=jac_mode)


@pytest.mark.parametrize("jac_mode", ["lowrank", "dense"])
@pytest.mark.parametrize("unroll,max_steps", [("scan", 48), ("while", 4096),
                                              ("while", 12)])
def test_batch_solve_matches_jax(jac_mode, unroll, max_steps):
    p, u0 = _params(), _u0()
    saveat = np.linspace(0.0, T1, 15)
    want = _jax_solve(p, u0, saveat, jac_mode, unroll, max_steps)
    got = _torch_solve(torch.from_numpy(p), u0, saveat, jac_mode, unroll,
                       max_steps)
    np.testing.assert_array_equal(got.n_steps.numpy(), np.asarray(want.n_steps))
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    np.testing.assert_allclose(got.ys.numpy(), np.asarray(want.ys), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.final_t.numpy(), np.asarray(want.final_t),
                               rtol=1e-12)
    if max_steps == 4096:
        assert bool(got.success.all())


@pytest.mark.parametrize("jac_mode", ["lowrank", "dense"])
def test_scan_gradient_matches_jax(jac_mode):
    p, u0 = _params(3), _u0(4, seed=5)
    saveat = np.linspace(0.0, T1, 10)

    def j_loss(p_):
        ys = _jax_solve(p_, u0, saveat, jac_mode, "scan", 40).ys
        return jnp.mean(jnp.abs(ys[:, :, :NS]))

    want_loss, want_g = jax.value_and_grad(j_loss)(jnp.asarray(p))
    pt = torch.from_numpy(p).requires_grad_(True)
    loss = torch.mean(torch.abs(
        _torch_solve(pt, u0, saveat, jac_mode, "scan", 40).ys[:, :, :NS]))
    (g,) = torch.autograd.grad(loss, pt)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-9,
                               atol=1e-14)


def test_unsupported_options_raise():
    p, u0 = torch.from_numpy(_params()), _u0()
    saveat = np.linspace(0.0, T1, 5)
    # nonautonomous=True needs f_jac's trailing df/dt: one output short
    # (the dense (du, J) of an autonomous RHS) raises
    w = t_p2vec(p, NS, NR)
    rhs_op, rhs_jac_op = tk.make_arrhenius_ops(LB, UB)
    with pytest.raises(ValueError, match="df/dt"):
        tbs.batch_odesolve_rb23(
            lambda t, y, w_: rhs_op(y, w_.w_in, w_.w_b, w_.w_out),
            lambda t, y, w_: rhs_jac_op(y, w_.w_in, w_.w_b, w_.w_out),
            torch.from_numpy(u0), 0.0, T1, torch.from_numpy(saveat), args=w,
            max_steps=4, nonautonomous=True)
    with pytest.raises(ValueError):
        _torch_solve(p, u0, saveat, "lowrank", "fori", 8)
