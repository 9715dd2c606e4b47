"""crnn_tpu_torch/ops/crnn_kernels.py against the JAX package.

On the CPU each wrapper (the RHS and the dense value+Jacobian) computes its
plain version; it is held against JAX's XLA reference and against the
Pallas kernel in interpret mode (as tests/test_pallas_kernels.py runs it):
rtol/atol 1e-12 in f64 (both sides are the same arithmetic up to summation
order) and 2e-6 in f32 (the tolerance the JAX package holds its own kernels
to). The CUDA kernels themselves are tested on the card by
tests/test_torch_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.ops import crnn_kernels as jk
from crnn_tpu_torch.ops import crnn_kernels as tk

LB, UB = 1e-6, 10.0
TOL = {np.float64: 1e-12, np.float32: 2e-6}


def _inputs(b=16, ns=6, nr=3, dtype=np.float64, seed=0, edges=False):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(b, ns))) + 0.05
    if edges:
        x[0, 0], x[1, 1], x[2, 2], x[3, 3] = 1e-9, LB, 50.0, 0.0
    temp = rng.uniform(323.0, 343.0, size=(b, 1))
    y = np.concatenate([x, temp], axis=1).astype(dtype)
    w_in = np.abs(rng.normal(size=(ns + 1, nr))).astype(dtype)
    w_b = rng.normal(size=(nr,)).astype(dtype)
    w_out = rng.normal(size=(ns, nr)).astype(dtype)
    return y, w_in, w_b, w_out


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("edges", [False, True])
def test_plain_rhs_matches_jax_reference_and_interpret_kernel(dtype, edges):
    arrays = _inputs(dtype=dtype, edges=edges)
    ref = np.asarray(jk.arrhenius_rhs_batched_reference(
        *map(jnp.asarray, arrays), LB, UB))
    pallas = np.asarray(jk.arrhenius_rhs_batched(
        *map(jnp.asarray, arrays), LB, UB, force="interpret"))
    out = tk.arrhenius_rhs_batched(*_t(*arrays), LB, UB).numpy()
    tol = TOL[dtype]
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(out, pallas, rtol=tol, atol=tol)


def test_plain_rhs_propagates_nan_like_jax():
    y, w_in, w_b, w_out = _inputs()
    y[0, 0] = np.nan
    y[1, 6] = np.nan
    y[2, 1] = np.inf
    y[3, 2] = -np.inf
    ref = np.asarray(jk.arrhenius_rhs_batched_reference(
        *map(jnp.asarray, (y, w_in, w_b, w_out)), LB, UB))
    out = tk.arrhenius_rhs_batched(*_t(y, w_in, w_b, w_out), LB, UB).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12)


def test_cpu_wrapper_uses_plain_version_without_launching():
    before = tk.arrhenius_rhs_batched.launches
    y, w_in, w_b, w_out = _t(*_inputs())
    out = tk.arrhenius_rhs_batched(y, w_in, w_b, w_out, LB, UB)
    ref = tk.arrhenius_rhs_batched_reference(y, w_in, w_b, w_out, LB, UB)
    assert torch.equal(out, ref)
    assert tk.arrhenius_rhs_batched.launches == before


def test_wrapper_rejects_devices_other_than_cpu_and_cuda():
    y, w_in, w_b, w_out = (t.to("meta") for t in _t(*_inputs()))
    with pytest.raises(ValueError, match="unsupported device"):
        tk.arrhenius_rhs_batched(y, w_in, w_b, w_out, LB, UB)


def test_factors_match_jax():
    arrays = _inputs(b=8)
    want = jk.arrhenius_rhs_jac_factors_reference(*map(jnp.asarray, arrays),
                                                  LB, UB)
    got = tk.arrhenius_rhs_jac_factors_reference(*_t(*arrays), LB, UB)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)
    # J = U @ V is the dense Jacobian of the JAX package
    _, jac = jk.arrhenius_rhs_jac_batched_reference(*map(jnp.asarray, arrays),
                                                    LB, UB)
    dense = torch.einsum("iq,bqj->bij", got[1], got[2])
    np.testing.assert_allclose(dense.numpy(), np.asarray(jac), rtol=1e-12,
                               atol=1e-12)


def test_autograd_function_matches_jax_vjp():
    y, w_in, w_b, w_out = _inputs(b=8, seed=3)
    g = np.random.default_rng(4).normal(size=y.shape)
    _, vjp = jax.vjp(lambda *a: jk.arrhenius_rhs_batched_reference(*a, LB, UB),
                     *map(jnp.asarray, (y, w_in, w_b, w_out)))
    want = vjp(jnp.asarray(g))
    inputs = [t.requires_grad_(True) for t in _t(y, w_in, w_b, w_out)]
    rhs_op, _ = tk.make_arrhenius_ops(LB, UB)
    out = rhs_op(*inputs)
    got = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    assert torch.autograd.gradcheck(rhs_op, inputs)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("edges", [False, True])
def test_plain_rhs_jac_matches_jax_reference_and_interpret_kernel(dtype,
                                                                  edges):
    arrays = _inputs(dtype=dtype, edges=edges, seed=6)
    ref = jk.arrhenius_rhs_jac_batched_reference(*map(jnp.asarray, arrays),
                                                 LB, UB)
    pallas = jk.arrhenius_rhs_jac_batched(*map(jnp.asarray, arrays), LB, UB,
                                          force="interpret")
    got = tk.arrhenius_rhs_jac_batched(*_t(*arrays), LB, UB)
    tol = TOL[dtype]
    for g, r, k in zip(got, ref, pallas):
        assert g.dtype == torch.from_numpy(arrays[0]).dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol, atol=tol)
        np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=tol, atol=tol)


def test_plain_rhs_jac_propagates_nan_like_jax():
    y, w_in, w_b, w_out = _inputs(seed=8)
    y[0, 0], y[1, 6], y[2, 1], y[3, 2] = np.nan, np.nan, np.inf, -np.inf
    y[4, 6] = 0.0
    want = jk.arrhenius_rhs_jac_batched_reference(
        *map(jnp.asarray, (y, w_in, w_b, w_out)), LB, UB)
    got = tk.arrhenius_rhs_jac_batched(*_t(y, w_in, w_b, w_out), LB, UB)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(np.asarray(w)))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_cpu_jac_wrapper_uses_plain_version_without_launching():
    before = tk.arrhenius_rhs_jac_batched.launches
    args = _t(*_inputs())
    got = tk.arrhenius_rhs_jac_batched(*args, LB, UB)
    want = tk.arrhenius_rhs_jac_batched_reference(*args, LB, UB)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tk.arrhenius_rhs_jac_batched.launches == before
    meta = [t.to("meta") for t in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.arrhenius_rhs_jac_batched(*meta, LB, UB)


def test_rhs_jac_op_gradients_match_jax_vjp():
    y, w_in, w_b, w_out = _inputs(b=8, seed=9)
    rng = np.random.default_rng(10)
    g_du = rng.normal(size=y.shape)
    g_jac = rng.normal(size=(y.shape[0], y.shape[1], y.shape[1]))
    _, vjp = jax.vjp(
        lambda *a: jk.arrhenius_rhs_jac_batched_reference(*a, LB, UB),
        *map(jnp.asarray, (y, w_in, w_b, w_out)))
    want = vjp((jnp.asarray(g_du), jnp.asarray(g_jac)))
    inputs = [t.requires_grad_(True) for t in _t(y, w_in, w_b, w_out)]
    _, rhs_jac_op = tk.make_arrhenius_ops(LB, UB)
    du, jac = rhs_jac_op(*inputs)
    got = torch.autograd.grad((du, jac), inputs,
                              (torch.from_numpy(g_du), torch.from_numpy(g_jac)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                   atol=1e-12)
    # a cotangent on J alone (du unused) is materialised as zeros for du
    (g_w,) = torch.autograd.grad(rhs_jac_op(*inputs)[1].sum(), inputs[1])
    (g_ref,) = torch.autograd.grad(
        tk.arrhenius_rhs_jac_batched_reference(*inputs, LB, UB)[1].sum(),
        inputs[1])
    torch.testing.assert_close(g_w, g_ref, rtol=1e-12, atol=1e-12)
