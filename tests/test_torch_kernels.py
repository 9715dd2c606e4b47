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


# ---- kernels 4-5: the isothermal RHS and its value+Jacobian ---------------

def _iso_inputs(b=16, ns=5, nr=4, dtype=np.float64, seed=0, edges=False,
                ub=UB):
    """Isothermal inputs y (B, ns). With ``edges`` the first rows hold
    values below, at and above the bounds, 0, and a row whose rates exceed
    exp(32) (every order positive on a large y, a large bias); w_out is then
    of one sign, so that du and J are sums without cancellation and a
    relative tolerance is meaningful at ~1e13. The orders are 0.5|N(0, 1)|,
    the size the case1 and robertson inits give (at most 0.77): an f32
    exponent z carries |z| * eps of rounding into exp(z), so orders of ~2 on
    log(lb) = -11.5 would put a one-ulp difference of summation order at
    2e-6 of the rate."""
    rng = np.random.default_rng(seed)
    y = np.abs(rng.normal(size=(b, ns))) + 0.05
    w_in = 0.5 * np.abs(rng.normal(size=(ns, nr)))
    w_b = rng.normal(size=(nr,))
    w_out = rng.normal(size=(ns, nr))
    if edges:
        y[0, 0], y[1, 1], y[2, 2], y[3, 3] = 1e-9, LB, 50.0, 0.0
        y[4, :] = 1e6
        y[5, 0] = UB
        w_b[0] = 40.0
        w_out = np.abs(w_out)
    return tuple(a.astype(dtype) for a in (y, w_in, w_b, w_out)), ub


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("ub", [UB, np.inf])
def test_plain_crnn_rhs_matches_jax_reference_and_interpret_kernel(dtype, edges,
                                                                   ub):
    arrays, ub = _iso_inputs(dtype=dtype, edges=edges, ub=ub)
    ref = np.asarray(jk.crnn_rhs_batched_reference(
        *map(jnp.asarray, arrays), LB, ub))
    out = tk.crnn_rhs_batched(*_t(*arrays), LB, ub).numpy()
    assert out.dtype == dtype
    tol = TOL[dtype]
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    if dtype == np.float32:  # the Pallas kernel accumulates in f32 only
        pallas = np.asarray(jk.crnn_rhs_batched(
            *map(jnp.asarray, arrays), LB, ub, force="interpret"))
        np.testing.assert_allclose(out, pallas, rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("edges", [False, True])
@pytest.mark.parametrize("ub", [UB, np.inf])
def test_plain_crnn_rhs_jac_matches_jax_reference_and_interpret_kernel(
        dtype, edges, ub):
    arrays, ub = _iso_inputs(dtype=dtype, edges=edges, seed=2, ub=ub)
    ref = jk.crnn_rhs_jac_batched_reference(*map(jnp.asarray, arrays), LB, ub)
    got = tk.crnn_rhs_jac_batched(*_t(*arrays), LB, ub)
    tol = TOL[dtype]
    assert got[1].shape == (16, 5, 5)
    for g, r in zip(got, ref):
        assert g.numpy().dtype == dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=tol, atol=tol)
    if dtype == np.float32:  # the Pallas kernel accumulates in f32 only
        pallas = jk.crnn_rhs_jac_batched(*map(jnp.asarray, arrays), LB, ub,
                                         force="interpret")
        for g, k in zip(got, pallas):
            np.testing.assert_allclose(g.numpy(), np.asarray(k), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("ub", [UB, np.inf])
def test_plain_crnn_pair_propagates_nan_like_jax(ub):
    (y, w_in, w_b, w_out), ub = _iso_inputs(seed=3, ub=ub)
    y[0, 0], y[1, 1], y[2, 2], y[3, 3] = np.nan, np.inf, -np.inf, 0.0
    args_j = [jnp.asarray(a) for a in (y, w_in, w_b, w_out)]
    want = (jk.crnn_rhs_batched_reference(*args_j, LB, ub),
            *jk.crnn_rhs_jac_batched_reference(*args_j, LB, ub))
    args_t = _t(y, w_in, w_b, w_out)
    got = (tk.crnn_rhs_batched(*args_t, LB, ub),
           *tk.crnn_rhs_jac_batched(*args_t, LB, ub))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g.numpy()),
                                      np.isnan(np.asarray(w)))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)


def test_cpu_crnn_wrappers_use_plain_versions_without_launching():
    before = (tk.crnn_rhs_batched.launches, tk.crnn_rhs_jac_batched.launches)
    args = _t(*_iso_inputs()[0])
    assert torch.equal(tk.crnn_rhs_batched(*args, LB, UB),
                       tk.crnn_rhs_batched_reference(*args, LB, UB))
    got = tk.crnn_rhs_jac_batched(*args, LB, UB)
    want = tk.crnn_rhs_jac_batched_reference(*args, LB, UB)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (tk.crnn_rhs_batched.launches,
            tk.crnn_rhs_jac_batched.launches) == before
    meta = [t.to("meta") for t in args]
    for fn in (tk.crnn_rhs_batched, tk.crnn_rhs_jac_batched):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(*meta, LB, UB)


@pytest.mark.parametrize("ub", [UB, np.inf])
def test_crnn_ops_gradients_match_jax_vjp(ub):
    (y, w_in, w_b, w_out), ub = _iso_inputs(b=8, seed=4, ub=ub)
    rng = np.random.default_rng(5)
    g_du = rng.normal(size=y.shape)
    g_jac = rng.normal(size=(y.shape[0], y.shape[1], y.shape[1]))
    args_j = [jnp.asarray(a) for a in (y, w_in, w_b, w_out)]
    _, vjp = jax.vjp(lambda *a: jk.crnn_rhs_batched_reference(*a, LB, ub),
                     *args_j)
    want_rhs = vjp(jnp.asarray(g_du))
    _, vjp = jax.vjp(lambda *a: jk.crnn_rhs_jac_batched_reference(*a, LB, ub),
                     *args_j)
    want_pair = vjp((jnp.asarray(g_du), jnp.asarray(g_jac)))
    want_jac_only = vjp((jnp.zeros_like(jnp.asarray(g_du)),
                         jnp.asarray(g_jac)))

    inputs = [t.requires_grad_(True) for t in _t(y, w_in, w_b, w_out)]
    rhs_op = tk.make_crnn_rhs_op(LB, ub)
    pair_op = tk.make_crnn_rhs_jac_op(LB, ub)
    got_rhs = torch.autograd.grad(rhs_op(*inputs), inputs,
                                  torch.from_numpy(g_du))
    got_pair = torch.autograd.grad(pair_op(*inputs), inputs,
                                   (torch.from_numpy(g_du),
                                    torch.from_numpy(g_jac)))
    # J alone, as the Rosenbrock23 W-matrix uses it: du gets zeros
    got_jac_only = torch.autograd.grad(pair_op(*inputs)[1], inputs,
                                       torch.from_numpy(g_jac))
    for got, want in ((got_rhs, want_rhs), (got_pair, want_pair),
                      (got_jac_only, want_jac_only)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10,
                                       atol=1e-12)
    assert torch.autograd.gradcheck(rhs_op, inputs)


@pytest.mark.parametrize("temperature", [False, True])
@pytest.mark.parametrize("jac", [False, True])
@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("ns,nr", [(5, 4), (3, 6), (6, 3), (32, 32), (1, 32),
                                   (32, 1)])
@pytest.mark.parametrize("batch", [0, 1, 20, 21, 4099, 65536])
def test_tile_geometry_covers_the_batch_within_the_launch_limits(
        batch, ns, nr, itemsize, jac, temperature):
    """The flat lane tile of kernels 4-5 (csrc/crnn_rhs.cu, crnn_rhs_jac.cu)
    and, with ``temperature``, of kernels 1-2 (csrc/arrhenius_rhs.cu,
    arrhenius_rhs_jac.cu), whose rows are ns + 1 wide: the launcher's grid
    of ceil(B / lanes) blocks covers every lane with no empty block, the
    threads are whole warps within the kernels' launch bound of 256 and
    cover the largest phase (width, nr or width^2 items a lane) in a few
    passes, and the shared memory the launcher lays out for these lanes
    stays under 48 KB without an opt-in: the weights (2 ns nr + nr values,
    nr more for the Ea row), then a row of width features, with J a row of
    width column factors, and nr rates a lane."""
    lanes, threads = tk.tile_geometry(batch, ns, nr, itemsize, jac,
                                      temperature=temperature)
    blocks = -(-batch // lanes)
    assert lanes >= 1 and blocks * lanes >= batch
    assert threads % 32 == 0 and 32 <= threads <= 256
    width = ns + 1 if temperature else ns
    per_lane = max(width, nr, width * width if jac else 0)
    items = lanes * per_lane
    # 512 items a block, or one lane of up to 33^2 J items
    assert -(-items // threads) <= max(2, -(-per_lane // 256))
    weights = 2 * ns * nr + (2 if temperature else 1) * nr
    per_lane_values = width * (2 if jac else 1) + nr
    smem = itemsize * (weights + lanes * per_lane_values)
    assert smem <= 48 * 1024
    if batch == 0:
        assert blocks == 0
    if batch == 65536:
        assert blocks >= 4 * 132  # many more blocks than the H100's SMs
    main_path = ((6, 3),) if temperature else ((5, 4), (3, 6))
    if 1 <= batch <= 20 and (ns, nr) in main_path:
        # the main path's B: the blocks its items fill at 512 a block (one;
        # two for case2's 49 J items a lane at B = 20)
        assert blocks == -(-batch * per_lane // 512)
