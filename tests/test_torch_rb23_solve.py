"""crnn_tpu_torch/ops/rb23_solve_kernel.py against the JAX package.

On the CPU the whole-solve wrapper runs its plain version. It is held
against the Pallas kernel in interpret mode (as tests/test_pallas_kernels.py
runs it): in f64 the two are the same arithmetic up to summation order, so
n_steps and status agree exactly and ys at rtol 1e-9; in f32 the step
sequence follows rounding, so ys agree within 5e-4 of each state
component's largest value with equal success flags (the JAX package's bar
for its kernel against its while driver, taken per component). The CUDA
kernel itself is tested on the card by tests/test_torch_gpu.py and
chip_smoke.py; its launch geometry (``solve_geometry``) is tested here.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.ops import rb23_solve_kernel as jrk
from crnn_tpu.transforms.p2vec import p2vec_case2 as j_p2vec
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ops import crnn_kernels as tk
from crnn_tpu_torch.ops import rb23_solve_kernel as trk
from crnn_tpu_torch.transforms.p2vec import p2vec_case2 as t_p2vec

NS, NR, LB, UB = 6, 3, 1e-6, 10.0
RTOL, ATOL = 1e-3, 1e-6
T1, N_SAVE, MAX_STEPS = 30.0, 12, 64


def _case(b=5, seed=0, dtype=np.float64, rate_shift=0.0):
    """case2-like params (the reference init) and initial states.
    ``rate_shift`` raises the log rate constants: 0.5 makes the controller
    reject steps, 1.0 makes some lanes run out of MAX_STEPS."""
    rng = np.random.default_rng(seed)
    p = 0.1 * rng.normal(size=NR * (NS + 2) + 1)
    p[:NR] += 0.8 + rate_shift
    p[NR * (NS + 1):NR * (NS + 2)] += 0.8
    p[-1] = 0.1
    u0 = np.zeros((b, NS + 1))
    u0[:, :2] = rng.uniform(size=(b, 2)) * 2.0 + 0.2
    u0[:, NS] = rng.uniform(size=b) * 20.0 + 323.0
    saveat = np.linspace(0.0, T1, N_SAVE)
    return p.astype(dtype), u0.astype(dtype), saveat.astype(dtype)


def _rel(a, ref):
    """Largest error of each state component over that component's largest
    value: the T column is constant and large, so a ratio over the largest
    entry of all would hide errors of the species."""
    return float((np.abs(a - ref).max(axis=(0, 1))
                  / np.abs(ref).max(axis=(0, 1))).max())


# f32 stays clear of rate_shift 1.0, where a lane finishes on its last
# allowed step and its success flag would follow rounding
@pytest.mark.parametrize("dtype,rate_shift", [
    (np.float64, 0.0), (np.float64, 0.5), (np.float64, 1.0),
    (np.float32, 0.0), (np.float32, 0.5)])
def test_plain_solve_matches_jax_interpret_kernel(dtype, rate_shift):
    p, u0, saveat = _case(dtype=dtype, rate_shift=rate_shift)
    jw = j_p2vec(jnp.asarray(p), NS, NR)
    consts = dict(max_steps=MAX_STEPS, t0=0.0, t1=T1, rtol=RTOL, atol=ATOL,
                  lb=LB, ub=UB)
    j_out = jrk._arrh_rb23_solve_pallas(jnp.asarray(u0), jw.w_in, jw.w_b,
                                        jw.w_out, ns=NS, nr=NR,
                                        interpret=True, **consts)
    j_ys, j_ok = jrk.make_arrhenius_fused_solve(
        NS, NR, LB, UB, 0.0, T1, jnp.asarray(saveat), RTOL, ATOL, MAX_STEPS,
        interpret=True)(jnp.asarray(u0), jw)
    tw = t_p2vec(torch.from_numpy(p), NS, NR)
    t_out = trk.arrh_rb23_solve(torch.from_numpy(u0), tw.w_in, tw.w_b,
                                tw.w_out, **consts)
    t_ys, t_ok = trk.make_arrhenius_fused_solve(
        NS, NR, LB, UB, 0.0, T1, torch.from_numpy(saveat), RTOL, ATOL,
        MAX_STEPS)(torch.from_numpy(u0), tw)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))
    assert bool(t_ok.any())
    if dtype == np.float64:
        status, n_steps = j_out[7][:, 0], j_out[8][:, 0]
        np.testing.assert_array_equal(t_out[7].numpy(), np.asarray(status))
        np.testing.assert_array_equal(t_out[8].numpy(), np.asarray(n_steps))
        np.testing.assert_allclose(t_out[9].numpy(), np.asarray(j_out[9]),
                                   rtol=1e-9)
        np.testing.assert_allclose(t_ys.numpy(), np.asarray(j_ys), rtol=1e-9,
                                   atol=1e-12)
    else:
        assert _rel(t_ys.numpy(), np.asarray(j_ys)) < 5e-4


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fused_solve_matches_the_while_driver(dtype):
    p, u0, saveat = _case(b=6, seed=2, dtype=dtype, rate_shift=0.5)
    tw = t_p2vec(torch.from_numpy(p), NS, NR)
    u0_t, saveat_t = torch.from_numpy(u0), torch.from_numpy(saveat)
    rhs_op, _ = tk.make_arrhenius_ops(LB, UB)
    factor_op = tk.make_arrhenius_factor_op(LB, UB)
    sol = batch_odesolve_rb23(
        lambda t, y, w_: rhs_op(y, w_.w_in, w_.w_b, w_.w_out),
        lambda t, y, w_: factor_op(y, w_.w_in, w_.w_b, w_.w_out),
        u0_t, 0.0, T1, saveat_t, args=tw, rtol=RTOL, atol=ATOL,
        max_steps=MAX_STEPS, unroll="while", jac_mode="lowrank")
    ys, ok = trk.make_arrhenius_fused_solve(
        NS, NR, LB, UB, 0.0, T1, saveat_t, RTOL, ATOL, MAX_STEPS)(u0_t, tw)
    assert torch.equal(ok, sol.success) and bool(ok.all())
    assert _rel(ys.numpy(), sol.ys.numpy()) < 5e-4


def test_unvisited_history_rows_never_reach_the_dense_output():
    """Rows after a lane's exit hold whatever the buffer held; only acc is
    zeroed. NaN and huge garbage there must give the same finite ys."""
    p, u0, saveat = _case(b=4, seed=5)
    tw = t_p2vec(torch.from_numpy(p), NS, NR)
    consts = dict(max_steps=MAX_STEPS, t0=0.0, t1=T1, rtol=RTOL, atol=ATOL,
                  lb=LB, ub=UB)
    ys = []
    for fill in (math.nan, 1e30, -math.inf):
        out = trk.arrh_rb23_solve(torch.from_numpy(u0), tw.w_in, tw.w_b,
                                  tw.w_out, hist_fill=fill, **consts)
        assert int(out[8].max()) < MAX_STEPS   # some rows stay unvisited
        ys.append(trk._dense_output(torch.from_numpy(saveat), 0.0,
                                    torch.from_numpy(u0), *out[:7]))
    assert bool(torch.isfinite(ys[0]).all())
    assert torch.equal(ys[0], ys[1]) and torch.equal(ys[0], ys[2])


def test_dense_output_matches_jax():
    p, u0, saveat = _case(b=3, seed=7, rate_shift=0.5)
    tw = t_p2vec(torch.from_numpy(p), NS, NR)
    out = trk.arrh_rb23_solve(torch.from_numpy(u0), tw.w_in, tw.w_b, tw.w_out,
                              max_steps=MAX_STEPS, t0=0.0, t1=T1, rtol=RTOL,
                              atol=ATOL, lb=LB, ub=UB, hist_fill=0.0)
    got = trk._dense_output(torch.from_numpy(saveat), 0.0,
                            torch.from_numpy(u0), *out[:7])
    want = jrk._dense_output(jnp.asarray(saveat), 0.0, jnp.asarray(u0),
                             *(jnp.asarray(h.numpy()) for h in out[:7]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


def test_inv_rows_inverts_near_identity_matrices():
    rng = np.random.default_rng(1)
    nr = 3
    m = np.eye(nr)[None] + 0.2 * rng.normal(size=(8, nr, nr))
    rows = [torch.from_numpy(m[:, r, q].copy()) for r in range(nr)
            for q in range(nr)]
    inv = trk._inv_rows(rows, nr)
    got = torch.stack([torch.stack(row, dim=1) for row in inv], dim=1)
    np.testing.assert_allclose(got.numpy(), np.linalg.inv(m), rtol=1e-10,
                               atol=1e-12)


def test_wrapper_rejects_devices_other_than_cpu_and_cuda():
    p, u0, _ = _case(b=2)
    tw = t_p2vec(torch.from_numpy(p), NS, NR)
    args = [t.to("meta") for t in (torch.from_numpy(u0), tw.w_in, tw.w_b,
                                   tw.w_out)]
    with pytest.raises(ValueError, match="unsupported device"):
        trk.arrh_rb23_solve(*args, max_steps=8, t0=0.0, t1=T1, rtol=RTOL,
                            atol=ATOL, lb=LB, ub=UB)


@pytest.mark.parametrize("ns,nr", [(ns, nr) for ns in range(1, trk._MAX_NS + 1)
                                   for nr in range(1, trk._MAX_NR + 1)])
def test_solve_geometry_covers_every_batch_and_shape_with_whole_warps(ns, nr):
    """Every B and (ns, nr) within the caps gets a group of 8 or 16 threads
    (a power of two that covers the ns + 1 state components), blocks of
    whole warps within 128 threads, and blocks that cover the batch with no
    block left empty; f32 and f64 launch alike."""
    for batch in (1, 2, 3, 4, 5, 7, 8, 29, 30, 31, 33, 64, 527, 528, 529,
                  2112, 4099, 65536):
        geo = trk.solve_geometry(batch, ns, nr, 4)
        assert trk.solve_geometry(batch, ns, nr, 8) == geo
        group, lanes, threads, blocks = geo
        assert group in (8, 16) and group >= ns + 1
        assert group & (group - 1) == 0 and (group == 8) == (ns + 1 <= 8)
        assert lanes >= 1 and threads == group * lanes
        assert threads % 32 == 0 and threads <= 128
        assert blocks * lanes >= batch > (blocks - 1) * lanes


def test_solve_geometry_spreads_a_small_batch_one_warp_a_block():
    """case2's 30 lanes: 8 threads a lane, 4 lanes a warp, one warp a block
    on 8 SMs; B=4099 fills 4 warps a block; the caps' ns = 8 take 16."""
    assert trk.solve_geometry(30, 6, 3, 4) == (8, 4, 32, 8)
    assert trk.solve_geometry(4099, 6, 3, 4) == (8, 16, 128, 257)
    assert trk.solve_geometry(3, 8, 4, 8) == (16, 2, 32, 2)
    with pytest.raises(ValueError, match="itemsize"):
        trk.solve_geometry(30, 6, 3, 2)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cpu_tensor_runs_the_plain_version_without_a_launch(dtype):
    p, u0, _ = _case(b=3, seed=4, dtype=dtype, rate_shift=0.5)
    tw = t_p2vec(torch.from_numpy(p), NS, NR)
    consts = dict(max_steps=MAX_STEPS, t0=0.0, t1=T1, rtol=RTOL, atol=ATOL,
                  lb=LB, ub=UB)
    before = trk.arrh_rb23_solve.launches
    got = trk.arrh_rb23_solve(torch.from_numpy(u0), tw.w_in, tw.w_b, tw.w_out,
                              **consts)
    want = trk.arrh_rb23_solve_reference(torch.from_numpy(u0), tw.w_in,
                                         tw.w_b, tw.w_out, **consts)
    assert trk.arrh_rb23_solve.launches == before
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
