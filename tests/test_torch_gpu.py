"""The CUDA kernels of crnn_tpu_torch on the card, against their plain
PyTorch versions, at the tolerances of chip_smoke.py; epochs of the cases
on the kernel path; and the ODE suite on the card (the ESDIRK and
AutoSwitch solvers against the CPU, per-lane case2 under them, robertson's
adjoint path, w_out_mask and LM finish); kernel 4 at the hybrid cases' shapes
and their epochs on the kernel path; HyChem and cathode on the card
against the CPU; a cathode UQ iteration on the card against the CPU,
``run_case(dp=1)`` on nccl against the batch epoch, and the compensated-f32
batch Rosenbrock23 (``two_sum`` on the card, the solve on kernels 4-5
against its plain path). Every test carries the ``gpu`` marker
and skips where no card is present. The file imports no JAX, so on the card's machine (no
JAX there) it runs without the repository's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from crnn_tpu_torch.ops import crnn_kernels as tk
from crnn_tpu_torch.ops import rb23_solve_kernel as rk
from crnn_tpu_torch.transforms.p2vec import p2vec_case2

LB, UB = 1e-6, 10.0

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(b, dtype, device, ns=6, nr=3, seed=0):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.normal(size=(b, ns))) + 0.05
    x[0, 0], x[1, 1], x[2, 2], x[3, 3] = 1e-9, LB, 50.0, 0.0
    x[4, 0], x[5, 1], x[6, 2] = np.nan, np.inf, -np.inf
    temp = rng.uniform(323.0, 343.0, size=(b, 1))
    temp[7, 0] = np.nan
    arrays = (np.concatenate([x, temp], axis=1), np.abs(rng.normal(size=(ns + 1, nr))),
              rng.normal(size=(nr,)), rng.normal(size=(ns, nr)))
    return [torch.from_numpy(a.astype(dtype)).to(device) for a in arrays]


def _arrh_tile_inputs(b, dtype, device, ns, nr, seed=0):
    """Inputs of kernels 1-2 for per-component gates at any B and at the
    caps: ``_iso_inputs``' species, orders, bias and stoichiometry (their
    edge rows, conditioning and one-signed w_out) with a T column in [323,
    343] K (NaN in row 8 and 0 in row 9 where the batch has them) and an Ea
    row 0.5 |N(0, 1)|: with a T feature of ~-1.5 it moves an exponent by
    at most ~-3, so the exponents stay below ~16."""
    y, w_in, w_b, w_out = _iso_inputs(b, dtype, "cpu", ns, nr, seed)
    rng = np.random.default_rng(seed + 1)
    temp = rng.uniform(323.0, 343.0, size=(b, 1))
    for row, val in ((8, np.nan), (9, 0.0)):
        if row < b:
            temp[row, 0] = val
    w_ea = 0.5 * np.abs(rng.normal(size=(1, nr)))
    y = torch.cat([y, torch.from_numpy(temp.astype(dtype))], dim=1)
    w_in = torch.cat([w_in, torch.from_numpy(w_ea.astype(dtype))])
    return [t.to(device).contiguous() for t in (y, w_in, w_b, w_out)]


# (batch, ns, nr, tile): the main path's B on _inputs at elementwise gates,
# then ragged last tiles (1 lane, one past a tile) at case2's shape and the
# caps on _arrh_tile_inputs at per-component gates of 2e-6 (f32), 1e-12
# (f64)
_ARRH_CASES = ([(b, 6, 3, False) for b in (20, 30, 4099)]
               + [(b, ns, nr, True) for b in (1, 21, 33)
                  for ns, nr in ((6, 3), (32, 32), (1, 32), (32, 1))])
_TILE_TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _arrh_case_inputs(batch, ns, nr, tile, dtype, device, seed):
    if tile:
        return _arrh_tile_inputs(batch, dtype, device, ns, nr, seed)
    return _inputs(batch, dtype, device, ns, nr, seed)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (np.float32, 1e-5, 1e-6), (np.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize("batch,ns,nr,tile", _ARRH_CASES)
def test_arrhenius_kernel_matches_plain_version(cuda_device, dtype, rtol,
                                                atol, batch, ns, nr, tile):
    args = _arrh_case_inputs(batch, ns, nr, tile, dtype, cuda_device, 0)
    before = tk.arrhenius_rhs_batched.launches
    out = tk.arrhenius_rhs_batched(*args, LB, UB)
    torch.cuda.synchronize()
    assert tk.arrhenius_rhs_batched.launches == before + 1
    ref = tk.arrhenius_rhs_batched_reference(*args, LB, UB)
    if tile:
        _same_nonfinite_and_close_per_component(out, ref, _TILE_TOL[dtype])
        return
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol)


def test_arrhenius_op_gradients_on_card(cuda_device):
    """The autograd op's kernel forward and plain backward on the card
    equal autograd of the plain version (f64)."""
    args = [t.nan_to_num(nan=1.0, posinf=2.0, neginf=0.5).requires_grad_(True)
            for t in _inputs(30, np.float64, cuda_device)]
    rhs_op, _ = tk.make_arrhenius_ops(LB, UB)
    g = torch.randn(args[0].shape, dtype=torch.float64, device=cuda_device)
    got = torch.autograd.grad(rhs_op(*args), args, g)
    want = torch.autograd.grad(
        tk.arrhenius_rhs_batched_reference(*args, LB, UB), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_arrhenius_wrapper_checks_its_inputs(cuda_device):
    y, w_in, w_b, w_out = _inputs(30, np.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        tk.arrhenius_rhs_batched(y.t().contiguous().t(), w_in, w_b, w_out,
                                 LB, UB)
    with pytest.raises(ValueError, match="shapes"):
        tk.arrhenius_rhs_batched(y[:, :-1].contiguous(), w_in, w_b, w_out,
                                 LB, UB)
    with pytest.raises(TypeError):
        tk.arrhenius_rhs_batched(y.half(), w_in.half(), w_b.half(),
                                 w_out.half(), LB, UB)
    with pytest.raises(ValueError, match="ns="):
        big = torch.ones((2, 40), device=cuda_device)
        tk.arrhenius_rhs_batched(big, torch.ones((40, 3), device=cuda_device),
                                 w_b, torch.ones((39, 3), device=cuda_device),
                                 LB, UB)


def _same_nan_and_close(out, ref, rtol, atol):
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype,rtol,atol", [
    (np.float32, 1e-5, 1e-6), (np.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize("batch,ns,nr,tile", _ARRH_CASES)
def test_arrhenius_jac_kernel_matches_plain_version(cuda_device, dtype, rtol,
                                                    atol, batch, ns, nr, tile):
    args = _arrh_case_inputs(batch, ns, nr, tile, dtype, cuda_device, 1)
    before = tk.arrhenius_rhs_jac_batched.launches
    du, jac = tk.arrhenius_rhs_jac_batched(*args, LB, UB)
    torch.cuda.synchronize()
    assert tk.arrhenius_rhs_jac_batched.launches == before + 1
    assert jac.shape == (batch, ns + 1, ns + 1)
    du_ref, jac_ref = tk.arrhenius_rhs_jac_batched_reference(*args, LB, UB)
    for out, ref in ((du, du_ref), (jac, jac_ref)):
        if tile:
            _same_nonfinite_and_close_per_component(out, ref,
                                                    _TILE_TOL[dtype])
        else:
            _same_nan_and_close(out, ref, rtol, atol)


@pytest.mark.parametrize("jac", [False, True])
def test_arrhenius_kernels_refuse_a_geometry_outside_the_launch_limits(
        cuda_device, jac):
    """The Arrhenius launchers refuse, through their return code, no lanes,
    threads that are not whole warps within 256, and lanes whose shared
    layout exceeds 48 KB; an empty batch launches nothing and is not
    counted."""
    y, w_in, w_b, w_out = _inputs(4099, np.float32, cuda_device)
    name = "arrhenius_rhs_jac" if jac else "arrhenius_rhs"
    outs = (torch.empty_like(y),) + (
        (torch.empty((4099, 7, 7), device=cuda_device),) if jac else ())
    weights = tk._arrhenius_weights(w_in, w_b, w_out)
    lanes, threads = tk.tile_geometry(4099, 6, 3, 4, jac, temperature=True)
    for bad in ((0, threads), (lanes, 16), (lanes, 48), (lanes, 288),
                (4099, threads)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            tk._launch(name, y, weights, outs, LB, UB, 32.0, bad)
    fn = tk.arrhenius_rhs_jac_batched if jac else tk.arrhenius_rhs_batched
    before = fn.launches
    out = fn(y[:0], w_in, w_b, w_out, LB, UB)
    assert fn.launches == before
    assert (out[1] if jac else out).shape[0] == 0


def test_arrhenius_jac_op_gradients_on_card(cuda_device):
    """Kernel forward and plain backward of the (du, J) op on the card equal
    autograd of the plain version (f64)."""
    args = [t.nan_to_num(nan=1.0, posinf=2.0, neginf=0.5).requires_grad_(True)
            for t in _inputs(30, np.float64, cuda_device)]
    _, rhs_jac_op = tk.make_arrhenius_ops(LB, UB)
    g = [torch.randn(t.shape, dtype=torch.float64, device=cuda_device)
         for t in rhs_jac_op(*args)]
    got = torch.autograd.grad(rhs_jac_op(*args), args, g)
    want = torch.autograd.grad(
        tk.arrhenius_rhs_jac_batched_reference(*args, LB, UB), args, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _solve_case(batch, dtype, device, seed=0, ns=6, nr=3):
    """case2-like initial states (two species in [0.2, 2.2], T in [323,
    343] K) and reference-init weights, from numpy. At case2's shape the
    log rate constants are raised by 1.3 so that steps get rejected; at the
    other shapes the reference init's +0.8 with half its spread (0.05)
    conditions the solve: one ulp of y0 moves the plain f64 solve by at
    most ~2e-13 of a component's largest value at B=30 and 4099 (one-ulp
    witness on the CPU), far inside the 1e-9 gate."""
    rng = np.random.default_rng(seed)
    shift, spread = (1.3, 0.1) if (ns, nr) == (6, 3) else (0.8, 0.05)
    p = spread * rng.normal(size=nr * (ns + 2) + 1)
    p[:nr] += shift
    p[nr * (ns + 1):nr * (ns + 2)] += 0.8
    p[-1] = 0.1
    u0 = np.zeros((batch, ns + 1))
    k = min(2, ns)
    u0[:, :k] = rng.uniform(size=(batch, k)) * 2.0 + 0.2
    u0[:, ns] = rng.uniform(size=batch) * 20.0 + 323.0
    w = p2vec_case2(torch.from_numpy(p.astype(dtype)).to(device), ns, nr)
    return torch.from_numpy(u0.astype(dtype)).to(device), w


_SOLVE_CONSTS = dict(max_steps=128, t0=0.0, t1=50.0, rtol=1e-3, atol=1e-6,
                     lb=LB, ub=UB)


def _check_solve_kernel(u0, w):
    """The whole-solve kernel against its plain version, each state
    component's error over that component's largest value (T is constant
    at ~330 K and would hide the species in a ratio over all entries): in
    f32 within 5e-4 with equal success flags (the step sequence follows
    rounding); in f64 n_steps and status exact and within 1e-9 (the stiff
    W-solve amplifies ulp differences of exp, log and pow to ~1e-10
    absolute, as one ulp of y0 does to the plain version). The kernel's
    histories start as NaN, which the post-pass must mask."""
    saveat = torch.linspace(0.0, 50.0, 50, dtype=u0.dtype, device=u0.device)
    before = rk.arrh_rb23_solve.launches
    out = rk.arrh_rb23_solve(u0, w.w_in, w.w_b, w.w_out, hist_fill=np.nan,
                             **_SOLVE_CONSTS)
    torch.cuda.synchronize()
    assert rk.arrh_rb23_solve.launches == before + 1
    ref = rk.arrh_rb23_solve_reference(u0, w.w_in, w.w_b, w.w_out,
                                       **_SOLVE_CONSTS)
    ys = rk._dense_output(saveat, 0.0, u0, *out[:7])
    ys_ref = rk._dense_output(saveat, 0.0, u0, *ref[:7])
    assert bool(torch.isfinite(ys).all())
    assert torch.equal(out[7] == 1, ref[7] == 1)
    per_component = ((ys - ys_ref).abs().amax(dim=(0, 1))
                     / ys_ref.abs().amax(dim=(0, 1)))
    if u0.dtype == torch.float32:
        assert float(per_component.max()) < 5e-4, per_component
    else:
        assert torch.equal(out[7], ref[7]) and torch.equal(out[8], ref[8])
        assert float(per_component.max()) < 1e-9, per_component


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch", [30, 4099])
def test_rb23_solve_kernel_matches_plain_version(cuda_device, dtype, batch):
    _check_solve_kernel(*_solve_case(batch, dtype, cuda_device))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ns,nr", [(6, 3), (1, 1), (3, 2), (7, 4), (8, 4)])
@pytest.mark.parametrize("batch", [1, 31, 33])
def test_rb23_solve_kernel_ragged_groups_and_shapes(cuda_device, dtype, batch,
                                                    ns, nr):
    """Ragged warps and blocks (B = 1, 31, 33 beside 30 and 4099 above) on
    the compiled (6, 3) path and the runtime path ((1, 1), (3, 2), (7, 4),
    and the caps (8, 4) with 16 threads a lane)."""
    _check_solve_kernel(*_solve_case(batch, dtype, cuda_device, ns=ns, nr=nr))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ns,nr", [(1, 1), (3, 2), (7, 4), (8, 4)])
@pytest.mark.parametrize("batch", [30, 4099])
def test_rb23_solve_kernel_runtime_path(cuda_device, dtype, batch, ns, nr):
    _check_solve_kernel(*_solve_case(batch, dtype, cuda_device, ns=ns, nr=nr))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("ns,nr", [(ns, nr) for ns in range(1, 9)
                                   for nr in range(1, 5)])
def test_rb23_solve_kernel_every_shape_within_the_caps(cuda_device, dtype, ns,
                                                       nr):
    _check_solve_kernel(*_solve_case(3, dtype, cuda_device, ns=ns, nr=nr))


def test_rb23_solve_kernel_refuses_a_bad_geometry(cuda_device):
    """The launcher refuses, through its return code, no lanes, threads
    that are not whole warps or above 128, and a group that is not 8 or 16
    or does not cover ns + 1; an empty batch launches nothing."""
    u0, w = _solve_case(33, np.float32, cuda_device)
    k = 8
    outs = ([torch.empty((k, 33), device=cuda_device) for _ in range(3)]
            + [torch.empty((k, 7, 33), device=cuda_device) for _ in range(4)]
            + [torch.empty(33, dtype=torch.int32, device=cuda_device)
               for _ in range(2)] + [torch.empty_like(u0)])
    consts = (0.0, 50.0, 1e-3, 1e-6, LB, UB, 32.0, 0.9, 0.2, 10.0, 5e-11)
    weights = (w.w_in, w.w_b, w.w_out)
    for bad in ((8, 0), (8, 3), (8, 20), (16, 16), (16, 1), (6, 16), (4, 8),
                (32, 1), (12, 8)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            rk._launch(u0, weights, outs, k, consts, bad)
    before = rk.arrh_rb23_solve.launches
    out = rk.arrh_rb23_solve(u0[:0], *weights, **_SOLVE_CONSTS)
    assert rk.arrh_rb23_solve.launches == before and out[7].shape == (0,)


def test_rb23_solve_wrapper_checks_its_inputs(cuda_device):
    u0, w = _solve_case(4, np.float32, cuda_device)
    consts = dict(max_steps=8, t0=0.0, t1=50.0, rtol=1e-3, atol=1e-6,
                  lb=LB, ub=UB)
    with pytest.raises(ValueError, match="contiguous"):
        rk.arrh_rb23_solve(u0.t().contiguous().t(), w.w_in, w.w_b, w.w_out,
                           **consts)
    with pytest.raises(ValueError, match="ns="):
        rk.arrh_rb23_solve(torch.ones((2, 10), device=cuda_device),
                           torch.ones((10, 3), device=cuda_device), w.w_b,
                           torch.ones((9, 3), device=cuda_device), **consts)


# ---- kernels 4-5: the isothermal RHS and its value+Jacobian ---------------

def _iso_inputs(b, dtype, device, ns=5, nr=4, seed=0):
    """Isothermal inputs with the edge rows: below, at and above the
    bounds, 0, NaN, +-inf, and y = 1e30, whose rates (with ub = inf) are
    far above exp(32) and capped. Elsewhere |z| stays below ~16: an f32
    exponent z carries ulp(z) of rounding into exp(z) (1.9e-6 relative at
    |z| ~ 30), which a 2e-6 gate would judge instead of the kernel. w_out
    is of one sign, so that du and J are sums without cancellation (at the
    capped row, terms of ~1e14 of both signs would leave their f32 rounding
    in a difference 100x smaller). The orders shrink as 5/ns above ns = 5,
    so that their sum, and with it z at a row clipped to ub = 10, stays that
    of ns = 5: at ns = 32 the clipped row would put z at ~30, where the
    one-ulp difference between two orders of a 32-term f32 sum moves
    exp(z) by ~2e-6. A batch of fewer than 8 lanes holds the edge rows it
    has room for; an edge's species index wraps at ns."""
    rng = np.random.default_rng(seed)
    y = np.abs(rng.normal(size=(b, ns))) + 0.05
    for row, col, val in ((0, 0, 1e-9), (1, 1, LB), (2, 2, 50.0), (3, 3, 0.0),
                          (4, 0, np.nan), (5, 1, np.inf), (6, 2, -np.inf)):
        if row < b:
            y[row, col % ns] = val
    if b > 7:
        y[7, :] = 1e30
    arrays = (y, 0.5 * min(1.0, 5.0 / ns) * np.abs(rng.normal(size=(ns, nr))),
              rng.normal(size=(nr,)) + 3.0, np.abs(rng.normal(size=(ns, nr))))
    return [torch.from_numpy(a.astype(dtype)).to(device) for a in arrays]


def _same_nonfinite_and_close_per_component(out, ref, tol):
    """NaN and inf positions exact; finite values within ``tol`` of each
    output component's largest finite |value| over the lanes (an entry of J
    is a sum of terms of both signs, so an elementwise f32 rtol would judge
    its cancellation, not the kernel)."""
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    assert torch.equal(torch.isfinite(out), fin)
    assert torch.equal(out[~fin & ~torch.isnan(ref)],
                       ref[~fin & ~torch.isnan(ref)])
    zero = torch.zeros_like(ref)
    scale = torch.where(fin, ref.abs(), zero).amax(dim=0)
    diff = torch.where(fin, (out - ref).abs(), zero)
    assert bool((diff <= tol * scale).all()), float((diff - tol * scale).max())


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("batch", [1, 20, 21, 30, 33, 4099])
@pytest.mark.parametrize("ub", [UB, np.inf])
@pytest.mark.parametrize("ns,nr", [(5, 4), (3, 6), (32, 32), (1, 32), (32, 1)])
def test_crnn_kernels_match_plain_versions(cuda_device, dtype, tol, batch, ub,
                                           ns, nr):
    """Kernels 4-5 at the main path's B, at ragged B (a last tile of 1 lane,
    of one lane past a full tile) and at the caps ns, nr <= 32."""
    args = _iso_inputs(batch, dtype, cuda_device, ns, nr)
    before = (tk.crnn_rhs_batched.launches, tk.crnn_rhs_jac_batched.launches)
    du = tk.crnn_rhs_batched(*args, LB, ub)
    du2, jac = tk.crnn_rhs_jac_batched(*args, LB, ub)
    torch.cuda.synchronize()
    assert (tk.crnn_rhs_batched.launches,
            tk.crnn_rhs_jac_batched.launches) == (before[0] + 1, before[1] + 1)
    assert jac.shape == (batch, ns, ns)
    du_ref, jac_ref = tk.crnn_rhs_jac_batched_reference(*args, LB, ub)
    for out, ref in ((du, tk.crnn_rhs_batched_reference(*args, LB, ub)),
                     (du2, du_ref), (jac, jac_ref)):
        _same_nonfinite_and_close_per_component(out, ref, tol)


def test_crnn_ops_gradients_on_card(cuda_device):
    """Kernel forward and plain backward of both isothermal ops on the card
    equal autograd of the plain versions (f64, ub = inf)."""
    args = [t.nan_to_num(nan=1.0, posinf=2.0, neginf=0.5).requires_grad_(True)
            for t in _iso_inputs(30, np.float64, cuda_device)]
    rhs_op = tk.make_crnn_rhs_op(LB, np.inf)
    pair_op = tk.make_crnn_rhs_jac_op(LB, np.inf)
    for op, ref in ((rhs_op, tk.crnn_rhs_batched_reference),
                    (pair_op, tk.crnn_rhs_jac_batched_reference)):
        out = op(*args)
        outs = out if isinstance(out, tuple) else (out,)
        g = [torch.randn(t.shape, dtype=torch.float64, device=cuda_device)
             for t in outs]
        got = torch.autograd.grad(outs, args, g)
        want_out = ref(*args, LB, np.inf)
        want = torch.autograd.grad(want_out if isinstance(want_out, tuple)
                                   else (want_out,), args, g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_crnn_wrappers_check_their_inputs(cuda_device):
    y, w_in, w_b, w_out = _iso_inputs(30, np.float32, cuda_device)
    for fn in (tk.crnn_rhs_batched, tk.crnn_rhs_jac_batched):
        with pytest.raises(ValueError, match="contiguous"):
            fn(y.t().contiguous().t(), w_in, w_b, w_out, LB, UB)
        with pytest.raises(ValueError, match="shapes"):
            fn(torch.cat([y, y[:, :1]], dim=1), w_in, w_b, w_out, LB, UB)
        with pytest.raises(TypeError):
            fn(y.half(), w_in.half(), w_b.half(), w_out.half(), LB, UB)


@pytest.mark.parametrize("jac", [False, True])
def test_crnn_kernels_refuse_a_geometry_outside_the_launch_limits(
        cuda_device, jac):
    """The C launcher refuses, through its return code, no lanes, threads
    that are not whole warps within 256, and lanes whose shared layout
    exceeds 48 KB; an empty batch launches nothing and is not counted."""
    y, w_in, w_b, w_out = _iso_inputs(4099, np.float32, cuda_device)
    name = "crnn_rhs_jac" if jac else "crnn_rhs"
    outs = (torch.empty_like(y),) + (
        (torch.empty((4099, 5, 5), device=cuda_device),) if jac else ())
    lanes, threads = tk.tile_geometry(4099, 5, 4, 4, jac)
    for bad in ((0, threads), (lanes, 16), (lanes, 48), (lanes, 288),
                (4099, threads)):
        with pytest.raises(RuntimeError, match="cudaError 1"):
            tk._launch(name, y, (w_in, w_b, w_out), outs, LB, UB, 32.0, bad)
    fn = tk.crnn_rhs_jac_batched if jac else tk.crnn_rhs_batched
    before = fn.launches
    out = fn(y[:0], w_in, w_b, w_out, LB, UB)
    assert fn.launches == before
    assert (out[1] if jac else out).shape[0] == 0


@pytest.mark.parametrize("name", ["case1", "robertson"])
def test_per_lane_case_epoch_on_kernel_path(cuda_device, name):
    """One epoch of case1 (f32, Tsit5) and of robertson (f64,
    Rosenbrock23) at a reduced size on the card: the kernel path launches
    its kernels, and agrees with the plain path on the same params, perm
    and masks: case1's f32 eval losses at the initial params at rtol 1e-4
    (the f32 gradient follows rounding, so an epoch's update is not
    compared in f32); robertson's f64 epoch (gradient, eval losses) at rtol
    1e-9."""
    from crnn_tpu_torch.cases import case1, robertson

    if name == "case1":
        mod, kw = case1, dict(n_exp_train=6, n_exp_test=2, datasize=30)
        cfg = case1.Case1Config
    else:
        mod, kw = robertson, dict(n_exp_train=6, n_exp_val=2, datasize=20,
                                  batchsize=16)
        cfg = robertson.RobertsonConfig
    setup = mod.build(cfg(**kw))
    plain = mod.build(cfg(rhs_plain=True, **kw), dataset=setup.dataset)
    trainer = setup.trainer
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(trainer.n_exp_train, generator=gen)
    masks = trainer.sample_masks(gen, perm.shape[0], setup.init_params.dtype)
    tk.crnn_rhs_batched.launches = tk.crnn_rhs_jac_batched.launches = 0
    state, m = trainer.epoch(trainer.init(setup.init_params), perm, masks)
    torch.cuda.synchronize()
    assert tk.crnn_rhs_batched.launches > 0
    assert (tk.crnn_rhs_jac_batched.launches > 0) == (name == "robertson")
    before = (tk.crnn_rhs_batched.launches, tk.crnn_rhs_jac_batched.launches)
    _, mp = plain.trainer.epoch(plain.trainer.init(plain.init_params), perm,
                                masks)
    assert (tk.crnn_rhs_batched.launches,
            tk.crnn_rhs_jac_batched.launches) == before
    assert bool(torch.isfinite(m.loss_exp).all()) and state.epoch == 1
    if name == "case1":
        idx = torch.arange(trainer.n_exp, device=cuda_device)
        ones = torch.ones((trainer.n_exp, trainer.n_save), device=cuda_device)
        with torch.no_grad():
            got = trainer.loss_batch_eval(setup.init_params, idx, ones)
            want = plain.trainer.loss_batch_eval(plain.init_params, idx, ones)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=0)
    else:
        torch.testing.assert_close(m.loss_exp, mp.loss_exp, rtol=1e-9, atol=0)
        _, g = trainer.value_and_grad(setup.init_params, perm.cuda(), masks)
        _, gp = plain.trainer.value_and_grad(plain.init_params, perm.cuda(),
                                             masks)
        torch.testing.assert_close(g, gp, rtol=1e-9,
                                   atol=1e-9 * float(gp.abs().max()))


def test_case2_per_lane_epoch_on_kernel_path(cuda_device):
    """case2 with ``batch_major=False`` in f64 at a reduced size: the
    reverse-mode epoch launches kernel 1 (every f) and kernel 2 (every J),
    and agrees with the plain path on the same params and perm at rtol
    1e-9 (gradient, eval losses, params)."""
    from crnn_tpu_torch.cases import case2

    kw = dict(n_exp_train=6, n_exp_test=2, datasize=20, batch_major=False,
              dtype="float64")
    setup = case2.build(case2.Case2Config(**kw))
    plain = case2.build(case2.Case2Config(rhs_plain=True, **kw),
                        dataset=setup.dataset)
    perm = torch.randperm(6, generator=torch.Generator().manual_seed(0))
    tk.arrhenius_rhs_batched.launches = 0
    tk.arrhenius_rhs_jac_batched.launches = 0
    state, m = setup.trainer.epoch(setup.trainer.init(setup.init_params), perm)
    torch.cuda.synchronize()
    launches = (tk.arrhenius_rhs_batched.launches,
                tk.arrhenius_rhs_jac_batched.launches)
    assert min(launches) > 0
    sp, mp = plain.trainer.epoch(plain.trainer.init(plain.init_params), perm)
    assert (tk.arrhenius_rhs_batched.launches,
            tk.arrhenius_rhs_jac_batched.launches) == launches
    torch.testing.assert_close(m.loss_exp, mp.loss_exp, rtol=1e-9, atol=0)
    torch.testing.assert_close(m.grad_norm, mp.grad_norm, rtol=1e-9, atol=0)
    torch.testing.assert_close(state.params, sp.params, rtol=1e-9,
                               atol=1e-9 * float(sp.params.abs().max()))


def test_case2_restart_on_card_equals_an_uninterrupted_run(cuda_device,
                                                           tmp_path):
    """case2 (batch-major, f32, reduced size) for 2 epochs and then 2 more
    with restart in one 2-epoch chunk gives the losses of 4 epochs run at
    once bit for bit, and the same final checkpoint (the generator's state
    among it), with metrics.jsonl counting epochs 1-4."""
    import json

    from crnn_tpu_torch.cases import base, case2

    setup = case2.build(case2.Case2Config(n_exp_train=6, n_exp_test=2,
                                          datasize=20))
    _, h4 = base.run_case(setup, 4, out_dir=str(tmp_path / "a"), log_every=0)
    base.run_case(setup, 2, out_dir=str(tmp_path / "b"), log_every=0)
    state, h2 = base.run_case(setup, 2, out_dir=str(tmp_path / "b"),
                              log_every=0, restart=True,
                              epochs_per_dispatch=2)
    rows = [json.loads(line) for line in
            (tmp_path / "b" / "case2" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2, 3, 4] and state.epoch == 4
    for name in ("loss_train", "loss_val", "grad_norm"):
        assert h2[name] == h4[name][2:]
    ckpts = [torch.load(tmp_path / k / "case2" / "checkpoint.pt",
                        weights_only=True) for k in ("a", "b")]
    for k, v in ckpts[0].items():
        assert (torch.equal(v, ckpts[1][k]) if isinstance(v, torch.Tensor)
                else v == ckpts[1][k]), k
    assert (tmp_path / "b" / "case2" / "p_opt.npy").exists()


@pytest.mark.parametrize("batch_major", [True, False])
def test_case2_sequential_forward_mode_evaluates_on_the_kernels(
        cuda_device, batch_major):
    """A sequential case2 epoch (forward mode, f32, reduced size): jacfwd
    differentiates the plain ops, the evaluation pass runs kernel 1 (and
    kernel 2 with the per-lane evaluation); the epoch is finite."""
    from crnn_tpu_torch.cases import case2

    setup = case2.build(case2.Case2Config(
        n_exp_train=4, n_exp_test=2, datasize=20, mode="sequential",
        batch_major=batch_major))
    assert setup.trainer.grad_mode == "fwd"
    tk.arrhenius_rhs_batched.launches = 0
    tk.arrhenius_rhs_jac_batched.launches = 0
    state, m = setup.trainer.epoch(setup.trainer.init(setup.init_params))
    torch.cuda.synchronize()
    assert tk.arrhenius_rhs_batched.launches > 0
    if not batch_major:
        assert tk.arrhenius_rhs_jac_batched.launches > 0
    assert state.opt_state.count == 4
    assert bool(torch.isfinite(m.loss_exp).all())
    assert bool(torch.isfinite(m.grad_norm))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("ub", [100.0, np.inf])
@pytest.mark.parametrize("ns,nr", [(9, 8), (9, 15)])
def test_crnn_rhs_kernel_at_case3_and_grn_shapes(cuda_device, dtype, tol, ub,
                                                 ns, nr):
    """Kernel 4 at the 100 lanes of case3 (ns=9, nr=8) and of the GRN
    (nr=15), ub = 100 as they run it and inf, against its plain version."""
    args = _iso_inputs(100, dtype, cuda_device, ns, nr)
    before = tk.crnn_rhs_batched.launches
    du = tk.crnn_rhs_batched(*args, LB, ub)
    torch.cuda.synchronize()
    assert tk.crnn_rhs_batched.launches == before + 1
    _same_nonfinite_and_close_per_component(
        du, tk.crnn_rhs_batched_reference(*args, LB, ub), tol)


@pytest.mark.parametrize("variant", ["case3", "grn"])
def test_case3_and_grn_epoch_on_kernel_path(cuda_device, variant):
    """One f64 epoch of case3 (log-space MAE, NAdam, updates over every
    experiment) and of the GRN (frozen rows, stochastic horizons) at a
    reduced size on the card: the kernel path launches kernel 4, and agrees
    with the plain path on the same params, perm and masks at rtol 1e-9
    (gradient, eval losses, params)."""
    import dataclasses

    from crnn_tpu_torch.cases import case3

    kw = dict(n_exp_train=6, n_exp_test=2, datasize=20, dtype="float64")
    base_cfg = (case3.grn_config() if variant == "grn"
                else case3.Case3Config())
    if variant == "grn":
        kw["horizon"] = (2, 20)
    setup = case3.build(dataclasses.replace(base_cfg, **kw))
    plain = case3.build(dataclasses.replace(base_cfg, rhs_plain=True, **kw),
                        dataset=setup.dataset)
    trainer = setup.trainer
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(trainer.n_exp_update or trainer.n_exp_train,
                          generator=gen)
    masks = trainer.sample_masks(gen, perm.shape[0], torch.float64)
    tk.crnn_rhs_batched.launches = 0
    state, m = trainer.epoch(trainer.init(setup.init_params), perm, masks)
    torch.cuda.synchronize()
    launches = tk.crnn_rhs_batched.launches
    assert launches > 0
    sp, mp = plain.trainer.epoch(plain.trainer.init(plain.init_params), perm,
                                 masks)
    assert tk.crnn_rhs_batched.launches == launches
    assert bool(torch.isfinite(m.loss_exp).all())
    torch.testing.assert_close(m.loss_exp, mp.loss_exp, rtol=1e-9, atol=0)
    torch.testing.assert_close(m.grad_norm, mp.grad_norm, rtol=1e-9, atol=0)
    torch.testing.assert_close(state.params, sp.params, rtol=1e-9,
                               atol=1e-9 * float(sp.params.abs().max()))


def test_t_dependent_rosenbrock23_on_card_equals_cpu(cuda_device):
    """The per-lane Rosenbrock23 takes df/dt of an RHS that is not declared
    autonomous (a temperature ramp in Arrhenius rates) by forward mode in t
    on the card as on the CPU: n_steps exact, ys within 1e-9 of each
    component's largest value (f64)."""
    from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
    from crnn_tpu_torch.ode.solve import odesolve

    def ramp_rhs(t, y, k):
        temp = 300.0 + 40.0 * t
        r1 = torch.exp(k[:, 0] - k[:, 1] / temp) * y[:, 0]
        r2 = torch.exp(k[:, 2] - k[:, 3] / temp) * y[:, 1]
        return torch.stack([-r1, r1 - r2, r2], dim=1)

    rng = np.random.default_rng(0)
    u0 = np.zeros((4, 3))
    u0[:, 0] = rng.uniform(0.5, 1.5, size=4)
    k = np.stack([10.0 + rng.uniform(-0.5, 0.5, size=4), np.full(4, 3000.0),
                  12.0 + rng.uniform(-0.5, 0.5, size=4), np.full(4, 3000.0)],
                 axis=1)
    saveat = np.linspace(0.0, 5.0, 12)
    sols = [odesolve(ramp_rhs, Rosenbrock23(),
                     torch.from_numpy(u0).to(dev), 0.0, 5.0,
                     torch.from_numpy(saveat).to(dev),
                     args=torch.from_numpy(k).to(dev), rtol=1e-3, atol=1e-6,
                     max_steps=4096, unroll="while")
            for dev in (cuda_device, "cpu")]
    assert torch.equal(sols[0].n_steps.cpu(), sols[1].n_steps)
    assert bool(sols[1].success.all())
    got, want = sols[0].ys.cpu(), sols[1].ys
    scale = want.abs().amax(dim=(0, 1))
    assert float(((got - want).abs() / scale).max()) <= 1e-9


def _robertson_lanes(t, y, k):
    r1 = k[:, 0] * y[:, 0]
    r2 = k[:, 1] * y[:, 1] * y[:, 1]
    r3 = k[:, 2] * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=1)


@pytest.mark.parametrize("name", ["trbdf2", "kvaerno3", "auto_tsit5_trbdf2",
                                  "auto_tsit5_rosenbrock23"])
def test_implicit_solvers_on_card_equal_cpu(cuda_device, name):
    """TRBDF2, Kvaerno3 and both AutoSwitch pairs on Robertson lanes of
    different stiffness in one batch (f64): the card's solve takes the
    CPU's steps (n_steps exact), ys within 1e-9 of each component's
    largest value."""
    from crnn_tpu_torch.ode import get_solver
    from crnn_tpu_torch.ode.base import autonomous
    from crnn_tpu_torch.ode.solve import odesolve

    k = torch.tensor([[4e-2, 3e7, 1e4], [4e-6, 3e-3, 1e-3]],
                     dtype=torch.float64)
    y0 = torch.tensor([[1.0, 0.0, 0.0]] * 2, dtype=torch.float64)
    saveat = 10.0 ** torch.linspace(-1.0, 3.0, 9, dtype=torch.float64)
    sols = [odesolve(autonomous(_robertson_lanes), get_solver(name),
                     y0.to(dev), 0.0, 1e3, saveat.to(dev), args=k.to(dev),
                     rtol=1e-6, atol=1e-10, max_steps=4096, unroll="while")
            for dev in (cuda_device, "cpu")]
    assert torch.equal(sols[0].n_steps.cpu(), sols[1].n_steps)
    assert bool(sols[1].success.all())
    got, want = sols[0].ys.cpu(), sols[1].ys
    scale = want.abs().amax(dim=(0, 1))
    assert float(((got - want).abs() / scale).max()) <= 1e-9


@pytest.mark.parametrize("solver", ["auto_tsit5_rosenbrock23", "trbdf2"])
def test_case2_per_lane_solvers_on_kernel_path(cuda_device, solver):
    """Per-lane case2 in f64 at a reduced size under AutoSwitch (kernel 1
    in every stage of both branches, kernel 2 once a step) and TRBDF2
    (kernel 1 in every Newton iteration, J by forward mode of the plain
    twin, so kernel 2 never): the epoch agrees with the plain path at rtol
    1e-9."""
    from crnn_tpu_torch.cases import case2

    kw = dict(n_exp_train=6, n_exp_test=2, datasize=20, batch_major=False,
              dtype="float64", solver=solver, max_steps=48)
    setup = case2.build(case2.Case2Config(**kw))
    plain = case2.build(case2.Case2Config(rhs_plain=True, **kw),
                        dataset=setup.dataset)
    perm = torch.randperm(6, generator=torch.Generator().manual_seed(0))
    tk.arrhenius_rhs_batched.launches = 0
    tk.arrhenius_rhs_jac_batched.launches = 0
    state, m = setup.trainer.epoch(setup.trainer.init(setup.init_params), perm)
    torch.cuda.synchronize()
    assert tk.arrhenius_rhs_batched.launches > 0
    assert (tk.arrhenius_rhs_jac_batched.launches > 0) == (solver != "trbdf2")
    sp, mp = plain.trainer.epoch(plain.trainer.init(plain.init_params), perm)
    torch.testing.assert_close(m.loss_exp, mp.loss_exp, rtol=1e-9, atol=0)
    torch.testing.assert_close(state.params, sp.params, rtol=1e-9,
                               atol=1e-9 * float(sp.params.abs().max()))


def test_robertson_adjoint_mask_and_lm_on_card(cuda_device):
    """robertson (f64, reduced size): the adjoint epoch on the kernel path
    launches kernels 4 and 5 in its forward solves and agrees with the
    plain path at rtol 1e-9; a w_out_mask keeps its pruned entries at
    exactly 0; 2 LM iterations give the CPU's cost history within 1e-9."""
    from crnn_tpu_torch.cases import robertson

    kw = dict(n_exp_train=4, n_exp_val=2, datasize=16, batchsize=12)
    setup = robertson.build(robertson.RobertsonConfig(grad_path="adjoint",
                                                      **kw))
    ds = setup.dataset
    plain = robertson.build(robertson.RobertsonConfig(
        grad_path="adjoint", rhs_plain=True, **kw), dataset=ds)
    perm = torch.arange(4, device=cuda_device)
    tk.crnn_rhs_batched.launches = tk.crnn_rhs_jac_batched.launches = 0
    loss, g = setup.trainer.value_and_grad(setup.init_params, perm)
    torch.cuda.synchronize()
    assert min(tk.crnn_rhs_batched.launches,
               tk.crnn_rhs_jac_batched.launches) > 0
    loss_p, g_p = plain.trainer.value_and_grad(plain.init_params, perm)
    torch.testing.assert_close(loss, loss_p, rtol=1e-9, atol=0)
    torch.testing.assert_close(g, g_p, rtol=1e-9,
                               atol=1e-9 * float(g_p.abs().max()))

    mask = tuple(tuple(0.0 if (i + j) % 4 == 0 else 1.0 for j in range(6))
                 for i in range(3))
    masked = robertson.build(robertson.RobertsonConfig(w_out_mask=mask, **kw),
                             dataset=ds)
    state, _ = masked.trainer.epoch(masked.trainer.init(masked.init_params))
    keep = torch.tensor(mask, dtype=torch.float64, device=cuda_device)
    assert bool((masked.weights_fn(state.params).w_out[keep == 0] == 0).all())

    ds_cpu = ds._replace(**{f: getattr(ds, f).cpu() for f in ds._fields})
    on_cpu = robertson.build(robertson.RobertsonConfig(device="cpu", **kw),
                             dataset=ds_cpu)
    _, card = robertson.run_lm_finish(setup, setup.init_params, max_iters=2)
    _, cpu = robertson.run_lm_finish(on_cpu, on_cpu.init_params, max_iters=2)
    assert card["history"].shape == cpu["history"].shape
    np.testing.assert_allclose(card["history"], cpu["history"], rtol=1e-9)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6), (np.float64, 1e-12)])
@pytest.mark.parametrize("batch", [20, 30])
@pytest.mark.parametrize("ns,nr,ub", [(12, 12, 100.0), (3, 3, 10.0),
                                      (12, 12, np.inf), (3, 3, np.inf)])
def test_crnn_rhs_kernel_at_the_hybrid_shapes(cuda_device, dtype, tol, batch,
                                              ns, nr, ub):
    """Kernel 4 at the CRNN cores of the hybrid RHSs: yeast's u_full
    (B, 12) with nr=12 (ub 100) and the QSSA's (B, 3) with nr=3 (ub 10), at
    the B of their training (20) and evaluation (30) solves, against its
    plain version."""
    args = _iso_inputs(batch, dtype, cuda_device, ns, nr)
    before = tk.crnn_rhs_batched.launches
    du = tk.crnn_rhs_batched(*args, LB, ub)
    torch.cuda.synchronize()
    assert tk.crnn_rhs_batched.launches == before + 1
    _same_nonfinite_and_close_per_component(
        du, tk.crnn_rhs_batched_reference(*args, LB, ub), tol)


@pytest.mark.parametrize("name", ["yeast", "robertson_qssa"])
def test_hybrid_epoch_on_kernel_path(cuda_device, name):
    """One f64 epoch of yeast (TRBDF2) and of the QSSA (Rosenbrock23) at a
    reduced size on the card: every f runs the MLP in plain torch and the
    CRNN core on kernel 4 (J by forward mode of the plain twin), and the
    epoch agrees with the plain path on the same params, perm and masks at
    rtol 1e-9 (eval losses, grad norm, params)."""
    from crnn_tpu_torch.cases import robertson_qssa, yeast

    if name == "yeast":
        mod, cfg_cls = yeast, yeast.YeastConfig
        kw = dict(n_exp_train=4, n_exp_val=2, ntotal=24, max_steps=96,
                  dtype="float64")
    else:
        mod, cfg_cls = robertson_qssa, robertson_qssa.QSSAConfig
        kw = dict(n_exp_train=4, n_exp_val=2, datasize=16)
    setup = mod.build(cfg_cls(**kw))
    plain = mod.build(cfg_cls(rhs_plain=True, **kw), dataset=setup.dataset)
    trainer = setup.trainer
    gen = torch.Generator().manual_seed(0)
    perm = torch.randperm(4, generator=gen)
    masks = trainer.sample_masks(gen, 4, torch.float64)
    tk.crnn_rhs_batched.launches = 0
    state, m = trainer.epoch(trainer.init(setup.init_params), perm, masks)
    torch.cuda.synchronize()
    launches = tk.crnn_rhs_batched.launches
    assert launches > 0
    sp, mp = plain.trainer.epoch(plain.trainer.init(plain.init_params), perm,
                                 masks)
    assert tk.crnn_rhs_batched.launches == launches
    assert bool(torch.isfinite(m.loss_exp).all())
    torch.testing.assert_close(m.loss_exp, mp.loss_exp, rtol=1e-9, atol=0)
    torch.testing.assert_close(m.grad_norm, mp.grad_norm, rtol=1e-9, atol=0)
    torch.testing.assert_close(state.params, sp.params, rtol=1e-9,
                               atol=1e-9 * float(sp.params.abs().max()))


def test_hychem_and_cathode_on_card_equal_cpu(cuda_device):
    """One epoch of HyChem (nr=2, 16 save points) and of cathode (two short
    curves) on the card and on the CPU from the same params and draws:
    losses and grad norms at rtol 1e-9. Neither path has a kernel."""
    from crnn_tpu_torch.cases import cathode, hychem
    from crnn_tpu_torch.data.loaders import synthetic_dsc

    dsc = synthetic_dsc(heating_rates=(20.0, 15.0), t0_celsius=150.0,
                        t1_celsius=250.0, dT=10.0)
    for build in (lambda dev: hychem.build(hychem.HyChemConfig(
                      nr=2, ntotal=16, device=dev)),
                  lambda dev: cathode.build(cathode.CathodeConfig(
                      val_index=1, device=dev), dsc=dsc)):
        ms = []
        for dev in ("cuda", "cpu"):
            s = build(dev)
            _, m = s.trainer.epoch(s.trainer.init(s.init_params, seed=0))
            ms.append(m)
        for k in ("loss_train", "loss_val", "grad_norm"):
            np.testing.assert_allclose(getattr(ms[0], k).item(),
                                       getattr(ms[1], k).item(), rtol=1e-9)


def test_uq_batch_major_iteration_on_card_equals_cpu(cuda_device):
    """One batch-major SVGD iteration of the cathode UQ case (16 particles,
    f64, 128 steps) on the card against the CPU at rtol 1e-9 per
    component; the same seeded particles and replicate curves on both."""
    from crnn_tpu_torch.cases.cathode_uq import CathodeUQConfig, run_uq

    out = {}
    for device in ("cuda", "cpu"):
        cfg = CathodeUQConfig(num_particles=16, maxiters=128, n_iters=1,
                              device=device)
        p, info = run_uq(cfg, verbose=False)
        out[device] = (p.cpu().numpy(), info["loss_train"], info["loss_val"])
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    assert np.isfinite(out["cuda"][1]).all()


def test_dp1_case2_epoch_on_nccl_equals_batch_epoch(cuda_device, tmp_path):
    """``run_case(dp=1)`` on a world of one (nccl) against the batch
    Trainer's epoch: per-lane case2, f64, 4 + 2 experiments, at 1e-9, with
    kernel 1 launched in the dp epoch."""
    from crnn_tpu_torch.cases import case2
    from crnn_tpu_torch.cases.base import run_case

    cfg = case2.Case2Config(n_exp_train=4, n_exp_test=2, batch_major=False,
                            dtype="float64")
    ref = case2.build(cfg)
    state_b, m = ref.trainer.epoch(ref.trainer.init(ref.init_params))
    tk.arrhenius_rhs_batched.launches = 0
    state, hist = run_case(case2.build(cfg, dataset=ref.dataset), 1,
                           out_dir=str(tmp_path), dp=1, log_every=0)
    assert tk.arrhenius_rhs_batched.launches > 0
    np.testing.assert_allclose(hist["loss_train"], [m.loss_train.item()],
                               rtol=1e-9)
    np.testing.assert_allclose(hist["loss_val"], [m.loss_val.item()],
                               rtol=1e-9)
    np.testing.assert_allclose(state.params.cpu().numpy(),
                               state_b.params.cpu().numpy(), rtol=1e-9)


def test_two_sum_on_card_is_error_free(cuda_device):
    """2^20 f32 pairs across 60 binades: s + e equals a + b in f64 (both
    round the same real number; exact where the binades are close)."""
    from crnn_tpu_torch.ode.compensated import two_sum

    rng = np.random.default_rng(0)
    n = 1 << 20
    a, b = (torch.from_numpy((rng.standard_normal(n)
                              * 2.0 ** rng.integers(-30, 30, n))
                             .astype(np.float32)).to(cuda_device)
            for _ in range(2))
    s, e = two_sum(a, b)
    torch.testing.assert_close(s.double() + e.double(),
                               a.double() + b.double(), rtol=0, atol=0)
    assert bool((e != 0).any())


def _comp_solve(device, plain, p, u0, saveat, dtype):
    from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs
    from crnn_tpu_torch.ode.compensated import batch_odesolve_rb23_comp
    from crnn_tpu_torch.transforms.p2vec import p2vec_robertson

    ds = torch.ones(3, dtype=dtype, device=device)
    f = make_crnn_scaled_rhs(1e-8, float("inf"), ds, plain=plain)
    op = tk.make_crnn_rhs_jac_op(1e-8, float("inf"), plain=plain)

    def f_jac(t, y, w):
        du, jac = op(y, w.w_in, w.w_b, w.w_out)
        return du * ds, jac * ds[:, None]

    def ys(q):
        return batch_odesolve_rb23_comp(
            f, f_jac, u0.to(device, dtype), 0.0, 100.0,
            saveat.to(device, dtype),
            args=p2vec_robertson(q.to(device, dtype), 3, 6), rtol=1e-3,
            atol=1e-6, max_steps=128).ys.cpu().numpy()
    return ys


def test_compensated_f32_solve_on_kernels_4_5(cuda_device):
    """The f32 compensated solve at robertson's shape (20 lanes, ns=3, nr=6,
    12 save points) with f on kernel 4 and f0, J on kernel 5, against its
    plain path on the card: per state component within 1e-4 of its largest
    value or 3x the plain path's move under one ulp of the params."""
    from crnn_tpu_torch.transforms.p2vec import init_params_robertson

    gen = torch.Generator().manual_seed(0)
    p = init_params_robertson(gen, 3, 6, dtype=torch.float32, device="cpu")
    u0 = torch.rand((20, 3), generator=gen, dtype=torch.float64) + 0.3
    saveat = 10.0 ** torch.linspace(0.0, 2.0, 12, dtype=torch.float64)
    tk.crnn_rhs_batched.launches = tk.crnn_rhs_jac_batched.launches = 0
    ys_k = _comp_solve(cuda_device, False, p, u0, saveat, torch.float32)(p)
    assert tk.crnn_rhs_batched.launches > 0
    assert tk.crnn_rhs_jac_batched.launches > 0
    plain = _comp_solve(cuda_device, True, p, u0, saveat, torch.float32)
    ys_p = plain(p)
    ulp = np.abs(plain(torch.from_numpy(np.nextafter(
        p.numpy(), np.float32(np.inf)))) - ys_p).max(axis=(0, 1))
    tol = np.maximum(1e-4 * np.abs(ys_p).max(axis=(0, 1)), 3.0 * ulp)
    assert np.isfinite(ys_k).all()
    assert np.all(np.abs(ys_k - ys_p).max(axis=(0, 1)) <= tol)
