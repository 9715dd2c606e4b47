"""The CUDA kernels of crnn_tpu_torch on the card, against their plain
PyTorch versions, at the tolerances of chip_smoke.py. Every test carries the ``gpu`` marker and skips where no
card is present. The file imports no JAX, so on the card's machine (no
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


@pytest.mark.parametrize("dtype,rtol,atol", [
    (np.float32, 1e-5, 1e-6), (np.float64, 1e-12, 1e-12)])
@pytest.mark.parametrize("batch", [20, 30, 4099])
def test_arrhenius_kernel_matches_plain_version(cuda_device, dtype, rtol,
                                                atol, batch):
    args = _inputs(batch, dtype, cuda_device)
    before = tk.arrhenius_rhs_batched.launches
    out = tk.arrhenius_rhs_batched(*args, LB, UB)
    torch.cuda.synchronize()
    assert tk.arrhenius_rhs_batched.launches == before + 1
    ref = tk.arrhenius_rhs_batched_reference(*args, LB, UB)
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
@pytest.mark.parametrize("batch", [20, 30, 4099])
def test_arrhenius_jac_kernel_matches_plain_version(cuda_device, dtype, rtol,
                                                    atol, batch):
    args = _inputs(batch, dtype, cuda_device, seed=1)
    before = tk.arrhenius_rhs_jac_batched.launches
    du, jac = tk.arrhenius_rhs_jac_batched(*args, LB, UB)
    torch.cuda.synchronize()
    assert tk.arrhenius_rhs_jac_batched.launches == before + 1
    assert jac.shape == (batch, 7, 7)
    du_ref, jac_ref = tk.arrhenius_rhs_jac_batched_reference(*args, LB, UB)
    _same_nan_and_close(du, du_ref, rtol, atol)
    _same_nan_and_close(jac, jac_ref, rtol, atol)


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


def _solve_case(batch, dtype, device, seed=0):
    """case2-like initial states and reference-init weights, from numpy."""
    rng = np.random.default_rng(seed)
    p = 0.1 * rng.normal(size=3 * 8 + 1)
    p[:3] += 1.3           # fast enough kinetics that steps get rejected
    p[21:24] += 0.8
    p[-1] = 0.1
    u0 = np.zeros((batch, 7))
    u0[:, :2] = rng.uniform(size=(batch, 2)) * 2.0 + 0.2
    u0[:, 6] = rng.uniform(size=batch) * 20.0 + 323.0
    w = p2vec_case2(torch.from_numpy(p.astype(dtype)).to(device), 6, 3)
    return torch.from_numpy(u0.astype(dtype)).to(device), w


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("batch", [30, 4099])
def test_rb23_solve_kernel_matches_plain_version(cuda_device, dtype, batch):
    """The whole-solve kernel against its plain version, each state
    component's error over that component's largest value (T is constant
    at ~330 K and would hide the species in a ratio over all entries): in
    f32 within 5e-4 with equal success flags (the step sequence follows
    rounding); in f64 n_steps and status exact and within 1e-9 (the stiff
    W-solve amplifies ulp differences of exp, log and pow to ~1e-10
    absolute, as one ulp of y0 does to the plain version). The kernel's
    histories start as NaN, which the post-pass must mask."""
    u0, w = _solve_case(batch, dtype, cuda_device)
    saveat = torch.linspace(0.0, 50.0, 50, dtype=u0.dtype, device=cuda_device)
    consts = dict(max_steps=128, t0=0.0, t1=50.0, rtol=1e-3, atol=1e-6,
                  lb=LB, ub=UB)
    before = rk.arrh_rb23_solve.launches
    out = rk.arrh_rb23_solve(u0, w.w_in, w.w_b, w.w_out, hist_fill=np.nan,
                             **consts)
    torch.cuda.synchronize()
    assert rk.arrh_rb23_solve.launches == before + 1
    ref = rk.arrh_rb23_solve_reference(u0, w.w_in, w.w_b, w.w_out, **consts)
    ys = rk._dense_output(saveat, 0.0, u0, *out[:7])
    ys_ref = rk._dense_output(saveat, 0.0, u0, *ref[:7])
    assert bool(torch.isfinite(ys).all())
    assert torch.equal(out[7] == 1, ref[7] == 1)
    per_component = ((ys - ys_ref).abs().amax(dim=(0, 1))
                     / ys_ref.abs().amax(dim=(0, 1)))
    if dtype == np.float32:
        assert float(per_component.max()) < 5e-4, per_component
    else:
        assert torch.equal(out[7], ref[7]) and torch.equal(out[8], ref[8])
        assert float(per_component.max()) < 1e-9, per_component


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
