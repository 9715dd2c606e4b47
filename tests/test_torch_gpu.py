"""The CUDA kernels of crnn_tpu_torch on the card, against their plain
PyTorch versions. Every test carries the ``gpu`` marker and skips where no
card is present. The file imports no JAX, so on the card's machine (no
JAX there) it runs without the repository's conftest:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from crnn_tpu_torch.ops import crnn_kernels as tk

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
    rhs_op = tk.make_arrhenius_ops(LB, UB)
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
