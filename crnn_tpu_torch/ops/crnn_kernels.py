"""Batched Arrhenius CRNN right-hand side: CUDA kernel and plain version
(port of crnn_tpu/ops/crnn_kernels.py, Arrhenius part).

``arrhenius_rhs_batched`` launches the hand-written Hopper kernel
(``csrc/arrhenius_rhs.cu``, replacing the Pallas ``_arrh_rhs_kernel``) for
a CUDA tensor and computes the plain version for a CPU tensor. There is no
batch-size threshold: the JAX package's ``min_pallas_batch=4096`` was a TPU
measurement. On a CUDA tensor the kernel is launched or the call raises.

The low-rank factors (``arrhenius_rhs_jac_factors_reference``) stay plain
torch, as they are XLA in the JAX package. The dense value+Jacobian kernel
(``_arrh_rhs_jac_kernel``) is not ported yet.
"""

from __future__ import annotations

import ctypes

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ops import _build

_EXP_CAP = 32.0
_INV_R_KCAL = -1.0 / 1.98720425864083e-3
_MAX_NS = 32
_MAX_NR = 32
_SYMBOLS = {torch.float32: "arrh_rhs_f32", torch.float64: "arrh_rhs_f64"}


def _min_cap(z, exp_cap):
    return torch.minimum(z, z.new_full((), exp_cap))


def arrhenius_rhs_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                    exp_cap=_EXP_CAP):
    """du for a batch: y (B, ns+1) -> (B, ns+1); w_in (ns+1, nr); dT = 0."""
    ns = w_out.shape[0]
    x, temp = y[:, :ns], y[:, ns]
    logx = torch.log(clip(x, lb, ub))
    z = logx @ w_in[:ns] + (_INV_R_KCAL / temp)[:, None] * w_in[ns][None, :]
    rates = torch.exp(_min_cap(z + w_b[None, :], exp_cap))
    du = rates @ w_out.T
    return torch.cat([du, torch.zeros_like(du[:, :1])], dim=1)


def _kernel_fn(dtype):
    lib = _build.load("arrhenius_rhs")
    fn = getattr(lib, _SYMBOLS[dtype])
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_double,
                       ctypes.c_double, ctypes.c_double, ptr]
        fn.restype = ctypes.c_int
    return fn


def arrhenius_rhs_batched(y, w_in, w_b, w_out, lb, ub, exp_cap=_EXP_CAP):
    """Batched Arrhenius RHS: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``arrhenius_rhs_batched.launches`` counts the
    kernel launches."""
    if y.device.type == "cpu":
        return arrhenius_rhs_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                               exp_cap)
    if y.device.type != "cuda":
        raise ValueError(f"arrhenius_rhs_batched: unsupported device {y.device}")
    if y.dtype not in _SYMBOLS:
        raise TypeError(f"arrhenius_rhs_batched: dtype {y.dtype} is not "
                        "float32 or float64")
    ns, nr = w_out.shape
    if not (1 <= ns <= _MAX_NS and 1 <= nr <= _MAX_NR):
        raise ValueError(f"arrhenius_rhs_batched: ns={ns}, nr={nr}; the kernel "
                         f"takes 1 <= ns <= {_MAX_NS}, 1 <= nr <= {_MAX_NR}")
    if (y.dim() != 2 or y.shape[1] != ns + 1
            or tuple(w_in.shape) != (ns + 1, nr) or tuple(w_b.shape) != (nr,)):
        raise ValueError(
            f"arrhenius_rhs_batched: shapes y {tuple(y.shape)}, w_in "
            f"{tuple(w_in.shape)}, w_b {tuple(w_b.shape)}, w_out ({ns}, {nr})")
    for t in (w_in, w_b, w_out):
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError("arrhenius_rhs_batched: weights must share y's "
                             "device and dtype")
    if not y.is_contiguous():
        raise ValueError("arrhenius_rhs_batched: y must be contiguous")
    w_in_x = w_in[:ns].contiguous()
    w_ea = w_in[ns].contiguous()
    w_b = w_b.contiguous()
    w_out = w_out.contiguous()
    du = torch.empty_like(y)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = _kernel_fn(y.dtype)(
            y.data_ptr(), w_in_x.data_ptr(), w_ea.data_ptr(), w_b.data_ptr(),
            w_out.data_ptr(), du.data_ptr(), y.shape[0], ns, nr, float(lb),
            float(ub), float(exp_cap), stream)
    if rc != 0:
        raise RuntimeError(f"arrhenius_rhs kernel launch failed: cudaError {rc}")
    arrhenius_rhs_batched.launches += 1
    return du


arrhenius_rhs_batched.launches = 0


def arrhenius_rhs_jac_factors_reference(y, w_in, w_b, w_out, lb, ub,
                                        exp_cap=_EXP_CAP):
    """(du, U, V) with J = U @ V exactly (rank nr): U = [w_out; 0]
    (ns+1, nr) shared by all lanes, V (B, nr, ns+1) =
    diag(rates[b]) @ [w_in_x^T diag(dlog[b]) | w_in_ea * dt_feat[b]].
    Feeds the Woodbury W-solve (ode/batch_solve.py, jac_mode='lowrank')."""
    ns, nr = w_out.shape
    x, temp = y[:, :ns], y[:, ns]
    xc = clip(x, lb, ub)
    logx = torch.log(xc)
    z = logx @ w_in[:ns] + (_INV_R_KCAL / temp)[:, None] * w_in[ns][None, :]
    rates = torch.exp(_min_cap(z + w_b[None, :], exp_cap))
    du = rates @ w_out.T
    du = torch.cat([du, torch.zeros_like(du[:, :1])], dim=1)
    u_fac = torch.cat([w_out, torch.zeros_like(w_out[:1])], dim=0)
    in_range = ((x > lb) & (x < ub)).to(y.dtype)
    dlog = in_range / xc                                          # (B, ns)
    dt_feat = (-_INV_R_KCAL) / (temp * temp)                      # (B,)
    v_x = w_in[:ns].T[None, :, :] * dlog[:, None, :]              # (B, nr, ns)
    v_t = w_in[ns][None, :, None] * dt_feat[:, None, None]        # (B, nr, 1)
    v_fac = rates[:, :, None] * torch.cat([v_x, v_t], dim=2)
    return du, u_fac, v_fac


def make_arrhenius_factor_op(lb: float, ub: float, exp_cap: float = _EXP_CAP):
    """Differentiable (du, U, V) factor op (plain torch)."""

    def op(y, w_in, w_b, w_out):
        return arrhenius_rhs_jac_factors_reference(y, w_in, w_b, w_out,
                                                   lb, ub, exp_cap)

    return op


class _ArrheniusRHS(torch.autograd.Function):
    """Kernel forward; backward by autograd of the plain version, as the
    ``custom_vjp`` at crnn_tpu/ops/crnn_kernels.py:377-386 does."""

    @staticmethod
    def forward(ctx, y, w_in, w_b, w_out, lb, ub, exp_cap, plain):
        ctx.save_for_backward(y, w_in, w_b, w_out)
        ctx.consts = (lb, ub, exp_cap)
        fn = arrhenius_rhs_batched_reference if plain else arrhenius_rhs_batched
        return fn(y, w_in, w_b, w_out, lb, ub, exp_cap)

    @staticmethod
    def backward(ctx, g):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = arrhenius_rhs_batched_reference(*inputs, *ctx.consts)
            grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
        return (*grads, None, None, None, None)


def make_arrhenius_ops(lb: float, ub: float, exp_cap: float = _EXP_CAP,
                       plain: bool = False):
    """Differentiable batched Arrhenius RHS op ``(y, w_in, w_b, w_out) -> du``
    for the batch-major solve: kernel forward, plain-version backward.
    ``plain=True`` runs the plain version forward too, on any device (the
    explicit switch that chip_smoke.py uses to hold the kernel path against
    the plain path). The dense (du, J) op waits for the port of
    ``_arrh_rhs_jac_kernel``."""

    def rhs_op(y, w_in, w_b, w_out):
        return _ArrheniusRHS.apply(y, w_in, w_b, w_out, lb, ub, exp_cap, plain)

    return rhs_op
