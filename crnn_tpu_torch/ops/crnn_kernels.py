"""Batched CRNN right-hand sides: CUDA kernels and plain versions (port of
crnn_tpu/ops/crnn_kernels.py).

Four wrappers, one per Pallas kernel of the JAX package, each launching a
hand-written Hopper kernel for a CUDA tensor and computing its plain version
for a CPU tensor:

- ``crnn_rhs_batched`` (``csrc/crnn_rhs.cu``, replacing ``_rhs_kernel``) and
  ``crnn_rhs_jac_batched`` (``csrc/crnn_rhs_jac.cu``, replacing
  ``_rhs_jac_kernel``): the isothermal RHS and its value+Jacobian, y (B, ns);
- ``arrhenius_rhs_batched`` (``csrc/arrhenius_rhs.cu``, replacing
  ``_arrh_rhs_kernel``) and ``arrhenius_rhs_jac_batched``
  (``csrc/arrhenius_rhs_jac.cu``, replacing ``_arrh_rhs_jac_kernel``): the
  Arrhenius pair, y (B, ns+1) with T last.

There is no batch-size threshold: the JAX package's ``min_pallas_batch`` was
a TPU measurement. On a CUDA tensor the kernel is launched or the call
raises.

The low-rank factors (``arrhenius_rhs_jac_factors_reference``) stay plain
torch, as they are XLA in the JAX package.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ops import _build

_EXP_CAP = 32.0
_INV_R_KCAL = -1.0 / 1.98720425864083e-3
_MAX_NS = 32
_MAX_NR = 32
_SMEM_BYTES = 48 * 1024
_TILE_ITEMS = 512
_TILE_THREADS = 256
SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_SYMBOL = {"arrhenius_rhs": "arrh_rhs", "arrhenius_rhs_jac": "arrh_rhs_jac",
           "crnn_rhs": "crnn_rhs", "crnn_rhs_jac": "crnn_rhs_jac"}


def _min_cap(z, exp_cap):
    return torch.minimum(z, z.new_full((), exp_cap))


def crnn_rhs_batched_reference(y, w_in, w_b, w_out, lb, ub, exp_cap=_EXP_CAP):
    """du for a batch: y (B, ns) -> (B, ns); w_in (ns, nr)."""
    logx = torch.log(clip(y, lb, ub))
    rates = torch.exp(_min_cap(logx @ w_in + w_b[None, :], exp_cap))
    return rates @ w_out.T


def crnn_rhs_jac_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                   exp_cap=_EXP_CAP):
    """(du, J) with J (B, ns, ns) = (w_out . rates[b]) @ w_in^T . dlog[b],
    dlog = 1{lb < y < ub} / clip(y, lb, ub)."""
    yc = clip(y, lb, ub)
    rates = torch.exp(_min_cap(torch.log(yc) @ w_in + w_b[None, :], exp_cap))
    du = rates @ w_out.T
    dlog = ((y > lb) & (y < ub)).to(y.dtype) / yc
    jac = torch.einsum("br,ir,jr->bij", rates, w_out, w_in) * dlog[:, None, :]
    return du, jac


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


def arrhenius_rhs_jac_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                        exp_cap=_EXP_CAP):
    """(du, J) with J (B, ns+1, ns+1) (models/jacobian.py closed form):
    x-block ``(w_out . rates) @ w_in_x^T . dlog``, T-column
    ``(rates . w_ea) @ w_out^T / (R T^2)``, T-row 0."""
    b = y.shape[0]
    ns = w_out.shape[0]
    x, temp = y[:, :ns], y[:, ns]
    xc = clip(x, lb, ub)
    logx = torch.log(xc)
    z = logx @ w_in[:ns] + (_INV_R_KCAL / temp)[:, None] * w_in[ns][None, :]
    rates = torch.exp(_min_cap(z + w_b[None, :], exp_cap))
    du = rates @ w_out.T
    du = torch.cat([du, torch.zeros_like(du[:, :1])], dim=1)
    in_range = ((x > lb) & (x < ub)).to(y.dtype)
    dlog = in_range / xc                                          # (B, ns)
    j_xx = torch.einsum("br,ir,jr->bij", rates, w_out, w_in[:ns]) \
        * dlog[:, None, :]
    dt_feat = (-_INV_R_KCAL) / (temp * temp)                      # 1/(R T^2)
    j_xt = ((rates * w_in[ns][None, :]) @ w_out.T) * dt_feat[:, None]
    top = torch.cat([j_xx, j_xt[:, :, None]], dim=2)              # (B, ns, ns+1)
    bottom = torch.zeros((b, 1, ns + 1), dtype=y.dtype, device=y.device)
    return du, torch.cat([top, bottom], dim=1)


@functools.cache
def _kernel_fn(name, dtype, n_ptr):
    """The ctypes function of kernel ``name`` for ``dtype``, bound once:
    ``n_ptr`` pointers, the shared scalars, the tile's (lanes, threads) and
    the stream."""
    fn = getattr(_build.load(name), f"{_SYMBOL[name]}_{SUFFIX[dtype]}")
    ptr = ctypes.c_void_p
    fn.argtypes = [ptr] * n_ptr + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int, ptr]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=256)
def tile_geometry(batch: int, ns: int, nr: int, itemsize: int, jac: bool,
                  temperature: bool = False):
    """(lanes, threads) of the flat lane tile of the RHS kernels: the
    isothermal pair (``csrc/crnn_rhs.cu``, and ``csrc/crnn_rhs_jac.cu`` with
    ``jac``) and, with ``temperature``, the Arrhenius pair
    (``csrc/arrhenius_rhs.cu``, ``csrc/arrhenius_rhs_jac.cu``), whose rows
    of y, du and J are ns + 1 wide with the T column. A block owns
    ``lanes`` consecutive lanes and loops over its items in phases: (lane,
    column), (lane, reaction), and the outputs, (lane, column) and with
    ``jac`` also (lane, i, j). The lanes give a block at most
    ``_TILE_ITEMS`` items in its largest phase (one lane at least) and keep
    its shared memory within 48 KB without an opt-in: the weights (2 ns nr
    + nr values, nr more for the Ea row with ``temperature``), then a lane's
    row of features (logx, and inv_t with ``temperature``), with ``jac`` a
    row of J's column factors (dlog, and dt_feat with ``temperature``), and
    nr rates. The threads, a multiple of 32 and at most ``_TILE_THREADS``,
    cover the largest phase in one or a few passes. The launcher derives the
    shared bytes and the grid, ceil(B / lanes) blocks, and refuses a layout
    above 48 KB."""
    width = ns + 1 if temperature else ns
    per_lane = max(width, nr, width * width if jac else 0)
    lane_bytes = itemsize * (width * (2 if jac else 1) + nr)
    weight_bytes = itemsize * (2 * ns * nr + (2 if temperature else 1) * nr)
    lanes = max(1, min(batch, _TILE_ITEMS // per_lane,
                       (_SMEM_BYTES - weight_bytes) // lane_bytes))
    return lanes, min(_TILE_THREADS, -(-lanes * per_lane // 32) * 32)


def check_kernel_inputs(who, y, w_in, w_b, w_out, max_ns=_MAX_NS,
                        max_nr=_MAX_NR, temperature=True):
    """(ns, nr) after the checks every kernel wrapper makes before it hands
    pointers to a kernel: a CUDA device, f32 or f64, ns and nr within the
    kernel's caps, matching shapes, devices and dtypes, and a contiguous
    ``y``. ``temperature``: y (B, ns+1) and w_in (ns+1, nr) with the T
    column and the Ea row (Arrhenius); else y (B, ns) and w_in (ns, nr)."""
    if y.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {y.device}")
    if y.dtype not in SUFFIX:
        raise TypeError(f"{who}: dtype {y.dtype} is not float32 or float64")
    ns, nr = w_out.shape
    if not (1 <= ns <= max_ns and 1 <= nr <= max_nr):
        raise ValueError(f"{who}: ns={ns}, nr={nr}; the kernel takes "
                         f"1 <= ns <= {max_ns}, 1 <= nr <= {max_nr}")
    nf = ns + 1 if temperature else ns
    if (y.dim() != 2 or y.shape[1] != nf
            or tuple(w_in.shape) != (nf, nr) or tuple(w_b.shape) != (nr,)):
        raise ValueError(
            f"{who}: shapes y {tuple(y.shape)}, w_in {tuple(w_in.shape)}, "
            f"w_b {tuple(w_b.shape)}, w_out ({ns}, {nr})")
    for t in (w_in, w_b, w_out):
        if t.device != y.device or t.dtype != y.dtype:
            raise ValueError(f"{who}: weights must share y's device and dtype")
    if not y.is_contiguous():
        raise ValueError(f"{who}: y must be contiguous")
    return ns, nr


def _launch(name, y, weights, outs, lb, ub, exp_cap, geometry):
    """Launch ``name`` on y, the kernel's weight operands (w_out last, each
    made contiguous) and ``outs`` on the current stream, with the tile's
    ``geometry`` (lanes, threads) from ``tile_geometry``. Returns False
    without a launch for an empty batch; raises on a CUDA error."""
    batch = y.shape[0]
    if batch == 0:
        return False
    ns, nr = weights[-1].shape
    fn = _kernel_fn(name, y.dtype, 1 + len(weights) + len(outs))
    weights = [w.contiguous() for w in weights]  # no copy if contiguous
    ptrs = [y.data_ptr(), *(w.data_ptr() for w in weights),
            *(o.data_ptr() for o in outs)]
    index = y.device.index
    on_current = index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(index):
        rc = fn(*ptrs, batch, ns, nr, float(lb), float(ub), float(exp_cap),
                *geometry, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return True


def _arrhenius_weights(w_in, w_b, w_out):
    """The Arrhenius kernels' weight operands: species orders, Ea row, bias,
    stoichiometry."""
    ns = w_out.shape[0]
    return w_in[:ns], w_in[ns], w_b, w_out


def crnn_rhs_batched(y, w_in, w_b, w_out, lb, ub, exp_cap=_EXP_CAP):
    """Batched isothermal RHS: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``crnn_rhs_batched.launches`` counts the kernel
    launches."""
    if y.device.type == "cpu":
        return crnn_rhs_batched_reference(y, w_in, w_b, w_out, lb, ub, exp_cap)
    ns, nr = check_kernel_inputs("crnn_rhs_batched", y, w_in, w_b, w_out,
                                 temperature=False)
    du = torch.empty_like(y)
    geometry = tile_geometry(y.shape[0], ns, nr, y.element_size(), False)
    if _launch("crnn_rhs", y, (w_in, w_b, w_out), (du,), lb, ub, exp_cap,
               geometry):
        crnn_rhs_batched.launches += 1
    return du


crnn_rhs_batched.launches = 0


def crnn_rhs_jac_batched(y, w_in, w_b, w_out, lb, ub, exp_cap=_EXP_CAP):
    """Batched isothermal (du, J): the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. ``crnn_rhs_jac_batched.launches`` counts
    the kernel launches."""
    if y.device.type == "cpu":
        return crnn_rhs_jac_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                              exp_cap)
    ns, nr = check_kernel_inputs("crnn_rhs_jac_batched", y, w_in, w_b, w_out,
                                 temperature=False)
    du = torch.empty_like(y)
    jac = torch.empty((y.shape[0], ns, ns), dtype=y.dtype, device=y.device)
    geometry = tile_geometry(y.shape[0], ns, nr, y.element_size(), True)
    if _launch("crnn_rhs_jac", y, (w_in, w_b, w_out), (du, jac), lb, ub,
               exp_cap, geometry):
        crnn_rhs_jac_batched.launches += 1
    return du, jac


crnn_rhs_jac_batched.launches = 0


def arrhenius_rhs_batched(y, w_in, w_b, w_out, lb, ub, exp_cap=_EXP_CAP):
    """Batched Arrhenius RHS: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. ``arrhenius_rhs_batched.launches`` counts the
    kernel launches."""
    if y.device.type == "cpu":
        return arrhenius_rhs_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                               exp_cap)
    ns, nr = check_kernel_inputs("arrhenius_rhs_batched", y, w_in, w_b,
                                 w_out)
    du = torch.empty_like(y)
    geometry = tile_geometry(y.shape[0], ns, nr, y.element_size(), False,
                             temperature=True)
    if _launch("arrhenius_rhs", y, _arrhenius_weights(w_in, w_b, w_out),
               (du,), lb, ub, exp_cap, geometry):
        arrhenius_rhs_batched.launches += 1
    return du


arrhenius_rhs_batched.launches = 0


def arrhenius_rhs_jac_batched(y, w_in, w_b, w_out, lb, ub, exp_cap=_EXP_CAP):
    """Batched fused Arrhenius (du, J): the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor. ``arrhenius_rhs_jac_batched.launches``
    counts the kernel launches."""
    if y.device.type == "cpu":
        return arrhenius_rhs_jac_batched_reference(y, w_in, w_b, w_out, lb,
                                                   ub, exp_cap)
    ns, nr = check_kernel_inputs("arrhenius_rhs_jac_batched", y, w_in, w_b,
                                 w_out)
    du = torch.empty_like(y)
    jac = torch.empty((y.shape[0], ns + 1, ns + 1), dtype=y.dtype,
                      device=y.device)
    geometry = tile_geometry(y.shape[0], ns, nr, y.element_size(), True,
                             temperature=True)
    if _launch("arrhenius_rhs_jac", y, _arrhenius_weights(w_in, w_b, w_out),
               (du, jac), lb, ub, exp_cap, geometry):
        arrhenius_rhs_jac_batched.launches += 1
    return du, jac


arrhenius_rhs_jac_batched.launches = 0


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


def _kernel_forward_op(kernel, reference):
    """A ``torch.autograd.Function`` with the kernel forward and a backward
    by autograd of the plain version, as the ``custom_vjp`` pairs at
    crnn_tpu/ops/crnn_kernels.py:372-405 do: the JAX package has no backward
    kernel."""

    class Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y, w_in, w_b, w_out, lb, ub, exp_cap):
            ctx.save_for_backward(y, w_in, w_b, w_out)
            ctx.consts = (lb, ub, exp_cap)
            return kernel(y, w_in, w_b, w_out, lb, ub, exp_cap)

        @staticmethod
        def backward(ctx, *g):
            inputs = [t.detach().requires_grad_(True)
                      for t in ctx.saved_tensors]
            with torch.enable_grad():
                out = reference(*inputs, *ctx.consts)
                grads = torch.autograd.grad(out, inputs, g, allow_unused=True)
            return (*grads, None, None, None)

    return Op


def _op(function, reference, lb, ub, exp_cap, plain):
    """``(y, w_in, w_b, w_out) -> out``: the plain version itself under
    ``plain`` (on any device; ``torch.func`` transforms can differentiate
    it), else ``function`` (kernel forward, plain-version backward)."""
    if plain:
        return lambda y, w_in, w_b, w_out: reference(y, w_in, w_b, w_out, lb,
                                                     ub, exp_cap)
    return lambda y, w_in, w_b, w_out: function.apply(y, w_in, w_b, w_out, lb,
                                                      ub, exp_cap)


_CRNNRHS = _kernel_forward_op(crnn_rhs_batched, crnn_rhs_batched_reference)
_CRNNRHSJac = _kernel_forward_op(crnn_rhs_jac_batched,
                                 crnn_rhs_jac_batched_reference)
_ArrheniusRHS = _kernel_forward_op(arrhenius_rhs_batched,
                                   arrhenius_rhs_batched_reference)
_ArrheniusRHSJac = _kernel_forward_op(arrhenius_rhs_jac_batched,
                                      arrhenius_rhs_jac_batched_reference)


def make_arrhenius_ops(lb: float, ub: float, exp_cap: float = _EXP_CAP,
                       plain: bool = False):
    """Differentiable batched Arrhenius ``(rhs_op, rhs_jac_op)`` pair for the
    batch-major solve, ``(y, w_in, w_b, w_out) -> du`` and ``-> (du, J)``:
    kernel forward, plain-version backward. ``plain=True`` runs the plain
    version instead, on any device (the explicit switch that chip_smoke.py
    uses to hold the kernel path against the plain path)."""
    return (_op(_ArrheniusRHS, arrhenius_rhs_batched_reference, lb, ub,
                exp_cap, plain),
            _op(_ArrheniusRHSJac, arrhenius_rhs_jac_batched_reference, lb, ub,
                exp_cap, plain))


def make_crnn_rhs_op(lb: float, ub: float, exp_cap: float = _EXP_CAP,
                     plain: bool = False):
    """Differentiable batched isothermal RHS op ``(y, w_in, w_b, w_out) ->
    du``: kernel forward, plain-version backward (crnn_kernels.py:409 of the
    JAX package). ``plain=True`` is the plain version itself."""
    return _op(_CRNNRHS, crnn_rhs_batched_reference, lb, ub, exp_cap, plain)


def make_crnn_rhs_jac_op(lb: float, ub: float, exp_cap: float = _EXP_CAP,
                         plain: bool = False):
    """Differentiable batched isothermal ``(y, w_in, w_b, w_out) -> (du, J)``
    op: kernel forward, plain-version backward (crnn_kernels.py:431 of the
    JAX package). ``plain=True`` is the plain version itself."""
    return _op(_CRNNRHSJac, crnn_rhs_jac_batched_reference, lb, ub, exp_cap,
               plain)
