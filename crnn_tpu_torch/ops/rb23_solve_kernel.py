"""Whole-solve Rosenbrock23 evaluator: the entire adaptive solve of a batch
of case2-family Arrhenius lanes in ONE kernel launch (port of
crnn_tpu/ops/rb23_solve_kernel.py).

``arrh_rb23_solve`` launches the hand-written Hopper kernel
(``csrc/arrh_rb23_solve.cu``, replacing the Pallas
``_arrh_rb23_solve_kernel``) for a CUDA tensor and runs the plain version,
``arrh_rb23_solve_reference``, for a CPU tensor. Both integrate every lane
from t0 to t1 with the Shampine 2(3) W-method, the rank-nr Woodbury W-solve
and the I-controller of ``ode/batch_solve.py``, and record each step's
endpoints (t, t_new, accepted, y, y_new, f0, f2) into step-major
histories. ``_dense_output`` (plain torch, as it is XLA in JAX) turns them
into the cubic-Hermite ``saveat`` trajectory.

Forward only: the evaluation and prediction paths. The JAX package's case2
eval pass uses the ``while`` driver, and so does the port's.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from crnn_tpu_torch import clip
from crnn_tpu_torch.ode.batch_solve import _D, _DONE, _E32, _FAILED, _RUNNING
from crnn_tpu_torch.ode.controller import error_norm, initial_step, propose_dt
from crnn_tpu_torch.ops import _build
from crnn_tpu_torch.ops.crnn_kernels import (
    SUFFIX, arrhenius_rhs_batched_reference,
    arrhenius_rhs_jac_factors_reference, check_kernel_inputs)

# compile-time caps of the kernel's per-thread register arrays
# (csrc/arrh_rb23_solve.cu kMaxSpecies / kMaxReactions)
_MAX_NS = 8
_MAX_NR = 4
# the launch: warps a block at most (kMaxThreads = 128 threads), and the
# card's SMs, over which the warps of a small batch are spread
_SOLVE_WARPS = 4
_SMS = 132


@functools.lru_cache(maxsize=256)
def solve_geometry(batch: int, ns: int, nr: int, itemsize: int):
    """(group, lanes, threads, blocks) of the whole-solve kernel
    (``csrc/arrh_rb23_solve.cu``). A group of ``group`` threads carries one
    lane, one thread per state component (ns + 1 of them) and reaction
    (nr <= 4): 8 threads, or 16 where ns + 1 > 8. A block holds ``lanes``
    lanes, ``threads`` = group * lanes, in whole warps: one warp a block
    while the batch's warps fit one a SM, so that each runs alone on its
    SM's scheduler, and up to ``_SOLVE_WARPS`` where there are more.
    ``blocks`` = ceil(B / lanes). ``itemsize`` (4 or 8) does not change the
    geometry: every instantiation keeps its carry in registers within the
    launch bound of 128 threads. The C launcher refuses a group that is not
    8 or 16 or does not cover ns + 1, no lanes, and threads that are not
    whole warps within 128."""
    if itemsize not in (4, 8):
        raise ValueError(f"solve_geometry: itemsize {itemsize}")
    group = 8 if ns + 1 <= 8 else 16
    per_warp = 32 // group
    warps = max(1, -(-batch // per_warp))
    lanes = per_warp * min(_SOLVE_WARPS, -(-warps // _SMS))
    return group, lanes, group * lanes, -(-batch // lanes)


def _inv_rows(m_rows, nr):
    """Invert B-many (nr, nr) matrices stored as nr*nr (B,) rows (index
    r*nr+q) by unrolled Gauss-Jordan without pivoting. The Woodbury inner
    matrix I - h*d*V@U is a small perturbation of the identity inside the
    controller's stability envelope; a (near-)singular one gives inf/NaN
    entries, which step acceptance rejects. Returns ``inv[r][q]`` rows."""
    aug = [[m_rows[r * nr + q] for q in range(nr)] for r in range(nr)]
    eye = [[torch.full_like(m_rows[0], 1.0 if r == q else 0.0)
            for q in range(nr)] for r in range(nr)]
    for col in range(nr):
        inv_piv = 1.0 / aug[col][col]
        aug[col] = [a * inv_piv for a in aug[col]]
        eye[col] = [a * inv_piv for a in eye[col]]
        for r in range(nr):
            if r == col:
                continue
            f = aug[r][col]
            aug[r] = [a - f * b for a, b in zip(aug[r], aug[col])]
            eye[r] = [a - f * b for a, b in zip(eye[r], eye[col])]
    return eye


@torch.no_grad()
def arrh_rb23_solve_reference(y0, w_in, w_b, w_out, *, max_steps, t0, t1,
                              rtol, atol, lb, ub, exp_cap=32.0, safety=0.9,
                              factor_min=0.2, factor_max=10.0,
                              dtmin_frac=1e-12, hist_fill=math.nan):
    """The plain version of the whole solve, batch-major: the JAX kernel
    body (crnn_tpu/ops/rb23_solve_kernel.py:85-265) written with the port's
    plain RHS, low-rank factors, lane norm, initial dt and I-controller.

    Returns ``(t_h, tn_h, acc_h (B, K), y_h, yn_h, f0_h, f2_h (B, K, ns+1),
    status, n_steps (B,) int32, y_final (B, ns+1))`` with K = max_steps.
    It stops, as the JAX ``while_loop`` does, once no lane is running (one
    host check per step); rows after that hold ``hist_fill`` (acc 0)."""
    b, ns1 = y0.shape
    ns, nr = w_out.shape
    dtype, dev = y0.dtype, y0.device
    t0, t1 = float(t0), float(t1)
    dtmin = float(dtmin_frac) * (t1 - t0)
    k = max_steps

    def rhs(t, y, args=None):
        return arrhenius_rhs_batched_reference(y, w_in, w_b, w_out, lb, ub,
                                               exp_cap)

    def full(v):
        return torch.full((b,), v, dtype=dtype, device=dev)

    # Hairer automatic initial dt; its RMS norms include the T row (:126-141)
    dt = initial_step(rhs, t0, t1, y0, None, 2, rtol, atol)

    t_h, tn_h = (torch.full((b, k), hist_fill, dtype=dtype, device=dev)
                 for _ in range(2))
    acc_h = torch.zeros((b, k), dtype=dtype, device=dev)
    y_h, yn_h, f0_h, f2_h = (torch.full((b, k, ns1), hist_fill, dtype=dtype,
                                        device=dev) for _ in range(4))

    t = full(t0)
    y = y0.clone()
    status = torch.zeros((b,), dtype=torch.int32, device=dev)
    n_steps = torch.zeros((b,), dtype=torch.int32, device=dev)
    zero = full(0.0)
    i = 0
    while i < k and bool(torch.any(status == _RUNNING)):
        running = status == _RUNNING
        t_rem = t1 - t
        clipped = dt >= t_rem
        dt = torch.where(running, torch.minimum(dt, t_rem), dt)
        dt = torch.maximum(dt, zero)
        hd = dt * _D

        # value, J = U @ V, and the Woodbury inner matrix M = I - h*d*V@U
        # inverted without pivoting, as the kernel does (:155-192)
        f0, u_fac, v_fac = arrhenius_rhs_jac_factors_reference(
            y, w_in, w_b, w_out, lb, ub, exp_cap)
        vu = torch.einsum("brj,jq->brq", v_fac, u_fac)            # (B, nr, nr)
        minv = _inv_rows([(1.0 if r == q else 0.0) - hd * vu[:, r, q]
                          for r in range(nr) for q in range(nr)], nr)

        def wsolve(v):
            s = torch.einsum("brj,bj->br", v_fac, v)              # (B, nr)
            xr = torch.stack([sum(minv[r][q] * s[:, q] for q in range(nr))
                              for r in range(nr)], dim=1)
            return v + hd[:, None] * (xr @ u_fac.T)

        k1 = wsolve(f0)
        f1 = rhs(t, y + (0.5 * dt)[:, None] * k1)
        k2 = wsolve(f1 - k1) + k1
        y1 = y + dt[:, None] * k2
        f2 = rhs(t, y1)
        k3 = wsolve(f2 - _E32 * (k2 - f1) - 2.0 * (k1 - f0))
        y_err = (dt / 6.0)[:, None] * (k1 - 2.0 * k2 + k3)

        ok = (torch.all(torch.isfinite(y1), dim=1)
              & torch.all(torch.isfinite(y_err), dim=1))
        err = torch.where(ok, error_norm(y_err, y, y1, rtol, atol), math.inf)
        accept = err <= 1.0
        t_new = t + dt

        adv = running & accept
        t_h[:, i], tn_h[:, i], acc_h[:, i] = t, t_new, adv.to(dtype)
        y_h[:, i], yn_h[:, i], f0_h[:, i], f2_h[:, i] = y, y1, f0, f2

        dt_next = propose_dt(dt, err, accept, 2, safety, factor_min,
                             factor_max)                          # (:214-219)
        finished = accept & clipped
        too_small = dt_next < dtmin
        new_status = torch.where(
            finished, _DONE, torch.where(too_small, _FAILED, _RUNNING)
        ).to(torch.int32)
        y1_safe = torch.where(torch.isfinite(y1), y1, 0.0)
        t = torch.where(adv, t_new, t)
        y = torch.where(adv[:, None], y1_safe, y)
        dt = torch.where(running, dt_next, dt)
        status = torch.where(running, new_status, status)
        n_steps = n_steps + running.to(torch.int32)
        i += 1
    return t_h, tn_h, acc_h, y_h, yn_h, f0_h, f2_h, status, n_steps, y


@functools.cache
def _kernel_fn(dtype):
    """The ctypes function of the kernel for ``dtype``, bound once: 14
    pointers, B, ns, nr, max_steps, 11 solver constants, the geometry's
    group and lanes, and the stream."""
    fn = getattr(_build.load("arrh_rb23_solve"),
                 f"arrh_rb23_solve_{SUFFIX[dtype]}")
    ptr, dbl = ctypes.c_void_p, ctypes.c_double
    fn.argtypes = ([ptr] * 14 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
                   + [dbl] * 11 + [ctypes.c_int, ctypes.c_int, ptr])
    fn.restype = ctypes.c_int
    return fn


def _launch(y0, weights, outs, max_steps, consts, geometry):
    """Launch the kernel on y0, (w_in, w_b, w_out) and the ten ``outs`` on
    the current stream, with the 11 solver constants ``consts`` (t0, t1,
    rtol, atol, lb, ub, exp_cap, safety, factor_min, factor_max, dtmin) and
    ``geometry`` (group, lanes) from ``solve_geometry``; raises on a CUDA
    error."""
    ns, nr = weights[-1].shape
    index = y0.device.index
    on_current = index == torch.cuda.current_device()
    with contextlib.nullcontext() if on_current else torch.cuda.device(index):
        rc = _kernel_fn(y0.dtype)(
            y0.data_ptr(), *(w.data_ptr() for w in weights),
            *(o.data_ptr() for o in outs), y0.shape[0], ns, nr, max_steps,
            *consts, *geometry, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"arrh_rb23_solve kernel launch failed: cudaError {rc}")


def arrh_rb23_solve(y0, w_in, w_b, w_out, *, max_steps, t0, t1, rtol, atol,
                    lb, ub, exp_cap=32.0, safety=0.9, factor_min=0.2,
                    factor_max=10.0, dtmin_frac=1e-12, hist_fill=None):
    """The whole solve: the CUDA kernel for a CUDA tensor, the plain version
    for a CPU tensor; the outputs of ``arrh_rb23_solve_reference``.

    On the card the histories are laid out step-major, (K, ns+1, B) and
    (K, B), so that neighbouring lanes store to neighbouring addresses; the
    batch-major results are views of them. ``acc`` is zeroed; the other
    histories are left uninitialised (``torch.empty``) unless ``hist_fill``
    gives a value to fill them with, which shows that unvisited rows never
    reach the dense output. ``arrh_rb23_solve.launches`` counts the kernel
    launches."""
    consts = dict(max_steps=max_steps, t0=t0, t1=t1, rtol=rtol, atol=atol,
                  lb=lb, ub=ub, exp_cap=exp_cap, safety=safety,
                  factor_min=factor_min, factor_max=factor_max,
                  dtmin_frac=dtmin_frac)
    if y0.device.type == "cpu":
        return arrh_rb23_solve_reference(
            y0, w_in, w_b, w_out, **consts,
            hist_fill=math.nan if hist_fill is None else hist_fill)
    ns, nr = check_kernel_inputs("arrh_rb23_solve", y0, w_in, w_b, w_out,
                                 _MAX_NS, _MAX_NR)
    if max_steps < 1:
        raise ValueError(f"arrh_rb23_solve: max_steps={max_steps}")
    b, ns1 = y0.shape
    k = max_steps
    t0_, t1_ = float(t0), float(t1)
    dtmin = float(dtmin_frac) * (t1_ - t0_)
    # one buffer for the float outputs and one for the int pair: two
    # allocations a call instead of ten
    sizes = [k * b] * 3 + [k * ns1 * b] * 4 + [b * ns1]
    buf = torch.empty(sum(sizes), dtype=y0.dtype, device=y0.device)
    if hist_fill is not None:
        buf.fill_(hist_fill)
    t_h, tn_h, acc_h, y_h, yn_h, f0_h, f2_h, y_fin = buf.split(sizes)
    acc_h.zero_()
    status, n_steps = torch.empty((2, b), dtype=torch.int32,
                                  device=y0.device)
    weights = [w.contiguous() for w in (w_in, w_b, w_out)]
    outs = (t_h.view(k, b), tn_h.view(k, b), acc_h.view(k, b),
            *(h.view(k, ns1, b) for h in (y_h, yn_h, f0_h, f2_h)), status,
            n_steps, y_fin.view(b, ns1))
    if b == 0:
        return _batch_major(outs)
    group, lanes, _, _ = solve_geometry(b, ns, nr, y0.element_size())
    _launch(y0, weights, outs, k,
            (t0_, t1_, float(rtol), float(atol), float(lb), float(ub),
             float(exp_cap), float(safety), float(factor_min),
             float(factor_max), dtmin), (group, lanes))
    arrh_rb23_solve.launches += 1
    return _batch_major(outs)


arrh_rb23_solve.launches = 0


def _batch_major(outs):
    """The batch-major views of the kernel's step-major outputs."""
    t_h, tn_h, acc_h, y_h, yn_h, f0_h, f2_h, status, n_steps, y_fin = outs
    return (t_h.T, tn_h.T, acc_h.T, y_h.permute(2, 0, 1), yn_h.permute(2, 0, 1),
            f0_h.permute(2, 0, 1), f2_h.permute(2, 0, 1), status, n_steps,
            y_fin)


def _dense_output(saveat, t0, y0, t_h, tn_h, acc_h, y_h, yn_h, f0_h, f2_h):
    """Cubic-Hermite dense output from recorded step endpoints
    (crnn_tpu/ops/rb23_solve_kernel.py:322-373). Each save time lies in
    (t, t_new] of exactly one accepted step; the bracket masks (B, K, S)
    contract with the endpoint tensors (B, K, ns+1)."""
    # Unvisited history rows hold whatever the buffer held (NaN in the plain
    # version, uninitialised memory on the card); only acc is zeroed. Every
    # history goes through the accepted mask BEFORE any arithmetic, since
    # NaN * 0 = NaN would leak through the contraction.
    ok_row = acc_h > 0.5                                          # (B, K)
    t_h = torch.where(ok_row, t_h, 0.0)
    tn_h = torch.where(ok_row, tn_h, -1.0)  # empty bracket: tn < t0 <= s
    y_h, yn_h, f0_h, f2_h = (torch.where(ok_row[:, :, None], h, 0.0)
                             for h in (y_h, yn_h, f0_h, f2_h))
    dt_h = tn_h - t_h                                             # (B, K)
    inv_dt = 1.0 / torch.maximum(dt_h, dt_h.new_full((), 1e-30))
    s = saveat[None, None, :]
    theta = (s - t_h[:, :, None]) * inv_dt[:, :, None]
    theta = clip(theta, 0.0, 1.0)                                 # (B, K, S)
    bracket = ((s > t_h[:, :, None]) & (s <= tn_h[:, :, None])
               & ok_row[:, :, None]).to(y_h.dtype)
    th2 = theta * theta
    th3 = th2 * theta
    b_f0 = (theta - 2.0 * th2 + th3) * bracket
    b_f1 = (th3 - th2) * bracket
    b_dy = (3.0 * th2 - 2.0 * th3) * bracket

    def contract(w, v):  # (B, K, S) x (B, K, N) -> (B, S, N), full f32
        return torch.einsum("bks,bkn->bsn", w, v)

    ys = (contract(bracket - b_dy, y_h) + contract(b_dy, yn_h)
          + contract(b_f0 * dt_h[:, :, None], f0_h)
          + contract(b_f1 * dt_h[:, :, None], f2_h))
    at_start = (saveat <= t0)[None, :, None]
    return torch.where(at_start, y0[:, None, :], ys)


def make_arrhenius_fused_solve(ns, nr, lb, ub, t0, t1, saveat, rtol, atol,
                               max_steps, exp_cap=32.0):
    """Whole-solve evaluator for the case2 Arrhenius family: returns
    ``solve(y0 (B, ns+1), w) -> (ys (B, n_save, ns+1), success (B,))``, the
    forward of ``batch_odesolve_rb23(..., jac_mode='lowrank')`` in one
    kernel launch plus the dense-output post-pass. No gradient."""
    saveat = torch.as_tensor(saveat)

    @torch.no_grad()
    def solve(y0, w):
        if tuple(w.w_out.shape) != (ns, nr):
            raise ValueError(f"weights of shape {tuple(w.w_out.shape)}, "
                             f"expected w_out ({ns}, {nr})")
        (t_h, tn_h, acc_h, y_h, yn_h, f0_h, f2_h, status, _,
         _) = arrh_rb23_solve(y0, w.w_in, w.w_b, w.w_out,
                              max_steps=max_steps, t0=t0, t1=t1, rtol=rtol,
                              atol=atol, lb=lb, ub=ub, exp_cap=exp_cap)
        ys = _dense_output(saveat.to(device=y0.device, dtype=y0.dtype),
                           float(t0), y0, t_h, tn_h, acc_h, y_h, yn_h, f0_h,
                           f2_h)
        return ys, status == _DONE

    return solve
