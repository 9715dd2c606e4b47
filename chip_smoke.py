"""Chip smoke test of crnn_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with the seconds it took:

1. device: the card's name and power limit (nvidia-smi), the torch version,
   the build of every CUDA kernel of the main path with plain nvcc (one
   process a source, all started together), and the latency of one
   dependent operation of each class kernel 3's chain holds (FMA, IEEE
   division, sqrt, exp, log, pow, shuffle, compare-and-select), f32 and
   f64, from one-warp chains of ``ops/csrc/latency_probe.cu`` (a
   measurement aid, not a kernel of the path);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the batch sizes of the main path and beyond, on edge inputs (x < lb,
   x = lb, x > ub, x = 0, NaN, +-inf, the exp cap); NaN positions must match
   exactly, finite values at rtol 1e-5 / atol 1e-6 (f32) or 1e-12 (f64);
   then the kernel's device time against the plain version's (f32 at each
   B, f64 at B=30); then the flat lane tile's coverage
   (``arrhenius_coverage``): B in {1, 20, 21, 30, 33, 4099} (ragged last
   tiles), at case2's shape (6, 3) and the caps (32, 32), (1, 32), (32, 1),
   f32 and f64, on plain, edge and exp-cap inputs conditioned as phase 7's
   (``arrhenius_cond_inputs``, drawn from a generator of their own): NaN
   and inf positions exact, finite values within 2e-6 (f32) or 1e-12 (f64)
   of each output component's largest value;
3. slice: the case2 batch-mode training epoch at full width (30
   experiments, 50 save points, max_steps 128, f32): data generated on the
   card, 3 guarded epochs through run_case with every launch counter set to
   0 just before and read just after (finite, decreasing training loss);
   the generated truth against an f64 CPU re-solve; the kernel path against
   the same inputs forced onto the plain path at rtol 1e-4: the f32 losses
   (train and eval) and a whole f64 epoch (loss, grad, eval losses). In f32
   the gradient follows the rounding of the adaptive step sequence, which
   a one-ulp probe prints.
4. kernels 2-3: the dense value+Jacobian kernel against its plain version
   as kernel 1 is held in phase 2 (du and J, NaN positions exact); the
   whole-solve Rosenbrock23 kernel against its plain version on case2's 30
   initial states at the initial params, its history buffers filled with
   NaN before the launch (f32: ys within 5e-4 of each state component's
   largest value, success equal; f64: n_steps and status exact, ys within
   1e-9 of each component's largest value), against the port's early-exit
   while driver (lowrank) at 5e-4 of each component's largest, and at
   B=4099 in f32 and f64, beside how far one ulp of y0 moves the plain f64
   solve; kernel 3's lane-group coverage (``solve_coverage``, the same
   gates): B in {1, 30, 31, 33, 4099} (ragged warps and blocks) at case2's
   shape (6, 3), the compiled path, and at (1, 1), (3, 2), (7, 4) and the
   caps (8, 4), the runtime path (16 threads a lane at ns = 8), then every
   (ns, nr) within the caps at B=3, f32 and f64, on inputs conditioned as
   ``solve_inputs`` says (the one-ulp witness printed at B=4099); then both
   kernels' device times against their plain versions' (kernel 2 in f32 at
   each B and in f64 at B=30; kernel 3 at B=30 in f32 and f64 and at
   B=4099 in f32, with its latency bound and us per step), and kernel 2
   through phase 2's coverage;
5. dense slice: case2 with jac_mode='dense' as shipped, 2 guarded epochs
   through run_case with every launch counter set to 0 just before and read
   just after; the kernel path against the plain path at rtol 1e-4 on the
   f32 losses (train and eval) at the initial and the trained params, and
   on a whole f64 dense epoch (loss, grad, eval losses);
6. fused eval: phase 3's trained params through the whole-solve evaluator
   (counters set to 0 just before, read just after) and the while driver on
   the 30 experiments, held against each other at 5e-4 of each state
   component's largest value, then timed in 12
   interleaved rounds of 10 calls each (median), as bench.py times its
   eval pair;
7. kernels 4-5: the isothermal RHS and its value+Jacobian against their
   plain versions at B in {1, 20, 21, 30, 33, 4099, 65536} (ragged last
   tiles beside the main path's B), at case1's shapes (ns=5, nr=4),
   robertson's (ns=3, nr=6) and the caps (32, 32), (1, 32), (32, 1), f32
   and f64, ub = 10 and ub = inf, on the edge inputs of phase 2 and at the
   exp cap: NaN and inf positions exact, finite values within 2e-6 (f32)
   or 1e-12 (f64) of each output component's largest value; then device
   and eager times against the plain versions' and the launch floor; then
   kernel 4 at the 100 lanes of case3 (ns=9, nr=8) and of the GRN (ns=9,
   nr=15), f32 and f64, ub = 100 and inf, under the same gate, with its
   device ms, the launch floor and its bound at B=100 in f32; and at the
   hybrid cases' CRNN cores, yeast's (ns=12, nr=12; ub 100) and the
   QSSA's (3, 3; ub 10), at B=20 and 30, f32 and f64, ub and inf, with its
   device ms and bound at B=20 in f32;
8. case1: 3 guarded epochs of Case1Config() (f32, Tsit5) through run_case,
   counters set to 0 just before and read just after (kernel 4 launches;
   finite, non-increasing training loss); the kernel path against the
   plain path on the same params and perm: f32 losses at rtol 1e-4, f32 ys
   within 5e-4 of each species' largest value, and a whole f64 epoch
   (loss, grad, eval losses, params) at rtol 1e-9;
9. robertson: 2 guarded epochs of RobertsonConfig() (f64, Rosenbrock23,
   stochastic horizons) through run_case, counters set to 0 just before
   and read just after (kernel 4 and kernel 5 launches); the kernel path
   against the plain path on the same params, perm and masks over a whole
   epoch (loss, grad, eval losses, params) at rtol 1e-9;
10. runner: per-lane case2 (``batch_major=False``, reverse mode) at
   ``Case2Config()`` width, 2 f32 epochs through run_case with the counts
   of kernels 1 and 2 set to 0 just before and read just after (each > 0),
   and an f64 epoch on the kernel path against the plain path at rtol
   1e-9, as phase 9; one sequential case2 epoch in forward mode (jacfwd
   through the plain ops, as the JAX package takes its reference ops
   there; the evaluation pass on the kernels) as the CLI runs it, with
   kernel 1 counted (> 0), and one with the per-lane evaluation, kernels 1
   and 2 counted (each > 0), both finite; one sequential case1 epoch at 5
   training experiments (kernel 4 counted, > 0); then the case2 CLI for 2
   epochs and 2 more with ``--restart --epochs-per-dispatch 2``:
   metrics.jsonl runs epochs 1-4, the checkpoint, best and p_opt.npy
   files exist, and every epoch's losses and grad norm and the final
   checkpoint (the generator's state among it) equal those of a 4-epoch
   uninterrupted run bit for bit;
11. isothermal family: (a) case3 (``Case3Config()``: 100 experiments,
   100 save points, ns=9, nr=8, f32, Tsit5, max_steps 192) and (b) the GRN
   (``grn_config()``: nr=15, 40 save points, horizons 2-40): 2 guarded
   epochs each through run_case with kernel 4 counted (> 0); the kernel
   path against the plain path on the f32 losses (train and eval) at the
   initial and the trained params at rtol 1e-4, or at 3x the plain path's
   own move under one ulp of the params where that is larger (case3's
   log-space loss of species that decay to lb), on the f32 ys within
   5e-4 of each species' largest value, and over a whole f64 epoch (loss,
   grad, eval losses, params) at rtol 1e-9; (c) case1 rev
   (``Case1RevConfig()``): 2 forward-mode epochs, finite, with every
   kernel's count 0 (its reversible RHS is plain torch, as in JAX); (d)
   the per-lane Rosenbrock23 on a t-dependent RHS (``ramp_rhs``, df/dt by
   forward mode in t) in f64 on the card against the same solve on the
   CPU: n_steps exact, ys within 1e-9 of each component's largest value;
12. ODE suite: (a) TRBDF2, Kvaerno3, ``AutoSwitch(Tsit5(), TRBDF2())`` and
   ``AutoSwitch(Tsit5(), Rosenbrock23())`` on Robertson in f64, three lanes
   of different stiffness in one batch, on the card against the CPU: n_steps
   and every lane's final ``is_stiff`` exact, ys within 1e-9 of each
   component's largest value; (b) per-lane case2
   (``Case2Config(batch_major=False)``) under
   ``solver='auto_tsit5_rosenbrock23'`` and ``'trbdf2'``: one f32 epoch each
   through run_case with kernels 1 and 2 counted and timed, and an f64 epoch
   at a reduced depth of 64 steps a scan on the kernel path against the
   plain path at rtol 1e-9 or 3x the plain path's own move under one ulp of
   the params, whichever is larger (AutoSwitch's f64 gradient moves by ~4e-8
   and its eval losses by ~2e-6; kernel launches counted); (c) robertson
   with ``grad_path='adjoint'``: an f64 epoch on the kernel path (kernels 4
   and 5 counted) against the plain path at rtol 1e-9, its seconds beside a
   ``'rev_scan'`` epoch's; (d) ``run_lm_finish`` for 20 iterations from
   phase 9's trained params, on the card and on the CPU (in the background):
   cost histories within 1e-9 or 3x the CPU's own move under one ulp of the
   params (CG on the ill-conditioned damped normal equations carries
   rounding into the steps), not increasing, at least one step taken (3
   iterations take none: lambda starts at 1e-3 and grows 3x a rejection);
   (e) a robertson epoch with a ``w_out_mask``: the pruned w_out entries
   exactly 0;
13. hybrid cases, after phase 16, each part on the card in a process of
   its own beside the other and phases 14-15 (every number of phases 1-12
   and 16 is taken before they start; the seconds of phases 13-15 are
   taken beside one another): (a) yeast at ``YeastConfig()`` (30
   experiments, 300 save points, ns=7 of 12, nr=12, f32, TRBDF2, max_steps
   384; data generated on the card): 1 guarded epoch through run_case
   with kernel 4 counted (> 0); the kernel path against the plain path on the f32 losses at the
   trained params at rtol 1e-4 or 3x the plain path's own one-ulp move
   (``f32_losses_vs_plain``), and over a whole f64 epoch at rtol 1e-9 at
   a reduced depth (4 + 2 experiments, every 5th save point, max_steps
   96, the widths kept); (b) the QSSA at ``QSSAConfig()`` (30 experiments,
   40 save points, f64, Rosenbrock23): 2 guarded epochs with kernel 4
   counted, and a whole f64 epoch kernel against plain at rtol 1e-9
   (max_steps 96);
14. single-fit cases, no kernel on their path (every count 0), on the card
   in a process of their own beside phases 13 and 15 (their CPU references
   run in the background from the start): (a) HyChem
   at ``HyChemConfig()`` (surrogate trajectory, nr=10, 40 save points,
   f64), 2 epochs through run_case on the card and on the CPU: losses and
   grad norms at 1e-9; (b) ``run_cathode`` for 2 epochs on
   ``synthetic_dsc`` from a YAML config the phase writes, on the card and
   on the CPU: the results dir (metrics, checkpoint, ``p_opt.npy``, the
   snapshot with the best losses written back), losses and grad norms at
   1e-9 or 3x the CPU's one-ulp move; (c) cathode's gradient on one short
   curve by reverse mode through the early-exit driver against
   ``torch.func.jacfwd`` at 1e-10, with the seconds of each;
15. UQ, no kernel on its path (every count 0), on the card in a process of
   its own beside phases 13-14: ``run_uq`` of ``CathodeUQConfig()``
   (100 particles, f64, batch-major Rosenbrock23 with the non-autonomous
   term, 512-step checkpointed scans) for 2 SVGD iterations, the history
   taken every iteration, and its run directory (posterior moments, the
   history tensor); the particles, losses and history against the CPU's
   run of the same (in the background from the start) per component at
   rtol 1e-9, or 3x the CPU's own move under one ulp of the particles
   (always taken) where larger; the seconds an iteration on each;
16. data parallel on a world of one (nccl, one card): (a) one per-lane f64
   case2 epoch at full width through ``run_case(dp=1)`` against the batch
   Trainer's epoch at 1e-9, kernels 1-2 counted over the dp epoch (each
   > 0); (b) one sharded SVGD step (``build_uq(dp=1)``) against the local
   step, 100 particles at a reduced 128 steps, at 1e-12;
17. compensated f32, after phase 16 and before the children of phases
   13-15, on phase 9's robertson dataset and trained params: the
   compensated-f32 batch Rosenbrock23 (``ode/compensated.py``) with every
   f on kernel 4 and every step's f0 and J from one launch of kernel 5:
   (a) ``two_sum`` on 2^20 f32 pairs on the card, s + e = a + b in f64;
   (b) f64 against ``batch_odesolve_rb23`` (dense), both on the kernels:
   n_steps exact, every lane done, ys within rtol 1e-10 / atol 1e-12; (c)
   f32 on the kernels against its plain path and against the CPU, each
   state component within 1e-4 of its largest value or 3x the plain
   path's one-ulp move, and differing from the plain f32 driver's ys; (d)
   one f32 gradient of the full-horizon loss inside
   ``infra.profiling.trace``: finite, kernels 4-5 counted (> 0) and among
   the trace's CUDA kernels, CUDA kernels per solver step printed; (e)
   ``scripts/robertson_comp32_torch.py`` at 3 epochs of lr 5e-3 a variant:
   ms per epoch and f64-judged losses (finite); (f), beside the children
   of phases 13-15: ``python -m crnn_tpu_torch.cli case1 --epochs 1`` on
   its default device and ``... cli list`` in subprocesses: exit 0, one
   metrics line.

Every kernel's row carries ``floor_ms``: the device time of one trivial
PyTorch kernel (``torch.neg`` into a buffer) on the same y, timed as the
kernel is, which says how much of the row's ``ms`` is the launch itself.
Kernel 3's row also carries ``latency_bound_ms`` (``rb23_latency_bound_ms``:
its dependent chain, counted from its source, at phase 1's latencies, over
the longest lane's steps) and ``us_per_step``.

The last lines are the card (nvidia-smi), one JSON line with every
kernel's numbers, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero before the result line. Without a CUDA card,
or run from a directory without the crnn_tpu_torch package, it fails.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import multiprocessing
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and non-tensor-core FLOP/s.
_HBM_BYTES_PER_S = 3.35e12
_PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
_TOL = {torch.float32: (1e-5, 1e-6), torch.float64: (1e-12, 1e-12)}
_EPOCH_RTOL = 1e-4
_Z_ORDERS = 2.0


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's name and, when it ends, its seconds."""
    print(f"[{name}] start", flush=True)
    t0 = time.perf_counter()
    yield
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def compare(out: torch.Tensor, ref: torch.Tensor, rtol: float, atol: float):
    """(ok, max_abs_err over finite entries): NaN positions and non-finite
    values must match exactly, finite values within atol + rtol*|ref|."""
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    if not torch.equal(nan_o, nan_r):
        return False, math.inf
    fin_o, fin_r = torch.isfinite(out), torch.isfinite(ref)
    if not torch.equal(fin_o, fin_r):
        return False, math.inf
    inf_mask = ~fin_r & ~nan_r
    if not torch.equal(out[inf_mask], ref[inf_mask]):
        return False, math.inf
    if not fin_r.any():
        return True, 0.0
    diff = (out[fin_r] - ref[fin_r]).abs()
    ok = bool((diff <= atol + rtol * ref[fin_r].abs()).all())
    return ok, float(diff.max())


def device_ms(fn, n: int = 200) -> float:
    """Device milliseconds per call: ``n`` calls captured in one CUDA graph,
    replayed after a warm-up and timed with CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (5 * n)


def floor_ms(y: torch.Tensor) -> float:
    """The launch floor of a row: device ms of one trivial kernel on ``y``
    (``torch.neg`` into a buffer), timed by ``device_ms``."""
    buf = torch.empty_like(y)
    return device_ms(lambda: torch.neg(y, out=buf))


def eager_ms(fn, n: int = 500, warmup: int = 20) -> float:
    """Milliseconds per call of eager calls back to back (host launch cost
    included), timed with CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def arrhenius_inputs(batch, dtype, gen, edges):
    """Case2-like RHS inputs on the card: species in the ranges the case2
    data span, T in [323, 343] K, weights from the case2 init. With
    ``edges`` the first rows carry the edge values."""
    from crnn_tpu_torch.transforms.p2vec import init_params_case2, p2vec_case2

    ns, nr, lb, ub = 6, 3, 1e-6, 10.0
    x = torch.rand((batch, ns), generator=gen, dtype=dtype) * 0.5
    x[:, :2] = x[:, :2] * 4.0 + 0.2
    temp = torch.rand((batch, 1), generator=gen, dtype=dtype) * 20.0 + 323.0
    y = torch.cat([x, temp], dim=1)
    if edges:
        lb_t = torch.tensor(lb, dtype=dtype)
        ub_t = torch.tensor(ub, dtype=dtype)
        for row, (col, val) in enumerate([
                (0, 1e-9), (0, lb_t), (1, 50.0), (2, 0.0), (0, math.nan),
                (1, math.inf), (3, -math.inf), (ns, math.nan), (4, -1.0),
                (0, ub_t), (ns, 0.0)]):
            y[row, col] = val
    w = p2vec_case2(init_params_case2(gen, ns, nr, dtype=dtype, device="cpu"),
                    ns, nr)
    dev = torch.device("cuda")
    return ([t.to(dev).contiguous() for t in (y, w.w_in, w.w_b, w.w_out)],
            (lb, ub))


def arrhenius_bound_ms(batch, ns, nr, dtype):
    """(bound_ms, bound_by): bytes moved (each input read once, the output
    written once) over HBM bandwidth, against the flops over the
    non-tensor-core peak; the larger wins."""
    itemsize = torch.finfo(dtype).bits // 8
    n_bytes = itemsize * (2 * batch * (ns + 1) + (ns + 1) * nr + nr + ns * nr)
    # per lane: ns logs, a (ns x nr) dot, the T feature, bias, cap, nr exps,
    # an (nr x ns) dot and one division
    flops = batch * (ns + 2 * ns * nr + 4 * nr + nr + 2 * ns * nr + 1)
    return _bound(n_bytes, flops, dtype)


def arrhenius_cond_inputs(batch, dtype, gen, shape, edges, device="cuda"):
    """Inputs of kernels 1-2 for the per-component gates of the flat lane
    tile's coverage, at ``shape`` (ns, nr): ``crnn_inputs``' orders, bias
    and stoichiometry for a cap shape, an Ea row |N(0, 1)|, species U(0,
    1.2), T in [323, 343] K, lb 1e-5, ub 10. ``edges``: False, True (the
    first rows carry phase 2's edge values, T's among them, as many as the
    batch has rows, a species index wrapping at ns) or 'exp-cap' (edge rows
    and a bias of +60). Conditioned as ``crnn_inputs`` conditions phase 7's:
    the orders' share of every finite exponent within ``_Z_ORDERS`` (the
    orders shrink where it would not), every finite uncapped exponent within
    16 (checked), w_out of one sign in f32 and at the cap, so the +60 lifts
    every finite exponent at least 12 above the cap.

    The case2 init is not used here: its Ea row and bias (both ~8, with a T
    feature of ~-1.5) put terms of ~12 into an exponent of ~-4, and in f32
    one ulp of 12 moves exp(z) by ~1e-6, so two roundings of the same sum
    may differ by the whole gate. Phase 2's checks hold the case2 weights at
    rtol 1e-5."""
    from crnn_tpu_torch import clip
    from crnn_tpu_torch.ops.crnn_kernels import _INV_R_KCAL

    (ns, nr), lb, ub = shape, 1e-5, 10.0
    w_in_x = (torch.randn((ns, nr), generator=gen, dtype=dtype).abs()
              * (0.5 / ns ** 0.5))
    w_ea = torch.randn((nr,), generator=gen, dtype=dtype).abs()
    w_b = torch.randn((nr,), generator=gen, dtype=dtype)
    w_out = torch.randn((ns, nr), generator=gen, dtype=dtype).abs()
    x = torch.rand((batch, ns), generator=gen, dtype=dtype) * 1.2
    temp = torch.rand((batch, 1), generator=gen, dtype=dtype) * 20.0 + 323.0
    y = torch.cat([x, temp], dim=1)
    if edges:
        lb_t = torch.tensor(lb, dtype=dtype)
        for row, (col, val) in enumerate([
                (0, 1e-9), (0, lb_t), (1, 50.0), (2, 0.0), (0, math.nan),
                (1, math.inf), (3, -math.inf), (None, math.nan), (4, -1.0),
                (0, ub), (None, 0.0)][:batch]):
            y[row, ns if col is None else col % ns] = val
    logx = torch.log(clip(y[:, :ns], lb, ub))
    z = logx @ w_in_x
    z_in = float(z[torch.isfinite(z)].abs().max())
    if z_in > _Z_ORDERS:
        w_in_x = w_in_x * (_Z_ORDERS / z_in)
    z = logx @ w_in_x + (_INV_R_KCAL / y[:, ns:]) * w_ea + w_b
    if float(z[torch.isfinite(z)].abs().max()) > 16.0:
        fail(f"arrhenius_cond_inputs: an exponent above 16 at {shape}")
    if dtype == torch.float32 or edges == "exp-cap":
        w_out = w_out.abs()
    if edges == "exp-cap":
        w_b = w_b + 60.0
    w_in = torch.cat([w_in_x, w_ea[None, :]], dim=0)
    return ([t.to(device).contiguous() for t in (y, w_in, w_b, w_out)],
            (lb, ub))


def arrhenius_coverage(jac: bool, gen):
    """The flat lane tile of kernel 1 (kernel 2 with ``jac``) against its
    plain version beyond phase 2's inputs: B in {1, 20, 21, 30, 33, 4099},
    at case2's shape (6, 3) and the caps (32, 32), (1, 32), (32, 1), f32
    and f64, plain, edge and exp-cap inputs from ``arrhenius_cond_inputs``:
    NaN and inf positions exact, finite values within 2e-6 (f32) or 1e-12
    (f64) of each output component's largest value over the lanes. Fails
    the run on a miss; prints the largest error over its component's scale
    for each shape and dtype."""
    from crnn_tpu_torch.ops.crnn_kernels import (
        arrhenius_rhs_batched, arrhenius_rhs_batched_reference,
        arrhenius_rhs_jac_batched, arrhenius_rhs_jac_batched_reference,
        tile_geometry)

    name = "arrhenius_rhs_jac" if jac else "arrhenius_rhs"
    kernel, plain = ((arrhenius_rhs_jac_batched,
                      arrhenius_rhs_jac_batched_reference) if jac else
                     (arrhenius_rhs_batched, arrhenius_rhs_batched_reference))
    tol = {torch.float32: 2e-6, torch.float64: 1e-12}
    for shape in ((6, 3), (32, 32), (1, 32), (32, 1)):
        for dtype in (torch.float32, torch.float64):
            worst = 0.0
            for batch in (1, 20, 21, 30, 33, 4099):
                for edges in (False, True, "exp-cap"):
                    args, (lb, ub) = arrhenius_cond_inputs(batch, dtype, gen,
                                                           shape, edges)
                    outs, refs = (kernel(*args, lb, ub), plain(*args, lb, ub))
                    torch.cuda.synchronize()
                    if not jac:
                        outs, refs = (outs,), (refs,)
                    for o, r in zip(outs, refs):
                        ok, err, rel = compare_components(o, r, tol[dtype])
                        if not ok:
                            fail(f"{name} disagrees with its plain version: "
                                 f"{shape} B={batch} {dtype} edges={edges}: "
                                 f"max abs err {err:.3e}")
                        worst = max(worst, rel)
                ns, nr = args[3].shape
                geo = tile_geometry(batch, ns, nr, args[0].element_size(),
                                    jac, temperature=True)
                print(f"  {name} {shape} {str(dtype)[6:]} B={batch}: plain, "
                      f"edges, exp cap: ok (lanes, threads: {geo})")
            print(f"  {name} {shape} {str(dtype)[6:]}: largest error over its "
                  f"component's largest value {worst:.3e} (gate "
                  f"{tol[dtype]:.0e})")


def time_arrhenius_f64(jac: bool, gen) -> dict:
    """Kernel 1 (kernel 2 with ``jac``), its plain version and the launch
    floor in f64 at B=30, timed as the f32 rows are."""
    from crnn_tpu_torch.ops.crnn_kernels import (
        arrhenius_rhs_batched, arrhenius_rhs_batched_reference,
        arrhenius_rhs_jac_batched, arrhenius_rhs_jac_batched_reference)

    kernel, plain = ((arrhenius_rhs_jac_batched,
                      arrhenius_rhs_jac_batched_reference) if jac else
                     (arrhenius_rhs_batched, arrhenius_rhs_batched_reference))
    (y, w_in, w_b, w_out), (lb, ub) = arrhenius_inputs(30, torch.float64, gen,
                                                       False)
    row = {"ms": device_ms(lambda: kernel(y, w_in, w_b, w_out, lb, ub)),
           "plain_ms": device_ms(lambda: plain(y, w_in, w_b, w_out, lb, ub)),
           "floor_ms": floor_ms(y)}
    bound, bound_by = (rhs_jac_bound_ms if jac else arrhenius_bound_ms)(
        30, 6, 3, torch.float64)
    print(f"  {'arrhenius_rhs_jac' if jac else 'arrhenius_rhs'} B=30 f64 "
          f"ms/call: kernel_device={row['ms']:.5f}, plain_device="
          f"{row['plain_ms']:.5f}, floor_device={row['floor_ms']:.5f}, "
          f"bound={bound:.3e} ({bound_by})")
    return {**row, "bound_ms": bound, "bound_by": bound_by}


def run_slice(device: str, gen: torch.Generator):
    """Phase 3 on ``device``: the case2 main path and its checks. Returns
    the kernel row's main-path numbers (launches, epoch times), the setup
    and the trained params."""
    from crnn_tpu_torch.cases.base import run_case
    from crnn_tpu_torch.cases.case2 import Case2Config, build
    from crnn_tpu_torch.data.truth import (CASE2_EA, CASE2_LOGA,
                                           case2_arrhenius, case2_truth,
                                           case2_truth_jac)
    from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
    from crnn_tpu_torch.ops.crnn_kernels import arrhenius_rhs_batched

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    row = {}
    cfg = Case2Config(device=device)
    n_epoch = 3
    arrhenius_rhs_batched.launches = 0
    t0 = time.perf_counter()
    setup = build(cfg)
    sync()
    t_build = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as out_dir:
        state, hist = run_case(setup, n_epoch, out_dir=out_dir, log_every=1)
        n_lines = len((Path(out_dir) / "case2" / "metrics.jsonl")
                      .read_text().splitlines())
    sync()
    launches = arrhenius_rhs_batched.launches
    print(f"  build (data on the card): {t_build:.2f} s; epochs_s="
          f"{hist['epoch_s']}; launches={launches} "
          f"({launches / n_epoch:.0f}/epoch)")
    ds = setup.dataset
    if tuple(ds.ys.shape) != (cfg.n_exp, cfg.datasize, cfg.ns):
        fail(f"dataset shape {tuple(ds.ys.shape)}")
    if not (bool(ds.success.all()) and bool(torch.isfinite(ds.ys).all())):
        fail("truth solve failed or produced non-finite data")
    if n_lines != n_epoch:
        fail(f"metrics.jsonl has {n_lines} lines, expected {n_epoch}")
    for k in ("loss_train", "loss_val", "grad_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            fail(f"non-finite {k}: {hist[k]}")
    if hist["n_skipped"]:
        fail(f"{hist['n_skipped']} epochs discarded by the NaN guard")
    if not hist["loss_train"][-1] < hist["loss_train"][0]:
        fail(f"the training loss did not decrease: {hist['loss_train']}")
    if launches == 0:
        fail("the main path launched the arrhenius_rhs kernel 0 times")
    row["launches"] = launches
    row["launches_per_epoch"] = launches / n_epoch
    row["epoch_s"] = hist["epoch_s"]

    # the card's f32 truth against an f64 re-solve on the CPU
    u0 = ds.u0.double().cpu()
    k = case2_arrhenius(torch.tensor(CASE2_LOGA, dtype=torch.float64),
                        torch.tensor(CASE2_EA, dtype=torch.float64), u0[:, -1])
    with torch.no_grad():
        ref = batch_odesolve_rb23(
            case2_truth, case2_truth_jac, u0, 0.0, float(cfg.datasize),
            ds.ts.double().cpu(), args=k, rtol=1e-6, atol=1e-9,
            max_steps=16384, unroll="while", jac_mode="dense")
    scale = ref.ys[..., :cfg.ns].abs().amax(dim=(0, 1))
    truth_err = float(((ds.ys_clean.double().cpu() - ref.ys[..., :cfg.ns])
                       .abs() / scale).max())
    print(f"  truth (f32 on the card) vs f64 CPU re-solve: max error "
          f"{truth_err:.3e} of the per-species scale")
    if not truth_err < 1e-3:
        fail(f"truth data disagree with the f64 re-solve: {truth_err}")

    # The kernel path against the plain path on the same inputs. In f32 the
    # step sequence of the adaptive solve follows rounding: a one-ulp change
    # of the params moves the epoch gradient by percents (the probe below
    # prints it), while the losses move by ~1e-6. So f32 compares the
    # losses, and a whole epoch (loss, grad, eval losses) is compared in
    # f64, where the same probe moves the gradient by ~1e-15.
    p0 = setup.init_params
    perm = torch.randperm(cfg.n_exp_train, generator=gen).to(device)
    plain = build(Case2Config(device=device, rhs_plain=True), dataset=ds)
    f32 = [forward_losses(s, p0, perm) for s in (setup, plain)]
    compare_epoch("f32 train loss", f32[0][0], f32[1][0])
    compare_epoch("f32 eval losses", f32[0][1], f32[1][1])
    _, g_a = plain.trainer.value_and_grad(p0, perm)
    _, g_b = plain.trainer.value_and_grad(
        torch.nextafter(p0, p0 + math.inf), perm)
    print(f"  f32 conditioning probe (plain path, params moved by one ulp): "
          f"grad moves by {float((g_a - g_b).abs().max() / g_a.abs().max()):.3e}"
          f" of its largest entry")

    ds64 = ds._replace(**{k: getattr(ds, k).double() for k in (
        "u0", "ys", "ys_clean", "ts", "yscale")})
    p64 = p0.double()
    results = []
    for plain_rhs in (False, True):
        s = build(Case2Config(device=device, dtype="float64",
                              rhs_plain=plain_rhs), dataset=ds64)
        loss, g = s.trainer.value_and_grad(p64, perm)
        sync()
        t0 = time.perf_counter()
        _, m = s.trainer.epoch(s.trainer.init(p64), perm)
        sync()
        results.append((loss, g, m, time.perf_counter() - t0))
    (lk, gk, mk, tk), (lp, gp, mp, tp) = results
    print(f"  f64 epoch s: kernel path {tk:.3f}, plain path {tp:.3f}")
    compare_epoch("f64 loss", lk, lp)
    compare_epoch("f64 grad", gk, gp)
    compare_epoch("f64 eval losses", mk.loss_exp, mp.loss_exp)
    compare_epoch("f64 grad norm", mk.grad_norm, mp.grad_norm)
    return row, setup, state.params


def forward_losses(setup, params, perm):
    """(mean training loss through the scan, eval losses through the
    early-exit solve) at ``params``, without gradients."""
    dev = params.device
    trainer = setup.trainer
    with torch.no_grad():
        train = trainer.loss_batch(
            params, perm, torch.ones((perm.shape[0], trainer.n_save),
                                     dtype=params.dtype, device=dev)).mean()
        evals = trainer.loss_batch_eval(
            params, torch.arange(trainer.n_exp, device=dev),
            torch.ones((trainer.n_exp, trainer.n_save), dtype=params.dtype,
                       device=dev))
    return train, evals


def within(a, b, rtol) -> bool:
    """Finite, and each entry of ``a`` within ``rtol`` of ``b``'s plus
    ``rtol`` of ``b``'s largest entry (a gradient component can be ~0)."""
    return bool(torch.isfinite(a).all()) and bool(
        ((a - b).abs() <= rtol * (b.abs() + b.abs().max())).all())


def compare_epoch(name, a, b, what="kernel", against="plain",
                  rtol=_EPOCH_RTOL):
    """The ``what`` path's ``a`` against the ``against`` path's ``b``
    (default: kernel path against plain path) ``within`` ``rtol`` (1e-4);
    fails the run if they disagree."""
    rel = float(((a - b).abs() / b.abs().max()).max())
    ok = within(a, b, rtol)
    print(f"  {what} vs {against} {name}: max rel err {rel:.3e} ok={ok}")
    if not ok:
        fail(f"{what} path {name} disagrees with the {against} path")


def rhs_jac_bound_ms(batch, ns, nr, dtype):
    """(bound_ms, bound_by) of the fused value+Jacobian: y, weights read
    once, du and J written once, against its flops."""
    itemsize = torch.finfo(dtype).bits // 8
    ns1 = ns + 1
    n_bytes = itemsize * (batch * (2 * ns1 + ns1 * ns1)
                          + ns1 * nr + nr + ns * nr)
    # per lane: the RHS as in kernel 1, dlog (ns divisions), dt_feat (2),
    # rates * w_out (ns*nr), the x-block (ns*ns*(2*nr + 1)) and the T column
    # (ns*(3*nr + 1))
    rhs = ns + 2 * ns * nr + 4 * nr + nr + 2 * ns * nr + 1
    flops = batch * (rhs + ns + 2 + ns * nr + ns * ns * (2 * nr + 1)
                     + ns * (3 * nr + 1))
    return _bound(n_bytes, flops, dtype)


def rb23_step_flops(ns, nr):
    """Flops of one lane's Rosenbrock23 step in the whole-solve kernel:
    three RHS evaluations, the factors and the Woodbury inner matrix, its
    Gauss-Jordan inverse, three W-solves, the stage combinations, the error
    norm and the controller (transcendentals count as one)."""
    ns1 = ns + 1
    rhs = ns + 2 * ns * nr + 5 * nr + 2 * ns * nr + 1
    factors = 2 * ns + 3 + nr * nr * (2 * ns + 3)
    inverse = nr * (1 + 2 * nr + (nr - 1) * 4 * nr)
    wsolve = ns + 2 * ns * nr + 4 * nr + 2 * nr * nr + 2 * ns * nr + 2 * ns
    stages = 2 * ns1 + 2 * ns1 + 2 * ns1 + 6 * ns1 + 5 * ns1
    norm = 6 * ns1 + 2
    return 3 * rhs + factors + inverse + 3 * wsolve + stages + norm + 12


def rb23_bound_ms(n_steps, ns, nr, dtype):
    """(bound_ms, bound_by) of the whole solve for this run's data: y0 and
    the weights read once; the history rows the lanes visit (t, t_new, acc
    and y, y_new, f0, f2), status, n_steps and y_final written once; the
    flops of the steps the lanes take plus the initial-dt probe."""
    itemsize = torch.finfo(dtype).bits // 8
    ns1 = ns + 1
    b = n_steps.numel()
    steps = int(n_steps.sum())
    n_bytes = (itemsize * (b * ns1 + ns1 * nr + nr + ns * nr)
               + itemsize * steps * (3 + 4 * ns1) + b * (8 + itemsize * ns1))
    rhs = ns + 2 * ns * nr + 5 * nr + 2 * ns * nr + 1
    flops = steps * rb23_step_flops(ns, nr) + b * (2 * rhs + 12 * ns1 + 20)
    return _bound(n_bytes, flops, dtype)


_LATENCY_OPS = ("fma", "div", "sqrt", "exp", "log", "pow", "shfl", "max")
# each chain's start and constants (ops/csrc/latency_probe.cu): x0, a, b
_LATENCY_ARGS = {"fma": (0.0, 0.5, 0.5), "div": (1.5, 2.0, 0.0),
                 "sqrt": (2.0, 0.0, 0.0), "exp": (0.5, 0.0, 0.0),
                 "log": (0.5, 0.0, 0.0), "pow": (0.5, 0.5, 0.0),
                 "shfl": (1.0, 0.0, 0.0), "max": (0.0, 1.0, 0.0)}


def op_latencies(dtype) -> dict:
    """Nanoseconds of one dependent operation of each class on the card:
    one warp runs a chain of 2^13 and of 2^16 operations
    (``ops/csrc/latency_probe.cu``), each launch timed with CUDA events;
    the smaller of three differences over the difference of lengths."""
    import ctypes

    from crnn_tpu_torch.ops import _build

    fn = getattr(_build.load("latency_probe"),
                 f"latency_chain_{'f32' if dtype == torch.float32 else 'f64'}")
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_double] * 3 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(32, dtype=dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    short, long_ = 1 << 13, 1 << 16

    def timed(op, n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = fn(op, n, *_LATENCY_ARGS[_LATENCY_OPS[op]], out.data_ptr(),
                stream)
        stop.record()
        torch.cuda.synchronize()
        if rc != 0:
            fail(f"latency probe launch failed: cudaError {rc}")
        return start.elapsed_time(stop)

    lat = {}
    for op, name in enumerate(_LATENCY_OPS):
        timed(op, short)
        lat[name] = min(timed(op, long_) - timed(op, short)
                        for _ in range(3)) / (long_ - short) * 1e6
    if not all(math.isfinite(v) and v > 0 for v in lat.values()):
        fail(f"latency probe: {lat}")
    return lat


def rb23_chain(ns, nr, lat):
    """(init, period): the dependent chains of the whole-solve kernel
    (``ops/csrc/arrh_rb23_solve.cu``, lane groups), counted from its source
    as Counters of operation classes (``_LATENCY_OPS``; ``max`` is a
    compare-and-select, ``fma`` also an add or a multiply) along the longest
    path at the latencies ``lat``. ``init`` is Hairer's initial dt up to the
    first step's dt; ``period`` the longer of a step's two cycles: y to the
    next y (rhs, Woodbury inverse, three stages, error norm, accept), and
    hd to the next hd (the inverse's last FMA, Gauss-Jordan, the stages,
    the norm, pow and the controller). Stores, loads and the finite-check
    vote are off the chain; a shuffle's partners are assumed ready."""
    from collections import Counter as C

    def longest(*paths):
        return max(paths, key=lambda p: sum(lat[k] * v for k, v in p.items()))

    ns1 = ns + 1
    # rhs: the clipped log (its gather and the ns-term sum) beside the T
    # feature (a gather and a division), the Ea and bias terms, the cap,
    # exp, the rates' gather and the nr-term sum, the T row's select
    rate = (longest(C(max=2, log=1, shfl=1, fma=ns), C(shfl=1, div=1))
            + C(fma=2, max=1, exp=1))
    du = rate + C(shfl=1, fma=nr, max=1)
    fac = C(max=3, div=1)                         # dlog or dt_feat
    rms = C(shfl=1, fma=ns1, div=1, sqrt=1)       # gather, ns+1 sum, mean
    gj = C(shfl=1, div=nr, fma=2 * nr)            # broadcast M, invert
    ws_pre = C(fma=ns + 3, shfl=2)                # v*fac, gather, sum, s
    ws_post = C(fma=2 * nr + 1, max=1)            # M^-1 s, U x, v + hd u
    # from M^-1 (and k1's s) to err: k1, stage 2, k2, y1, stage 3, k3,
    # y_err, the ratio and its finite select, the norm, the ok select
    stages = (ws_post + C(fma=1) + du + C(fma=1) + ws_pre + ws_post
              + C(fma=2) + du + C(fma=2) + ws_pre + ws_post
              + C(fma=2, div=1, max=1) + rms + C(max=1))
    minv_y = longest(rate, fac + C(shfl=1, fma=ns)) + C(fma=2) + gj
    k1_in = longest(minv_y, longest(du, fac) + ws_pre)
    y_cycle = k1_in + stages + C(max=2)           # accept, y = y1
    # errc, pow, safety, clip, dt*factor; dt clip and hd of the next step;
    # the inverse's last FMA
    hd_cycle = C(fma=1) + gj + stages + C(max=5, pow=1, fma=3)
    init = (du + C(div=1) + rms + C(max=3, div=1, fma=1) + du
            + C(fma=1, div=1) + rms + C(div=2, max=5, pow=1))
    return init, longest(y_cycle, hd_cycle)


def rb23_latency_bound_ms(longest_steps, ns, nr, lat):
    """(latency_bound_ms, init Counter, period Counter): the initial-dt
    chain plus the longest lane's steps times a step's period, at the
    latencies ``lat`` (ns per operation class, ``op_latencies``)."""
    init, period = rb23_chain(ns, nr, lat)

    def ns_of(path):
        return sum(lat[k] * v for k, v in path.items())

    return ((ns_of(init) + longest_steps * ns_of(period)) * 1e-6, init,
            period)


def _bound(n_bytes, flops, dtype):
    t_bytes = n_bytes / _HBM_BYTES_PER_S * 1e3
    t_flops = flops / _PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def check_rhs_jac_kernel(gen) -> dict:
    """Kernel 2 against its plain version on the card, as kernel 1 is held
    in phase 2, then its device time. Returns its row's numbers."""
    from crnn_tpu_torch.ops.crnn_kernels import (
        arrhenius_rhs_jac_batched, arrhenius_rhs_jac_batched_reference)

    row = {}
    cases = [(b, torch.float32) for b in (20, 30, 4099, 65536)]
    cases.append((30, torch.float64))
    for batch, dtype in cases:
        rtol, atol = _TOL[dtype]
        for edges in (False, True, "exp-cap"):
            (y, w_in, w_b, w_out), (lb, ub) = arrhenius_inputs(
                batch, dtype, gen, bool(edges))
            if edges == "exp-cap":
                # every rate above exp(32), w_out of one sign (as in phase 2)
                w_b, w_out = w_b + 40.0, w_out.abs()
            out = arrhenius_rhs_jac_batched(y, w_in, w_b, w_out, lb, ub)
            ref = arrhenius_rhs_jac_batched_reference(y, w_in, w_b, w_out,
                                                      lb, ub)
            torch.cuda.synchronize()
            (ok_du, err_du), (ok_j, err_j) = (compare(o, r, rtol, atol)
                                              for o, r in zip(out, ref))
            err = max(err_du, err_j)
            print(f"  arrhenius_rhs_jac B={batch} {str(dtype)[6:]} "
                  f"edges={edges}: max_abs_err du={err_du:.3e} "
                  f"J={err_j:.3e} ok={ok_du and ok_j}")
            if not (ok_du and ok_j):
                fail(f"arrhenius_rhs_jac disagrees with its plain version at "
                     f"B={batch} {dtype} edges={edges}")
            if batch == 20 and dtype == torch.float32 and edges is False:
                row["max_abs_err"] = err
    for batch in (20, 30, 4099, 65536):
        (y, w_in, w_b, w_out), (lb, ub) = arrhenius_inputs(
            batch, torch.float32, gen, False)
        times = {
            "kernel_device": device_ms(lambda: arrhenius_rhs_jac_batched(
                y, w_in, w_b, w_out, lb, ub)),
            "plain_device": device_ms(
                lambda: arrhenius_rhs_jac_batched_reference(
                    y, w_in, w_b, w_out, lb, ub)),
            "kernel_eager": eager_ms(lambda: arrhenius_rhs_jac_batched(
                y, w_in, w_b, w_out, lb, ub)),
            "plain_eager": eager_ms(
                lambda: arrhenius_rhs_jac_batched_reference(
                    y, w_in, w_b, w_out, lb, ub)),
            "floor_device": floor_ms(y),
        }
        bound, bound_by = rhs_jac_bound_ms(batch, 6, 3, torch.float32)
        print(f"  arrhenius_rhs_jac B={batch} f32 ms/call: " + ", ".join(
            f"{k}={v:.5f}" for k, v in times.items())
            + f", bound={bound:.3e} ({bound_by})")
        if batch == 20:
            row.update(ms=times["kernel_device"],
                       plain_ms=times["plain_device"],
                       ms_eager=times["kernel_eager"],
                       plain_ms_eager=times["plain_eager"], bound_ms=bound,
                       bound_by=bound_by, floor_ms=times["floor_device"])
    return row


def case2_solve_kwargs(cfg):
    """The whole-solve kernel's solver arguments for ``cfg``."""
    return dict(max_steps=cfg.max_steps, t0=0.0,
                t1=float(cfg.datasize * cfg.tstep), rtol=cfg.rtol,
                atol=cfg.atol, lb=cfg.lb, ub=cfg.ub)


def while_solve(cfg, u0, w, saveat):
    """The port's early-exit eval solve (kernel 1, lowrank) -> (ys, success)."""
    from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
    from crnn_tpu_torch.ops.crnn_kernels import (make_arrhenius_factor_op,
                                                 make_arrhenius_ops)

    rhs_op, _ = make_arrhenius_ops(cfg.lb, cfg.ub)
    factor_op = make_arrhenius_factor_op(cfg.lb, cfg.ub)
    consts = case2_solve_kwargs(cfg)
    with torch.no_grad():
        sol = batch_odesolve_rb23(
            lambda t, y, w_: rhs_op(y, w_.w_in, w_.w_b, w_.w_out),
            lambda t, y, w_: factor_op(y, w_.w_in, w_.w_b, w_.w_out),
            u0, 0.0, consts["t1"], saveat, args=w, rtol=cfg.rtol,
            atol=cfg.atol, max_steps=cfg.max_steps, unroll="while",
            jac_mode="lowrank")
    return sol.ys, sol.success


def rel_err_components(a, b):
    """Largest error of each state component over that component's largest
    value, over lanes and save points. The T column is constant at ~330 K,
    so a ratio over the largest entry of all would let the species (0-2.2)
    be off by ~0.17."""
    return float(((a - b).abs().amax(dim=(0, 1))
                  / b.abs().amax(dim=(0, 1))).max())


def solve_kernel_vs_plain(u0, w, saveat, consts, label, quiet=False):
    """Kernel 3 (histories filled with NaN first) against its plain version
    on the same inputs; fails the run if they disagree: in f32 ys within
    5e-4 of each state component's largest value and success equal (the
    step sequence follows rounding); in f64 n_steps and status exact and ys
    within 1e-9 of each component's largest value. Returns (max abs error
    of ys, kernel outputs, kernel ys, plain ys, the error over each
    component's largest); ``quiet`` prints only a failure."""
    from crnn_tpu_torch.ops.rb23_solve_kernel import (
        _dense_output, arrh_rb23_solve, arrh_rb23_solve_reference)

    out = arrh_rb23_solve(u0, w.w_in, w.w_b, w.w_out, hist_fill=math.nan,
                          **consts)
    ref = arrh_rb23_solve_reference(u0, w.w_in, w.w_b, w.w_out, **consts)
    ys = _dense_output(saveat, 0.0, u0, *out[:7])
    ys_ref = _dense_output(saveat, 0.0, u0, *ref[:7])
    torch.cuda.synchronize()
    ok = bool(torch.isfinite(ys).all()) and torch.equal(out[7] == 1,
                                                         ref[7] == 1)
    rel_c = rel_err_components(ys, ys_ref)
    if u0.dtype == torch.float32:
        ok = ok and rel_c < 5e-4
    else:
        ok = (ok and torch.equal(out[7], ref[7]) and torch.equal(out[8], ref[8])
              and rel_c < 1e-9)
    err = float((ys - ys_ref).abs().max())
    if quiet and ok:
        return err, out, ys, ys_ref, rel_c
    print(f"  arrh_rb23_solve {label} {str(u0.dtype)[6:]} vs plain: "
          f"ys max err {rel_c:.3e} of each component's largest (max abs "
          f"{err:.3e}), n_steps "
          f"{int(out[8].min())}-{int(out[8].max())} (plain "
          f"{int(ref[8].min())}-{int(ref[8].max())}), success "
          f"{int((out[7] == 1).sum())}/{u0.shape[0]} ok={ok}")
    if not ok:
        fail(f"arrh_rb23_solve disagrees with its plain version ({label}, "
             f"{u0.dtype})")
    return err, out, ys, ys_ref, rel_c


def solve_inputs(batch, ns, nr, dtype, seed=0, device="cuda"):
    """Kernel 3's coverage inputs on ``device``, the draws of
    ``tests/test_torch_gpu.py:_solve_case``: two species in [0.2, 2.2] (one
    at ns = 1), T in [323, 343] K, weights from ``p2vec_case2`` of the
    reference init. At case2's shape the log rate constants are raised by
    1.3 so that steps get rejected; at the other shapes the init's +0.8
    with half its spread (0.05) conditions the solve: one ulp of y0 moves
    the plain f64 solve by at most 2.2e-13 of a component's largest value
    over every (ns, nr) within the caps at B=30, and 2.2e-14 at B=4099
    (one-ulp witness, plain version on the CPU), where the f64 gate is
    1e-9."""
    import numpy as np

    from crnn_tpu_torch.transforms.p2vec import p2vec_case2

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
    w = p2vec_case2(torch.from_numpy(p).to(device, dtype), ns, nr)
    return torch.from_numpy(u0).to(device, dtype), w


def solve_coverage(consts):
    """Kernel 3's lane groups against its plain version at the gates of
    ``solve_kernel_vs_plain``: B in {1, 30, 31, 33, 4099} at case2's shape
    (6, 3), the compiled path, and at (1, 1), (3, 2), (7, 4) and (8, 4),
    the runtime path; then every (ns, nr) within the caps at B=3; f32 and
    f64. The one-ulp witness at B=4099 f64 of each runtime shape. One line
    per shape and dtype: the error over each component's largest, by B."""
    saveat = torch.linspace(0.0, consts["t1"], 50, device="cuda")
    for shape in ((6, 3), (1, 1), (3, 2), (7, 4), (8, 4)):
        for dtype in (torch.float32, torch.float64):
            errs = []
            for batch in (1, 30, 31, 33, 4099):
                u0, w = solve_inputs(batch, *shape, dtype)
                _, out, ys, ys_ref, rel = solve_kernel_vs_plain(
                    u0, w, saveat.to(dtype), consts, f"B={batch} {shape}",
                    quiet=True)
                errs.append(f"B={batch} {rel:.3e} (steps "
                            f"{int(out[8].min())}-{int(out[8].max())})")
                if batch == 4099 and dtype == torch.float64 and shape != (6, 3):
                    ulp_witness(u0, w, saveat.to(dtype), consts, ys, ys_ref)
            print(f"  arrh_rb23_solve {shape} {str(dtype)[6:]} vs plain, "
                  f"error over each component's largest: " + ", ".join(errs))
    worst = {}
    for dtype in (torch.float32, torch.float64):
        for ns in range(1, 9):
            for nr in range(1, 5):
                u0, w = solve_inputs(3, ns, nr, dtype)
                rel = solve_kernel_vs_plain(u0, w, saveat.to(dtype), consts,
                                            f"B=3 ({ns}, {nr})", quiet=True)[4]
                worst[dtype] = max(worst.get(dtype, (0.0, None)),
                                   (rel, (ns, nr)), key=lambda x: x[0])
    print("  arrh_rb23_solve every (ns, nr) within the caps at B=3 vs plain: "
          "ok, worst error over each component's largest " + ", ".join(
              f"{str(dtype)[6:]} {rel:.3e} at {shape}"
              for dtype, (rel, shape) in worst.items()))


def ulp_witness(u0, w, saveat, consts, ys_kernel, ys_plain):
    """How far one ulp of y0 moves the plain f64 solve, printed beside the
    kernel's distance from the plain version (no gate): the stiff W-solve
    amplifies a one-ulp difference, of y0 here and of exp/log/pow between
    CUDA and torch in the kernel, to the same order."""
    from crnn_tpu_torch.ops.rb23_solve_kernel import (
        _dense_output, arrh_rb23_solve_reference)

    nudged = torch.nextafter(u0, u0.new_full((), math.inf))
    out = arrh_rb23_solve_reference(nudged, w.w_in, w.w_b, w.w_out, **consts)
    ys_nudged = _dense_output(saveat, 0.0, nudged, *out[:7])

    def species_err(a, b):  # T moves by its own ulp in the nudged y0
        err = (a - b)[..., :-1].abs().amax(dim=(1, 2))
        return (f"{rel_err_components(a, b):.3e} of each component's largest"
                f" (species max abs {float(err.max()):.3e}, worst lanes "
                f"{sorted(torch.topk(err, 5).indices.tolist())})")

    print(f"  f64 one-ulp witness B={u0.shape[0]}: plain(y0 + 1 ulp) vs "
          f"plain(y0) {species_err(ys_nudged, ys_plain)}; kernel vs plain "
          f"{species_err(ys_kernel, ys_plain)}")


def check_solve_kernel(setup, gen, lat) -> dict:
    """Kernel 3 against its plain version and the while driver on case2's
    30 initial states at the initial params, then at B=4099 (f32 and f64,
    with the one-ulp witness), then its lane-group coverage
    (``solve_coverage``), then its device time at B=30 (f32 and f64) and at
    B=4099 (f32) beside its bounds: bytes and operations, and its dependent
    chain at the latencies ``lat`` ({dtype: ns per class}). Returns its
    row's numbers."""
    from crnn_tpu_torch.cases.case2 import Case2Config, make_u0
    from crnn_tpu_torch.ops.rb23_solve_kernel import (
        arrh_rb23_solve, arrh_rb23_solve_reference, make_arrhenius_fused_solve)

    row, n_steps = {}, {}
    cfg = Case2Config()
    consts = case2_solve_kwargs(cfg)
    ds = setup.dataset
    for dtype in (torch.float32, torch.float64):
        u0 = ds.u0.to(dtype).contiguous()
        w = setup.weights_fn(setup.init_params.to(dtype))
        err, out = solve_kernel_vs_plain(u0, w, ds.ts.to(dtype), consts,
                                         "case2 u0, initial params")[:2]
        n_steps[dtype] = out[8]
        if dtype == torch.float32:
            row["max_abs_err"] = err
    u0, w = ds.u0.contiguous(), setup.weights_fn(setup.init_params)
    fused = make_arrhenius_fused_solve(cfg.ns, cfg.nr, cfg.lb, cfg.ub, 0.0,
                                       consts["t1"], ds.ts, cfg.rtol, cfg.atol,
                                       cfg.max_steps)
    ys_f, ok_f = fused(u0, w)
    ys_w, ok_w = while_solve(cfg, u0, w, ds.ts)
    rel = rel_err_components(ys_f, ys_w)
    ok = rel < 5e-4 and torch.equal(ok_f, ok_w)
    print(f"  fused solve vs while driver (initial params): max err "
          f"{rel:.3e} of each component's largest, success "
          f"{int(ok_f.sum())}/{int(ok_w.sum())} ok={ok}")
    if not ok:
        fail("the fused solve disagrees with the while driver")

    big = make_u0(gen, Case2Config(n_exp_train=4099, n_exp_test=0),
                  torch.float32).cuda()
    solve_kernel_vs_plain(big, w, ds.ts, consts, "B=4099")
    big64, w64, ts64 = big.double(), setup.weights_fn(
        setup.init_params.double()), ds.ts.double()
    ys64, ys64_ref = solve_kernel_vs_plain(big64, w64, ts64, consts,
                                           "B=4099")[2:4]
    ulp_witness(big64, w64, ts64, consts, ys64, ys64_ref)
    solve_coverage(consts)

    def kernel(y, w_):
        return lambda: arrh_rb23_solve(y, w_.w_in, w_.w_b, w_.w_out, **consts)

    def plain():
        return arrh_rb23_solve_reference(u0, w.w_in, w.w_b, w.w_out, **consts)

    u0_64, w_64 = u0.double(), setup.weights_fn(setup.init_params.double())
    times = {"kernel_device": device_ms(kernel(u0, w), n=20),
             "kernel_device_f64": device_ms(kernel(u0_64, w_64), n=20),
             "kernel_device_b4099": device_ms(kernel(big, w), n=20),
             "kernel_eager": eager_ms(kernel(u0, w), n=50, warmup=5),
             "plain_eager": eager_ms(plain, n=5, warmup=2),
             "floor_device": floor_ms(u0)}
    bound, bound_by = rb23_bound_ms(n_steps[torch.float32], cfg.ns, cfg.nr,
                                    torch.float32)
    longest = int(n_steps[torch.float32].max())
    lat_bound, init, period = rb23_latency_bound_ms(longest, cfg.ns, cfg.nr,
                                                    lat[torch.float32])
    longest64 = int(n_steps[torch.float64].max())
    lat_bound64 = rb23_latency_bound_ms(longest64, cfg.ns, cfg.nr,
                                        lat[torch.float64])[0]
    us_per_step = times["kernel_device"] / longest * 1e3
    print(f"  arrh_rb23_solve B=30 f32 ms/call: " + ", ".join(
        f"{k}={v:.5f}" for k, v in times.items())
        + f", bound={bound:.3e} ({bound_by}); serial chain: the longest lane "
        f"takes {longest} steps (f64 {longest64}), {us_per_step:.3f} us of "
        f"kernel time per step; steps summed over lanes "
        f"{int(n_steps[torch.float32].sum())}")
    print(f"  arrh_rb23_solve latency bound B=30 f32 {lat_bound:.5f} ms (f64 "
          f"{lat_bound64:.5f} ms): initial dt {dict(sorted(init.items()))}, a "
          f"step {dict(sorted(period.items()))}; ns per operation f32 "
          + json.dumps({k: round(v, 3) for k, v in lat[torch.float32].items()}))
    print("  plain_ms of arrh_rb23_solve is eager (host clock included): the "
          "plain version checks on the host once per step whether a lane "
          "still runs, so it cannot be captured in a CUDA graph")
    row.update(ms=times["kernel_device"], plain_ms=times["plain_eager"],
               ms_eager=times["kernel_eager"], bound_ms=bound,
               bound_by=bound_by, latency_bound_ms=lat_bound,
               us_per_step=us_per_step, longest_lane_steps=longest,
               floor_ms=times["floor_device"],
               ms_f64=times["kernel_device_f64"],
               latency_bound_ms_f64=lat_bound64,
               ms_b4099=times["kernel_device_b4099"])
    return row


def run_dense_slice(ds, gen) -> dict:
    """Phase 5: case2 with jac_mode='dense' as shipped on the card, its
    launches, and the kernel path against the plain path."""
    from crnn_tpu_torch.cases.base import run_case
    from crnn_tpu_torch.cases.case2 import Case2Config, build
    from crnn_tpu_torch.ops.crnn_kernels import (arrhenius_rhs_batched,
                                                 arrhenius_rhs_jac_batched)

    cfg = Case2Config(jac_mode="dense")
    n_epoch = 2
    setup = build(cfg, dataset=ds)
    arrhenius_rhs_batched.launches = 0
    arrhenius_rhs_jac_batched.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        state, hist = run_case(setup, n_epoch, out_dir=out_dir, log_every=1)
    torch.cuda.synchronize()
    launches = arrhenius_rhs_jac_batched.launches
    print(f"  dense: epochs_s={hist['epoch_s']}; arrhenius_rhs_jac launches="
          f"{launches} ({launches / n_epoch:.0f}/epoch), arrhenius_rhs "
          f"launches={arrhenius_rhs_batched.launches}")
    if launches == 0 or arrhenius_rhs_batched.launches == 0:
        fail("the dense slice launched a kernel of its path 0 times")
    for k in ("loss_train", "loss_val", "grad_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            fail(f"dense slice: non-finite {k}: {hist[k]}")
    if hist["n_skipped"]:
        fail(f"dense slice: {hist['n_skipped']} epochs discarded")

    perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
    plain = build(Case2Config(jac_mode="dense", rhs_plain=True), dataset=ds)
    for name, params in (("initial", setup.init_params),
                         ("trained", state.params)):
        got, want = (forward_losses(s, params, perm)
                     for s in (setup, plain))
        compare_epoch(f"dense f32 train loss ({name} params)", got[0], want[0])
        compare_epoch(f"dense f32 eval losses ({name} params)", got[1],
                      want[1])

    ds64 = ds._replace(**{k: getattr(ds, k).double() for k in (
        "u0", "ys", "ys_clean", "ts", "yscale")})
    p64 = setup.init_params.double()
    results = []
    for plain_rhs in (False, True):
        s = build(Case2Config(jac_mode="dense", dtype="float64",
                              rhs_plain=plain_rhs), dataset=ds64)
        loss, g = s.trainer.value_and_grad(p64, perm)
        _, m = s.trainer.epoch(s.trainer.init(p64), perm)
        results.append((loss, g, m))
    (lk, gk, mk), (lp, gp, mp) = results
    compare_epoch("dense f64 loss", lk, lp)
    compare_epoch("dense f64 grad", gk, gp)
    compare_epoch("dense f64 eval losses", mk.loss_exp, mp.loss_exp)
    compare_epoch("dense f64 grad norm", mk.grad_norm, mp.grad_norm)
    return {"launches": launches, "launches_per_epoch": launches / n_epoch,
            "dense_epoch_s": hist["epoch_s"]}


def run_fused_eval(setup, params) -> dict:
    """Phase 6: the trained params through the whole-solve evaluator (the
    main path of kernel 3) and the while driver; then both timed."""
    from crnn_tpu_torch.cases.case2 import Case2Config
    from crnn_tpu_torch.ops.rb23_solve_kernel import (arrh_rb23_solve,
                                                      make_arrhenius_fused_solve)

    cfg = Case2Config()
    ds = setup.dataset
    u0, w = ds.u0.contiguous(), setup.weights_fn(params)
    fused = make_arrhenius_fused_solve(cfg.ns, cfg.nr, cfg.lb, cfg.ub, 0.0,
                                       float(cfg.datasize * cfg.tstep), ds.ts,
                                       cfg.rtol, cfg.atol, cfg.max_steps)
    arrh_rb23_solve.launches = 0
    ys_f, ok_f = fused(u0, w)
    torch.cuda.synchronize()
    launches = arrh_rb23_solve.launches
    ys_w, ok_w = while_solve(cfg, u0, w, ds.ts)
    rel = rel_err_components(ys_f, ys_w)
    ok = (launches > 0 and rel < 5e-4 and torch.equal(ok_f, ok_w)
          and bool(torch.isfinite(ys_f).all()))
    print(f"  fused eval (trained params): launches={launches}, vs while "
          f"driver max err {rel:.3e} of each component's largest, success "
          f"{int(ok_f.sum())}/{int(ok_w.sum())} ok={ok}")
    if not ok:
        fail("the fused eval disagrees with the while driver or did not "
             "launch its kernel")

    variants = (("eval_while_ms", lambda: while_solve(cfg, u0, w, ds.ts)),
                ("eval_fused_ms", lambda: fused(u0, w)))
    for _, fn in variants:
        fn()
    samples = {name: [] for name, _ in variants}
    for _ in range(12):
        for name, fn in variants:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            samples[name].append((time.perf_counter() - t0) / 10 * 1e3)
    pair = {name: statistics.median(xs) for name, xs in samples.items()}
    print(f"eval_while_ms={pair['eval_while_ms']:.4f} "
          f"eval_fused_ms={pair['eval_fused_ms']:.4f} (median of 12 "
          f"interleaved rounds of 10 calls, B=30, trained params)")
    for name, xs in samples.items():
        print(f"  {name} rounds: {[round(x, 4) for x in xs]}")
    return {"launches": launches, **pair}


def crnn_inputs(batch, dtype, gen, shape, edges, device="cuda"):
    """Isothermal RHS inputs at ``shape``: 'case1' (ns=5, nr=4, weights from
    the case1 init, lb 1e-5), 'robertson' (ns=3, nr=6, weights from the
    robertson init, lb 1e-8), 'case3' (ns=9, nr=8) and 'grn' (ns=9, nr=15,
    w_out's DNA rows frozen) with weights from the case3 init, y
    log-uniform in [1e-3, 1] as case3's u0 and lb 1e-5, or (ns, nr) (orders
    0.5|N(0, 1)|/sqrt(ns), bias N(0, 1), w_out |N(0, 1)|, lb 1e-5).
    ``edges``: False, True (the
    first rows carry phase 2's edge values, as many as the batch has rows,
    an edge's species index wrapping at ns) or 'exp-cap' (edge rows and a
    bias of +60 that lifts every rate above exp(32)).

    The gate holds each output component to a few ulps of its largest value
    over the lanes (at B = 1, of the lane's own value), so the inputs keep
    two roundings of the same sums from differing by more than that:
    - the orders' share of every finite exponent, sum_i w_in[i, r] log x_i,
      lies within ``_Z_ORDERS`` (the orders shrink where it would not), and
      the bias keeps the exponent within 16: in f32 one ulp of z moves
      exp(z) by 1.9e-6 for |z| in [16, 32), the whole gate, and a 32-term
      sum of partial sums up to 8 rounds z by ~1e-6;
    - in f32, w_out is of one sign, so that du and J are sums without
      cancellation (case1's stoichiometry has both signs, and kernel and
      plain version associate J's triple products differently); f64 keeps
      it, where a cancellation of 1e3 still fits its gate;
    - with 'exp-cap', the bias of +60 then lifts every finite exponent at
      least 40 above the cap, and w_out is of one sign at both dtypes: a
      sum of terms of ~1e14 of both signs would leave its rounding in a
      far smaller difference."""
    from crnn_tpu_torch import clip
    from crnn_tpu_torch.transforms.p2vec import (CRNNWeights,
                                                 init_params_case1,
                                                 init_params_case3,
                                                 init_params_robertson,
                                                 p2vec_case1, p2vec_case3,
                                                 p2vec_robertson)

    if shape == "case1":
        ns, nr, lb = 5, 4, 1e-5
        w = p2vec_case1(init_params_case1(gen, ns, nr, dtype=dtype,
                                          device="cpu"), ns, nr)
        y = torch.rand((batch, ns), generator=gen, dtype=dtype) * 1.2
    elif shape == "robertson":
        ns, nr, lb = 3, 6, 1e-8
        w = p2vec_robertson(init_params_robertson(gen, ns, nr, dtype=dtype,
                                                  device="cpu"), ns, nr)
        y = torch.rand((batch, ns), generator=gen, dtype=dtype) * 2.0 + 0.5
        y[:, 1] = y[:, 1] * 1e-4
    elif shape in ("case3", "grn"):
        ns, nr, lb = 9, (8 if shape == "case3" else 15), 1e-5
        w = p2vec_case3(init_params_case3(gen, ns, nr, dtype=dtype,
                                          device="cpu"), ns, nr,
                        frozen_rows=(0, 3, 6) if shape == "grn" else None)
        y = 10.0 ** (torch.rand((batch, ns), generator=gen, dtype=dtype)
                     * -3.0)
    else:
        (ns, nr), lb = shape, 1e-5
        w = CRNNWeights(
            w_in=torch.randn((ns, nr), generator=gen, dtype=dtype).abs()
            * (0.5 / ns ** 0.5),
            w_b=torch.randn((nr,), generator=gen, dtype=dtype),
            w_out=torch.randn((ns, nr), generator=gen, dtype=dtype).abs())
        y = torch.rand((batch, ns), generator=gen, dtype=dtype) * 1.2
    w_in, w_b, w_out = w.w_in, w.w_b, w.w_out
    if edges:
        lb_t = torch.tensor(lb, dtype=dtype)
        for row, (col, val) in enumerate([
                (0, 1e-9), (0, lb_t), (1, 50.0), (2, 0.0), (0, math.nan),
                (1, math.inf), (2, -math.inf), (1, -1.0), (0, 10.0)][:batch]):
            y[row, col % ns] = val
    z = torch.cat([torch.log(clip(y, lb, ub)) @ w_in
                   for ub in (10.0, math.inf)])
    z_in = float(z[torch.isfinite(z)].abs().max())
    if z_in > _Z_ORDERS:
        w_in = w_in * (_Z_ORDERS / z_in)
    assert float(w_b.abs().max()) + _Z_ORDERS <= 16.0
    if dtype == torch.float32 or edges == "exp-cap":
        w_out = w_out.abs()
    if edges == "exp-cap":
        w_b = w_b + 60.0
    return [t.to(device).contiguous() for t in (y, w_in, w_b, w_out)], lb


def compare_components(out, ref, tol):
    """(ok, max_abs_err over finite entries, largest error over its
    component's scale): NaN and inf positions must match exactly, finite
    values within ``tol`` of each output component's largest finite |value|
    over the lanes."""
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    fin_r = torch.isfinite(ref)
    if not (torch.equal(nan_o, nan_r) and torch.equal(torch.isfinite(out), fin_r)
            and torch.equal(out[~fin_r & ~nan_r], ref[~fin_r & ~nan_r])):
        return False, math.inf, math.inf
    scale = torch.where(fin_r, ref.abs(), torch.zeros_like(ref)).amax(dim=0)
    diff = torch.where(fin_r, (out - ref).abs(), torch.zeros_like(ref))
    rel = torch.where(diff > 0, diff / scale, torch.zeros_like(diff))
    return (bool((diff <= tol * scale).all()), float(diff.max()),
            float(rel.max()))


def crnn_bound_ms(batch, ns, nr, dtype, jac):
    """(bound_ms, bound_by) of kernel 4 (``jac=False``) or kernel 5: y and
    the weights read once, du (and J) written once, against the flops."""
    itemsize = torch.finfo(dtype).bits // 8
    n_out = batch * ns * (ns + 1 if jac else 1)
    n_bytes = itemsize * (batch * ns + 2 * ns * nr + nr + n_out)
    # per lane: ns logs, the (ns x nr) dot, bias, cap, nr exps, the (nr x ns)
    # dot; with J: ns divisions for dlog, rates * w_out (ns*nr) and the
    # (ns x ns) block of 2*nr + 1 each
    flops = ns + 2 * ns * nr + 3 * nr + 2 * ns * nr
    if jac:
        flops += ns + ns * nr + ns * ns * (2 * nr + 1)
    return _bound(n_bytes, batch * flops, dtype)


def check_crnn_kernels(gen):
    """Phase 7: kernels 4-5 against their plain versions, then timed.
    Returns their rows' numbers: kernel 4 at case1's training shape (f32,
    B=20), kernel 5 at robertson's (f64, B=20)."""
    from crnn_tpu_torch.ops.crnn_kernels import (
        crnn_rhs_batched, crnn_rhs_batched_reference, crnn_rhs_jac_batched,
        crnn_rhs_jac_batched_reference, tile_geometry)

    tol = {torch.float32: 2e-6, torch.float64: 1e-12}
    rhs_row, jac_row = {}, {}
    row_of = {("crnn_rhs", "case1"): rhs_row,
              ("crnn_rhs_jac", "robertson"): jac_row}
    worst = {}
    for shape in ("case1", "robertson", (32, 32), (1, 32), (32, 1)):
        for dtype in (torch.float32, torch.float64):
            for batch in (1, 20, 21, 30, 33, 4099, 65536):
                for edges in (False, True, "exp-cap"):
                    args, lb = crnn_inputs(batch, dtype, gen, shape, edges)
                    for ub in (10.0, math.inf):
                        outs = (crnn_rhs_batched(*args, lb, ub),
                                *crnn_rhs_jac_batched(*args, lb, ub))
                        refs = (crnn_rhs_batched_reference(*args, lb, ub),
                                *crnn_rhs_jac_batched_reference(*args, lb, ub))
                        torch.cuda.synchronize()
                        (ok4, e4, r4), (ok5a, e5a, r5a), (ok5b, e5b, r5b) = (
                            compare_components(o, r, tol[dtype])
                            for o, r in zip(outs, refs))
                        if not (ok4 and ok5a and ok5b):
                            fail(f"crnn kernels disagree with their plain "
                                 f"versions: {shape} B={batch} {dtype} "
                                 f"edges={edges} ub={ub}: du {e4:.3e}, "
                                 f"(du, J) {e5a:.3e} {e5b:.3e}")
                        key = (shape, dtype)
                        worst[key] = max(worst.get(key, 0.0), r4, r5a, r5b)
                        if batch == 20 and not edges and ub == 10.0:
                            if (shape, dtype) == ("case1", torch.float32):
                                rhs_row["max_abs_err"] = e4
                            if (shape, dtype) == ("robertson", torch.float64):
                                jac_row["max_abs_err"] = max(e5a, e5b)
                ns, nr = args[3].shape
                geo = [tile_geometry(batch, ns, nr, args[0].element_size(),
                                     jac) for jac in (False, True)]
                print(f"  crnn_rhs/crnn_rhs_jac {shape} {str(dtype)[6:]} "
                      f"B={batch}: plain, edges, exp cap; ub 10 and inf: ok "
                      f"(lanes, threads: {geo[0]}, {geo[1]})")
    for (shape, dtype), err in worst.items():
        print(f"  crnn kernels {shape} {str(dtype)[6:]}: largest error over "
              f"its component's largest value, over B, inputs and ub "
              f"{err:.3e} (gate {tol[dtype]:.0e})")
    for shape, dtype in (("case1", torch.float32),
                         ("robertson", torch.float64)):
        ub = 10.0 if shape == "case1" else math.inf
        for batch in (20, 30, 4099, 65536):
            (y, w_in, w_b, w_out), lb = crnn_inputs(batch, dtype, gen, shape,
                                                    False)
            ns, nr = w_out.shape
            floor = floor_ms(y)
            fns = {"crnn_rhs": (crnn_rhs_batched, crnn_rhs_batched_reference),
                   "crnn_rhs_jac": (crnn_rhs_jac_batched,
                                    crnn_rhs_jac_batched_reference)}
            for name, (kernel, plain) in fns.items():
                times = {
                    "kernel_device": device_ms(
                        lambda: kernel(y, w_in, w_b, w_out, lb, ub)),
                    "plain_device": device_ms(
                        lambda: plain(y, w_in, w_b, w_out, lb, ub)),
                    "kernel_eager": eager_ms(
                        lambda: kernel(y, w_in, w_b, w_out, lb, ub)),
                    "plain_eager": eager_ms(
                        lambda: plain(y, w_in, w_b, w_out, lb, ub)),
                    "floor_device": floor,
                }
                jac = name == "crnn_rhs_jac"
                bound, bound_by = crnn_bound_ms(batch, ns, nr, dtype, jac)
                print(f"  {name} {shape} B={batch} {str(dtype)[6:]} ms/call: "
                      + ", ".join(f"{k}={v:.5f}" for k, v in times.items())
                      + f", bound={bound:.3e} ({bound_by})")
                row = row_of.get((name, shape))
                if batch == 20 and row is not None:
                    row.update(
                        ms=times["kernel_device"],
                        plain_ms=times["plain_device"],
                        ms_eager=times["kernel_eager"],
                        plain_ms_eager=times["plain_eager"], bound_ms=bound,
                        bound_by=bound_by, floor_ms=floor,
                        timed_at=f"{shape} B=20 {str(dtype)[6:]}")
    return rhs_row, jac_row


def check_crnn_rhs_family_shapes(gen) -> dict:
    """Phase 7, continued: kernel 4 at the 100 lanes of case3 (ns=9, nr=8)
    and of the GRN (ns=9, nr=15), f32 and f64, plain, edge and exp-cap
    inputs, ub = 100 (as the cases run it) and inf, held as ``crnn_inputs``
    conditions them; then its device and eager times at B=100 in f32
    against the plain version's, the launch floor and its bound. The draws
    come from ``gen``, a generator of their own. Returns {shape: times}."""
    from crnn_tpu_torch.ops.crnn_kernels import (crnn_rhs_batched,
                                                 crnn_rhs_batched_reference)

    tol = {torch.float32: 2e-6, torch.float64: 1e-12}
    out = {}
    for shape in ("case3", "grn"):
        for dtype in (torch.float32, torch.float64):
            worst = 0.0
            for edges in (False, True, "exp-cap"):
                args, lb = crnn_inputs(100, dtype, gen, shape, edges)
                for ub in (100.0, math.inf):
                    got = crnn_rhs_batched(*args, lb, ub)
                    ref = crnn_rhs_batched_reference(*args, lb, ub)
                    torch.cuda.synchronize()
                    ok, err, rel = compare_components(got, ref, tol[dtype])
                    if not ok:
                        fail(f"crnn_rhs disagrees with its plain version: "
                             f"{shape} B=100 {dtype} edges={edges} ub={ub}: "
                             f"{err:.3e}")
                    worst = max(worst, rel)
                    if dtype == torch.float32 and not edges and ub == 100.0:
                        out[shape] = {"max_abs_err": err}
            print(f"  crnn_rhs {shape} B=100 {str(dtype)[6:]}: plain, edges, "
                  f"exp cap; ub 100 and inf: ok; largest error over its "
                  f"component's largest value {worst:.3e} (gate "
                  f"{tol[dtype]:.0e})")
        (y, w_in, w_b, w_out), lb = crnn_inputs(100, torch.float32, gen,
                                                shape, False)
        ns, nr = w_out.shape
        bound, bound_by = crnn_bound_ms(100, ns, nr, torch.float32, False)
        out[shape].update(
            ms=device_ms(lambda: crnn_rhs_batched(y, w_in, w_b, w_out, lb,
                                                  100.0)),
            plain_ms=device_ms(lambda: crnn_rhs_batched_reference(
                y, w_in, w_b, w_out, lb, 100.0)),
            ms_eager=eager_ms(lambda: crnn_rhs_batched(y, w_in, w_b, w_out,
                                                       lb, 100.0)),
            floor_ms=floor_ms(y), bound_ms=bound, bound_by=bound_by,
            timed_at=f"{shape} ({ns}, {nr}) B=100 f32")
        print(f"  crnn_rhs {shape} ({ns}, {nr}) B=100 f32 ms/call: "
              + ", ".join(f"{k}={out[shape][k]:.5f}" for k in (
                  "ms", "plain_ms", "ms_eager", "floor_ms"))
              + f", bound={bound:.3e} ({bound_by})")
    return out


def train_case(module, cfg, n_epoch, counters, launch=True):
    """``n_epoch`` guarded epochs of ``cfg`` through run_case on the card,
    with every counter of ``counters`` set to 0 just before and read just
    after; fails on non-finite metrics, a discarded epoch, a missing
    metrics line or a kernel launched 0 times (with ``launch=False``: a
    kernel launched at all, for a path that has none). Returns (setup,
    state, history, launches)."""
    from crnn_tpu_torch.cases.base import run_case

    t0 = time.perf_counter()
    setup = module.build(cfg)
    torch.cuda.synchronize()
    print(f"  build (truth on the card): {time.perf_counter() - t0:.2f} s")
    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as out_dir:
        state, hist = run_case(setup, n_epoch, out_dir=out_dir, log_every=1)
        n_lines = len((Path(out_dir) / setup.name / "metrics.jsonl")
                      .read_text().splitlines())
    torch.cuda.synchronize()
    launches = [c.launches for c in counters]
    print(f"  {setup.name}: epochs_s={hist['epoch_s']}; launches "
          + ", ".join(f"{c.__name__}={n} ({n / n_epoch:.0f}/epoch)"
                      for c, n in zip(counters, launches)))
    if n_lines != n_epoch:
        fail(f"{setup.name}: metrics.jsonl has {n_lines} lines")
    for k in ("loss_train", "loss_val", "grad_norm"):
        if not all(math.isfinite(v) for v in hist[k]):
            fail(f"{setup.name}: non-finite {k}: {hist[k]}")
    if hist["n_skipped"]:
        fail(f"{setup.name}: {hist['n_skipped']} epochs discarded")
    if not hist["loss_train"][-1] <= hist["loss_train"][0]:
        fail(f"{setup.name}: the training loss rose: {hist['loss_train']}")
    if launch and min(launches) == 0:
        fail(f"{setup.name}: a kernel of its path launched 0 times: "
             f"{launches}")
    if not launch and max(launches) > 0:
        fail(f"{setup.name}: a kernel launched on a path without kernels: "
             f"{launches}")
    return setup, state, hist, launches


def epoch_with_grad(trainer, params, perm, masks):
    """One batch-mode epoch from ``params`` -> (loss, grad, state,
    metrics): the training loss and gradient are the epoch's own, taken
    from its one call to ``value_and_grad`` (one gradient pass, not two)."""
    seen = []
    vag = trainer.value_and_grad

    def capture(*args):
        seen.append(vag(*args))
        return seen[-1]

    trainer.value_and_grad = capture
    try:
        state, m = trainer.epoch(trainer.init(params), perm, masks)
    finally:
        del trainer.value_and_grad
    ((loss, g),) = seen
    return loss, g, state, m


def compare_f64_epochs(module, cfg_cls, dataset, params, perm, masks, label,
                       rtol=1e-9, counters=(), **kw):
    """A whole f64 epoch on the kernel path against the plain path from the
    same params, perm and masks: loss, grad, eval losses and updated params
    at ``rtol`` (plus rtol of the largest entry for entries near 0; a dict
    gives each quantity its own). Every
    counter of ``counters`` is set to 0 just before the kernel path's epoch
    and read just after (each must be > 0). Returns the two epochs' seconds
    and the kernel path's launches."""
    results = []
    launches = []
    for plain in (False, True):
        s = module.build(cfg_cls(dtype="float64", rhs_plain=plain, **kw),
                         dataset=dataset)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        loss, g, state, m = epoch_with_grad(s.trainer, params, perm, masks)
        torch.cuda.synchronize()
        results.append((loss, g, m, state.params, time.perf_counter() - t0))
        if not plain:
            launches = [c.launches for c in counters]
    if counters:
        print(f"  {label} f64 kernel-path epoch launches " + ", ".join(
            f"{c.__name__}={n}" for c, n in zip(counters, launches)))
        if min(launches) == 0:
            fail(f"{label}: a kernel of its path launched 0 times: "
                 f"{launches}")
    (lk, gk, mk, pk, tk), (lp, gp, mp, pp, tp) = results
    print(f"  {label} f64 epoch s: kernel path {tk:.3f}, plain path {tp:.3f}")
    for name, a, b in (("loss", lk, lp), ("grad", gk, gp),
                       ("eval losses", mk.loss_exp, mp.loss_exp),
                       ("params", pk, pp)):
        tol = rtol[name] if isinstance(rtol, dict) else rtol
        rel = float(((a - b).abs() / b.abs().max()).max())
        ok = within(a, b, tol)
        print(f"  kernel vs plain {label} f64 {name}: max rel err {rel:.3e} "
              f"ok={ok}")
        if not ok:
            fail(f"{label}: kernel path f64 {name} disagrees with the plain "
                 "path")
    return tk, tp, launches


def run_case1(gen) -> dict:
    """Phase 8: case1 as shipped on the card, its kernel-4 launches, and
    the kernel path against the plain path."""
    from crnn_tpu_torch.cases import case1
    from crnn_tpu_torch.ode.solve import odesolve
    from crnn_tpu_torch.ode.tsit5 import Tsit5
    from crnn_tpu_torch.models.crnn import make_crnn_rhs
    from crnn_tpu_torch.ops.crnn_kernels import crnn_rhs_batched

    cfg = case1.Case1Config()
    setup, _, hist, (launches,) = train_case(case1, cfg, 3,
                                             (crnn_rhs_batched,))
    ds = setup.dataset
    if not (bool(ds.success.all()) and bool(torch.isfinite(ds.ys).all())):
        fail("case1: truth solve failed or produced non-finite data")
    plain = case1.build(case1.Case1Config(rhs_plain=True), dataset=ds)
    p0 = setup.init_params
    perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
    f32 = [forward_losses(s, p0, perm) for s in (setup, plain)]
    compare_epoch("case1 f32 train loss", f32[0][0], f32[1][0])
    compare_epoch("case1 f32 eval losses", f32[0][1], f32[1][1])
    ys = []
    for plain_rhs in (False, True):
        with torch.no_grad():
            ys.append(odesolve(
                make_crnn_rhs(cfg.lb, cfg.ub, plain=plain_rhs), Tsit5(),
                ds.u0, 0.0, cfg.datasize * cfg.tstep, ds.ts,
                args=setup.weights_fn(p0), rtol=cfg.rtol, atol=cfg.atol,
                max_steps=cfg.max_steps, unroll="while").ys)
    rel = rel_err_components(*ys)
    print(f"  case1 f32 ys kernel vs plain: max err {rel:.3e} of each "
          f"species' largest value")
    if not rel < 5e-4:
        fail("case1: kernel path ys disagree with the plain path")
    _, g_a = plain.trainer.value_and_grad(p0, perm)
    _, g_b = plain.trainer.value_and_grad(torch.nextafter(p0, p0 + math.inf),
                                          perm)
    print(f"  case1 f32 conditioning probe (plain path, params moved by one "
          f"ulp): grad moves by "
          f"{float((g_a - g_b).abs().max() / g_a.abs().max()):.3e} of its "
          f"largest entry")
    ds64 = ds._replace(**{k: getattr(ds, k).double() for k in (
        "u0", "ys", "ys_clean", "ts", "yscale")})
    masks = torch.ones((cfg.n_exp_train, cfg.datasize), dtype=torch.float64)
    compare_f64_epochs(case1, case1.Case1Config, ds64, p0.double(), perm,
                       masks, "case1")
    return {"launches": launches, "launches_per_epoch": launches / 3,
            "case1_epoch_s": hist["epoch_s"]}


def run_robertson(gen) -> dict:
    """Phase 9: robertson as shipped on the card, its kernel-4 and kernel-5
    launches, and the kernel path against the plain path in f64."""
    from crnn_tpu_torch.cases import robertson
    from crnn_tpu_torch.ops.crnn_kernels import (crnn_rhs_batched,
                                                 crnn_rhs_jac_batched)

    cfg = robertson.RobertsonConfig()
    setup, state, hist, (n_rhs, n_jac) = train_case(
        robertson, cfg, 2, (crnn_rhs_batched, crnn_rhs_jac_batched))
    ds = setup.dataset
    print(f"  robertson truth: success {int(ds.success.sum())}/{cfg.n_exp}, "
          f"yscale {ds.yscale.tolist()}")
    if not (bool(ds.success.all()) and bool(torch.isfinite(ds.ys).all())):
        fail("robertson: truth solve failed or produced non-finite data")
    trainer = setup.trainer
    perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
    masks = trainer.sample_masks(gen, cfg.n_exp_train, torch.float64)
    tk, tp, _ = compare_f64_epochs(robertson, robertson.RobertsonConfig, ds,
                                   setup.init_params, perm, masks,
                                   "robertson")
    return {"launches": n_jac, "launches_per_epoch": n_jac / 2,
            "rhs_launches": n_rhs, "robertson_epoch_s": hist["epoch_s"],
            "robertson_f64_epoch_kernel_s": tk,
            "robertson_f64_epoch_plain_s": tp}, setup, state.params


def run_runner(gen) -> dict:
    """Phase 10: the case runner and the rest of the Trainer on the card.
    (a) per-lane case2 (``batch_major=False``, reverse mode): 2 f32 epochs
    through run_case with kernels 1 and 2 counted, and an f64 epoch on the
    kernel path against the plain path at rtol 1e-9; (b) sequential case2
    (forward mode): one epoch as the CLI runs it and one with the per-lane
    evaluation, kernels counted; (c) sequential case1: one epoch at 5
    training experiments with kernel 4 counted; (d) the case2 CLI for 2
    epochs and then 2 more with --restart in one 2-epoch chunk, against 4
    epochs uninterrupted, bit for bit. Returns the launch counts and epoch
    seconds by kernel row."""
    from crnn_tpu_torch.cases import case1, case2
    from crnn_tpu_torch.ops.crnn_kernels import (arrhenius_rhs_batched,
                                                 arrhenius_rhs_jac_batched,
                                                 crnn_rhs_batched)

    out = {"arrhenius_rhs": {}, "arrhenius_rhs_jac": {}, "crnn_rhs": {}}
    # (a) per-lane case2
    cfg = case2.Case2Config(batch_major=False)
    setup, _, hist, (n_rhs, n_jac) = train_case(
        case2, cfg, 2, (arrhenius_rhs_batched, arrhenius_rhs_jac_batched))
    out["arrhenius_rhs"].update(per_lane_case2_launches=n_rhs,
                                per_lane_case2_epoch_s=hist["epoch_s"])
    out["arrhenius_rhs_jac"].update(per_lane_case2_launches=n_jac,
                                    per_lane_case2_epoch_s=hist["epoch_s"])
    ds = setup.dataset
    ds64 = ds._replace(**{k: getattr(ds, k).double() for k in (
        "u0", "ys", "ys_clean", "ts", "yscale")})
    perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
    masks = torch.ones((cfg.n_exp_train, cfg.datasize), dtype=torch.float64)
    tk, tp, _ = compare_f64_epochs(case2, case2.Case2Config, ds64,
                                   setup.init_params.double(), perm, masks,
                                   "case2 per-lane", batch_major=False)
    out["arrhenius_rhs_jac"].update(per_lane_case2_f64_epoch_kernel_s=tk,
                                    per_lane_case2_f64_epoch_plain_s=tp)

    # (b) sequential case2, forward mode: jacfwd through the plain ops (as
    # the JAX package takes its reference ops), the evaluation pass on the
    # kernels; as the CLI runs it (batch-major eval: kernel 1), then with
    # the per-lane eval (kernels 1 and 2)
    for batch_major, need in ((True, (arrhenius_rhs_batched,)),
                              (False, (arrhenius_rhs_batched,
                                       arrhenius_rhs_jac_batched))):
        seq = case2.build(case2.Case2Config(mode="sequential",
                                            batch_major=batch_major),
                          dataset=ds)
        counters = (arrhenius_rhs_batched, arrhenius_rhs_jac_batched)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, m = seq.trainer.epoch(seq.trainer.init(seq.init_params))
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        n_rhs, n_jac = (c.launches for c in counters)
        label = "case2 sequential" + ("" if batch_major else " per-lane")
        print(f"  {label} (grad_mode={seq.trainer.grad_mode}): 1 epoch "
              f"{seq_s:.3f} s, loss_train {float(m.loss_train):.6e}, "
              f"{state.opt_state.count} updates; launches "
              f"arrhenius_rhs_batched={n_rhs}, "
              f"arrhenius_rhs_jac_batched={n_jac}")
        if not (math.isfinite(float(m.loss_train))
                and math.isfinite(float(m.grad_norm))):
            fail(f"{label}: non-finite loss or grad norm")
        if state.opt_state.count != cfg.n_exp_train:
            fail(f"{label}: {state.opt_state.count} updates")
        if min(c.launches for c in need) == 0:
            fail(f"{label}: a kernel of its path launched 0 times: "
                 f"{n_rhs}, {n_jac}")
        key = "sequential_case2" + ("" if batch_major else "_per_lane")
        out["arrhenius_rhs"].update({f"{key}_launches": n_rhs,
                                     f"{key}_epoch_s": seq_s})
        if not batch_major:
            out["arrhenius_rhs_jac"].update({f"{key}_launches": n_jac,
                                             f"{key}_epoch_s": seq_s})

    # (c) sequential case1: reverse mode, one lane per update, at a reduced
    # depth of 5 training experiments (5 updates; 20 took ~43 s on the card)
    _, _, hist, (n_iso,) = train_case(
        case1, case1.Case1Config(mode="sequential", n_exp_train=5), 1,
        (crnn_rhs_batched,))
    out["crnn_rhs"].update(sequential_case1_launches=n_iso,
                           sequential_case1_epoch_s=hist["epoch_s"])

    # (d) the CLI: 2 epochs, then --restart for 2 in one chunk, against 4
    with tempfile.TemporaryDirectory() as d:
        base = Path(d)
        case2.main(["--epochs", "2", "--out", str(base / "b")])
        case2.main(["--epochs", "2", "--restart", "--epochs-per-dispatch",
                    "2", "--out", str(base / "b")])
        case2.main(["--epochs", "4", "--out", str(base / "a")])
        rows = {k: [json.loads(line) for line in
                    (base / k / "case2" / "metrics.jsonl").read_text()
                    .splitlines()] for k in ("a", "b")}
        missing = [f for f in ("checkpoint.pt", "best.pt", "p_opt.npy")
                   if not (base / "b" / "case2" / f).exists()]
        ckpts = {k: torch.load(base / k / "case2" / "checkpoint.pt",
                               weights_only=True) for k in ("a", "b")}
    epochs = [r["epoch"] for r in rows["b"]]
    print(f"  CLI restart: metrics epochs {epochs}")
    if epochs != [1, 2, 3, 4]:
        fail(f"CLI restart: metrics.jsonl epochs {epochs}")
    if missing:
        fail(f"CLI restart: missing {missing}")
    # bitwise: the f32 losses of every epoch, and the final checkpoint
    # (params, Adam state, epoch and the generator's state, which differs
    # if the restart lost the draws of the run it continues)
    for name in ("loss_train", "loss_val", "grad_norm"):
        same = [r[name] for r in rows["b"]] == [r[name] for r in rows["a"]]
        print(f"  restart vs uninterrupted f32 {name}: bitwise equal {same}")
        if not same:
            fail(f"CLI restart: {name} differs from the uninterrupted run")
    differ = [k for k, v in ckpts["a"].items() if not (
        torch.equal(v, ckpts["b"][k]) if isinstance(v, torch.Tensor)
        else v == ckpts["b"][k])]
    print(f"  restart vs uninterrupted checkpoint: entries that differ "
          f"{differ} of {sorted(ckpts['a'])}")
    if differ:
        fail(f"CLI restart: the final checkpoint differs in {differ}")
    return out


def ramp_rhs(t, y, k):
    """A -> B -> C with Arrhenius rates on a temperature ramp T = 300 + 40 t
    (a DSC-like t-dependent RHS, not declared autonomous), lanes y (B, 3),
    k (B, 4) = (log A1, E1, log A2, E2); the CPU test's
    (tests/test_torch_rosenbrock_ft.py)."""
    temp = 300.0 + 40.0 * t
    r1 = torch.exp(k[:, 0] - k[:, 1] / temp) * y[:, 0]
    r2 = torch.exp(k[:, 2] - k[:, 3] / temp) * y[:, 1]
    return torch.stack([-r1, r1 - r2, r2], dim=1)


def check_t_dependent_rb23():
    """Phase 11(d): the per-lane Rosenbrock23 on ``ramp_rhs`` in f64, its
    df/dt by forward mode in t, on the card against the same solve on the
    CPU: n_steps exact, ys within 1e-9 of each component's largest value."""
    from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
    from crnn_tpu_torch.ode.solve import odesolve

    gen = torch.Generator().manual_seed(3)
    u0 = torch.zeros((4, 3), dtype=torch.float64)
    u0[:, 0] = torch.rand(4, generator=gen, dtype=torch.float64) + 0.5
    jitter = torch.rand((4, 2), generator=gen, dtype=torch.float64) - 0.5
    k = torch.stack([10.0 + jitter[:, 0], torch.full((4,), 3000.0,
                     dtype=torch.float64), 12.0 + jitter[:, 1],
                     torch.full((4,), 3000.0, dtype=torch.float64)], dim=1)
    saveat = torch.linspace(0.0, 5.0, 12, dtype=torch.float64)
    sols = []
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        sols.append(odesolve(ramp_rhs, Rosenbrock23(), u0.to(dev), 0.0, 5.0,
                             saveat.to(dev), args=k.to(dev), rtol=1e-3,
                             atol=1e-6, max_steps=4096, unroll="while"))
        print(f"  t-dependent Rosenbrock23 on {dev}: "
              f"{time.perf_counter() - t0:.3f} s")
    (card, cpu) = sols
    rel = rel_err_components(card.ys.cpu(), cpu.ys)
    same_steps = torch.equal(card.n_steps.cpu(), cpu.n_steps)
    print(f"  t-dependent Rosenbrock23 card vs CPU: n_steps "
          f"{cpu.n_steps.tolist()} equal {same_steps}; ys max err {rel:.3e} "
          f"of each component's largest value (gate 1e-9)")
    if not (same_steps and bool(cpu.success.all()) and rel <= 1e-9):
        fail("t-dependent Rosenbrock23: the card's solve differs from the "
             "CPU's")


def f32_losses_vs_plain(label, setup, plain, params, perm):
    """The f32 training loss (mean over ``perm``, scan driver) and eval
    losses (per experiment, early-exit driver) of the kernel path against
    the plain path at ``params``, at rtol 1e-4 or, where the plain path
    itself is worse conditioned, at 3x its conditioning witness: the
    largest move of the same losses on the plain path when every param
    moves by one ulp (all up, all down, and two draws of a random sign
    each), taken only where the paths differ by more than 1e-4 (the gate is
    the larger of the two). case3's log-space loss needs that: where a
    predicted species decays to lb (1e-5), f32's absolute rounding of the
    O(1) states becomes a large difference of logs, so one ulp of the
    params moves one experiment's loss by ~3e-3 of the largest (printed
    below). The kernel is held per experiment in f64 at rtol 1e-9
    (``compare_f64_epochs``)."""
    kernel = forward_losses(setup, params, perm)
    ref = forward_losses(plain, params, perm)
    moved = None
    for i, what in enumerate(("train loss", "eval losses")):
        rtol = _EPOCH_RTOL
        if not within(kernel[i], ref[i], rtol):
            if moved is None:
                signs = torch.randint(
                    0, 2, (2, *params.shape),
                    generator=torch.Generator().manual_seed(0))
                dirs = [torch.full_like(params, math.inf),
                        torch.full_like(params, -math.inf),
                        *((2.0 * signs - 1.0).to(params) * math.inf)]
                moved = [forward_losses(
                    plain, torch.nextafter(params, params + d), perm)
                    for d in dirs]
            witness = max(float(((m[i] - ref[i]).abs()
                                 / ref[i].abs().max()).max()) for m in moved)
            rtol = max(rtol, 3.0 * witness)
            print(f"  {label} f32 {what}: one ulp of the params moves the "
                  f"plain path by {witness:.3e} of its largest; gate rtol "
                  f"{rtol:.3e}")
        compare_epoch(f"{label} f32 {what}", kernel[i], ref[i], rtol=rtol)


def run_isothermal_family(gen) -> dict:
    """Phase 11: (a) case3 and (b) the GRN as shipped on the card: 2 f32
    epochs through run_case with kernel 4 counted; the kernel path against
    the plain path on the f32 losses at the initial and the trained params
    (``f32_losses_vs_plain``), on the f32 ys (5e-4 of each species'
    largest value), and over a whole f64 epoch at rtol 1e-9; (c) case1 rev: 2
    forward-mode epochs, no kernel launched; (d) the t-dependent
    Rosenbrock23 on the card against the CPU. Returns the launch counts
    and epoch seconds for kernel 4's row."""
    import dataclasses

    from crnn_tpu_torch.cases import case1_rev, case3
    from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs
    from crnn_tpu_torch.ode.solve import odesolve
    from crnn_tpu_torch.ode.tsit5 import Tsit5
    from crnn_tpu_torch.ops import crnn_kernels as ck

    counters = (ck.crnn_rhs_batched, ck.crnn_rhs_jac_batched,
                ck.arrhenius_rhs_batched, ck.arrhenius_rhs_jac_batched)
    row = {}
    for name, cfg in (("case3", case3.Case3Config()),
                      ("grn", case3.grn_config())):
        setup, state, hist, (launches,) = train_case(
            case3, cfg, 2, (ck.crnn_rhs_batched,))
        ds = setup.dataset
        if not (bool(ds.success.all()) and bool(torch.isfinite(ds.ys).all())):
            fail(f"{name}: truth solve failed or produced non-finite data")
        plain = case3.build(dataclasses.replace(cfg, rhs_plain=True),
                            dataset=ds)
        trainer = setup.trainer
        n_upd = trainer.n_exp_update or trainer.n_exp_train
        perm = torch.randperm(n_upd, generator=gen).cuda()
        for label, params in (("initial", setup.init_params),
                              ("trained", state.params)):
            f32_losses_vs_plain(f"{name} ({label} params)", setup, plain,
                                params, perm)
        ys = []
        for plain_rhs in (False, True):
            with torch.no_grad():
                ys.append(odesolve(
                    make_crnn_scaled_rhs(cfg.lb, cfg.ub, setup.dydt_scale,
                                         plain=plain_rhs), Tsit5(),
                    ds.u0, 0.0, cfg.datasize * cfg.tstep, ds.ts,
                    args=setup.weights_fn(setup.init_params),
                    rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
                    unroll="while").ys)
        rel = rel_err_components(*ys)
        print(f"  {name} f32 ys kernel vs plain: max err {rel:.3e} of each "
              f"species' largest value")
        if not rel < 5e-4:
            fail(f"{name}: kernel path ys disagree with the plain path")
        ds64 = ds._replace(**{k: getattr(ds, k).double() for k in (
            "u0", "ys", "ys_clean", "ts", "yscale")})
        masks = trainer.sample_masks(gen, n_upd, torch.float64)
        tk, tp, _ = compare_f64_epochs(
            case3, functools.partial(dataclasses.replace, cfg), ds64,
            setup.init_params.double(), perm, masks, name)
        row.update({f"{name}_launches": launches,
                    f"{name}_launches_per_epoch": launches / 2,
                    f"{name}_epoch_s": hist["epoch_s"],
                    f"{name}_f64_epoch_kernel_s": tk,
                    f"{name}_f64_epoch_plain_s": tp})

    # (c) case1 rev: forward mode through the while driver, plain torch
    _, _, hist, launches = train_case(case1_rev, case1_rev.Case1RevConfig(),
                                      2, counters, launch=False)
    print(f"  case1_rev: no kernel on its path (launches {launches}); "
          f"epoch_s {hist['epoch_s']}")

    # (d) the t-dependent Rosenbrock23
    check_t_dependent_rb23()
    return row


def robertson_lanes_rhs(t, y, k):
    """The Robertson system of tests/test_solvers.py with per-lane rate
    constants ``k (B, 3)``, lanes ``y (B, 3)``; t-independent."""
    r1 = k[:, 0] * y[:, 0]
    r2 = k[:, 1] * y[:, 1] * y[:, 1]
    r3 = k[:, 2] * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=-1)


ROBERTSON_LANE_SOLVERS = ("trbdf2", "kvaerno3", "auto_tsit5_trbdf2",
                          "auto_tsit5_rosenbrock23")


def robertson_lanes_solve(name: str, dev: str) -> dict:
    """Phase 12(a)'s solve under solver ``name`` on ``dev``: Robertson over
    [0, 1e5] in f64, three lanes of different stiffness in one batch (k =
    (4e-2, 3e7, 1e4), (4e-2, 3e5, 1e3) and the slow (4e-6, 3e-3, 1e-3),
    which stays explicit), 10 save points, rtol 1e-6, atol 1e-10. Returns
    its ys, n_steps, success, every lane's final ``is_stiff`` (AutoSwitch)
    and seconds, as plain lists and numbers."""
    from crnn_tpu_torch.ode import (AutoSwitch, Kvaerno3, Rosenbrock23,
                                    TRBDF2, Tsit5)
    from crnn_tpu_torch.ode.base import autonomous
    from crnn_tpu_torch.ode.solve import odesolve

    class Recording(AutoSwitch):
        """AutoSwitch that keeps every step's incoming ``is_stiff``."""

        def __init__(self, stiff):
            super().__init__(Tsit5(), stiff)
            self.is_stiff = []

        def step(self, f, t, y, dt, args, state):
            self.is_stiff.append(state.is_stiff)
            return super().step(f, t, y, dt, args, state)

    f64 = torch.float64
    k = torch.tensor([[4e-2, 3e7, 1e4], [4e-2, 3e5, 1e3], [4e-6, 3e-3, 1e-3]],
                     dtype=f64)
    y0 = torch.tensor([[1.0, 0.0, 0.0]] * 3, dtype=f64)
    saveat = 10.0 ** torch.linspace(0.0, 5.0, 10, dtype=f64)
    solver = {"trbdf2": TRBDF2, "kvaerno3": Kvaerno3,
              "auto_tsit5_trbdf2": lambda: Recording(TRBDF2()),
              "auto_tsit5_rosenbrock23": lambda: Recording(Rosenbrock23()),
              }[name]()
    sync = torch.cuda.synchronize if dev == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    sol = odesolve(autonomous(robertson_lanes_rhs), solver, y0.to(dev), 0.0,
                   1e5, saveat.to(dev), args=k.to(dev), rtol=1e-6,
                   atol=1e-10, max_steps=16384, unroll="while")
    sync()
    return {"ys": sol.ys.cpu().tolist(), "n_steps": sol.n_steps.tolist(),
            "success": bool(sol.success.all()),
            "is_stiff": (solver.is_stiff[-1].cpu().tolist()
                         if isinstance(solver, Recording) else None),
            "seconds": time.perf_counter() - t0}


def check_solvers_card_vs_cpu(refs) -> dict:
    """Phase 12(a): TRBDF2, Kvaerno3 and AutoSwitch to TRBDF2 and to
    Rosenbrock23 on Robertson lanes (``robertson_lanes_solve``) on the card
    against the same solve on the CPU (``refs()``, from ``cpu_references``):
    n_steps exact, the final is_stiff of every lane exact (AutoSwitch), ys
    within 1e-9 of each component's largest value. Returns the card's
    seconds per solver."""
    seconds = {}
    cpu_runs = refs()["robertson_lanes"]
    for name in ROBERTSON_LANE_SOLVERS:
        card, cpu = robertson_lanes_solve(name, "cuda"), cpu_runs[name]
        rel = rel_err_components(*(torch.tensor(r["ys"], dtype=torch.float64)
                                   for r in (card, cpu)))
        same_steps = card["n_steps"] == cpu["n_steps"]
        print(f"  12(a) {name}: card {card['seconds']:.2f} s, CPU "
              f"{cpu['seconds']:.2f} s (in the background); n_steps "
              f"{cpu['n_steps']} equal {same_steps}; final is_stiff card "
              f"{card['is_stiff']} CPU {cpu['is_stiff']}; ys max err "
              f"{rel:.3e} of each component's largest value (gate 1e-9)")
        if not (same_steps and card["is_stiff"] == cpu["is_stiff"]
                and cpu["success"] and rel <= 1e-9):
            fail(f"12(a) {name}: the card's solve differs from the CPU's")
        seconds[name] = card["seconds"]
    return seconds


def f64_epoch_witness(module, cfg_cls, dataset, params, perm, masks, **kw):
    """For each quantity ``compare_f64_epochs`` holds (loss, grad, eval
    losses, params), how far one ulp of the params (all up, all down, two
    draws of a random sign) moves the plain path's own f64 epoch, over the
    quantity's largest entry: the conditioning witness of a kernel-against-
    plain gate, as ``f32_losses_vs_plain`` takes it for f32 losses."""
    s = module.build(cfg_cls(dtype="float64", rhs_plain=True, **kw),
                     dataset=dataset)

    def run(p):
        loss, g, state, m = epoch_with_grad(s.trainer, p, perm, masks)
        return {"loss": loss, "grad": g, "eval losses": m.loss_exp,
                "params": state.params}

    base = run(params)
    signs = torch.randint(0, 2, (2, *params.shape),
                          generator=torch.Generator().manual_seed(0))
    dirs = [torch.full_like(params, math.inf),
            torch.full_like(params, -math.inf),
            *((2.0 * signs - 1.0).to(params) * math.inf)]
    moves = dict.fromkeys(base, 0.0)
    for d in dirs:
        out = run(torch.nextafter(params, params + d))
        for k, v in out.items():
            moves[k] = max(moves[k], float(((v - base[k]).abs()
                                            / base[k].abs().max()).max()))
    return moves


def run_case2_solvers(gen) -> dict:
    """Phase 12(b): per-lane case2 (``Case2Config(batch_major=False)``)
    under ``solver='auto_tsit5_rosenbrock23'`` and ``'trbdf2'``: one f32
    epoch each through run_case with kernels 1 and 2 counted (TRBDF2 takes
    J by forward mode of the plain twin, so kernel 2 stays at 0 there), and
    an f64 epoch on the kernel path against the plain path at rtol 1e-9, or
    at 3x the plain path's own one-ulp move where that is larger
    (``f64_epoch_witness``, AutoSwitch), both at a reduced depth of 64
    steps a scan. Returns the counts and seconds by kernel row."""
    from crnn_tpu_torch.cases import case2
    from crnn_tpu_torch.ops.crnn_kernels import (arrhenius_rhs_batched,
                                                 arrhenius_rhs_jac_batched)

    out = {"arrhenius_rhs": {}, "arrhenius_rhs_jac": {}}
    for solver, key in (("auto_tsit5_rosenbrock23", "autoswitch"),
                        ("trbdf2", "trbdf2")):
        t0 = time.perf_counter()
        cfg = case2.Case2Config(batch_major=False, solver=solver)
        counters = (arrhenius_rhs_batched,) if solver == "trbdf2" else (
            arrhenius_rhs_batched, arrhenius_rhs_jac_batched)
        arrhenius_rhs_jac_batched.launches = 0
        setup, _, hist, launches = train_case(case2, cfg, 1, counters)
        n_jac = arrhenius_rhs_jac_batched.launches
        print(f"  12(b) case2 per-lane {solver}: f32 epoch_s "
              f"{hist['epoch_s']}, loss_train {hist['loss_train']}; "
              f"arrhenius_rhs_batched={launches[0]}, "
              f"arrhenius_rhs_jac_batched={n_jac}")
        ds = setup.dataset
        ds64 = ds._replace(**{k: getattr(ds, k).double() for k in (
            "u0", "ys", "ys_clean", "ts", "yscale")})
        perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
        masks = torch.ones((cfg.n_exp_train, cfg.datasize),
                           dtype=torch.float64)
        # AutoSwitch's f64 epoch is ill-conditioned on the plain path
        # itself: one ulp of the params moves its gradient by ~4e-8 and its
        # eval losses by ~2e-6 (TRBDF2's gradient by ~5e-13), on the CPU.
        # Gate each quantity at 1e-9 or 3x its own one-ulp move
        p64 = setup.init_params.double()
        rtol = 1e-9
        if solver != "trbdf2":
            witness = f64_epoch_witness(case2, case2.Case2Config, ds64, p64,
                                        perm, masks, batch_major=False,
                                        solver=solver, max_steps=64)
            rtol = {k: max(1e-9, 3.0 * w) for k, w in witness.items()}
            print(f"  12(b) {solver}: one ulp of the params moves the plain "
                  "path's f64 epoch by " + ", ".join(
                      f"{k} {w:.3e}" for k, w in witness.items())
                  + " of each one's largest; gate rtol " + ", ".join(
                      f"{k} {r:.3e}" for k, r in rtol.items()))
        tk, tp, (n_rhs64, *_) = compare_f64_epochs(
            case2, case2.Case2Config, ds64, p64, perm, masks,
            f"case2 per-lane {solver} (max_steps 64)", rtol=rtol,
            counters=counters, batch_major=False, solver=solver,
            max_steps=64)
        out["arrhenius_rhs"].update({
            f"per_lane_case2_{key}_launches": launches[0],
            f"per_lane_case2_{key}_epoch_s": hist["epoch_s"],
            f"per_lane_case2_{key}_f64_epoch_launches": n_rhs64,
            f"per_lane_case2_{key}_f64_epoch_kernel_s": tk,
            f"per_lane_case2_{key}_f64_epoch_plain_s": tp})
        if solver != "trbdf2":
            out["arrhenius_rhs_jac"].update({
                f"per_lane_case2_{key}_launches": n_jac,
                f"per_lane_case2_{key}_epoch_s": hist["epoch_s"]})
        print(f"  12(b) {solver}: {time.perf_counter() - t0:.2f} s")
    return out


def lm_history(s, p):
    """``run_lm_finish`` for 20 iterations: (cost history, seconds)."""
    from crnn_tpu_torch.cases import robertson

    t1 = time.perf_counter()
    _, info = robertson.run_lm_finish(s, p, max_iters=20)
    if p.device.type == "cuda":
        torch.cuda.synchronize()
    return info["history"], time.perf_counter() - t1


def lm_cpu_references(out_path: str, in_path: str):
    """12(d)'s CPU side, in a process of its own: the LM finish from phase
    9's trained params on its dataset (``in_path``) on the CPU, and how far
    one ulp of the params (all up, all down) moves that history, two
    threads. Writes the history, its seconds and the witness to
    ``out_path`` as JSON."""
    import numpy as np

    from crnn_tpu_torch.cases import robertson
    from crnn_tpu_torch.data.generate import Dataset

    torch.set_num_threads(2)
    data = torch.load(in_path, weights_only=True)
    with open(out_path + ".log", "w") as log, \
            contextlib.redirect_stdout(log):
        s = robertson.build(robertson.RobertsonConfig(device="cpu"),
                            dataset=Dataset(**data["dataset"]))
        p = data["params"]
        h_cpu, s_cpu = lm_history(s, p)
        moved = [lm_history(s, torch.nextafter(
            p, p + torch.full_like(p, d)))[0] for d in (math.inf, -math.inf)]
    witness = max(float(np.max(np.abs(h - h_cpu) / np.abs(h_cpu)))
                  if h.shape == h_cpu.shape else math.inf for h in moved)
    Path(out_path).write_text(json.dumps({
        "history": h_cpu.tolist(), "seconds": s_cpu, "witness": witness}))


def run_robertson_suite(gen, setup, trained, lm_refs) -> dict:
    """Phase 12(c)-(e) on phase 9's robertson dataset (f64): (c)
    ``grad_path='adjoint'``: one epoch on the kernel path (kernels 4 and 5
    counted, > 0) against the plain path at rtol 1e-9 (loss, gradient, eval
    losses, params), its seconds beside a ``'rev_scan'`` epoch's; (d)
    ``run_lm_finish`` with max_iters 20 from phase 9's trained params, on
    the card and on the CPU: cost histories within 1e-9 (relative) or 3x
    how far one ulp of the params moves the CPU's own history, not
    increasing, at least one step taken (from lambda = 1e-3, growing 3x a
    rejection, the first step is taken at ~17 iterations); (e) an epoch with a ``w_out_mask`` that prunes 5 of the 18
    w_out entries: those entries exactly 0 after the update. Returns the
    counts and seconds by kernel row."""
    import numpy as np

    from crnn_tpu_torch.cases import robertson
    from crnn_tpu_torch.ops.crnn_kernels import (crnn_rhs_batched,
                                                 crnn_rhs_jac_batched)

    counters = (crnn_rhs_batched, crnn_rhs_jac_batched)
    cfg = robertson.RobertsonConfig()
    ds = setup.dataset
    p0 = setup.init_params
    perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
    masks = setup.trainer.sample_masks(gen, cfg.n_exp_train, torch.float64)

    # (c) the adjoint gradient path against rev_scan
    t0 = time.perf_counter()
    tk, tp, (n_rhs, n_jac) = compare_f64_epochs(
        robertson, robertson.RobertsonConfig, ds, p0, perm, masks,
        "robertson adjoint", counters=counters, grad_path="adjoint")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    setup.trainer.epoch(setup.trainer.init(p0), perm, masks)
    torch.cuda.synchronize()
    t_rev = time.perf_counter() - t1
    print(f"  12(c) robertson f64 kernel-path epoch s: adjoint {tk:.3f}, "
          f"rev_scan {t_rev:.3f} (plain-path adjoint {tp:.3f}); "
          f"{time.perf_counter() - t0:.2f} s")

    # (d) LM from phase 9's trained params, card against CPU. The damped
    # normal equations are ill-conditioned (rank <= 20 of 43 params), and
    # CG carries each run's rounding into its steps: one ulp of the params
    # moves the CPU's own history by ~3e-3 (measured on the CPU). Gate at
    # 1e-9 or 3x that witness, measured on the CPU (``lm_cpu_references``)
    t0 = time.perf_counter()
    on_card = robertson.build(robertson.RobertsonConfig(), dataset=ds)
    for c in counters:
        c.launches = 0
    h_card, s_card = lm_history(on_card, trained)
    l_card = [c.launches for c in counters]
    ref = lm_refs()
    h_cpu, s_cpu, witness = (np.asarray(ref["history"]), ref["seconds"],
                             ref["witness"])
    tol = max(1e-9, 3.0 * witness)
    rel = (float(np.max(np.abs(h_card - h_cpu) / np.abs(h_cpu)))
           if h_card.shape == h_cpu.shape else math.inf)
    print(f"  12(d) LM finish, 20 iterations: history card {h_card.tolist()} "
          f"(launches {l_card}: forward mode runs the plain ops), CPU "
          f"{h_cpu.tolist()}; one ulp of the params moves the CPU's by "
          f"{witness:.3e}; max rel diff {rel:.3e} (gate {tol:.3e}); card "
          f"{s_card:.2f} s, CPU {s_cpu:.2f} s (in the background)")
    if not (rel <= tol and bool(np.all(np.diff(h_card) <= 0))
            and h_card.shape[0] >= 2):
        fail("12(d): the LM cost history differs from the CPU's, rose, or "
             "took no step")
    print(f"  12(d): {time.perf_counter() - t0:.2f} s")

    # (e) w_out_mask
    t0 = time.perf_counter()
    mask = tuple(tuple(0.0 if (i + j) % 4 == 0 else 1.0
                       for j in range(cfg.nr)) for i in range(cfg.ns))
    s = robertson.build(robertson.RobertsonConfig(w_out_mask=mask),
                        dataset=ds)
    for c in counters:
        c.launches = 0
    state, m = s.trainer.epoch(s.trainer.init(s.init_params), perm, masks)
    torch.cuda.synchronize()
    w_out = s.weights_fn(state.params).w_out
    keep = torch.tensor(mask, dtype=w_out.dtype, device=w_out.device)
    pruned_zero = bool((w_out[keep == 0] == 0).all())
    kept = bool((w_out[keep == 1] != 0).all())
    launches = [c.launches for c in counters]
    print(f"  12(e) w_out_mask epoch: loss_train {float(m.loss_train):.6e}, "
          f"pruned w_out entries exactly 0 {pruned_zero}, kept entries "
          f"non-zero {kept}, launches {launches}; "
          f"{time.perf_counter() - t0:.2f} s")
    if not (pruned_zero and kept and math.isfinite(float(m.loss_train))
            and min(launches) > 0):
        fail("12(e): the masked w_out entries are not 0, or the epoch "
             "failed")
    return {"crnn_rhs": {"robertson_adjoint_f64_epoch_launches": n_rhs,
                         "robertson_adjoint_f64_epoch_s": tk,
                         "robertson_rev_scan_f64_epoch_s": t_rev},
            "crnn_rhs_jac": {"robertson_adjoint_f64_epoch_launches": n_jac,
                             "robertson_adjoint_f64_epoch_s": tk,
                             "robertson_lm_20_iters_card_s": s_card,
                             "robertson_lm_20_iters_cpu_s": s_cpu}}


def check_crnn_rhs_hybrid_shapes(gen) -> dict:
    """Phase 7, continued: kernel 4 at the CRNN cores of the hybrid RHSs,
    yeast's ``u_full`` (ns=12, nr=12; ub 100) and the QSSA's (3, 3; ub 10),
    at the B of their training (20) and evaluation (30) solves, f32 and
    f64, plain, edge and exp-cap inputs, that ub and inf, held as
    ``crnn_inputs`` conditions them (lb 1e-5, the cases' own); then its
    device and eager times at B=20 in f32 against the plain version's, the
    launch floor and its bound. The draws come from ``gen``, a generator of
    their own. Returns {shape: numbers}."""
    from crnn_tpu_torch.ops.crnn_kernels import (crnn_rhs_batched,
                                                 crnn_rhs_batched_reference)

    tol = {torch.float32: 2e-6, torch.float64: 1e-12}
    out = {}
    for name, shape, ub_case in (("yeast", (12, 12), 100.0),
                                 ("qssa", (3, 3), 10.0)):
        for dtype in (torch.float32, torch.float64):
            worst = 0.0
            for batch in (20, 30):
                for edges in (False, True, "exp-cap"):
                    args, lb = crnn_inputs(batch, dtype, gen, shape, edges)
                    for ub in (ub_case, math.inf):
                        got = crnn_rhs_batched(*args, lb, ub)
                        ref = crnn_rhs_batched_reference(*args, lb, ub)
                        torch.cuda.synchronize()
                        ok, err, rel = compare_components(got, ref,
                                                          tol[dtype])
                        if not ok:
                            fail(f"crnn_rhs disagrees with its plain version:"
                                 f" {name} {shape} B={batch} {dtype} "
                                 f"edges={edges} ub={ub}: {err:.3e}")
                        worst = max(worst, rel)
                        if (batch == 20 and dtype == torch.float32
                                and not edges and ub == ub_case):
                            out[name] = {"max_abs_err": err}
            print(f"  crnn_rhs {name} {shape} B=20, 30 {str(dtype)[6:]}: "
                  f"plain, edges, exp cap; ub {ub_case:g} and inf: ok; "
                  f"largest error over its component's largest value "
                  f"{worst:.3e} (gate {tol[dtype]:.0e})")
        (y, w_in, w_b, w_out), lb = crnn_inputs(20, torch.float32, gen, shape,
                                                False)
        bound, bound_by = crnn_bound_ms(20, *shape, torch.float32, False)
        out[name].update(
            ms=device_ms(lambda: crnn_rhs_batched(y, w_in, w_b, w_out, lb,
                                                  ub_case)),
            plain_ms=device_ms(lambda: crnn_rhs_batched_reference(
                y, w_in, w_b, w_out, lb, ub_case)),
            ms_eager=eager_ms(lambda: crnn_rhs_batched(y, w_in, w_b, w_out,
                                                       lb, ub_case)),
            floor_ms=floor_ms(y), bound_ms=bound, bound_by=bound_by,
            timed_at=f"{name} {shape} B=20 f32")
        print(f"  crnn_rhs {name} {shape} B=20 f32 ms/call: "
              + ", ".join(f"{k}={out[name][k]:.5f}" for k in (
                  "ms", "plain_ms", "ms_eager", "floor_ms"))
              + f", bound={bound:.3e} ({bound_by})")
    return out


def run_hybrid(part: str, gen) -> dict:
    """Phase 13: the hybrid-MLP cases on the card, the MLP in plain torch
    and the CRNN core on kernel 4 in every f; ``part`` 'a' or 'b', each in
    a process of its own. (a) yeast at
    ``YeastConfig()`` (30 experiments, 300 save points, ns=7 of ns_=12,
    nr=12, f32, TRBDF2, max_steps 384), its data generated on the card: 1
    guarded epoch through run_case with kernel 4 counted (> 0); the kernel
    path against the plain path on the f32 losses at the trained params
    (``f32_losses_vs_plain``: rtol 1e-4 or 3x the plain path's own one-ulp
    move); a whole f64 epoch (loss, grad, eval losses, params) at rtol
    1e-9 at a reduced depth, 4 + 2 experiments, every 5th save point (60)
    and max_steps 96 (where the slowest solves stop short of t1: a check
    of kernel against plain, not a fit), the widths kept. (b) the QSSA at ``QSSAConfig()``
    (30 experiments, 40 save points, f64, Rosenbrock23): 2 guarded epochs
    with kernel 4 counted, and a whole f64 epoch kernel against plain at
    rtol 1e-9 with max_steps 96 (its solves take ~60). Returns kernel 4's
    row entries."""
    import dataclasses

    from crnn_tpu_torch.cases import robertson_qssa, yeast
    from crnn_tpu_torch.ops.crnn_kernels import crnn_rhs_batched
    from crnn_tpu_torch.train.loss import prefix_mask

    counters = (crnn_rhs_batched,)
    row = {}
    t0 = time.perf_counter()
    if part == "b":
        # (b) the QSSA
        cfg = robertson_qssa.QSSAConfig()
        setup, state, hist, (launches,) = train_case(robertson_qssa, cfg, 2,
                                                     counters)
        ds = setup.dataset
        if not (bool(ds.success.all()) and bool(torch.isfinite(ds.ys).all())):
            fail("robertson_qssa: truth solve failed or produced non-finite "
                 "data")
        tk, tp, (n64,) = compare_f64_epochs(
            robertson_qssa,
            lambda dtype, **kw: robertson_qssa.QSSAConfig(**kw),
            ds, setup.init_params, torch.randperm(cfg.n_exp_train,
                                                  generator=gen).cuda(),
            torch.ones((cfg.n_exp_train, cfg.datasize), dtype=torch.float64),
            "robertson_qssa (max_steps 96)", counters=counters, max_steps=96)
        row.update(qssa_launches=launches,
                   qssa_launches_per_epoch=launches / 2,
                   qssa_epoch_s=hist["epoch_s"], qssa_f64_epoch_launches=n64,
                   qssa_f64_epoch_kernel_s=tk, qssa_f64_epoch_plain_s=tp)
        print(f"  13(b) robertson_qssa: {time.perf_counter() - t0:.2f} s")
        return row
    # (a) yeast
    cfg = yeast.YeastConfig()
    setup, state, hist, (launches,) = train_case(yeast, cfg, 1, counters)
    ds = setup.dataset
    print(f"  yeast truth: success {int(ds.success.sum())}/{cfg.n_exp}, "
          f"yscale {[round(v, 4) for v in ds.yscale.tolist()]}")
    if not (bool(ds.success.all()) and bool(torch.isfinite(ds.ys).all())):
        fail("yeast: truth solve failed or produced non-finite data")
    # the f32 losses at the shipped 384 steps: a shorter scan exhausts at
    # the trained params, and one ulp of the params then moves the plain
    # path's own losses by 0.26-0.85 of their largest (a 128-step trial)
    plain = yeast.build(dataclasses.replace(cfg, rhs_plain=True), dataset=ds)
    perm = torch.randperm(cfg.n_exp_train, generator=gen).cuda()
    f32_losses_vs_plain("yeast (trained params)", setup, plain, state.params,
                        perm)
    n_tr, n_val, every, max_steps = 4, 2, 5, 96
    n = n_tr + n_val
    ds64 = ds._replace(u0=ds.u0[:n].double(), ys=ds.ys[:n, ::every].double(),
                       ys_clean=ds.ys_clean[:n, ::every].double(),
                       ts=ds.ts[::every].double(), yscale=ds.yscale.double(),
                       success=ds.success[:n])
    n_save = ds64.ts.shape[0]
    masks = prefix_mask(n_save, torch.randint(
        min(cfg.batch_min, n_save), n_save + 1, (n_tr,), generator=gen),
        torch.float64)
    tk, tp, (n64,) = compare_f64_epochs(
        yeast, yeast.YeastConfig, ds64, setup.init_params.double(),
        torch.randperm(n_tr, generator=gen).cuda(), masks,
        f"yeast ({n_tr}+{n_val} experiments, {n_save} save points, "
        f"max_steps {max_steps})", counters=counters, n_exp_train=n_tr,
        n_exp_val=n_val, ntotal=n_save, max_steps=max_steps)
    row.update(yeast_launches=launches, yeast_launches_per_epoch=launches,
               yeast_epoch_s=hist["epoch_s"],
               yeast_f64_reduced_epoch_launches=n64,
               yeast_f64_reduced_epoch_kernel_s=tk,
               yeast_f64_reduced_epoch_plain_s=tp)
    print(f"  13(a) yeast: {time.perf_counter() - t0:.2f} s")
    return row


CATHODE_YAML = "expr_name: smoke\nn_epoch: 2\nn_plot: 1\n"
_HIST = ("loss_train", "loss_val", "grad_norm")


def cathode_run(device: str, tmp: Path) -> tuple:
    """``run_cathode`` for 2 epochs on ``synthetic_dsc`` from a YAML config
    written to ``tmp``, on ``device``: (seconds, metrics rows, best, the
    results dir)."""
    from crnn_tpu_torch.cases import cathode
    from crnn_tpu_torch.infra.config import config_from_yaml

    yaml_path = tmp / "config.yaml"
    yaml_path.write_text(CATHODE_YAML)
    cfg = config_from_yaml(cathode.CathodeConfig, str(yaml_path),
                           device=device)
    t0 = time.perf_counter()
    _, best = cathode.run_cathode(cfg, out_dir=str(tmp / "out"),
                                  config_yaml=str(yaml_path))
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rdir = tmp / "out" / "cathode" / "smoke"
    rows = [json.loads(x) for x in
            (rdir / "metrics.jsonl").read_text().splitlines()]
    return seconds, rows, best, rdir


def cpu_references(out_path: str):
    """The CPU references of phases 12(a) and 14, in a process of their own
    started with the script, so that they run while the card runs the
    phases before them: the four Robertson-lane solves
    (``robertson_lanes_solve``), HyChem's 2 epochs through run_case and
    cathode's ``run_cathode`` (``cathode_run``) on the CPU, two threads.
    Writes their results and seconds to ``out_path`` as JSON; the
    process's own output goes to a log beside it."""
    from crnn_tpu_torch.cases import hychem
    from crnn_tpu_torch.cases.base import run_case

    torch.set_num_threads(2)
    out = {"robertson_lanes": {name: robertson_lanes_solve(name, "cpu")
                               for name in ROBERTSON_LANE_SOLVERS}}
    with open(out_path + ".log", "w") as log, \
            contextlib.redirect_stdout(log), \
            tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        _, hist = run_case(hychem.build(hychem.HyChemConfig(device="cpu")),
                           2, out_dir=tmp, log_every=0)
        out["hychem"] = {"rows": [dict(zip(_HIST, r)) for r in zip(
            *(hist[k] for k in _HIST))],
            "seconds": time.perf_counter() - t0}
        seconds, rows, _, _ = cathode_run("cpu", Path(tmp))
        out["cathode"] = {"rows": rows, "seconds": seconds}
    Path(out_path).write_text(json.dumps(out))


def histories_card_vs_cpu(label, card, cpu, witness=None):
    """The card's per-epoch (loss_train, loss_val, grad_norm) against the
    CPU's at rtol 1e-9; where they differ by more, against 3x
    ``witness()``, the CPU's own move under one ulp of the params, taken
    only then (the gate is the larger of the two)."""
    a = torch.tensor([[r[k] for k in _HIST] for r in card],
                     dtype=torch.float64)
    b = torch.tensor([[r[k] for k in _HIST] for r in cpu],
                     dtype=torch.float64)
    rel = float(((a - b).abs() / b.abs()).max()) if a.shape == b.shape \
        else math.inf
    gate = 1e-9
    if rel > gate and witness is not None:
        gate = max(gate, 3.0 * witness())
    print(f"  {label} card vs CPU: {a.tolist()} against {b.tolist()}; max "
          f"rel diff {rel:.3e} (gate {gate:.3e})")
    if not rel <= gate:
        fail(f"{label}: the card's losses differ from the CPU's")
    return rel


def cathode_witness() -> float:
    """How far one ulp of cathode's initial params (all up, all down) moves
    its 2-epoch (loss_train, loss_val, grad_norm) history on the CPU."""
    from crnn_tpu_torch.cases import cathode

    s = cathode.build(cathode.CathodeConfig(device="cpu"))
    p0 = s.init_params

    def history(p):
        state = s.trainer.init(p, seed=0)
        out = []
        for _ in range(2):
            state, m = s.trainer.epoch(state)
            out.append([float(getattr(m, k)) for k in _HIST])
        return torch.tensor(out, dtype=torch.float64)

    base = history(p0)
    return max(float(((history(torch.nextafter(
        p0, p0 + torch.full_like(p0, d))) - base).abs() / base.abs()).max())
        for d in (math.inf, -math.inf))


def wait_json(path: str, timeout_s: float = 1100.0):
    """The JSON another process writes to ``path``, waited for (polled
    until it exists and parses)."""
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            return json.loads(Path(path).read_text())
        except (OSError, ValueError):
            if time.monotonic() > deadline:
                fail(f"{path} was not written within {timeout_s} s")
            time.sleep(1.0)


def hybrid_child(out_path: str, part: str, seed: int):
    """Phase 13 part ``part`` (``run_hybrid``) in a process of its own, on
    the card beside the other parts and phases 14-15: its kernel rows'
    numbers to ``out_path``, its output to a log beside it; a failed check
    exits non-zero."""
    with open(out_path + ".log", "w") as log, \
            contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        out = run_hybrid(part, torch.Generator().manual_seed(seed))
        print(f"[13({part}) hybrid case] done in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    Path(out_path).write_text(json.dumps(out))


def single_fit_child(out_path: str, refs_path: str):
    """Phase 14 (``run_single_fit``) in a process of its own, on the card
    beside phases 13 and 15, against the CPU references at ``refs_path`` (waited
    for: they run in the background from the start). Its output goes to a
    log beside ``out_path``, its seconds to ``out_path``; a failed check
    exits non-zero."""
    with open(out_path + ".log", "w") as log, \
            contextlib.redirect_stdout(log):
        t0 = time.perf_counter()
        out = run_single_fit(lambda: wait_json(refs_path))
        print(f"[14 single-fit cases] done in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
    Path(out_path).write_text(json.dumps(out))


def run_single_fit(refs) -> dict:
    """Phase 14: the single-fit cases, which have no kernel on their path
    (every count 0). (a) HyChem at ``HyChemConfig()`` (the surrogate
    trajectory, nr=10, 40 save points, f64, Rosenbrock23 with df/dt
    through the interpolants): 2 guarded epochs through run_case on the
    card. (b) ``run_cathode`` for 2 epochs on ``synthetic_dsc`` from a
    YAML config the phase writes (f64, TRBDF2, sequential updates, the
    gradient of the early-exit loss): ``metrics.jsonl``,
    ``checkpoint.pt``, ``p_opt.npy`` and the snapshot with the best losses
    written back. Both against the CPU's runs of the same (``refs()``, from
    ``cpu_references``): losses and grad norms at 1e-9, or for cathode 3x
    the CPU's one-ulp move where that is larger. (c) cathode's gradient on
    one short curve by reverse mode through the early-exit driver (the
    case's ``grad_mode='rev_while'``) against ``torch.func.jacfwd`` through
    it (the JAX package's way) at 1e-10, with the seconds of each. Returns
    the seconds."""
    import numpy as np

    from crnn_tpu_torch.cases import cathode, hychem
    from crnn_tpu_torch.data.loaders import synthetic_dsc
    from crnn_tpu_torch.infra.config import load_yaml
    from crnn_tpu_torch.ops import crnn_kernels as ck

    counters = (ck.crnn_rhs_batched, ck.crnn_rhs_jac_batched,
                ck.arrhenius_rhs_batched, ck.arrhenius_rhs_jac_batched)
    out = {}
    # (a) HyChem
    t0 = time.perf_counter()
    _, _, hist, _ = train_case(hychem, hychem.HyChemConfig(), 2, counters,
                               launch=False)
    ref = refs()
    rows = [dict(zip(_HIST, r)) for r in zip(*(hist[k] for k in _HIST))]
    histories_card_vs_cpu("14(a) hychem", rows, ref["hychem"]["rows"])
    out.update(hychem_epoch_s=hist["epoch_s"],
               hychem_cpu_2_epochs_s=ref["hychem"]["seconds"])
    print(f"  14(a) hychem: card epochs {hist['epoch_s']}, CPU 2 epochs "
          f"{ref['hychem']['seconds']:.2f} s (in the background); "
          f"{time.perf_counter() - t0:.2f} s")

    # (b) cathode through its YAML lifecycle
    t0 = time.perf_counter()
    for c in counters:
        c.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        seconds, rows, best, rdir = cathode_run("cuda", Path(tmp))
        snap = load_yaml(str(rdir / "config.yaml"))
        p_opt = np.load(rdir / "p_opt.npy")
        if not ([m["epoch"] for m in rows] == [1, 2]
                and (rdir / "checkpoint.pt").exists()
                and snap.get("loss_train") == best["loss_train"]
                and snap.get("loss_val") == best["loss_val"]
                and p_opt.shape == (18,)
                and all(math.isfinite(m["loss_train"]) for m in rows)):
            fail(f"14(b) cathode: its results dir is incomplete: {rows}, "
                 f"{snap}")
    if max(c.launches for c in counters):
        fail("14(b) cathode: a kernel launched on a path without kernels")
    print(f"  14(b) cathode run_cathode 2 epochs: card {seconds:.2f} s, CPU "
          f"{ref['cathode']['seconds']:.2f} s (in the background); "
          f"snapshot loss_train {snap['loss_train']:.6e} loss_val "
          f"{snap['loss_val']:.6e}")
    histories_card_vs_cpu("14(b) cathode", rows, ref["cathode"]["rows"],
                          cathode_witness)
    out.update(cathode_run_2_epochs_card_s=seconds,
               cathode_run_2_epochs_cpu_s=ref["cathode"]["seconds"])

    # (c) the cathode gradient by reverse mode through the early-exit
    # driver against torch.func.jacfwd through it (the JAX package's way),
    # on one short curve: the same derivative, and what each costs
    dsc = synthetic_dsc(heating_rates=(20.0, 15.0), t0_celsius=150.0,
                        t1_celsius=250.0, dT=10.0)
    grads = {}
    for mode in ("rev_while", "fwd", "rev_while"):
        s = cathode.build(cathode.CathodeConfig(val_index=1), dsc=dsc)
        s.trainer.grad_mode = mode
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, grads[mode] = s.trainer.value_and_grad(
            s.init_params, torch.tensor([0], device="cuda"))
        torch.cuda.synchronize()
        out[f"cathode_short_curve_grad_{mode}_s"] = time.perf_counter() - t1
    g_r, g_f = grads["rev_while"], grads["fwd"]
    rel = float((g_r - g_f).abs().max() / g_f.abs().max())
    print(f"  14(c) cathode gradient on one short curve: rev_while "
          f"{out['cathode_short_curve_grad_rev_while_s']:.3f} s, jacfwd "
          f"{out['cathode_short_curve_grad_fwd_s']:.3f} s; they differ by "
          f"{rel:.3e} of the largest entry (gate 1e-10)")
    if not rel <= 1e-10:
        fail("14(c): the reverse-mode cathode gradient differs from jacfwd's")
    print(f"  14(b)-(c) cathode: {time.perf_counter() - t0:.2f} s")
    return out


# --- phases 15-16: the UQ case and the data-parallel runner ------------------

UQ_ITERS = 2


def uq_run(device: str, nudge: float = 0.0) -> dict:
    """``run_uq`` of ``CathodeUQConfig()`` for ``UQ_ITERS`` SVGD iterations
    (history every iteration) on ``device``, from the seeded particles
    (drawn on the CPU, so the same on every device), moved one ulp toward
    ``nudge`` (+-inf) when given. Returns the particles, the losses, the
    history tensor and the seconds, as lists, and the run's info."""
    import dataclasses

    from crnn_tpu_torch.cases import cathode_uq

    cfg = cathode_uq.CathodeUQConfig(n_iters=UQ_ITERS, gap=1, device=device)
    particles = None
    if nudge:
        p0, _, _ = cathode_uq.build_uq(dataclasses.replace(cfg, device="cpu"))
        particles = torch.nextafter(p0, torch.full_like(p0, nudge)).numpy()
    t0 = time.perf_counter()
    p, info = cathode_uq.run_uq(cfg, verbose=False, particles=particles)
    if device == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"particles": p.cpu().tolist(), "loss_train": info["loss_train"],
            "loss_val": info["loss_val"], "history": info["history"].tolist(),
            "seconds": seconds, "maxiters": cfg.maxiters}, p, info


def uq_cpu_references(out_path: str):
    """Phase 15's CPU side, in a process of its own started with the
    script: ``uq_run`` on the CPU (two threads), and again from particles
    one ulp up (the witness). Writes both as JSON to ``out_path``."""
    torch.set_num_threads(2)
    out = {"cpu": uq_run("cpu")[0], "cpu_ulp": uq_run("cpu", math.inf)[0]}
    Path(out_path).write_text(json.dumps(out))


def uq_child(out_path: str):
    """Phase 15 on the card in a process of its own (beside phases 13-14):
    ``uq_run`` on the card with every kernel counter at 0 (the UQ path has
    no kernel; each count must stay 0), then ``write_outputs`` into a run
    directory (particles, losses, posterior moments, the history tensor;
    figures need matplotlib, which the card's machine lacks). Writes the
    run's numbers to ``out_path``; its output goes to a log beside it."""
    import numpy as np

    from crnn_tpu_torch.cases.cathode_uq import write_outputs
    from crnn_tpu_torch.ops import crnn_kernels as ck

    counters = (ck.crnn_rhs_batched, ck.crnn_rhs_jac_batched,
                ck.arrhenius_rhs_batched, ck.arrhenius_rhs_jac_batched)
    with open(out_path + ".log", "w") as log, \
            contextlib.redirect_stdout(log), \
            tempfile.TemporaryDirectory() as tmp:
        for c in counters:
            c.launches = 0
        out, particles, info = uq_run("cuda")
        launches = [c.launches for c in counters]
        moments = write_outputs(tmp, particles, info, figures=False)
        files = {f: np.load(Path(tmp) / f).shape for f in
                 ("particles.npy", "history.npy")}
        n = len(out["particles"])
        print(f"  15 cathode_uq: {UQ_ITERS} SVGD iterations of "
              f"CathodeUQConfig() ({n} particles, f64, batch-major "
              f"Rosenbrock23, {out['maxiters']} steps) on the card in "
              f"{out['seconds']:.2f} s ({out['seconds'] / UQ_ITERS:.2f} s an "
              f"iteration); kernel launches {launches}; run dir {files}, "
              f"posterior std {np.round(moments['std'], 4).tolist()}",
              flush=True)
        if max(launches):
            fail(f"15: a kernel launched on a path without kernels: "
                 f"{launches}")
        if not (files["particles.npy"] == (n, 17)
                and files["history.npy"] == (UQ_ITERS, n, 17)
                and np.isfinite(moments["std"]).all()
                and (Path(tmp) / "moments.npz").exists()):
            fail(f"15: the run directory is incomplete: {files}")
    Path(out_path).write_text(json.dumps(out))


def uq_card_vs_cpu(card: dict, refs: dict) -> dict:
    """Phase 15's gate: the card's particles, losses and history against
    the CPU's, per component at rtol 1e-9, or 3x the CPU's own move under
    one ulp of the particles (the witness, always taken) where larger."""
    keys = ("particles", "loss_train", "loss_val", "history")

    def rel(a, b):
        return max(float(((torch.tensor(a[k], dtype=torch.float64)
                           - torch.tensor(b[k], dtype=torch.float64)).abs()
                          / torch.tensor(b[k], dtype=torch.float64).abs()
                          ).max()) for k in keys)

    cpu, witness = refs["cpu"], rel(refs["cpu_ulp"], refs["cpu"])
    err = rel(card, cpu)
    gate = max(1e-9, 3.0 * witness)
    print(f"  15 cathode_uq card vs CPU: max rel diff per component "
          f"{err:.3e} (one-ulp witness {witness:.3e}, gate {gate:.3e}); "
          f"losses card {card['loss_train']} / {card['loss_val']}, CPU "
          f"{cpu['loss_train']} / {cpu['loss_val']}; CPU {UQ_ITERS} "
          f"iterations {cpu['seconds']:.2f} s (two threads, background)")
    if not (err <= gate and all(math.isfinite(x) for x in
                                card["loss_train"] + card["loss_val"])):
        fail("15: the card's UQ run differs from the CPU's")
    return {"uq_card_vs_cpu_rel": err, "uq_ulp_witness": witness,
            "uq_card_s_per_iter": card["seconds"] / UQ_ITERS,
            "uq_cpu_s_per_iter": cpu["seconds"] / UQ_ITERS}


def run_data_parallel() -> dict:
    """Phase 16 on a world of one (nccl, this process): (a) one per-lane
    case2 epoch (``Case2Config(batch_major=False, dtype='float64')``, full
    width) through ``run_case(dp=1)`` against the batch Trainer's epoch on
    the same data and params at rtol 1e-9 (losses, grad norm, params), with
    kernels 1-2 counted over the dp epoch (each > 0); (b) one sharded SVGD
    step (``build_uq(dp=1)``) against the local step, 100 particles at a
    reduced depth of 128 steps, at rtol 1e-12. Returns the launch counts and
    seconds."""
    from crnn_tpu_torch.cases import case2
    from crnn_tpu_torch.cases.base import run_case
    from crnn_tpu_torch.cases.cathode_uq import CathodeUQConfig, build_uq
    from crnn_tpu_torch.ops import crnn_kernels as ck
    from crnn_tpu_torch.parallel import mesh

    counters = (ck.arrhenius_rhs_batched, ck.arrhenius_rhs_jac_batched)
    cfg = case2.Case2Config(batch_major=False, dtype="float64")
    ref = case2.build(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_b, m = ref.trainer.epoch(ref.trainer.init(ref.init_params))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    out = {}
    with mesh.process_group(1, 0, device="cuda"), \
            tempfile.TemporaryDirectory() as tmp:
        setup = case2.build(cfg, dataset=ref.dataset)
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        state, hist = run_case(setup, 1, out_dir=tmp, dp=1, log_every=0)
        torch.cuda.synchronize()
        dp_s = time.perf_counter() - t0
        launches = [c.launches for c in counters]
        errs = {k: abs(hist[k][0] - float(getattr(m, k))) / abs(
            float(getattr(m, k))) for k in _HIST}
        errs["params"] = float(((state.params - state_b.params).abs()
                                / state_b.params.abs().max()).max())
        print(f"  16(a) case2 per-lane f64 epoch through run_case(dp=1) "
              f"(nccl, world 1) {dp_s:.2f} s against the batch epoch "
              f"{batch_s:.2f} s; rel diff {errs}; kernel launches in the "
              f"dp epoch " + ", ".join(f"{c.__name__}={n}" for c, n in
                                       zip(counters, launches)))
        if min(launches) == 0:
            fail(f"16(a): a kernel of the dp epoch launched 0 times: "
                 f"{launches}")
        if not max(errs.values()) <= 1e-9:
            fail("16(a): the dp=1 epoch differs from the batch epoch")
        # (b) the sharded SVGD step against the local step
        uq = CathodeUQConfig(maxiters=128)
        p, step_local, _ = build_uq(uq)
        p_dp, step_dp, _ = build_uq(CathodeUQConfig(maxiters=128, dp=1))
        t0 = time.perf_counter()
        new_l, loss_l = step_local(p, 0, uq.stepsize)
        torch.cuda.synchronize()
        local_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        new_d, loss_d = step_dp(p_dp, 0, uq.stepsize)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        rel = max(float(((new_d - new_l).abs() / new_l.abs()).max()),
                  abs(loss_d.item() - loss_l.item()) / abs(loss_l.item()))
        print(f"  16(b) sharded SVGD step (dp=1) {sharded_s:.2f} s against "
              f"the local step {local_s:.2f} s ({p.shape[0]} particles, "
              f"128 steps): "
              f"max rel diff {rel:.3e} (gate 1e-12)")
        if not rel <= 1e-12:
            fail("16(b): the sharded SVGD step differs from the local step")
    out["arrhenius_rhs"] = {"dp_epoch_launches": launches[0],
                            "dp_epoch_s": dp_s, "dp_batch_epoch_s": batch_s}
    out["arrhenius_rhs_jac"] = {"dp_epoch_launches": launches[1]}
    return out


# --- phase 17: the compensated-f32 batch Rosenbrock23 on kernels 4-5 --------

def comp32_script():
    """``scripts/robertson_comp32_torch.py`` as a module."""
    import importlib.util

    path = HERE / "scripts" / "robertson_comp32_torch.py"
    spec = importlib.util.spec_from_file_location("robertson_comp32_torch",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def gate_per_component(label, out, ref, witness, rtol=1e-4):
    """Each state component of ``out`` within the larger of ``rtol`` of its
    largest |value| in ``ref`` and 3x ``witness`` (the same component's
    move under one ulp of the params); fails otherwise."""
    dims = tuple(range(ref.dim() - 1))
    err = (out - ref).abs().amax(dim=dims)
    tol = torch.maximum(rtol * ref.abs().amax(dim=dims), 3.0 * witness)
    ok = bool(torch.isfinite(out).all()) and bool((err <= tol).all())
    print(f"  {label}: max err per component {err.tolist()}, gate "
          f"{tol.tolist()}; ok={ok}")
    if not ok:
        fail(f"17: {label} disagree")


def trace_kernels(logdir: str) -> tuple:
    """(kernel events by name, trace bytes) of the one trace in
    ``logdir``."""
    import re
    from collections import Counter

    (path,) = Path(logdir).glob("*.pt.trace.json")
    raw = path.read_bytes()
    names = re.findall(rb'"cat":\s*"kernel",\s*"name":\s*"([^"]*)"', raw)
    if not names:      # another field order: parse the whole trace
        names = [e["name"].encode() for e in json.loads(raw)["traceEvents"]
                 if e.get("cat") == "kernel"]
    return Counter(names), len(raw)


def run_compensated(setup, trained) -> dict:
    """Phase 17 on phase 9's robertson dataset (f64, 20 + 5 experiments, 40
    save points, ns=3, nr=6, 192 steps, rtol 1e-3) and trained params: the
    compensated-f32 batch Rosenbrock23 with every f on kernel 4 and every
    step's f0 and J on kernel 5. (a) ``two_sum`` on 2^20 f32 pairs across
    60 binades on the card: s + e equals a + b in f64; (b) f64: the
    compensated driver against ``batch_odesolve_rb23`` (dense), both on
    the kernels: n_steps exact, every lane done, ys within rtol 1e-10 /
    atol 1e-12; (c) f32: the compensated driver on the kernels against its
    plain path on the card and against the CPU, each state component
    within 1e-4 of its largest value or 3x the plain path's move under one
    ulp of the params, and its ys differ from the plain f32 driver's; (d)
    one f32 gradient of the full-horizon training loss inside
    ``infra.profiling.trace`` with kernels 4-5 counted from 0: finite,
    both counted, the trace written with both kernels among its CUDA
    kernel events, CUDA kernels per solver step printed; (e)
    ``scripts/robertson_comp32_torch.py`` at a cut depth (3 epochs at lr
    5e-3 per variant, the f64 judge). (f) is ``cli_child``. Returns the
    kernel rows' numbers."""
    import numpy as np

    from crnn_tpu_torch.infra.profiling import trace
    from crnn_tpu_torch.ode.compensated import two_sum
    from crnn_tpu_torch.ops.crnn_kernels import (crnn_rhs_batched,
                                                 crnn_rhs_jac_batched)

    counters = (crnn_rhs_batched, crnn_rhs_jac_batched)
    script = comp32_script()
    cfg = setup.extras["config"]
    ds = setup.dataset

    # (a) two_sum on the card
    t0 = time.perf_counter()
    rng = np.random.default_rng(17)
    n = 1 << 20
    a, b = (torch.from_numpy((rng.standard_normal(n)
                              * 2.0 ** rng.integers(-30, 30, n))
                             .astype(np.float32)).cuda() for _ in range(2))
    s, e = two_sum(a, b)
    exact = bool(torch.equal(s.double() + e.double(), a.double() + b.double()))
    print(f"  17(a) two_sum on {n} f32 pairs: s + e == a + b in f64 {exact}, "
          f"{int((e != 0).sum())} non-zero errors; "
          f"{time.perf_counter() - t0:.2f} s")
    if not exact:
        fail("17(a): two_sum is not error-free on the card")

    def solve(dtype, comp=True, plain=False, params=trained, device=None):
        run = script.make_solve(cfg, setup, dtype, comp, plain,
                                device=device)
        with torch.no_grad():
            return run(params, ds.u0)

    # (b) f64: compensated against the plain batch driver, both on kernels
    t0 = time.perf_counter()
    comp64, plain64 = solve(torch.float64), solve(torch.float64, comp=False)
    torch.cuda.synchronize()
    rel = float(((comp64.ys - plain64.ys).abs()
                 / (1e-12 + 1e-10 * plain64.ys.abs())).max())
    same_steps = torch.equal(comp64.n_steps, plain64.n_steps)
    print(f"  17(b) f64 compensated vs batch driver (kernels 4-5, "
          f"{ds.u0.shape[0]} lanes): "
          f"n_steps equal {same_steps} (max {int(comp64.n_steps.max())}), "
          f"all done {bool(comp64.success.all())}, max |diff| / (1e-12 + "
          f"1e-10 |ys|) {rel:.3e}; {time.perf_counter() - t0:.2f} s")
    if not (same_steps and bool(comp64.success.all())
            and bool(plain64.success.all()) and rel <= 1.0):
        fail("17(b): the f64 compensated driver differs from the batch "
             "driver")

    # (c) f32: kernel path against the plain path and against the CPU
    t0 = time.perf_counter()
    p32 = trained.float()
    ys_k = solve(torch.float32).ys
    ys_p = solve(torch.float32, plain=True).ys
    p_ulp = torch.nextafter(p32, torch.full_like(p32, math.inf))
    witness = (solve(torch.float32, plain=True, params=p_ulp).ys
               - ys_p).abs().amax(dim=(0, 1))
    ys_cpu = solve(torch.float32, device="cpu").ys.to(ys_k.device)
    ys_f32 = solve(torch.float32, comp=False).ys
    torch.cuda.synchronize()
    print(f"  17(c) f32 one-ulp witness per component (plain path) "
          f"{witness.tolist()}")
    gate_per_component("17(c) f32 compensated kernel vs plain path", ys_k,
                       ys_p, witness)
    gate_per_component("17(c) f32 compensated card vs CPU", ys_k, ys_cpu,
                       witness)
    moved = float((ys_k - ys_f32).abs().max())
    print(f"  17(c) compensation acts: max |comp - plain f32 driver| "
          f"{moved:.3e}; {time.perf_counter() - t0:.2f} s")
    if not moved > 0.0:
        fail("17(c): the compensated f32 ys equal the plain driver's")

    # (d) one f32 gradient under the profiler
    t0 = time.perf_counter()
    train_loss, _ = script.make_variant(cfg, setup, torch.float32, True)
    q = p32.clone().requires_grad_(True)
    with tempfile.TemporaryDirectory() as logdir:
        for c in counters:
            c.launches = 0
        with trace(logdir):
            (g,) = torch.autograd.grad(train_loss(q), q)
        launches = [c.launches for c in counters]
        t_grad = time.perf_counter() - t0
        kernels, n_bytes = trace_kernels(logdir)
    n_kernels = sum(kernels.values())
    traced = {k: sum(n for name, n in kernels.items()
                     if f"{k}_kernel<".encode() in name)
              for k in ("crnn_rhs", "crnn_rhs_jac")}
    per_step = n_kernels / cfg.max_steps
    print(f"  17(d) f32 gradient through the compensated driver under the "
          f"profiler: {t_grad:.2f} s; launches kernel 4 {launches[0]}, "
          f"kernel 5 {launches[1]}; trace {n_bytes / 2**20:.1f} MiB, "
          f"{n_kernels} CUDA kernels ({per_step:.1f} per solver step, "
          f"forward, recompute and backward), crnn_rhs {traced['crnn_rhs']}, "
          f"crnn_rhs_jac {traced['crnn_rhs_jac']}; grad finite "
          f"{bool(torch.isfinite(g).all())}; "
          f"{time.perf_counter() - t0:.2f} s")
    if not (bool(torch.isfinite(g).all()) and min(launches) > 0
            and min(traced.values()) > 0):
        fail("17(d): the gradient is not finite, a kernel was not launched "
             "or is not in the trace")

    # (e) the experiment script at a cut depth
    t0 = time.perf_counter()
    results = script.run(epochs_per_stage=3, lrs=(5e-3,), device="cuda",
                         setup=setup)["results"]
    for name, r in results.items():
        print(f"  17(e) {name}: {r['ms_per_epoch']:.1f} ms/epoch, own train "
              f"{r['own_train']:.4e}, f64-judged train {r['f64_train']:.4e}, "
              f"val {r['f64_val']:.4e}")
    print(f"  17(e): {time.perf_counter() - t0:.2f} s")
    if not all(math.isfinite(r[k]) for r in results.values()
               for k in ("own_train", "f64_train", "f64_val")):
        fail("17(e): a variant's loss is not finite")

    return {
        "crnn_rhs": {"comp32_grad_launches": launches[0],
                     "comp32_cuda_kernels_per_step": per_step,
                     "comp32_grad_traced_s": t_grad,
                     **{f"comp32_{k}_ms_per_epoch": r["ms_per_epoch"]
                        for k, r in results.items()}},
        "crnn_rhs_jac": {"comp32_grad_launches": launches[1]}}


def cli_child(out_path: str):
    """Phase 17(f) in a process of its own beside the children of phases
    13-15 (it times nothing into the kernels line): ``python -m
    crnn_tpu_torch.cli list`` and ``... cli case1 --epochs 1`` in
    subprocesses on their default device, each exiting 0, the case writing
    one metrics line; its output to a log beside ``out_path``."""
    with open(out_path + ".log", "w") as log, \
            contextlib.redirect_stdout(log), \
            tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        runs = [subprocess.run(
            [sys.executable, "-m", "crnn_tpu_torch.cli", *args], cwd=HERE,
            capture_output=True, text=True, timeout=600)
            for args in (("list",), ("case1", "--epochs", "1", "--out", out))]
        metrics = Path(out) / "case1" / "metrics.jsonl"
        n_lines = (len(metrics.read_text().splitlines())
                   if metrics.exists() else 0)
        print(f"  17(f) cli list rc {runs[0].returncode}, cli case1 --epochs "
              f"1 rc {runs[1].returncode}: "
              f"{runs[1].stdout.strip().splitlines()[-1:]}, metrics.jsonl "
              f"lines {n_lines}; {time.perf_counter() - t0:.2f} s",
              flush=True)
        if not (runs[0].returncode == 0 and runs[1].returncode == 0
                and n_lines == 1):
            fail("17(f): the cli failed: " + runs[1].stderr[-2000:])
    Path(out_path).write_text(json.dumps({"seconds":
                                          time.perf_counter() - t0}))


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: chip_smoke.py needs a "
              "CUDA card", flush=True)
        return 2
    sys.path.insert(0, str(HERE))
    import crnn_tpu_torch  # noqa: F401  (fails outside a checkout)

    if Path(crnn_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"crnn_tpu_torch imported from {crnn_tpu_torch.__file__}, "
             "not from this checkout")
    # the CPU references of phases 12(a) and 14 run in a process of their
    # own while the card runs the phases before them
    bg = Background()
    bg.start("refs", cpu_references)
    bg.start("uq_refs", uq_cpu_references)
    try:
        return run_phases(bg)
    finally:
        bg.stop()


class Background:
    """CPU work in processes of their own (``spawn``), each writing one JSON
    result, while the card runs other phases. ``result(name)`` waits for
    one and fails the run if it failed; ``stop()`` ends every process."""

    def __init__(self):
        self.tmp = tempfile.TemporaryDirectory()
        self.procs = {}

    def path(self, name: str) -> str:
        return str(Path(self.tmp.name) / name)

    def start(self, name: str, target, *args):
        """``target(out_path, *args)`` in a new process."""
        proc = multiprocessing.get_context("spawn").Process(
            target=target, args=(self.path(name + ".json"), *args),
            daemon=True)
        proc.start()
        self.procs[name] = proc

    def result(self, name: str):
        proc = self.procs[name]
        proc.join()
        out = Path(self.path(name + ".json"))
        if proc.exitcode != 0:
            log = Path(str(out) + ".log")
            tail = log.read_text()[-2000:] if log.exists() else ""
            fail(f"background {name} failed (exit {proc.exitcode}): {tail}")
        return json.loads(out.read_text())

    def stop(self):
        for proc in self.procs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
        self.tmp.cleanup()


def run_phases(bg: Background) -> int:
    """Phases 1-17 and the closing lines; ``bg`` holds the CPU work that
    runs beside them (``cpu_references``, ``lm_cpu_references``,
    ``uq_cpu_references``) and phases 14-15 on the card."""
    def refs():
        return bg.result("refs")

    from crnn_tpu_torch.ops import _build
    from crnn_tpu_torch.ops.crnn_kernels import (
        arrhenius_rhs_batched, arrhenius_rhs_batched_reference)

    t_all = time.perf_counter()
    with phase("1 device"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        print(f"nvidia-smi: {smi}")
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        t0 = time.perf_counter()
        libs = _build.build("arrhenius_rhs", "arrhenius_rhs_jac",
                            "arrh_rb23_solve", "crnn_rhs", "crnn_rhs_jac",
                            "latency_probe")
        print(f"kernel build: {time.perf_counter() - t0:.2f} s")
        for name, path in libs.items():
            for line in path.with_suffix(".log").read_text().splitlines():
                if "Compiling entry" in line or "registers" in line or (
                        "spill" in line):
                    print(f"  ptxas {name}: {line.strip()}")
        lat = {dtype: op_latencies(dtype)
               for dtype in (torch.float32, torch.float64)}
        for dtype, ns_per_op in lat.items():
            print(f"  ns per dependent operation {str(dtype)[6:]}: "
                  + json.dumps({k: round(v, 3) for k, v in ns_per_op.items()}))

    gen = torch.Generator().manual_seed(0)
    # the tile coverage of kernels 1-2 draws from its own generator, so
    # phase 3 and the later phases see the draws they saw before it
    cov_gen = torch.Generator().manual_seed(8)
    kernel_row = {}
    with phase("2 kernels"):
        cases = [(b, torch.float32) for b in (20, 30, 4099, 65536)]
        cases.append((30, torch.float64))
        for batch, dtype in cases:
            rtol, atol = _TOL[dtype]
            for edges in (False, True):
                (y, w_in, w_b, w_out), (lb, ub) = arrhenius_inputs(
                    batch, dtype, gen, edges)
                out = arrhenius_rhs_batched(y, w_in, w_b, w_out, lb, ub)
                ref = arrhenius_rhs_batched_reference(y, w_in, w_b, w_out,
                                                      lb, ub)
                torch.cuda.synchronize()
                ok, err = compare(out, ref, rtol, atol)
                print(f"  arrhenius_rhs B={batch} {str(dtype)[6:]} "
                      f"edges={edges}: max_abs_err={err:.3e} ok={ok}")
                if not ok:
                    fail(f"arrhenius_rhs disagrees with its plain version at "
                         f"B={batch} {dtype} edges={edges}")
                if batch == 20 and dtype == torch.float32 and not edges:
                    kernel_row["max_abs_err"] = err
            if edges:
                # exp cap: a bias that lifts every rate above exp(32); w_out
                # of one sign, so du is a sum without cancellation and rtol
                # is meaningful at ~1e14
                w_b_cap = w_b + 40.0
                w_out_pos = w_out.abs()
                out = arrhenius_rhs_batched(y, w_in, w_b_cap, w_out_pos, lb, ub)
                ref = arrhenius_rhs_batched_reference(y, w_in, w_b_cap,
                                                      w_out_pos, lb, ub)
                torch.cuda.synchronize()
                ok, err = compare(out, ref, rtol, atol)
                print(f"  arrhenius_rhs B={batch} {str(dtype)[6:]} exp-cap: "
                      f"max_abs_err={err:.3e} ok={ok}")
                if not ok:
                    fail(f"arrhenius_rhs disagrees at the exp cap, B={batch}")
        for batch in (20, 30, 4099, 65536):
            (y, w_in, w_b, w_out), (lb, ub) = arrhenius_inputs(
                batch, torch.float32, gen, False)
            times = {
                "kernel_device": device_ms(lambda: arrhenius_rhs_batched(
                    y, w_in, w_b, w_out, lb, ub)),
                "plain_device": device_ms(lambda: arrhenius_rhs_batched_reference(
                    y, w_in, w_b, w_out, lb, ub)),
                "kernel_eager": eager_ms(lambda: arrhenius_rhs_batched(
                    y, w_in, w_b, w_out, lb, ub)),
                "plain_eager": eager_ms(lambda: arrhenius_rhs_batched_reference(
                    y, w_in, w_b, w_out, lb, ub)),
                "floor_device": floor_ms(y),
            }
            bound, bound_by = arrhenius_bound_ms(batch, 6, 3, torch.float32)
            print(f"  arrhenius_rhs B={batch} f32 ms/call: " + ", ".join(
                f"{k}={v:.5f}" for k, v in times.items())
                + f", bound={bound:.3e} ({bound_by})")
            if batch == 20:
                kernel_row.update(
                    ms=times["kernel_device"], plain_ms=times["plain_device"],
                    ms_eager=times["kernel_eager"],
                    plain_ms_eager=times["plain_eager"], bound_ms=bound,
                    bound_by=bound_by, floor_ms=times["floor_device"])
        kernel_row["f64_b30"] = time_arrhenius_f64(False, cov_gen)
        arrhenius_coverage(False, cov_gen)

    with phase("3 slice"):
        row, setup, trained = run_slice("cuda", gen)
        kernel_row.update(row)

    with phase("4 kernels 2-3"):
        jac_row = check_rhs_jac_kernel(gen)
        jac_row["f64_b30"] = time_arrhenius_f64(True, cov_gen)
        arrhenius_coverage(True, cov_gen)
        solve_row = check_solve_kernel(setup, gen, lat)

    with phase("5 dense slice"):
        jac_row.update(run_dense_slice(setup.dataset, gen))

    with phase("6 fused eval"):
        solve_row.update(run_fused_eval(setup, trained))

    with phase("7 kernels 4-5"):
        iso_row, iso_jac_row = check_crnn_kernels(gen)
        # case3's and the GRN's shapes draw from a generator of their own,
        # so the later phases see the draws they saw before them
        for shape, times in check_crnn_rhs_family_shapes(
                torch.Generator().manual_seed(11)).items():
            iso_row[f"{shape}_shape"] = times
        for shape, times in check_crnn_rhs_hybrid_shapes(
                torch.Generator().manual_seed(13)).items():
            iso_row[f"{shape}_shape"] = times

    with phase("8 case1"):
        iso_row.update(run_case1(gen))

    with phase("9 robertson"):
        rob, rob_setup, rob_trained = run_robertson(gen)
        # 12(d)'s CPU side from phase 9's data and trained params, in the
        # background while the card runs phases 10-12(c)
        lm_in = bg.path("lm_inputs.pt")
        ds = rob_setup.dataset
        torch.save({"dataset": {f: getattr(ds, f).cpu() for f in ds._fields},
                    "params": rob_trained.cpu()}, lm_in)
        bg.start("lm", lm_cpu_references, lm_in)
        iso_row["robertson_launches"] = rob.pop("rhs_launches")
        iso_jac_row.update(rob)

    with phase("10 runner"):
        runner = run_runner(gen)
        kernel_row.update(runner["arrhenius_rhs"])
        jac_row.update(runner["arrhenius_rhs_jac"])
        iso_row.update(runner["crnn_rhs"])

    with phase("11 isothermal family"):
        iso_row.update(run_isothermal_family(gen))

    with phase("12 ODE suite"):
        t0 = time.perf_counter()
        solver_s = check_solvers_card_vs_cpu(refs)
        print(f"  12(a): {time.perf_counter() - t0:.2f} s")
        case2_rows = run_case2_solvers(gen)
        kernel_row.update(case2_rows["arrhenius_rhs"])
        jac_row.update(case2_rows["arrhenius_rhs_jac"])
        rob_rows = run_robertson_suite(gen, rob_setup, rob_trained,
                                       lambda: bg.result("lm"))
        iso_row.update(rob_rows["crnn_rhs"])
        iso_jac_row.update(rob_rows["crnn_rhs_jac"])
        iso_row["ode_suite_card_s"] = solver_s

    with phase("16 data parallel"):
        dp_rows = run_data_parallel()
        kernel_row.update(dp_rows["arrhenius_rhs"])
        jac_row.update(dp_rows["arrhenius_rhs_jac"])

    with phase("17 compensated f32"):
        comp_rows = run_compensated(rob_setup, rob_trained)
        iso_row.update(comp_rows["crnn_rhs"])
        iso_jac_row.update(comp_rows["crnn_rhs_jac"])

    # phases 13-15 run on the card in four processes of their own, beside
    # one another, after every phase that times into the kernels line: no
    # number of phases 1-12, 16 and 17 is taken beside them. Each part of
    # phase 13 draws from a generator of its own
    with phase("13-15 (13(a), 13(b), 14, 15 and 17(f) beside one another)"):
        bg.start("phase13a", hybrid_child, "a", 17)
        bg.start("phase13b", hybrid_child, "b", 19)
        bg.start("phase14", single_fit_child, bg.path("refs.json"))
        bg.start("phase15", uq_child)
        bg.start("phase17f", cli_child)
        for part in ("a", "b"):
            iso_row.update(bg.result(f"phase13{part}"))
            print(Path(bg.path(f"phase13{part}.json") + ".log").read_text(),
                  end="")
        single_fit = bg.result("phase14")
        print(Path(bg.path("phase14.json") + ".log").read_text(), end="")
        print("single-fit seconds: " + json.dumps(single_fit))
        uq_card = bg.result("phase15")
        print(Path(bg.path("phase15.json") + ".log").read_text(), end="")
        uq = uq_card_vs_cpu(uq_card, bg.result("uq_refs"))
        print("UQ: " + json.dumps(uq))
        bg.result("phase17f")
        print(Path(bg.path("phase17f.json") + ".log").read_text(), end="")

    print(f"total {time.perf_counter() - t_all:.1f} s")
    print("library_ms: null for every kernel: no single PyTorch call computes "
          "the Arrhenius or the isothermal CRNN RHS, their fused "
          "value+Jacobian, or a whole adaptive Rosenbrock23 solve")
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")
    kernels = [{
        "name": name,
        "route": "cuda",
        "source": f"crnn_tpu_torch/ops/csrc/{name}.cu",
        "replaces": replaces,
        **{k: row[k] for k in keys},
        "library_ms": None,
        **{k: v for k, v in row.items() if k not in keys},
    } for name, replaces, row in (
        ("arrhenius_rhs", "crnn_tpu/ops/crnn_kernels.py:171", kernel_row),
        ("arrhenius_rhs_jac", "crnn_tpu/ops/crnn_kernels.py:185", jac_row),
        ("arrh_rb23_solve", "crnn_tpu/ops/rb23_solve_kernel.py:85",
         solve_row),
        ("crnn_rhs", "crnn_tpu/ops/crnn_kernels.py:67", iso_row),
        ("crnn_rhs_jac", "crnn_tpu/ops/crnn_kernels.py:75", iso_jac_row))]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
