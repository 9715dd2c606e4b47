"""Chip smoke test of crnn_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printed with the seconds it took:

1. device: the card's name and power limit (nvidia-smi), the torch version,
   and the build of every CUDA kernel of the main path with plain nvcc;
2. kernels: each kernel against its plain PyTorch version on the card, at
   the batch sizes of the main path and beyond, on edge inputs (x < lb,
   x = lb, x > ub, x = 0, NaN, +-inf, the exp cap); NaN positions must match
   exactly, finite values at rtol 1e-5 / atol 1e-6 (f32) or 1e-12 (f64);
   then the kernel's device time against the plain version's;
3. slice: the case2 batch-mode training epoch at full width (30
   experiments, 50 save points, max_steps 128, f32): data generated on the
   card, 3 guarded epochs through run_case with every launch counter set to
   0 just before and read just after (finite, decreasing training loss);
   the generated truth against an f64 CPU re-solve; the kernel path against
   the same inputs forced onto the plain path at rtol 1e-4: the f32 losses
   (train and eval) and a whole f64 epoch (loss, grad, eval losses). In f32
   the gradient follows the rounding of the adaptive step sequence, which
   a one-ulp probe prints.

The last lines are the card (nvidia-smi), one JSON line with every
kernel's numbers, and the result line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Any failed check exits non-zero before the result line. Without a CUDA card,
or run from a directory without the crnn_tpu_torch package, it fails.
"""

from __future__ import annotations

import contextlib
import json
import math
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


def eager_ms(fn, n: int = 500) -> float:
    """Milliseconds per call of eager calls back to back (host launch cost
    included), timed with CUDA events after a warm-up."""
    for _ in range(20):
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
    t_bytes = n_bytes / _HBM_BYTES_PER_S * 1e3
    t_flops = flops / _PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def run_slice(device: str, gen: torch.Generator) -> dict:
    """Phase 3 on ``device``: the case2 main path and its checks. Returns
    the kernel row's main-path numbers (launches, epoch times)."""
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
        _, hist = run_case(setup, n_epoch, out_dir=out_dir, log_every=1)
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
    f32 = [forward_losses(s, p0, perm, cfg) for s in (setup, plain)]
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
    return row


def forward_losses(setup, params, perm, cfg):
    """(mean training loss through the scan, eval losses through the
    early-exit solve) at ``params``, without gradients."""
    dev = params.device
    with torch.no_grad():
        train = setup.trainer.loss_batch(
            params, perm, torch.ones((perm.shape[0], cfg.datasize),
                                     dtype=params.dtype, device=dev)).mean()
        evals = setup.trainer.loss_batch_eval(
            params, torch.arange(cfg.n_exp, device=dev),
            torch.ones((cfg.n_exp, cfg.datasize), dtype=params.dtype,
                       device=dev))
    return train, evals


def compare_epoch(name, a, b):
    """Kernel path ``a`` against plain path ``b``: rtol 1e-4 of each entry,
    plus 1e-4 of the largest entry for entries near 0 (a gradient component
    can be ~0); fails the run if they disagree."""
    tol = _EPOCH_RTOL * (b.abs() + b.abs().max())
    rel = float(((a - b).abs() / b.abs().max()).max())
    ok = bool(torch.isfinite(a).all()) and bool(((a - b).abs() <= tol).all())
    print(f"  kernel vs plain {name}: max rel err {rel:.3e} ok={ok}")
    if not ok:
        fail(f"kernel path {name} disagrees with the plain path")


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
        libs = _build.build("arrhenius_rhs")
        print(f"kernel build: {time.perf_counter() - t0:.2f} s")
        for name, path in libs.items():
            for line in path.with_suffix(".log").read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  ptxas {name}: {line.strip()}")

    gen = torch.Generator().manual_seed(0)
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
                    bound_by=bound_by)

    with phase("3 slice"):
        kernel_row.update(run_slice("cuda", gen))

    print(f"total {time.perf_counter() - t_all:.1f} s")
    kernels = [{
        "name": "arrhenius_rhs",
        "route": "cuda",
        "source": "crnn_tpu_torch/ops/csrc/arrhenius_rhs.cu",
        "replaces": "crnn_tpu/ops/crnn_kernels.py:171",
        "launches": kernel_row["launches"],
        "max_abs_err": kernel_row["max_abs_err"],
        "ms": kernel_row["ms"],
        "plain_ms": kernel_row["plain_ms"],
        "bound_ms": kernel_row["bound_ms"],
        "bound_by": kernel_row["bound_by"],
        "library_ms": None,
        **{k: v for k, v in kernel_row.items() if k not in (
            "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by")},
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
