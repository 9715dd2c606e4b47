"""Where the time of the crnn_tpu_torch cathode UQ case goes, on one CUDA
card.

    python3 scripts/profile_torch_uq.py [--particles 100] [--maxiters 512]
        [--iters 1] [--out PATH] [--device cuda|cpu]

At ``CathodeUQConfig()`` (100 particles, f64, the batch-major Rosenbrock23
at rtol 1e-4 with a 512-step checkpointed scan) it times, host clock ending
in a synchronize:

- one gradient solve (``value_and_grad`` of the 100 per-particle losses of
  one heating-rate curve: the forward scan, its recompute and its
  backward), twice;
- one validation solve without a gradient (the early-exit driver);
- ``--iters`` SVGD iterations through ``run_uq`` (4 gradient solves and one
  validation solve each);
- gradient solves of 32 and 64 steps under ``torch.profiler``: CUDA
  kernels launched, their summed device time and the device's busy share
  of the span; every step of the scan runs the same ops, so the kernels of
  the ``--maxiters`` solve are extrapolated from the two (a profile of a
  million kernels costs more than the solve).

Writes one JSON file (default ``runs_torch/profile_torch_uq.json``) and
prints it with the card's name and power limit. ``--device cpu`` runs the
same on the CPU (no device numbers).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from crnn_tpu_torch.cases.cathode_uq import (  # noqa: E402
    CathodeUQConfig, build_uq, run_uq)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def profile_kernels(fn, device) -> dict:
    """CUDA kernels of one ``fn()``: count, summed device ms, busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
            as prof:
        fn()
        _sync(device)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    span = (spans[-1][1] - spans[0][0]) if spans else 0.0
    return {"cuda_kernels": len(spans),
            "device_ms": sum(e - s for s, e in spans) / 1e3,
            "busy_share": busy / span if span else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--maxiters", type=int, default=512)
    ap.add_argument("--iters", type=int, default=1)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="runs_torch/profile_torch_uq.json")
    args = ap.parse_args(argv)
    cfg = CathodeUQConfig(num_particles=args.particles,
                          maxiters=args.maxiters, n_iters=args.iters,
                          device=args.device)
    out = {"config": vars(args), "torch": torch.__version__}
    if args.device == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    particles, _, ex = build_uq(cfg)
    device = particles.device
    out["grad_solve_s"] = [
        _timed(lambda: ex["value_and_grad"](particles, 0), device)[0]
        for _ in range(2)]
    out["val_solve_s"] = _timed(lambda: ex["loss_all"](particles, 3),
                                device)[0]
    seconds, _ = _timed(lambda: run_uq(cfg, verbose=False), device)
    out["svgd_iteration_s"] = seconds / args.iters
    if args.device == "cuda":
        prof = {}
        for steps in (32, 64):
            p_s, _, ex_s = build_uq(CathodeUQConfig(
                num_particles=args.particles, maxiters=steps,
                device=args.device))
            prof[steps] = profile_kernels(
                lambda: ex_s["value_and_grad"](p_s, 0), device)
        per_step = (prof[64]["cuda_kernels"] - prof[32]["cuda_kernels"]) / 32
        out["grad_solve_profile"] = {
            "32_steps": prof[32], "64_steps": prof[64],
            "cuda_kernels_per_step": per_step,
            "cuda_kernels_extrapolated": prof[32]["cuda_kernels"]
            + per_step * (args.maxiters - 32)}
    print(json.dumps(out, indent=1))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
