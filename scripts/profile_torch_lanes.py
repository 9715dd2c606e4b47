"""Where the time of one crnn_tpu_torch case1 or robertson training epoch
goes, on one CUDA card.

    python3 scripts/profile_torch_lanes.py [--case case1|robertson] [--epochs 3] [--out PATH]

At the shipped configuration (case1: 20+10 experiments, 100 save points,
Tsit5, max_steps 128, f32; robertson: 20+5 experiments, 40 save points,
Rosenbrock23, max_steps 192, f64, stochastic horizons) it times, for the
kernel path and the plain path (``rhs_plain=True``) in turns (kernel, plain,
plain, kernel):

- the epoch (host clock around ``Trainer.epoch`` ending in a synchronize)
  with its launches of the isothermal RHS kernel (kernel 4) and its
  value+Jacobian kernel (kernel 5), and its two parts: the gradient
  (``value_and_grad`` through the checkpointed scan) and the evaluation pass
  (early-exit solve of every experiment);
- one epoch under ``torch.profiler``: CUDA kernels launched, their summed
  device time, the device's busy share of the epoch's device span, and the
  kernels that take the most device time
  (``scripts/profile_torch_case2.py:_profile_epoch``).

Writes one JSON file (default ``runs_torch/profile_torch_<case>.json``) and
prints a summary, with the card's name and power limit. ``--device cpu``
rehearses the script without a card; it then reports no device numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from crnn_tpu_torch.cases import case1, robertson  # noqa: E402
from crnn_tpu_torch.ops.crnn_kernels import (  # noqa: E402
    crnn_rhs_batched, crnn_rhs_jac_batched)
from profile_torch_case2 import _profile_epoch, _timed  # noqa: E402

CASES = {"case1": (case1, case1.Case1Config),
         "robertson": (robertson, robertson.RobertsonConfig)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="case1", choices=tuple(CASES))
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = Path(args.out or ROOT / "runs_torch"
               / f"profile_torch_{args.case}.json")
    device = torch.device(args.device)
    card = "not measured (no card)"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]

    module, config = CASES[args.case]
    cfg = config(device=args.device)
    kernel = module.build(cfg)
    plain = module.build(config(device=args.device, rhs_plain=True),
                         dataset=kernel.dataset)
    gen = torch.Generator().manual_seed(0)
    p0 = kernel.init_params
    trainer = kernel.trainer
    perm = torch.randperm(trainer.n_exp_train, generator=gen)
    masks = trainer.sample_masks(gen, trainer.n_exp_train, p0.dtype)
    idx = torch.arange(trainer.n_exp, device=device)
    ones = torch.ones((trainer.n_exp, trainer.n_save), dtype=p0.dtype,
                      device=device)
    results = {"kernel": defaultdict(list), "plain": defaultdict(list)}
    for name in ("kernel", "plain", "plain", "kernel"):
        tr = (kernel if name == "kernel" else plain).trainer
        tr.epoch(tr.init(p0), perm, masks)       # warm-up
        for _ in range(args.epochs):
            crnn_rhs_batched.launches = crnn_rhs_jac_batched.launches = 0
            t, _ = _timed(lambda: tr.epoch(tr.init(p0), perm, masks), device)
            results[name]["epoch_s"].append(t)
            results[name]["rhs_launches"].append(crnn_rhs_batched.launches)
            results[name]["rhs_jac_launches"].append(
                crnn_rhs_jac_batched.launches)
            t, _ = _timed(lambda: tr.value_and_grad(p0, perm.to(device),
                                                    masks), device)
            results[name]["grad_s"].append(t)
            with torch.no_grad():
                t, _ = _timed(lambda: tr.loss_batch_eval(p0, idx, ones),
                              device)
            results[name]["eval_s"].append(t)
    report = {"card": card, "torch": torch.__version__,
              "config": f"{args.case} shipped ({cfg})", "paths": {}}
    for name in ("kernel", "plain"):
        r = results[name]
        setup = kernel if name == "kernel" else plain
        report["paths"][name] = {
            **r,
            "epoch_s_median": statistics.median(r["epoch_s"]),
            "grad_s_median": statistics.median(r["grad_s"]),
            "eval_s_median": statistics.median(r["eval_s"]),
            "profile": _profile_epoch(setup, p0, perm, device),
        }
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"card: {card}")
    for name, r in report["paths"].items():
        prof = r["profile"]
        print(f"{args.case} {name}: epoch_s median {r['epoch_s_median']:.4f} "
              f"(grad {r['grad_s_median']:.4f}, eval {r['eval_s_median']:.4f});"
              f" launches/epoch rhs {r['rhs_launches'][-1]}, rhs_jac "
              f"{r['rhs_jac_launches'][-1]}; profiled epoch: "
              f"{prof['kernels']} kernels, device {prof['device_ms']} ms, "
              f"busy share {prof['busy_share']}")
        for row in prof["top"]:
            print(f"    {row['launches']:6d} x {row['ms']:9.3f} ms  "
                  f"{row['name']}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
