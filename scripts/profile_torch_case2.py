"""Where the time of one crnn_tpu_torch case2 training epoch goes, on one
CUDA card.

    python3 scripts/profile_torch_case2.py [--epochs 3] [--out PATH]

At the shipped configuration (30 experiments, 50 save points,
max_steps 128, f32, lowrank) it times, for the kernel path and the plain
path (``rhs_plain=True``) in turns (kernel, plain, plain, kernel):

- the epoch (host clock around ``Trainer.epoch`` ending in a synchronize),
  and its two parts: the gradient (``value_and_grad`` through the
  checkpointed 128-step scan) and the evaluation pass (early-exit solve,
  with its count of kernel launches: two per step plus two);
- the RHS op alone at the eval shape, back to back and with one host sync
  per call as in the early-exit solve;
- one epoch under ``torch.profiler``: CUDA kernels launched, their summed
  device time, the device's busy share of the epoch's device span (union of
  kernel intervals over first start to last end), and the kernels that take
  the most device time.

Writes one JSON file (default ``runs_torch/profile_torch_case2.json``) and
prints a summary, with the card's name and power limit. ``--device cpu``
rehearses the script without a card; it then reports no device numbers.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from crnn_tpu_torch.cases.case2 import Case2Config, build  # noqa: E402
from crnn_tpu_torch.ops.crnn_kernels import (  # noqa: E402
    arrhenius_rhs_batched, make_arrhenius_ops)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def _rhs_loop_ms(setup, plain, device, sync_each, n=200):
    """Host ms per call of the RHS op (kernel or plain) at the eval shape
    (B=30) under no_grad, back to back or each followed by a host sync as in
    the ``while`` solve (``bool(torch.any(...))`` once per step)."""
    cfg = Case2Config()
    w = setup.weights_fn(setup.init_params)
    y = setup.dataset.u0.contiguous()
    op = make_arrhenius_ops(cfg.lb, cfg.ub, plain=plain)
    with torch.no_grad():
        for _ in range(10):
            op(y, w.w_in, w.w_b, w.w_out)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            du = op(y, w.w_in, w.w_b, w.w_out)
            if sync_each:
                bool(torch.any(du > 1e30))
        _sync(device)
    return (time.perf_counter() - t0) / n * 1e3


def _profile_epoch(setup, p0, perm, device):
    """Kernel count, device time and busy share of one profiled epoch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer = setup.trainer
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    state = trainer.init(p0)
    _sync(device)
    with profile(activities=activities) as prof:
        trainer.epoch(state, perm)
        _sync(device)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"kernels": "not measured", "device_ms": "not measured",
                "busy_share": "not measured", "top": []}
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {
        "kernels": len(kernels),
        "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        "device_span_ms": span / 1e3,
        "busy_share": busy / span,
        "top": [{"name": n[:90], "launches": c, "ms": t / 1e3}
                for n, (c, t) in top],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=str(ROOT / "runs_torch"
                                         / "profile_torch_case2.json"))
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    card = "not measured (no card)"
    if device.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]

    kernel = build(Case2Config(device=args.device))
    plain = build(Case2Config(device=args.device, rhs_plain=True),
                  dataset=kernel.dataset)
    perm = torch.randperm(20, generator=torch.Generator().manual_seed(0))
    results = {"kernel": defaultdict(list), "plain": defaultdict(list)}
    for name in ("kernel", "plain", "plain", "kernel"):
        setup = kernel if name == "kernel" else plain
        tr = setup.trainer
        p0 = kernel.init_params
        tr.epoch(tr.init(p0), perm)       # warm-up
        for _ in range(args.epochs):
            arrhenius_rhs_batched.launches = 0
            t, _ = _timed(lambda: tr.epoch(tr.init(p0), perm), device)
            results[name]["epoch_s"].append(t)
            results[name]["arrhenius_launches"].append(
                arrhenius_rhs_batched.launches)
            t, _ = _timed(lambda: tr.value_and_grad(p0, perm.to(device)),
                          device)
            results[name]["grad_s"].append(t)
            ones = torch.ones((30, 50), dtype=p0.dtype, device=device)
            idx = torch.arange(30, device=device)
            arrhenius_rhs_batched.launches = 0
            with torch.no_grad():
                t, _ = _timed(lambda: tr.loss_batch_eval(p0, idx, ones), device)
            results[name]["eval_s"].append(t)
            results[name]["eval_arrhenius_launches"].append(
                arrhenius_rhs_batched.launches)
            for sync_each in (False, True):
                key = "rhs_call_synced_ms" if sync_each else "rhs_call_ms"
                results[name][key].append(_rhs_loop_ms(
                    setup, name == "plain", device, sync_each))
    report = {"card": card, "torch": torch.__version__, "config":
              "case2 shipped: 20+10 experiments, 50 save points, "
              "max_steps 128, f32, lowrank", "paths": {}}
    for name in ("kernel", "plain"):
        r = results[name]
        setup = kernel if name == "kernel" else plain
        report["paths"][name] = {
            **{k: v for k, v in r.items()},
            "epoch_s_median": statistics.median(r["epoch_s"]),
            "grad_s_median": statistics.median(r["grad_s"]),
            "eval_s_median": statistics.median(r["eval_s"]),
            "profile": _profile_epoch(setup, kernel.init_params, perm, device),
        }
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    print(f"card: {card}")
    for name, r in report["paths"].items():
        prof = r["profile"]
        print(f"{name}: epoch_s median {r['epoch_s_median']:.4f} "
              f"(grad {r['grad_s_median']:.4f}, eval {r['eval_s_median']:.4f}); "
              f"arrhenius launches/epoch {r['arrhenius_launches'][-1]}; "
              f"profiled epoch: {prof['kernels']} kernels, device "
              f"{prof['device_ms']} ms, busy share {prof['busy_share']}")
        print(f"    eval launches {r['eval_arrhenius_launches']}; rhs op ms/call "
              f"{statistics.median(r['rhs_call_ms']):.4f}, with a sync per "
              f"call {statistics.median(r['rhs_call_synced_ms']):.4f}")
        for row in prof["top"]:
            print(f"    {row['launches']:6d} x {row['ms']:9.3f} ms  {row['name']}")
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
