"""Device time, host cost and outputs of the whole-solve Rosenbrock23 kernel
(kernel 3, ``arrh_rb23_solve``) of one crnn_tpu_torch tree on one CUDA
card, for comparing two trees in one call.

    python scripts/profile_torch_solve.py --label new [--tree DIR]
        [--save OUT.pt]
    python scripts/profile_torch_solve.py --diff A.pt B.pt
    python scripts/profile_torch_solve.py --sweep

The first form imports ``crnn_tpu_torch`` from DIR (default: this
checkout; for a parent commit, unpack ``git archive <commit>
crnn_tpu_torch`` into an ignored directory), builds the kernel and times
it with ``chip_smoke.py``'s ``device_ms`` (20 solves captured in one CUDA
graph, timed with CUDA events) on case2's initial states and initial
params (``Case2Config()``, seed 0) at B=30 in f32 and f64 and at B=4099
in f32, beside the launch floor (one ``torch.neg`` on y0). It also takes
the wrapper's host cost (fastest of 200 calls, each timed on the host
clock from the call to its return, with the card idle before it) and, at
B=30 f32, the whole-solve evaluator's ``eval_fused_ms`` (host clock, as
``chip_smoke.py`` phase 6 times it) and device ms. It prints the
card, the ptxas lines of the build and one JSON line with every row. With
``--save`` it also writes the kernel's outputs (histories filled with NaN
before the launch) on those inputs in f32 and f64 and on
``chip_smoke.py:solve_inputs`` at (6, 3), (1, 1), (3, 2), (7, 4) and (8, 4)
(B=33) to OUT.pt. Run the trees in separate processes in turns (parent,
new, new, parent).

The second form says, for each input of two saved files, which outputs
are bitwise equal, and for the others how many entries differ and the
first step at which a lane's histories differ. The third times this
checkout's kernel at 1, 2 and 4 warps a block (``sweep``).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
OUTPUTS = ("t", "t_new", "acc", "y", "y_new", "f0", "f2", "status", "n_steps",
           "y_final")


def _case2_inputs(batch, dtype):
    """case2's initial states (``make_u0``, B lanes) and its initial params'
    weights, drawn in f32 from the generators ``case2.build`` draws them
    from (B=30 is ``Case2Config()``'s 20 + 10 experiments) and cast to
    ``dtype``, as ``chip_smoke.py`` phase 4 casts them."""
    from crnn_tpu_torch.cases.base import seed_generators
    from crnn_tpu_torch.cases.case2 import Case2Config, make_u0
    from crnn_tpu_torch.transforms.p2vec import init_params_case2, p2vec_case2

    cfg = Case2Config(n_exp_train=batch - 10, n_exp_test=10)
    g_u0, _, g_p = seed_generators(cfg.seed, 3)
    u0 = make_u0(g_u0, cfg, torch.float32).to("cuda", dtype)
    p = init_params_case2(g_p, cfg.ns, cfg.nr, device="cuda").to(dtype)
    return u0, p2vec_case2(p, cfg.ns, cfg.nr)


def _host_us(fn, n=200):
    """The wrapper's host cost: the fastest of ``n`` calls (after 20 to warm
    up), each timed on the host clock from the call to its return with the
    card idle before it."""
    for _ in range(20):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return min(times)


def _eval_fused(rk, chip_smoke, u0, w, consts):
    """The whole-solve evaluator (``make_arrhenius_fused_solve``: the kernel
    and the dense-output post-pass at 50 save points) on u0: host ms per
    call as ``chip_smoke.py`` phase 6 times ``eval_fused_ms`` (median of
    12 rounds of 10 calls ending in a synchronize), and its device ms
    (``device_ms``, 20 calls in one CUDA graph)."""
    import statistics

    saveat = torch.linspace(0.0, consts["t1"], 50, device=u0.device)
    fused = rk.make_arrhenius_fused_solve(
        6, 3, consts["lb"], consts["ub"], 0.0, consts["t1"], saveat,
        consts["rtol"], consts["atol"], consts["max_steps"])
    rounds = []
    for _ in range(13):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fused(u0, w)
        torch.cuda.synchronize()
        rounds.append((time.perf_counter() - t0) / 10 * 1e3)
    return {"eval_fused_ms": statistics.median(rounds[1:]),
            "eval_fused_device_ms": chip_smoke.device_ms(
                lambda: fused(u0, w), n=20)}


def profile(tree: Path, label: str, save: Path | None) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(tree))
    import crnn_tpu_torch
    from crnn_tpu_torch.cases.case2 import Case2Config
    from crnn_tpu_torch.ops import _build
    from crnn_tpu_torch.ops import rb23_solve_kernel as rk

    pkg = Path(crnn_tpu_torch.__file__).resolve().parent.parent
    if pkg != tree.resolve():
        raise SystemExit(f"crnn_tpu_torch imported from {pkg}, not {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    path = _build.build("arrh_rb23_solve")["arrh_rb23_solve"]
    print(f"  {label} build: {time.perf_counter() - t0:.2f} s")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    consts = chip_smoke.case2_solve_kwargs(Case2Config())
    rows = []
    for batch, dtype in ((30, torch.float32), (30, torch.float64),
                         (4099, torch.float32)):
        u0, w = _case2_inputs(batch, dtype)

        def solve():
            return rk.arrh_rb23_solve(u0, w.w_in, w.w_b, w.w_out, **consts)

        n_steps = solve()[8]
        ms = chip_smoke.device_ms(solve, n=20)
        row = {"dtype": str(dtype)[6:], "B": batch, "ms": ms,
               "floor_ms": chip_smoke.floor_ms(u0),
               "longest_lane_steps": int(n_steps.max()),
               "us_per_step": ms / int(n_steps.max()) * 1e3,
               "host_us": _host_us(solve)}
        if (batch, dtype) == (30, torch.float32):
            row.update(_eval_fused(rk, chip_smoke, u0, w, consts))
        print(f"  {label} arrh_rb23_solve {row['dtype']} B={batch}: "
              + ", ".join(f"{k}={v:.5f}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in row.items()
                          if k not in ("dtype", "B")), flush=True)
        rows.append(row)
    if save is not None:
        cases = {}
        for dtype in (torch.float32, torch.float64):
            for batch in (30, 4099):
                cases[f"case2 {str(dtype)[6:]} B={batch}"] = _case2_inputs(
                    batch, dtype)
            for shape in ((6, 3), (1, 1), (3, 2), (7, 4), (8, 4)):
                cases[f"{shape} {str(dtype)[6:]} B=33"] = \
                    chip_smoke.solve_inputs(33, *shape, dtype)
        outs = {}
        for key, (u0, w) in cases.items():
            out = rk.arrh_rb23_solve(u0, w.w_in, w.w_b, w.w_out,
                                     hist_fill=math.nan, **consts)
            outs[key] = [t.cpu() for t in out]
        save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outs, save)
    return {"label": label, "tree": str(tree), "card": smi, "rows": rows}


def sweep() -> dict:
    """Device ms of this checkout's kernel at 1, 2 and 4 warps a block
    (lanes = 32 / group * warps), through ``_launch`` with the geometry
    given, at B=30 and 4099 in f32 and f64 on case2's inputs: the choice
    ``solve_geometry`` makes against the others."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from crnn_tpu_torch.cases.case2 import Case2Config
    from crnn_tpu_torch.ops import rb23_solve_kernel as rk

    c = chip_smoke.case2_solve_kwargs(Case2Config())
    consts = (0.0, c["t1"], c["rtol"], c["atol"], c["lb"], c["ub"], 32.0, 0.9,
              0.2, 10.0, 1e-12 * c["t1"])
    rows = []
    for dtype in (torch.float32, torch.float64):
        for batch in (30, 4099):
            u0, w = _case2_inputs(batch, dtype)
            k, dev = c["max_steps"], u0.device
            outs = ([torch.zeros((k, batch), dtype=dtype, device=dev)
                     for _ in range(3)]
                    + [torch.empty((k, 7, batch), dtype=dtype, device=dev)
                       for _ in range(4)]
                    + [torch.empty(batch, dtype=torch.int32, device=dev)
                       for _ in range(2)] + [torch.empty_like(u0)])
            group, lanes, _, _ = rk.solve_geometry(batch, 6, 3,
                                                   u0.element_size())
            for warps in (1, 2, 4):
                geo = (group, 32 // group * warps)
                ms = chip_smoke.device_ms(lambda: rk._launch(
                    u0, (w.w_in, w.w_b, w.w_out), outs, c["max_steps"],
                    consts, geo), n=20)
                row = {"dtype": str(dtype)[6:], "B": batch, "warps": warps,
                       "lanes": geo[1], "chosen": geo[1] == lanes, "ms": ms}
                print(f"  sweep {row}", flush=True)
                rows.append(row)
    return {"sweep": rows}


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def diff(a: Path, b: Path) -> dict:
    """Bitwise comparison of two saved output files, input by input."""
    outs_a, outs_b = torch.load(a), torch.load(b)
    report = {}
    for key, got in outs_a.items():
        want = outs_b[key]
        entry = {}
        for name, x, y in zip(OUTPUTS, got, want):
            differs = _bits(x) != _bits(y)
            if not differs.any():
                continue
            entry[name] = int(differs.sum())
            if x.dim() >= 2:  # (B, K, ...): the first step that differs
                steps = differs.reshape(x.shape[0], x.shape[1], -1).any(-1)
                entry[f"{name}_first_step"] = int(
                    steps.float().argmax(dim=1)[steps.any(dim=1)].min())
        report[key] = entry or "bitwise equal"
        print(f"  {key}: {report[key]}")
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--label", default="new")
    ap.add_argument("--save", type=Path)
    ap.add_argument("--diff", type=Path, nargs=2)
    ap.add_argument("--sweep", action="store_true",
                    help="time this checkout at 1, 2 and 4 warps a block")
    args = ap.parse_args()
    if args.diff:
        print(json.dumps({"diff": [str(p) for p in args.diff],
                          "inputs": diff(*args.diff)}))
        return 0
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    if args.sweep:
        print(json.dumps(sweep()))
        return 0
    print(json.dumps(profile(args.tree, args.label, args.save)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
