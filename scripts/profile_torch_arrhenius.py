"""Device time and outputs of the Arrhenius RHS kernels of one
crnn_tpu_torch tree on one CUDA card: kernel 1 (``arrhenius_rhs``) and
kernel 2 (``arrhenius_rhs_jac``), for comparing two trees in one call.

    python scripts/profile_torch_arrhenius.py --label new [--tree DIR]
        [--save OUT.pt]
    python scripts/profile_torch_arrhenius.py --diff A.pt B.pt

The first form imports ``crnn_tpu_torch`` from DIR (default: this
checkout; for a parent commit, unpack ``git archive <commit>
crnn_tpu_torch`` into an ignored directory), builds both kernels and times
each, its plain version and the launch floor (one ``torch.neg`` on y) with
``chip_smoke.py``'s ``device_ms`` (200 calls in one CUDA graph) at B 20,
30, 4099 and 65536 in f32 and f64, on ``chip_smoke.py``'s
``arrhenius_inputs`` (case2's shape, seeded). It prints the card, the
ptxas lines of the build and one JSON line with every row. With
``--save`` it also writes the kernels' outputs on phase 2's inputs (plain,
edge and exp-cap rows at the same B and dtypes) to OUT.pt. Run the trees in
separate processes in turns (parent, new, new, parent).

The second form says, for each input of two saved files, whether kernel
1's du, kernel 2's du and kernel 2's J are bitwise equal, and counts the J
entries that differ in the x-block and the T column (the T row is 0).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
BATCHES = (20, 30, 4099, 65536)
DTYPES = (torch.float32, torch.float64)


def _inputs(chip_smoke, batch, dtype, edges):
    """``arrhenius_inputs`` of a generator seeded by the case alone, so every
    tree and process sees the same inputs; exp-cap as phase 2 builds it."""
    seed = BATCHES.index(batch) * 10 + DTYPES.index(dtype) * 3 + (
        0 if edges is False else 1 if edges is True else 2)
    gen = torch.Generator().manual_seed(seed)
    (y, w_in, w_b, w_out), (lb, ub) = chip_smoke.arrhenius_inputs(
        batch, dtype, gen, bool(edges))
    if edges == "exp-cap":
        w_b, w_out = w_b + 40.0, w_out.abs()
    return (y, w_in, w_b, w_out), (lb, ub)


def profile(tree: Path, label: str, save: Path | None) -> dict:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, str(tree))
    import crnn_tpu_torch
    from crnn_tpu_torch.ops import _build
    from crnn_tpu_torch.ops import crnn_kernels as tk

    pkg = Path(crnn_tpu_torch.__file__).resolve().parent.parent
    if pkg != tree.resolve():
        raise SystemExit(f"crnn_tpu_torch imported from {pkg}, not {tree}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    libs = _build.build("arrhenius_rhs", "arrhenius_rhs_jac")
    for name, path in libs.items():
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    kernels = {
        "arrhenius_rhs": (tk.arrhenius_rhs_batched,
                          tk.arrhenius_rhs_batched_reference,
                          chip_smoke.arrhenius_bound_ms),
        "arrhenius_rhs_jac": (tk.arrhenius_rhs_jac_batched,
                              tk.arrhenius_rhs_jac_batched_reference,
                              chip_smoke.rhs_jac_bound_ms)}
    rows = []
    for dtype in DTYPES:
        for batch in BATCHES:
            args, (lb, ub) = _inputs(chip_smoke, batch, dtype, False)
            floor = chip_smoke.floor_ms(args[0])
            for name, (kernel, plain, bound_fn) in kernels.items():
                bound, bound_by = bound_fn(batch, 6, 3, dtype)
                row = {"kernel": name, "dtype": str(dtype)[6:], "B": batch,
                       "ms": chip_smoke.device_ms(
                           lambda: kernel(*args, lb, ub)),
                       "plain_ms": chip_smoke.device_ms(
                           lambda: plain(*args, lb, ub)),
                       "floor_ms": floor, "bound_ms": bound,
                       "bound_by": bound_by}
                print(f"  {label} {name} {row['dtype']} B={batch}: "
                      f"ms={row['ms']:.5f} plain_ms={row['plain_ms']:.5f} "
                      f"floor_ms={floor:.5f} bound_ms={bound:.3e}",
                      flush=True)
                rows.append(row)
    if save is not None:
        outs = {}
        for dtype in DTYPES:
            for batch in BATCHES:
                for edges in (False, True, "exp-cap"):
                    args, (lb, ub) = _inputs(chip_smoke, batch, dtype, edges)
                    du1 = tk.arrhenius_rhs_batched(*args, lb, ub)
                    du2, jac = tk.arrhenius_rhs_jac_batched(*args, lb, ub)
                    outs[f"{str(dtype)[6:]} B={batch} edges={edges}"] = [
                        t.cpu() for t in (du1, du2, jac)]
        save.parent.mkdir(parents=True, exist_ok=True)
        torch.save(outs, save)
    return {"label": label, "tree": str(tree), "card": smi, "rows": rows}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def diff(a: Path, b: Path) -> dict:
    """Bitwise comparison of two saved output files, input by input."""
    outs_a, outs_b = torch.load(a), torch.load(b)
    report = {}
    for key, (du1_a, du2_a, jac_a) in outs_a.items():
        du1_b, du2_b, jac_b = outs_b[key]
        differs = _bits(jac_a) != _bits(jac_b)
        ns = jac_a.shape[1] - 1
        scale = jac_b[torch.isfinite(jac_b)].abs().max()
        finite = torch.isfinite(jac_a) & torch.isfinite(jac_b)
        report[key] = {
            "du_rhs_equal": torch.equal(_bits(du1_a), _bits(du1_b)),
            "du_jac_equal": torch.equal(_bits(du2_a), _bits(du2_b)),
            "j_entries": differs.numel(),
            "j_differ_x_block": int(differs[:, :ns, :ns].sum()),
            "j_differ_t_column": int(differs[:, :ns, ns].sum()),
            "j_differ_t_row": int(differs[:, ns, :].sum()),
            "j_max_diff_over_largest": float(
                (jac_a - jac_b)[finite].abs().max() / scale),
        }
        print(f"  {key}: {report[key]}")
    return report


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT)
    ap.add_argument("--label", default="new")
    ap.add_argument("--save", type=Path)
    ap.add_argument("--diff", type=Path, nargs=2)
    args = ap.parse_args()
    if args.diff:
        print(json.dumps({"diff": [str(p) for p in args.diff],
                          "inputs": diff(*args.diff)}))
        return 0
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    print(json.dumps(profile(args.tree, args.label, args.save)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
