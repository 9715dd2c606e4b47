"""Device time of the flat-lane-tile RHS kernels against their lanes per
block, on one CUDA card:

    python scripts/sweep_torch_tile.py [--batches 4099 65536]

For kernels 1 and 2 (``arrhenius_rhs``, ``arrhenius_rhs_jac``, case2's
shape ns=6, nr=3, on ``chip_smoke.py``'s ``arrhenius_inputs``) and kernels
4 and 5 (``crnn_rhs``, ``crnn_rhs_jac``, case1's shape ns=5, nr=4, on
``chip_smoke.py``'s ``crnn_inputs``), in f32 and f64, it launches each
kernel through ``crnn_kernels._launch`` with ``tile_geometry``'s lanes
times 1, 2, 4, 8 and 16 (256 threads, where the shared layout fits in 48
KB: the launcher refuses the others), checks that every geometry gives
the outputs of the default one bit for bit, and times each with
``chip_smoke.py``'s ``device_ms``. It prints the card and one JSON line
with every row (lanes, threads, blocks, ms).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from crnn_tpu_torch.ops import crnn_kernels as tk  # noqa: E402


def _case(name, batch, dtype, gen):
    """(y, weights, outs, lb, ub, ns, nr, temperature) of kernel ``name``."""
    if name.startswith("arrhenius"):
        (y, w_in, w_b, w_out), (lb, ub) = chip_smoke.arrhenius_inputs(
            batch, dtype, gen, False)
        weights, temperature = tk._arrhenius_weights(w_in, w_b, w_out), True
    else:
        (y, w_in, w_b, w_out), lb = chip_smoke.crnn_inputs(
            batch, dtype, gen, "case1", False)
        ub, weights, temperature = 10.0, (w_in, w_b, w_out), False
    ns, nr = w_out.shape
    width = ns + 1 if temperature else ns
    outs = [torch.empty_like(y)]
    if name.endswith("_jac"):
        outs.append(torch.empty((batch, width, width), dtype=dtype,
                                device=y.device))
    return y, weights, outs, lb, ub, ns, nr, temperature


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, nargs="+", default=[4099, 65536])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card", flush=True)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}")
    rows = []
    gen = torch.Generator().manual_seed(0)
    for name in ("arrhenius_rhs", "arrhenius_rhs_jac", "crnn_rhs",
                 "crnn_rhs_jac"):
        jac = name.endswith("_jac")
        for dtype in (torch.float32, torch.float64):
            for batch in args.batches:
                y, weights, outs, lb, ub, ns, nr, temperature = _case(
                    name, batch, dtype, gen)
                lanes0, threads0 = tk.tile_geometry(
                    batch, ns, nr, y.element_size(), jac,
                    temperature=temperature)
                tk._launch(name, y, weights, outs, lb, ub, 32.0,
                           (lanes0, threads0))
                want = [o.clone() for o in outs]
                for mult in (1, 2, 4, 8, 16):
                    lanes = lanes0 * mult
                    threads = threads0 if mult == 1 else 256
                    if lanes > batch:
                        continue
                    geo = (lanes, threads)
                    try:
                        tk._launch(name, y, weights, outs, lb, ub, 32.0, geo)
                    except RuntimeError:  # a layout above 48 KB
                        continue
                    torch.cuda.synchronize()
                    same = all(torch.equal(o.view(torch.int8), w.view(
                        torch.int8)) for o, w in zip(outs, want))
                    ms = chip_smoke.device_ms(lambda: tk._launch(
                        name, y, weights, outs, lb, ub, 32.0, geo))
                    row = {"kernel": name, "dtype": str(dtype)[6:],
                           "B": batch, "lanes": lanes, "threads": threads,
                           "blocks": -(-batch // lanes), "ms": ms,
                           "same_bits": same}
                    print(f"  {row}", flush=True)
                    rows.append(row)
                    if not same:
                        print(f"FAIL: {name} lanes={lanes} changed the "
                              "outputs", flush=True)
                        return 1
    print(smi)
    print(json.dumps({"card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
