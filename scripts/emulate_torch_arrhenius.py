"""CPU emulation of the Arrhenius RHS kernels' arithmetic against their
plain versions, at the inputs of ``chip_smoke.py``'s flat-lane-tile
coverage (``arrhenius_cond_inputs``): an estimate, without a card, of how
close the per-component gates (2e-6 f32, 1e-12 f64) are.

    python scripts/emulate_torch_arrhenius.py [--draws 6]

The emulation follows ``crnn_tpu_torch/ops/csrc/arrhenius_rhs.cu`` and
``arrhenius_rhs_jac.cu`` expression by expression in numpy: the dots in
ascending index order with fused multiply-adds (in f32 the product and
sum taken in f64 and rounded once), the T feature's multiply-add into the
exponent, the J x-block's rounded rates·w_out and the T column's rounded
rates·w_ea. numpy's log and exp stand in for CUDA's, so the estimate is
pessimistic. For each draw (a generator seeded by the draw), shape
((6, 3), (32, 32), (1, 32), (32, 1)), dtype, B (1, 20, 21, 30, 33, and
4099 in the first draw, 200 in the others) and input (plain, edges,
exp cap) it compares du and J with ``chip_smoke.py``'s
``compare_components`` and prints the largest error over its component's
largest value for each shape and dtype.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from crnn_tpu_torch.ops import crnn_kernels as tk  # noqa: E402


def _fma(dtype):
    if dtype == np.float32:
        return lambda a, b, c: (a.astype(np.float64) * b + c).astype(
            np.float32)
    return lambda a, b, c: a * b + c


def kernel_emulation(y, w_in, w_b, w_out, lb, ub, exp_cap=32.0):
    """(du, J) as the kernels compute them, in y's dtype."""
    y, w_in, w_b, w_out = (t.numpy() for t in (y, w_in, w_b, w_out))
    dt = y.dtype.type
    fma = _fma(y.dtype)
    ns, nr = w_out.shape
    b = y.shape[0]
    x, temp = y[:, :ns], y[:, ns]
    with np.errstate(all="ignore"):
        xc = np.where(x < lb, dt(lb), np.where(x > ub, dt(ub), x))
        logx = np.log(xc)
        inv_t = dt(tk._INV_R_KCAL) / temp
        dlog = ((x > lb) & (x < ub)).astype(y.dtype) / xc
        dt_feat = dt(-tk._INV_R_KCAL) / (temp * temp)
        rates = np.zeros((b, nr), y.dtype)
        for r in range(nr):
            z = np.zeros(b, y.dtype)
            for i in range(ns):
                z = fma(logx[:, i], w_in[i, r], z)
            z = fma(inv_t, w_in[ns, r], z) + w_b[r]
            rates[:, r] = np.exp(np.where(z > exp_cap, dt(exp_cap), z))
        du = np.zeros((b, ns + 1), y.dtype)
        jac = np.zeros((b, ns + 1, ns + 1), y.dtype)
        for i in range(ns):
            for r in range(nr):
                du[:, i] = fma(rates[:, r], w_out[i, r], du[:, i])
            for j in range(ns + 1):
                s = np.zeros(b, y.dtype)
                for r in range(nr):
                    if j < ns:
                        s = fma(rates[:, r] * w_out[i, r], w_in[j, r], s)
                    else:
                        s = fma(rates[:, r] * w_in[ns, r], w_out[i, r], s)
                jac[:, i, j] = s * (dlog[:, j] if j < ns else dt_feat)
    return torch.from_numpy(du), torch.from_numpy(jac)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=6)
    args = ap.parse_args()
    tol = {torch.float32: 2e-6, torch.float64: 1e-12}
    worst = {}
    for draw in range(args.draws):
        gen = torch.Generator().manual_seed(draw)
        for shape in ((6, 3), (32, 32), (1, 32), (32, 1)):
            for dtype in (torch.float32, torch.float64):
                for batch in (1, 20, 21, 30, 33, 4099 if draw == 0 else 200):
                    for edges in (False, True, "exp-cap"):
                        inputs, (lb, ub) = chip_smoke.arrhenius_cond_inputs(
                            batch, dtype, gen, shape, edges, device="cpu")
                        du, jac = kernel_emulation(*inputs, lb, ub)
                        du_ref = tk.arrhenius_rhs_batched_reference(
                            *inputs, lb, ub)
                        pair_ref = tk.arrhenius_rhs_jac_batched_reference(
                            *inputs, lb, ub)
                        key = (shape, str(dtype)[6:])
                        for out, ref in ((du, du_ref), (du, pair_ref[0]),
                                         (jac, pair_ref[1])):
                            ok, _, rel = chip_smoke.compare_components(
                                out, ref, tol[dtype])
                            worst[key] = max(worst.get(key, 0.0),
                                             rel if ok else math.inf)
    for (shape, dtype), err in worst.items():
        print(f"{shape} {dtype}: largest error over its component's largest "
              f"value {err:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
