"""Mechanism export: learned weights -> CSV tables (port of
crnn_tpu/infra/export.py).

The pruning scripts' ``weights.csv`` (case2_pruning.jl:250-253,
case3_pruning.jl:291-294): one row per reaction, ``[w_in' | w_b |
w_out']``, for downstream mechanism analysis. Tensors on any device are
copied to the host first.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from crnn_tpu_torch.infra.plotting import _numpy


def export_weights_csv(weights, path: str,
                       dydt_scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Write ``[w_in.T | w_b | w_out.T]`` rows (one per reaction) to CSV and
    return the table. With ``dydt_scale``, w_out is exported in physical
    units (``w_out * dydt_scale``, case3_pruning.jl's scaled export)."""
    w_in = _numpy(weights.w_in)
    w_b = _numpy(weights.w_b)
    w_out = _numpy(weights.w_out)
    if dydt_scale is not None:
        w_out = w_out * _numpy(dydt_scale)[:, None]
    table = np.hstack([w_in.T[:, : w_out.shape[0]], w_b[:, None], w_out.T])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, table, delimiter=",")
    return table


def export_gradient_blocks(grad, ns: int, nr: int) -> str:
    """Print and return the w_out block of a raw gradient vector
    (display_grad, case3/case3.jl:75-83), one row per reaction."""
    grad = _numpy(grad)
    block = grad[nr * (ns + 1):nr * (2 * ns + 1)].reshape(ns, nr)
    out = "grad w_out (reaction rows):\n" + np.array2string(
        block.T, precision=6, suppress_small=True)
    print(out, flush=True)
    return out
