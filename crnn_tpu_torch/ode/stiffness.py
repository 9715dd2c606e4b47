"""Batch stiffness classification for a static solver split (port of
crnn_tpu/ode/stiffness.py).

AutoSwitch (``ode/autoswitch.py``) pays both branches on every lane. Where
the same experiments are solved every epoch, each lane can be classified
once up front and the two groups solved by two statically chosen solvers,
an explicit one for the non-stiff lanes and a W-method or ESDIRK for the
stiff ones.

The probe integrates every lane with Tsit5 under a tight step budget. A lane
whose stability limit forces dt far below the horizon exhausts the budget
(``success=False``) or burns most of it.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5


def classify_stiffness(
    rhs,
    u0_batch: torch.Tensor,
    t0: float,
    t1: float,
    args: Any = None,
    rtol: float = 1e-3,
    atol: float = 1e-6,
    probe_steps: int = 256,
    dense_fraction: float = 0.75,
) -> torch.Tensor:
    """Bool mask ``(B,)``: True where the lane is stiff for an explicit RK.

    A lane is stiff when the Tsit5 probe cannot reach ``t1`` within
    ``probe_steps`` steps, or takes at least ``dense_fraction`` of them.
    The probe is one lane-batched early-exit solve. Pass the training
    solve's ``rtol``/``atol`` so that the probe's step count reflects the
    real workload; an accuracy-limited lane that trips ``dense_fraction`` is
    merely routed to the implicit group.
    """
    saveat = torch.tensor([float(t1)], dtype=u0_batch.dtype,
                          device=u0_batch.device)
    sol = odesolve(rhs, Tsit5(), u0_batch, t0, t1, saveat, args=args,
                   rtol=rtol, atol=atol, max_steps=probe_steps,
                   unroll="while")
    too_dense = sol.n_steps >= int(dense_fraction * probe_steps)
    return (~sol.success) | too_dense


def partition_by_stiffness(mask_stiff) -> tuple:
    """Host-side index split: ``(nonstiff_idx, stiff_idx)`` numpy arrays."""
    if isinstance(mask_stiff, torch.Tensor):
        mask_stiff = mask_stiff.cpu().numpy()
    m = np.asarray(mask_stiff)
    return np.nonzero(~m)[0], np.nonzero(m)[0]
