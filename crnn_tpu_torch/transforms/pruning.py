"""Weight pruning (port of crnn_tpu/transforms/pruning.py:hard_threshold,
prune_case2_params)."""

from __future__ import annotations

import torch


def hard_threshold(w: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Zero entries with |w| < cutoff (the mask carries no gradient)."""
    mask = (torch.abs(w) >= cutoff).to(w.dtype).detach()
    return w * mask


def prune_case2_params(p: torch.Tensor, ns: int, nr: int,
                       cutoff: float) -> torch.Tensor:
    """Prune the raw w_out block of a case2-layout parameter vector before
    the w_in sign-tie (case2_pruning.jl:100-113)."""
    lo, hi = nr, nr * (ns + 1)
    return torch.cat([p[:lo], hard_threshold(p[lo:hi], cutoff), p[hi:]])
