"""Weight pruning (port of crnn_tpu/transforms/pruning.py:hard_threshold,
relative_threshold, prune_case2_params). Every mask is detached, so pruned
fine-tuning trains the kept entries only."""

from __future__ import annotations

import torch


def hard_threshold(w: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Zero entries with |w| < cutoff (the mask carries no gradient)."""
    mask = (torch.abs(w) >= cutoff).to(w.dtype).detach()
    return w * mask


def relative_threshold(w_out: torch.Tensor, dy_scale: torch.Tensor,
                       cutoff: float) -> torch.Tensor:
    """case3-style pruning (case3_pruning.jl:243-248): each reaction's row of
    ``w_out^T * dy_scale`` over its signed row max; entries whose |ratio| is
    below ``cutoff`` are zeroed in w_out."""
    w_scaled = w_out.T * dy_scale[None, :]                  # (nr, ns)
    w_rel = w_scaled / w_scaled.amax(dim=1, keepdim=True)
    mask = (torch.abs(w_rel) >= cutoff).to(w_out.dtype).detach().T
    return w_out * mask


def prune_case2_params(p: torch.Tensor, ns: int, nr: int,
                       cutoff: float) -> torch.Tensor:
    """Prune the raw w_out block of a case2-layout parameter vector before
    the w_in sign-tie (case2_pruning.jl:100-113)."""
    lo, hi = nr, nr * (ns + 1)
    return torch.cat([p[:lo], hard_threshold(p[lo:hi], cutoff), p[hi:]])
