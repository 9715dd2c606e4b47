"""Data-parallel train step and eval over ranks (port of
crnn_tpu/parallel/dp.py).

The experiment axis is the batch axis: each rank solves its shard of the
experiments; the loss, the weight count and the gradient are summed over
the ranks with one ``all_reduce``; the parameters stay replicated, every
rank applying the same update.
"""

from __future__ import annotations

import inspect
from typing import Callable

import torch
import torch.distributed as dist

from crnn_tpu_torch.parallel.mesh import all_gather_cat


def make_dp_train_step(loss_on_data: Callable, optimizer) -> Callable:
    """``step(params, opt_state, u0_l, ys_l, masks_l, weights_l) ->
    (params, opt_state, loss, grad_norm)`` on this rank's shard
    (``loss_on_data(params, u0 (n, ...), ys, masks) -> (n,)``);
    ``weights_l`` is 0 on padded lanes.

    The backward pass differentiates the LOCAL weighted loss sum; the sum,
    the weight count and the gradient are then reduced over the ranks and
    divided. The collective is never differentiated through (the JAX
    package documents the wrong gradient that gave, crnn_tpu/parallel/
    dp.py:38-44). Divergence guard: a non-finite loss or gradient norm
    keeps the old params and optimizer state (the bad loss is reported).
    """

    def step(params, opt_state, u0_l, ys_l, masks_l, weights_l):
        p = params.detach().requires_grad_(True)
        s = torch.sum(loss_on_data(p, u0_l, ys_l, masks_l) * weights_l)
        (g_local,) = torch.autograd.grad(s, p)
        buf = torch.cat([s.detach()[None], torch.sum(weights_l)[None],
                         g_local.reshape(-1)])
        dist.all_reduce(buf)
        n = buf[1]
        loss = buf[0] / n
        g = (buf[2:] / n).reshape(params.shape)
        grad_norm = torch.sqrt(torch.sum(g * g))
        new_params, new_opt_state = optimizer.update(g, opt_state,
                                                     params.detach())
        if not bool(torch.isfinite(loss) & torch.isfinite(grad_norm)):
            return params.detach(), opt_state, loss, grad_norm
        return new_params.detach(), new_opt_state, loss, grad_norm

    return step


def make_dp_eval(loss_on_data: Callable) -> Callable:
    """``eval(params, u0_l, ys_l, masks_l) -> losses`` of every rank's
    shard, gathered in rank order on every rank, without a gradient. A
    ``loss_on_data`` that takes ``unroll`` (the case convention) is asked
    for the early-exit driver."""
    try:
        accepts_unroll = "unroll" in inspect.signature(
            loss_on_data).parameters
    except (TypeError, ValueError):  # no signature (builtins, partials)
        accepts_unroll = False
    kw = {"unroll": "while"} if accepts_unroll else {}

    def eval_losses(params, u0_l, ys_l, masks_l):
        with torch.no_grad():
            return all_gather_cat(loss_on_data(params, u0_l, ys_l, masks_l,
                                               **kw))

    return eval_losses
