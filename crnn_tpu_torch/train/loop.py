"""Batch-mode training epochs (port of crnn_tpu/train/loop.py:Trainer,
batch mode with reverse-mode gradients, and the guarded epoch).

One epoch: a permutation of the training experiments and, with
``horizon_range``, one stochastic prefix horizon per experiment, both drawn
from the trainer's ``torch.Generator``; ONE update on the mean loss over
them (the whole batch solved together); then an evaluation pass over every
experiment at the full horizon under ``torch.no_grad``. Sequential mode,
forward-mode gradients and fused multi-epoch dispatch are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from crnn_tpu_torch.train.loss import prefix_mask
from crnn_tpu_torch.train.optimizers import AdamState, AdamWLike


class TrainState(NamedTuple):
    params: torch.Tensor
    opt_state: AdamState
    epoch: int
    gen: torch.Generator


class EpochMetrics(NamedTuple):
    loss_train: torch.Tensor
    loss_val: torch.Tensor
    grad_norm: torch.Tensor
    loss_exp: torch.Tensor  # (n_exp,) per-experiment losses


class BestState(NamedTuple):
    """Best-so-far carry of the guarded epoch. The losses are float32, as the
    JAX package keeps them (crnn_tpu/train/loop.py:253-256)."""

    params: torch.Tensor
    loss_val: np.float32    # best val loss seen
    loss_train: np.float32  # train loss at the best-val epoch
    n_skipped: int          # epochs whose update was discarded (non-finite)


@dataclass
class Trainer:
    """``loss_batch(params, idxs (n,), masks (n, n_save)) -> (n,)`` losses of
    the whole batch solved together (differentiable); ``loss_batch_eval``
    the same loss through the early-exit solve, called under
    ``torch.no_grad``. ``horizon_range = (lo, hi)`` trains each experiment
    on its first ``randint(lo, hi + 1)`` save points (rober_crnn.jl:218)."""

    loss_batch: Callable
    loss_batch_eval: Callable
    optimizer: AdamWLike
    n_exp_train: int
    n_exp: int
    n_save: int
    horizon_range: Optional[Tuple[int, int]] = None

    def init(self, params: torch.Tensor, seed: int = 0) -> TrainState:
        gen = torch.Generator().manual_seed(seed)
        return TrainState(params.detach(), self.optimizer.init(params), 0, gen)

    def sample_masks(self, gen: torch.Generator, n: int,
                     dtype=torch.float32) -> torch.Tensor:
        """(n, n_save) 0/1 horizon masks: all ones without
        ``horizon_range``, else prefix masks of random lengths in [lo, hi]."""
        if self.horizon_range is None:
            return torch.ones((n, self.n_save), dtype=dtype)
        lo, hi = self.horizon_range
        samples = torch.randint(lo, hi + 1, (n,), generator=gen)
        return prefix_mask(self.n_save, samples, dtype)

    def value_and_grad(self, params: torch.Tensor, perm: torch.Tensor,
                       masks: Optional[torch.Tensor] = None):
        """(mean training loss over ``perm`` under the horizon ``masks``
        (default: all ones), its gradient w.r.t. params)."""
        p = params.detach().requires_grad_(True)
        if masks is None:
            masks = torch.ones((perm.shape[0], self.n_save), dtype=p.dtype)
        masks = masks.to(device=p.device, dtype=p.dtype)
        loss = torch.mean(self.loss_batch(p, perm, masks))
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g

    def epoch(self, state: TrainState, perm: Optional[torch.Tensor] = None,
              masks: Optional[torch.Tensor] = None):
        """One epoch -> (new state, EpochMetrics). ``perm`` and ``masks``
        default to draws from the state's generator."""
        params = state.params
        if perm is None:
            perm = torch.randperm(self.n_exp_train, generator=state.gen)
        if masks is None:
            masks = self.sample_masks(state.gen, perm.shape[0], params.dtype)
        perm = perm.to(params.device)
        _, g = self.value_and_grad(params, perm, masks)
        grad_norm = torch.sqrt(torch.sum(g * g))
        params, opt_state = self.optimizer.update(g, state.opt_state, params)

        with torch.no_grad():
            loss_exp = self.loss_batch_eval(
                params, torch.arange(self.n_exp, device=params.device),
                torch.ones((self.n_exp, self.n_save), dtype=params.dtype,
                           device=params.device))
        loss_train = torch.mean(loss_exp[:self.n_exp_train])
        if self.n_exp > self.n_exp_train:
            loss_val = torch.mean(loss_exp[self.n_exp_train:])
        else:
            loss_val = loss_train
        new_state = TrainState(params, opt_state, state.epoch + 1, state.gen)
        return new_state, EpochMetrics(loss_train, loss_val, grad_norm, loss_exp)

    def init_best(self, state: TrainState) -> BestState:
        return BestState(state.params, np.float32(np.inf), np.float32(np.inf),
                         0)

    def guarded_epoch(self, state: TrainState, best: BestState):
        """Epoch with the NaN guard and the best-val carry
        (crnn_tpu/train/loop.py:237-259): a non-finite train loss or grad
        norm discards the update (params and optimizer state revert), and
        the best-val params are kept. -> (state, best, metrics)."""
        new_state, m = self.epoch(state)
        ok = bool(torch.isfinite(m.loss_train) & torch.isfinite(m.grad_norm))
        if not ok:
            new_state = TrainState(state.params, state.opt_state,
                                   new_state.epoch, new_state.gen)
        # the new loss in its own precision against the float32 best, as
        # JAX compares them; then stored rounded to float32
        loss_val = float(m.loss_val)
        if ok and loss_val < float(best.loss_val):
            best = BestState(new_state.params, np.float32(loss_val),
                             np.float32(float(m.loss_train)), best.n_skipped)
        elif not ok:
            best = best._replace(n_skipped=best.n_skipped + 1)
        return new_state, best, m
