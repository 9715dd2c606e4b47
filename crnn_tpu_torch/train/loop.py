"""Training epochs (port of crnn_tpu/train/loop.py:Trainer).

One epoch rebuilds the reference's loop (case2/case2.jl:192-207): a
permutation of the training experiments and, with ``horizon_range``, one
stochastic prefix horizon per experiment, both drawn from the trainer's
``torch.Generator``; the updates; then an evaluation pass over every
experiment at the full horizon under ``torch.no_grad``. Two modes:

- ``mode='batch'``: ONE update per epoch on the mean loss over the
  permutation, its experiments solved together;
- ``mode='sequential'``: one update per experiment in permutation order
  (the reference's batch size of one experiment), the optimizer's count
  advancing per update as under JAX's ``lax.scan``; the epoch's grad norm
  is the mean of the updates' norms.

Losses take ``(params, idxs (n,), masks (n, n_save)) -> (n,)``.
``loss_i_exp`` is the per-experiment loss on the per-lane driver
(``ode/solve.py:odesolve``): its lanes are independent, so one call over n
experiments is what JAX's ``vmap`` of its one-experiment loss computes, and
a one-lane call is one experiment's loss. ``loss_batch`` may solve its
lanes together (the batch-major driver); without it, batch mode and the
evaluation pass use ``loss_i_exp``. The ``*_eval`` variants run the
early-exit ``while`` driver.

Gradients: ``grad_mode='rev'`` is reverse mode through the scan driver;
``grad_mode='fwd'`` is ``torch.func.jacfwd`` through the while driver (the
ForwardDiff.gradient analogue, case2/case2.jl:195). Forward mode needs a
loss built from plain torch ops: the kernel ops' ``autograd.Function`` has
no forward-mode rule (``ops/crnn_kernels.py:_kernel_forward_op``). A case
whose losses run the kernel ops passes that plain loss as ``loss_fwd``;
the evaluation pass keeps the kernel ops. ``grad_mode='rev_while'`` takes
the derivative 'fwd' takes, of the while driver's loss, by reverse mode:
PyTorch records the eager while loop, where JAX's ``lax.while_loop`` has
no reverse mode (the reason the JAX package takes forward mode there). The
two agree to rounding; reverse mode costs one backward pass where
``jacfwd`` pushes one tangent per parameter through every operation
(cathode's 18: PERF.md §6).
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


def _stack_metrics(ms) -> EpochMetrics:
    """Per-epoch metrics stacked along a leading (k,) axis."""
    return EpochMetrics(*(torch.stack(list(f)) for f in zip(*ms)))


def _global_norm(g: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(g * g))


@dataclass(kw_only=True)
class Trainer:
    """``horizon_range = (lo, hi)`` trains each experiment on its first
    ``randint(lo, hi + 1)`` save points (rober_crnn.jl:218).
    ``n_exp_update`` experiments are visited by the updates (default
    ``n_exp_train``; case3 updates on all of them). ``mode`` defaults to
    'batch', every case's default (the JAX class defaults to
    'sequential'). ``loss_fwd``, when given, is the loss that forward mode
    differentiates in place of the mode's while-driver loss, called as that
    loss is (one lane an update under sequential)."""

    optimizer: AdamWLike
    n_exp_train: int
    n_exp: int
    n_save: int
    loss_i_exp: Optional[Callable] = None
    loss_i_exp_eval: Optional[Callable] = None
    loss_batch: Optional[Callable] = None
    loss_batch_eval: Optional[Callable] = None
    mode: str = "batch"
    grad_mode: str = "rev"
    horizon_range: Optional[Tuple[int, int]] = None
    n_exp_update: Optional[int] = None
    loss_fwd: Optional[Callable] = None

    def __post_init__(self):
        if self.loss_batch is None:
            # the lane-batched per-experiment loss is its own batch loss
            self.loss_batch = self.loss_i_exp
            self.loss_batch_eval = self.loss_batch_eval or self.loss_i_exp_eval

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
        # an empty range (lo > hi, a cut-down n_save) draws lo, as
        # jax.random.randint does
        samples = torch.randint(lo, max(lo, hi) + 1, (n,), generator=gen)
        return prefix_mask(self.n_save, samples, dtype)

    def _grad_loss(self) -> Callable:
        """The loss the updates differentiate, as JAX picks it
        (crnn_tpu/train/loop.py:105-116, 126-174): reverse mode through the
        scan, forward mode through the early-exit driver (or ``loss_fwd``),
        and 'rev_while' the early-exit driver's loss as 'fwd' takes it."""
        if self.mode == "sequential":
            if self.loss_i_exp is None:
                raise ValueError("mode='sequential' needs loss_i_exp")
            if self.grad_mode == "fwd":
                return (self.loss_fwd or self.loss_i_exp_eval
                        or self.loss_i_exp)
            if self.grad_mode == "rev_while":
                return self.loss_i_exp_eval or self.loss_i_exp
            return self.loss_i_exp
        if self.mode != "batch":
            raise ValueError(f"unknown mode {self.mode!r}")
        if self.grad_mode == "fwd":
            return self.loss_fwd or self.loss_batch_eval or self.loss_batch
        if self.grad_mode == "rev_while":
            return self.loss_batch_eval or self.loss_batch
        return self.loss_batch

    def value_and_grad(self, params: torch.Tensor, perm: torch.Tensor,
                       masks: Optional[torch.Tensor] = None):
        """(mean training loss over ``perm`` under the horizon ``masks``
        (default: all ones), its gradient w.r.t. params) in the configured
        mode and ``grad_mode``."""
        if self.grad_mode not in ("rev", "fwd", "rev_while"):
            raise ValueError(f"unknown grad_mode {self.grad_mode!r}")
        loss_fn = self._grad_loss()
        params = params.detach()
        if masks is None:
            masks = torch.ones((perm.shape[0], self.n_save),
                               dtype=params.dtype)
        masks = masks.to(device=params.device, dtype=params.dtype)
        if self.grad_mode == "fwd":
            def mean_loss(p):
                loss = torch.mean(loss_fn(p, perm, masks))
                return loss, loss

            g, loss = torch.func.jacfwd(mean_loss, has_aux=True)(params)
            return loss.detach(), g
        p = params.requires_grad_(True)
        loss = torch.mean(loss_fn(p, perm, masks))
        (g,) = torch.autograd.grad(loss, p)
        return loss.detach(), g

    def epoch(self, state: TrainState, perm: Optional[torch.Tensor] = None,
              masks: Optional[torch.Tensor] = None):
        """One epoch -> (new state, EpochMetrics). ``perm`` and ``masks``
        default to draws from the state's generator."""
        params, opt_state = state.params, state.opt_state
        if perm is None:
            perm = torch.randperm(self.n_exp_update or self.n_exp_train,
                                  generator=state.gen)
        if masks is None:
            masks = self.sample_masks(state.gen, perm.shape[0], params.dtype)
        perm = perm.to(params.device)
        if self.mode == "sequential":
            gnorms = []
            for i in range(perm.shape[0]):
                _, g = self.value_and_grad(params, perm[i:i + 1],
                                           masks[i:i + 1])
                gnorms.append(_global_norm(g))
                params, opt_state = self.optimizer.update(g, opt_state,
                                                          params)
            grad_norm = torch.mean(torch.stack(gnorms))
        else:
            _, g = self.value_and_grad(params, perm, masks)
            grad_norm = _global_norm(g)
            params, opt_state = self.optimizer.update(g, opt_state, params)

        eval_loss = self.loss_batch_eval or self.loss_batch
        with torch.no_grad():
            loss_exp = eval_loss(
                params, torch.arange(self.n_exp, device=params.device),
                torch.ones((self.n_exp, self.n_save), dtype=params.dtype,
                           device=params.device))
        loss_train = torch.mean(loss_exp[:self.n_exp_train])
        if self.n_exp > self.n_exp_train:
            loss_val = torch.mean(loss_exp[self.n_exp_train:])
        else:
            loss_val = loss_train
        new_state = TrainState(params.detach(), opt_state, state.epoch + 1,
                               state.gen)
        return new_state, EpochMetrics(loss_train, loss_val, grad_norm, loss_exp)

    def epoch_fn(self) -> Callable:
        """The ``(state) -> (state, metrics)`` single-epoch function."""
        return self.epoch

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

    def guarded_epoch_fn(self) -> Callable:
        """The ``(state, best) -> (state, best, metrics)`` guarded epoch."""
        return self.guarded_epoch

    def epochs_fn(self, k: int) -> Callable:
        """``(state) -> (state, metrics stacked (k,))``: ``k`` epochs in one
        call, the counterpart of JAX's one-dispatch ``lax.scan``
        (crnn_tpu/train/loop.py:261-279), here a plain loop with the same
        per-epoch metrics."""

        def run(state: TrainState):
            ms = []
            for _ in range(k):
                state, m = self.epoch(state)
                ms.append(m)
            return state, _stack_metrics(ms)

        return run

    def guarded_epochs_fn(self, k: int) -> Callable:
        """``(state, best) -> (state, best, metrics stacked (k,))``: ``k``
        guarded epochs in one call. The guard and the best-val carry fold
        per epoch inside the chunk, so a non-finite epoch mid-chunk is
        discarded exactly as a single guarded epoch discards it."""

        def run(state: TrainState, best: BestState):
            ms = []
            for _ in range(k):
                state, best, m = self.guarded_epoch(state, best)
                ms.append(m)
            return state, best, _stack_metrics(ms)

        return run

    def fit(self, state: TrainState, n_epochs: int,
            callback: Optional[Callable] = None, callback_every: int = 1,
            epochs_per_dispatch: int = 1) -> Tuple[TrainState, dict]:
        """Run ``n_epochs``; ``callback(epoch, state, metrics)`` every
        ``callback_every`` epochs (the reference's cb/cbi layer). With
        ``epochs_per_dispatch`` > 1 the epochs run in chunks
        (``epochs_fn``) and callbacks fire at chunk boundaries with the
        chunk's last metrics, as in the JAX package."""
        history = {"loss_train": [], "loss_val": [], "grad_norm": []}
        k = max(1, int(epochs_per_dispatch))
        done = 0
        while done < n_epochs:
            ran = min(k, n_epochs - done)
            state, ms = self.epochs_fn(ran)(state)
            for name in history:
                history[name].extend(getattr(ms, name).tolist())
            done += ran
            if callback is not None and (done % callback_every == 0 or (
                    k > 1 and done == n_epochs)):
                callback(done - 1, state, EpochMetrics(*(f[-1] for f in ms)))
        return state, history
