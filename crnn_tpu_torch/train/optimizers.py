"""ExpDecay-ADAMW written out by hand in optax's order
(port of crnn_tpu/train/optimizers.py:expdecay_adamw).

One update, as ``optax.chain(clip_by_global_norm(grad_max),
add_decayed_weights(wd), adam(schedule, b1, b2, eps=1e-8))`` computes it:

1. clip by global norm: ``g <- g if |g| < grad_max else g / |g| * grad_max``;
2. coupled weight decay: ``g <- g + wd * p`` (Flux's ADAMW);
3. Adam moments and bias correction at the incremented count;
4. step ``-lr(count) * update`` with ``lr`` a staircase exponential decay
   floored at ``lr_floor``, evaluated in float32 at the pre-increment count.

The state is ``AdamState(mu, nu, count)``; parameters are one flat tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


@dataclass(frozen=True)
class ExpDecayAdamW:
    lr0: float
    decay_rate: float
    decay_steps: int
    lr_floor: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_max: Optional[float] = None

    def init(self, params: torch.Tensor) -> AdamState:
        return AdamState(torch.zeros_like(params), torch.zeros_like(params), 0)

    def lr(self, count: int) -> float:
        """Staircase exponential decay floored at lr_floor (optax
        exponential_decay with staircase=True, end_value=lr_floor). optax
        evaluates it in float32 from its int32 count, so this does too."""
        f32 = np.float32
        if count <= 0:
            decayed = f32(self.lr0)
        else:
            p = np.floor(f32(count) / f32(self.decay_steps))
            decayed = f32(self.lr0) * np.power(f32(self.decay_rate), p)
        return float(np.maximum(decayed, f32(self.lr_floor)))

    def update(self, grad: torch.Tensor, state: AdamState,
               params: torch.Tensor) -> tuple[torch.Tensor, AdamState]:
        """(new params, new state) for one step."""
        g = grad
        if self.grad_max is not None:
            g_norm = torch.sqrt(torch.sum(g * g))
            g = torch.where(g_norm < self.grad_max, g,
                            (g / g_norm) * self.grad_max)
        if self.weight_decay:
            g = g + self.weight_decay * params
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g ** 2) + self.b2 * state.nu
        count_inc = state.count + 1
        mu_hat = mu / (1 - self.b1 ** count_inc)
        nu_hat = nu / (1 - self.b2 ** count_inc)
        step = mu_hat / (torch.sqrt(nu_hat) + self.eps)
        new_params = params + (-self.lr(state.count)) * step
        return new_params, AdamState(mu, nu, count_inc)


def expdecay_adamw(lr0: float, decay_rate: float, decay_steps: int,
                   lr_floor: float, b1: float = 0.9, b2: float = 0.999,
                   weight_decay: float = 0.0,
                   grad_max: Optional[float] = None) -> ExpDecayAdamW:
    """Staircase exponential lr decay floored at lr_floor, composed with the
    coupled-decay Adam (case2/case2.jl:31-32)."""
    return ExpDecayAdamW(lr0, decay_rate, decay_steps, lr_floor, b1, b2,
                         weight_decay=weight_decay, grad_max=grad_max)
