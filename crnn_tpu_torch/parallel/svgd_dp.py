"""SVGD over ranks: the particle axis sharded for the scores, the kernel
algebra on every rank (port of crnn_tpu/parallel/svgd_dp.py).

The update couples all particles through the (n, n) RBF kernel, but the
costly part, each particle's solve and gradient, is independent per
particle. Each rank scores its contiguous shard of the (replicated)
ensemble; one ``all_gather`` brings every rank the particles, scores and
losses (n x (2d + 1) numbers); every rank then computes the same update.
"""

from __future__ import annotations

from typing import Callable

import torch

from crnn_tpu_torch.parallel.mesh import all_gather_cat, rank, world_size
from crnn_tpu_torch.uq.svgd import svgd_step_tolerant


def check_divides(n_particles: int, world: int) -> None:
    if n_particles % world:
        raise ValueError(
            f"num_particles={n_particles} must divide over the {world} ranks "
            "for SVGD dp")


def shard_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous shard of ``x``'s rows."""
    per = x.shape[0] // world_size()
    return x[rank() * per:(rank() + 1) * per]


def make_dp_svgd_step(value_and_grad_lanes: Callable) -> Callable:
    """The sharded SVGD step on the current process group.

    ``value_and_grad_lanes(particles (m, d), i_exp) -> (losses (m,), grads
    (m, d))`` scores a block of particles. Returns ``step(particles (n, d),
    i_exp, stepsize, normalizer) -> (new particles (n, d), mean loss)``,
    the same on every rank; n must divide the world size.
    """

    def step(particles, i_exp, stepsize, normalizer):
        n, d = particles.shape
        check_divides(n, world_size())
        shard = shard_rows(particles)
        losses, grads = value_and_grad_lanes(shard, i_exp)
        lnpgrad = -grads / normalizer ** 2
        full = all_gather_cat(torch.cat([shard, lnpgrad, losses[:, None]],
                                        dim=1))
        return svgd_step_tolerant(full[:, :d], full[:, 2 * d],
                                  full[:, d:2 * d], stepsize)

    return step


def make_dp_losses(loss_lanes: Callable) -> Callable:
    """``losses(particles (n, d), i_exp) -> (n,)`` with each rank solving
    its shard, gathered on every rank."""

    def losses(particles, i_exp):
        return all_gather_cat(loss_lanes(shard_rows(particles), i_exp))

    return losses
