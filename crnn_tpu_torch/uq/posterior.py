"""Posterior analysis for SVGD particle ensembles (port of
crnn_tpu/uq/posterior.py).

The UQ observability layer of the reference
(Cathode_NCM333_UQ/src_333/post_Plotting.jl): posterior moments, the
Kendall-tau correlation matrix (:201-265), realisation bands around the
data, per-parameter histograms and the particle-evolution history tensor
(crnn_cathode.jl:54-57). numpy in, numpy out; matplotlib is imported inside
the functions that plot (the card's machine has none).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _savefig(fig, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)


def posterior_moments(particles: np.ndarray) -> dict:
    """Mean/std/quantiles per parameter. particles: (n, d)."""
    q = np.quantile(particles, [0.025, 0.25, 0.5, 0.75, 0.975], axis=0)
    return {
        "mean": particles.mean(axis=0),
        "std": particles.std(axis=0),
        "q2.5": q[0], "q25": q[1], "median": q[2], "q75": q[3], "q97.5": q[4],
    }


def kendall_correlation(particles: np.ndarray) -> np.ndarray:
    """Kendall-tau rank correlation matrix (post_Plotting.jl:201-216 uses
    corkendall)."""
    from scipy.stats import kendalltau

    d = particles.shape[1]
    corr = np.eye(d)
    for i in range(d):
        for j in range(i + 1, d):
            tau = kendalltau(particles[:, i], particles[:, j]).statistic
            corr[i, j] = corr[j, i] = tau
    return corr


def plot_correlation_heatmap(particles: np.ndarray, path: str,
                             names: Optional[Sequence[str]] = None) -> None:
    plt = _pyplot()
    corr = kendall_correlation(particles)
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(corr, vmin=-1, vmax=1, cmap="RdBu_r")
    if names:
        ax.set_xticks(range(len(names)), names, rotation=90, fontsize=7)
        ax.set_yticks(range(len(names)), names, fontsize=7)
    fig.colorbar(im, ax=ax, label="Kendall tau")
    fig.tight_layout()
    _savefig(fig, path)
    plt.close(fig)


def plot_posterior_band(ts, data, predict_fn: Callable,
                        particles: np.ndarray, path: str, n_draw: int = 50,
                        logx: bool = False) -> None:
    """Overlay posterior predictive realisations +/- band on the data
    (post_Plotting.jl:90-199)."""
    plt = _pyplot()
    idx = np.linspace(0, particles.shape[0] - 1,
                      min(n_draw, particles.shape[0])).astype(int)
    preds = np.stack([np.asarray(predict_fn(particles[i])) for i in idx])
    mean = preds.mean(axis=0)
    std = preds.std(axis=0)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.scatter(ts, data, s=8, facecolors="none", edgecolors="k", label="data")
    ax.plot(ts, mean, "C1-", label="posterior mean")
    ax.fill_between(np.asarray(ts), mean - 4 * std, mean + 4 * std,
                    color="C1", alpha=0.25, label="+/-4 sigma")
    if logx:
        ax.set_xscale("log")
    ax.legend(frameon=False)
    fig.tight_layout()
    _savefig(fig, path)
    plt.close(fig)


def plot_particle_histograms(particles: np.ndarray, path: str,
                             names: Optional[Sequence[str]] = None) -> None:
    plt = _pyplot()
    d = particles.shape[1]
    ncol = int(np.ceil(np.sqrt(d)))
    nrow = int(np.ceil(d / ncol))
    fig, axes = plt.subplots(nrow, ncol, figsize=(2.4 * ncol, 2.0 * nrow))
    axes = np.atleast_1d(axes).ravel()
    for i in range(d):
        axes[i].hist(particles[:, i], bins=20, color="C0", alpha=0.8)
        axes[i].set_title(names[i] if names else f"p{i}", fontsize=8)
    for ax in axes[d:]:
        ax.axis("off")
    fig.tight_layout()
    _savefig(fig, path)
    plt.close(fig)


class ParticleHistory:
    """Rolling particle-history tensor saved every ``gap`` iters
    (crnn_cathode.jl:54-57) for posterior-evolution animations."""

    def __init__(self, gap: int = 10):
        self.gap = gap
        self.snapshots: list = []

    def maybe_record(self, iteration: int, particles) -> None:
        # a device tensor is kept on the device (no host sync per
        # snapshot; one transfer in tensor()); each snapshot is a copy, so
        # a later in-place update cannot alias it
        if (iteration + 1) % self.gap == 0:
            if isinstance(particles, torch.Tensor):
                particles = particles.detach().clone()
            else:
                particles = np.array(particles, copy=True)
            self.snapshots.append(particles)

    def tensor(self) -> np.ndarray:
        """(n_snapshots, n, d), or an empty array without snapshots."""
        if not self.snapshots:
            return np.empty((0,))
        if isinstance(self.snapshots[0], torch.Tensor):
            return torch.stack(self.snapshots).cpu().numpy()
        return np.stack(self.snapshots)


def animate_particle_evolution(history: np.ndarray, path: str,
                               param_pair=(0, 3), fps: int = 10) -> None:
    """GIF of two parameters' particle cloud over SVGD iterations
    (the mp4 animations of post_Plotting.jl:286-331)."""
    if history.size == 0:
        return
    plt = _pyplot()
    import matplotlib.animation as animation

    i, j = param_pair
    fig, ax = plt.subplots(figsize=(4, 4))
    lo = history[..., [i, j]].min(axis=(0, 1))
    hi = history[..., [i, j]].max(axis=(0, 1))
    pad = 0.05 * (hi - lo + 1e-12)
    scat = ax.scatter(history[0, :, i], history[0, :, j], s=8, alpha=0.6)
    ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
    ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
    ax.set_xlabel(f"p{i}")
    ax.set_ylabel(f"p{j}")

    def update(frame):
        scat.set_offsets(history[frame][:, [i, j]])
        ax.set_title(f"snapshot {frame}")
        return (scat,)

    anim = animation.FuncAnimation(fig, update, frames=history.shape[0])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    anim.save(path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
