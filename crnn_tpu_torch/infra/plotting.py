"""Figures and the weight printer (port of crnn_tpu/infra/plotting.py), on
numpy: prediction against data per species (``plot_experiment``), loss and
grad-norm curves (``plot_loss_curves``) and the learned stoichiometry
(``display_weights``).

matplotlib is imported inside the two plot functions, never when this
module is imported: a machine without it still trains, and
``cases/base.py:run_case`` then skips the figures (``have_matplotlib``).
That is a choice about output files only; no device or kernel path
depends on it.
"""

from __future__ import annotations

import importlib.util
import os
from typing import Optional, Sequence

import numpy as np


def have_matplotlib() -> bool:
    """True iff matplotlib can be imported."""
    return importlib.util.find_spec("matplotlib") is not None


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (any device) or an array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def plot_experiment(ts, data, pred, path: str,
                    species: Optional[Sequence[str]] = None,
                    logx: bool = False) -> None:
    """Scatter data against predicted trajectories, one panel per species."""
    plt = _pyplot()
    ts, data, pred = _numpy(ts), _numpy(data), _numpy(pred)
    ns = data.shape[1]
    ncol = int(np.ceil(np.sqrt(ns)))
    nrow = int(np.ceil(ns / ncol))
    fig, axes = plt.subplots(nrow, ncol, figsize=(3.2 * ncol, 2.6 * nrow))
    axes = np.atleast_1d(axes).ravel()
    for i in range(ns):
        ax = axes[i]
        ax.scatter(ts, data[:, i], s=8, facecolors="none", edgecolors="C0",
                   label="data")
        ax.plot(ts, pred[:, i], "C1-", label="CRNN")
        ax.set_ylabel(species[i] if species else f"y{i + 1}")
        if logx:
            ax.set_xscale("log")
        if i == 0:
            ax.legend(frameon=False, fontsize=8)
    for ax in axes[ns:]:
        ax.axis("off")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_loss_curves(history: dict, path: str) -> None:
    """Train/val loss and grad-norm curves against the epoch, log scales."""
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(8, 3))
    axes[0].plot(history["loss_train"], label="train")
    axes[0].plot(history["loss_val"], label="val")
    axes[0].set_yscale("log")
    axes[0].set_xscale("log")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("Loss")
    axes[0].legend(frameon=False)
    if history.get("grad_norm"):
        axes[1].plot(history["grad_norm"], label="grad_norm", color="C2")
        axes[1].set_yscale("log")
        axes[1].set_xscale("log")
        axes[1].set_xlabel("Epoch")
        axes[1].set_ylabel("Grad norm")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def display_weights(weights, dydt_scale=None) -> str:
    """Print the learned stoichiometry for mechanism inspection (the
    reference's ``display_p``); returns the printed string."""
    w_in, w_b, w_out = (_numpy(weights.w_in), _numpy(weights.w_b),
                        _numpy(weights.w_out))
    lines = ["species (column) reaction (row)", "w_in:",
             np.array2string(w_in.T, precision=3, suppress_small=True),
             "exp(w_b):",
             np.array2string(np.exp(w_b), precision=3, suppress_small=True)]
    if dydt_scale is not None:
        w_out_scale = (w_out.T * _numpy(dydt_scale)[None, :]
                       * np.exp(w_b)[:, None])
        denom = np.max(np.abs(w_out_scale), axis=1, keepdims=True)
        lines += ["w_out_scale (row-normalised):",
                  np.array2string(w_out_scale / denom, precision=3,
                                  suppress_small=True)]
    else:
        lines += ["w_out:", np.array2string(w_out.T, precision=3,
                                            suppress_small=True)]
    out = "\n".join(lines)
    print(out, flush=True)
    return out
