"""Case runner (port of crnn_tpu/cases/base.py:run_case): guarded epochs,
``metrics.jsonl``, checkpoint/restart, the best-val params and figures.

Files in ``<out_dir>/<name>/``:

- ``metrics.jsonl``: one line per epoch (``ts``, the absolute ``epoch``,
  ``loss_train``, ``loss_val``, ``grad_norm``, ``epoch_s``), appended, so a
  restarted run continues the series;
- ``checkpoint.pt`` and ``best.pt``: the ``TrainState`` and the best-val
  carry (``infra/checkpoint.py``), written every ``n_plot`` epochs and at
  the end; ``restart=True`` resumes from both;
- ``p_opt.npy``: the best-val params, the learned mechanism; a case whose
  params are a tree in the JAX package (the hybrid cases' ``{"crnn",
  "mlp"}``) writes ``p_opt.npz`` instead, its leaves in JAX's tree order
  (``arr_0``, ``arr_1``, ...), as crnn_tpu/cases/base.py:51-57 does;
- ``figs/``: the prediction of one experiment against its data and the loss
  curves, every ``n_plot`` epochs and at the end. Without matplotlib the
  figures are skipped, with one line saying so, and every other file is
  written as usual.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from crnn_tpu_torch.infra.checkpoint import load_checkpoint, save_checkpoint
from crnn_tpu_torch.infra.metrics import MetricsLogger
from crnn_tpu_torch.infra.plotting import (display_weights, have_matplotlib,
                                           plot_experiment, plot_loss_curves)
from crnn_tpu_torch.train.loop import BestState, Trainer, TrainState
from crnn_tpu_torch.transforms.ravel import tree_leaves


@dataclass
class CaseSetup:
    name: str
    trainer: Trainer
    init_params: torch.Tensor
    predict: Callable              # (params, i_exp) -> (n_save, n_obs)
    weights_fn: Callable           # params -> CRNNWeights
    dataset: Any                   # data.generate.Dataset
    dydt_scale: Optional[torch.Tensor] = None
    species: Optional[list] = None
    logx_plots: bool = False
    # (params, u0 (n, ...), ys (n, n_save, n_obs), masks (n, n_save)) -> (n,)
    # losses on explicit data (index-free), for a data-parallel runner
    loss_on_data: Optional[Callable] = None
    extras: dict = field(default_factory=dict)
    # flat params -> the params tree of the JAX package, for a case whose
    # params are a tree there (transforms/ravel.py); None: a flat vector
    unravel: Optional[Callable] = None
    # (build_fn, cfg, kwargs): ``build_fn(cfg, **kwargs)`` builds this setup
    # again, from picklable pieces, in a rank of its own (the dp runner);
    # the rank sets ``cfg.device`` and moves the kwargs' tensors there
    recipe: Optional[tuple] = None


# the --dp flag of the case CLIs
DP_HELP = ("data-parallel over N ranks (-1: one per card; on the CPU N gloo "
           "processes), batch updates")


def seed_generators(seed: int, n: int) -> list[torch.Generator]:
    """``n`` independent CPU generators from one seed, as JAX splits its key
    (e.g. into u0, noise and params): no stream depends on another's use."""
    seeds = torch.randint(2**62, (n,),
                          generator=torch.Generator().manual_seed(seed))
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _save_best(run_dir: str, name: str, best: BestState, quiet: bool = False,
               unravel: Optional[Callable] = None):
    """Write the best-val params to ``p_opt.npy``, or with ``unravel`` the
    leaves of their tree to ``p_opt.npz`` in JAX's order (at every
    checkpoint, so a killed long run keeps its best, and at the end)."""
    if not float(best.loss_val) < float("inf"):
        return
    params = best.params.detach().cpu()
    if unravel is None:
        np.save(os.path.join(run_dir, "p_opt.npy"), params.numpy())
    else:
        np.savez(os.path.join(run_dir, "p_opt.npz"),
                 *[x.numpy() for x in tree_leaves(unravel(params))])
    if not quiet:
        print(f"[{name}] best val {float(best.loss_val):.4e} "
              f"(train {float(best.loss_train):.4e}) -> p_opt", flush=True)


def observe_run(setup: CaseSetup, run_dir: str, state: TrainState,
                best: BestState, history: dict, e: int, figures: bool):
    """Every ``n_plot`` epochs and at the end: the weights, the best losses
    so far, the figures (one experiment's prediction, the loss curves),
    ``checkpoint.pt``, ``best.pt`` and ``p_opt``."""
    fig_dir = os.path.join(run_dir, "figs")
    display_weights(setup.weights_fn(state.params), setup.dydt_scale)
    print(f"[{setup.name}] epoch {state.epoch} min loss train "
          f"{np.min(history['loss_train']):.4e} val "
          f"{np.min(history['loss_val']):.4e}", flush=True)
    if figures:
        i_show = int(np.random.default_rng(e).integers(
            0, setup.dataset.ys.shape[0]))
        with torch.no_grad():
            pred = setup.predict(state.params, i_show)
        plot_experiment(setup.dataset.ts, setup.dataset.ys[i_show], pred,
                        os.path.join(fig_dir, f"i_exp_{i_show}.png"),
                        species=setup.species, logx=setup.logx_plots)
        plot_loss_curves(history, os.path.join(fig_dir, "loss.png"))
    save_checkpoint(os.path.join(run_dir, "checkpoint.pt"), state)
    save_checkpoint(os.path.join(run_dir, "best.pt"), best)
    _save_best(run_dir, setup.name, best, quiet=True, unravel=setup.unravel)


def run_case(setup: CaseSetup, n_epoch: int, out_dir: str = "runs",
             n_plot: int = 50, restart: bool = False, seed: int = 0,
             log_every: int = 10, dp: int = 0,
             epochs_per_dispatch: int = 1) -> tuple[TrainState, dict]:
    """Train ``n_epoch`` guarded epochs with metrics, checkpoints, the
    best-val params and figures in ``<out_dir>/<name>/`` (module docstring).

    ``dp`` > 0 trains data-parallel over ``dp`` ranks (``dp=-1``: one per
    card) through ``parallel/dp_runner.py:run_case_dp``, which needs the
    case's ``loss_on_data``; ``epochs_per_dispatch`` does not apply there.

    ``epochs_per_dispatch`` > 1 runs the epochs in chunks of that many
    (``Trainer.guarded_epochs_fn``); metrics stay per epoch, and figures and
    checkpoints come at chunk boundaries. Returns (state, history) with this
    run's per-epoch losses, grad norms and seconds, and the best-val carry.
    """
    if dp:
        from crnn_tpu_torch.parallel.dp_runner import run_case_dp

        return run_case_dp(setup, n_epoch, n_ranks=None if dp < 0 else dp,
                           out_dir=out_dir, n_plot=n_plot, restart=restart,
                           seed=seed, log_every=log_every)
    run_dir = os.path.join(out_dir, setup.name)
    ckpt_path = os.path.join(run_dir, "checkpoint.pt")
    best_path = os.path.join(run_dir, "best.pt")
    os.makedirs(run_dir, exist_ok=True)

    trainer = setup.trainer
    state = trainer.init(setup.init_params, seed=seed)
    if restart and os.path.exists(ckpt_path):
        state = load_checkpoint(ckpt_path, state)
        print(f"[{setup.name}] restarted from {ckpt_path} at epoch "
              f"{state.epoch}", flush=True)
    best = trainer.init_best(state)
    # the best-val carry survives restarts: without it, a continuation that
    # never beats the earlier segment would overwrite p_opt.npy with its
    # own worse best
    if restart and os.path.exists(best_path):
        best = load_checkpoint(best_path, best)
        print(f"[{setup.name}] best-val carry restored "
              f"(val {float(best.loss_val):.4e})", flush=True)
    # metrics carry absolute epoch numbers across restarts
    epoch0 = state.epoch
    figures = have_matplotlib()
    if not figures:
        print(f"[{setup.name}] matplotlib is not installed: figures skipped",
              flush=True)
    device = state.params.device
    history: dict = {"loss_train": [], "loss_val": [], "grad_norm": [],
                     "epoch_s": []}

    def observe(e):
        observe_run(setup, run_dir, state, best, history, e, figures)

    k = max(1, int(epochs_per_dispatch))
    step = trainer.guarded_epoch_fn()
    step_k = trainer.guarded_epochs_fn(k) if k > 1 else None
    t_start = time.perf_counter()
    e = 0
    with MetricsLogger(os.path.join(run_dir, "metrics.jsonl")) as logger:
        while e < n_epoch:
            t0 = time.perf_counter()
            if step_k is not None and n_epoch - e >= k:
                state, best, m = step_k(state, best)    # metrics stacked (k,)
                ran = k
            else:
                state, best, m = step(state, best)
                ran = 1
            _sync(device)
            epoch_s = (time.perf_counter() - t0) / ran
            cols = [torch.atleast_1d(x).tolist()
                    for x in (m.loss_train, m.loss_val, m.grad_norm)]
            for j, (lt, lv, gn) in enumerate(zip(*cols)):
                row = {"epoch": epoch0 + e + j + 1, "loss_train": lt,
                       "loss_val": lv, "grad_norm": gn, "epoch_s": epoch_s}
                logger.log(**row)
                for name in history:
                    history[name].append(row[name])
            e += ran
            if log_every and (e % log_every < ran or e == n_epoch):
                print(f"[{setup.name}] epoch={epoch0 + e} "
                      f"loss_train={history['loss_train'][-1]:.4e} "
                      f"loss_val={history['loss_val'][-1]:.4e} "
                      f"epoch_s={epoch_s:.4f}", flush=True)
            if e % n_plot < ran or e == n_epoch:
                observe(e)

    wall = time.perf_counter() - t_start
    print(f"[{setup.name}] {n_epoch} epochs in {wall:.1f}s "
          f"({wall / max(n_epoch, 1) * 1e3:.1f} ms/epoch)", flush=True)
    if best.n_skipped:
        print(f"[{setup.name}] WARNING: {best.n_skipped} epochs produced "
              "non-finite loss/grad; their updates were discarded", flush=True)
    _save_best(run_dir, setup.name, best, unravel=setup.unravel)
    history.update(best_val=best.loss_val, best_train=best.loss_train,
                   n_skipped=best.n_skipped, best_params=best.params)
    return state, history
