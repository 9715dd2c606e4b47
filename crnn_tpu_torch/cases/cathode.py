"""Cathode: DSC thermal-decomposition CRNN fit to measured heat flow (port
of crnn_tpu/cases/cathode.py).

Three sequential decomposition reactions c1 -> c2 -> c3 with extended
Arrhenius kinetics k_i = exp(lnA_i + b_i ln T - Ea_i/(R T)) under linear
heating ramps T(t) = T0 + beta/60 * t (Cathode/src/). The species ODE is
solved per heating-rate curve, the heat-release rate HRR = rates @ delH is
rebuilt from the solution (network.jl:82-91,121) and fit to the measured
curve by a masked MAE. The 15 K/min curve (index 3) is held out for
validation (header.jl:47-56) and moved to the end, the Trainer's split.

Each curve has its own time span, save row and heating rate
(``DSCData``): each is solved in turn on the per-lane driver, one lane,
which is what JAX's vmapped per-curve solves compute. f64, TRBDF2 (J in
closed form, ``models/crnn.py:make_cathode_jac``, which equals the
forward-mode J the JAX package takes), 18 parameters; updates are
sequential (one curve an update, set explicitly: the port's ``Trainer``
defaults to batch). The gradient is the derivative of the early-exit
driver's loss, which the JAX package (and the reference, ForwardDiff,
crnn_cathode.jl:17) takes by forward mode; the port takes it by reverse
mode through the eager while loop (``grad_mode='rev_while'``), the same
derivative at a fraction of ``torch.func.jacfwd``'s cost (PERF.md §6; a
Trainer with ``grad_mode='fwd'`` runs jacfwd). No Pallas kernel backs this
RHS in the JAX package: it is plain torch on every device.

``run_cathode`` is the reference's lifecycle (header.jl:60-86,
crnn_cathode.jl:44-46): a results dir ``<out>/cathode/<expr_name>/`` with
``metrics.jsonl``, the YAML config's snapshot, ``checkpoint.pt`` (every
``n_plot`` epochs and at the end; ``is_restart`` resumes from it), the
best-by-train-loss params in ``p_opt.npy`` and the best losses written
back into the snapshot. The measured curves are read by
``data/loaders.py:load_cathode_dir`` from ``data_dir``; without one the
case runs on ``synthetic_dsc``.

    python -m crnn_tpu_torch.cases.cathode [--config my.yaml] [--epochs N]
        [--data-dir DIR] [--out DIR] [--device cpu] [--dp N]
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import DP_HELP, CaseSetup, run_case
from crnn_tpu_torch.data.generate import Dataset
from crnn_tpu_torch.data.loaders import (DSCData, load_cathode_dir,
                                         synthetic_dsc)
from crnn_tpu_torch.models.crnn import (cathode_hrr, make_cathode_jac,
                                        make_cathode_rhs)
from crnn_tpu_torch.ode import get_solver
from crnn_tpu_torch.ode.rosenbrock import give_jac
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.optimizers import adamw_like
from crnn_tpu_torch.transforms.p2vec import init_params_cathode, p2vec_cathode


@dataclass
class CathodeConfig:
    # mirrors Cathode/config.yaml
    expr_name: str = "4s8r-01"
    ns: int = 3
    nr: int = 3
    lb: float = 1e-8
    n_epoch: int = 1000
    n_plot: int = 100
    grad_max: float = 1e2
    maxiters: int = 2048
    adam_lr: float = 1e-3
    w_decay: float = 1e-7
    cathode: int = 1
    is_restart: bool = False
    # framework extensions
    data_dir: Optional[str] = None   # None: synthetic surrogate curves
    val_index: int = 3               # heating rate 15 K/min held out
    solver: str = "trbdf2"
    mode: str = "sequential"
    seed: int = 0
    rtol: float = 1e-4
    device: str = "cuda"


def build(cfg: CathodeConfig = CathodeConfig(),
          dsc: Optional[DSCData] = None) -> CaseSetup:
    """The cathode setup on ``cfg.device``, in f64. ``dsc`` replaces the
    curves of ``cfg.data_dir`` (or the synthetic ones)."""
    device = resolve_device(cfg.device)
    f64 = torch.float64
    if dsc is None:
        dsc = (load_cathode_dir(cfg.data_dir, cfg.cathode) if cfg.data_dir
               else synthetic_dsc(seed=cfg.seed))
    n_exp = dsc.ts.shape[0]
    # training curves first, the validation curve last: the Trainer's split
    # (the reference skips l_val inside the loop, crnn_cathode.jl:14-16)
    order = [i for i in range(n_exp) if i != cfg.val_index] + [cfg.val_index]

    def rows(a):
        return torch.as_tensor(np.asarray(a)[order], dtype=f64).to(device)

    ts, hrr_data, masks, betas = (rows(dsc.ts), rows(dsc.hrr),
                                  rows(dsc.mask), rows(dsc.betas))
    # each curve's span and save row, read once on the host
    spans = [(float(r[0]), float(r[-1])) for r in np.asarray(dsc.ts)[order]]

    rhs = make_cathode_rhs(cfg.lb)
    # J in closed form (the JAX package's batch-major one), where JAX takes
    # jacfwd of the RHS: the same J, without a forward-mode pass a step
    solver = give_jac(get_solver(cfg.solver), make_cathode_jac(cfg.lb))
    u0 = torch.zeros((1, cfg.ns), dtype=f64, device=device)
    u0[0, 0] = 1.0  # unity mass of c1
    n_save = ts.shape[1]

    def predict_hrr(p, i, unroll="while"):
        """The HRR curve of experiment ``i`` (n_save,)."""
        w = p2vec_cathode(p)
        beta = betas[i]
        t0, t1 = spans[i]
        sol = odesolve(rhs, solver, u0, t0, t1, ts[i], args=(w, beta),
                       rtol=cfg.rtol, atol=cfg.lb, max_steps=cfg.maxiters,
                       unroll=unroll)
        return cathode_hrr(ts[i], clip(sol.ys[0], 0.0, 10.0), w, beta, cfg.lb)

    def make_loss(unroll):
        def loss(p, idxs, horizon_masks):
            """One curve's solve at a time, (n,) losses."""
            out = []
            for i, m in zip(idxs.tolist(), horizon_masks):
                w = masks[i] * m
                out.append(torch.sum(torch.abs(
                    predict_hrr(p, i, unroll) - hrr_data[i]) * w)
                    / torch.sum(w))
            return torch.stack(out)
        return loss

    def loss_on_data(p, u0_b, ys_b, horizon_masks, unroll="scan"):
        """The dp runner's loss: each row of ``u0_b`` holds its curve's
        index (each curve has its own time row and heating rate)."""
        out = []
        for i, y, m in zip(u0_b.tolist(), ys_b, horizon_masks):
            w = masks[i] * m
            out.append(torch.sum(torch.abs(predict_hrr(p, i, unroll)
                                           - y[:, 0]) * w) / torch.sum(w))
        return torch.stack(out)

    trainer = Trainer(
        loss_i_exp=make_loss("scan"),
        loss_i_exp_eval=make_loss("while"),
        optimizer=adamw_like(cfg.adam_lr, weight_decay=cfg.w_decay,
                             grad_max=cfg.grad_max),
        n_exp_train=n_exp - 1,
        n_exp=n_exp,
        n_save=n_save,
        mode=cfg.mode,
        # the derivative of the early-exit driver's loss (the reference's
        # ForwardDiff path, crnn_cathode.jl:17), by reverse mode
        grad_mode="rev_while",
    )
    # a Dataset-like view for the runner: u0 holds the experiment index
    dataset = Dataset(u0=torch.arange(n_exp, device=device),
                      ys=hrr_data[:, :, None], ys_clean=hrr_data[:, :, None],
                      ts=ts[0],
                      yscale=torch.ones(1, dtype=f64, device=device),
                      success=torch.ones(n_exp, dtype=torch.bool,
                                         device=device))
    return CaseSetup(
        name="cathode", trainer=trainer,
        init_params=init_params_cathode(
            torch.Generator().manual_seed(cfg.seed), dtype=f64,
            device=device),
        predict=lambda p, i: predict_hrr(p, i)[:, None],
        weights_fn=p2vec_cathode, dataset=dataset, species=["HRR"],
        loss_on_data=loss_on_data,
        extras={"dsc": dsc, "config": cfg, "predict_hrr": predict_hrr},
        recipe=(build, cfg, {"dsc": dsc}))


def run_cathode(cfg: CathodeConfig, out_dir: str = "runs_torch",
                config_yaml: Optional[str] = None,
                dsc: Optional[DSCData] = None):
    """The reference's driver (module docstring): ``cfg.n_epoch`` epochs with
    metrics, the YAML snapshot and its loss write-back, best-by-train-loss
    tracking (callback.jl:122-126), ``p_opt.npy`` and checkpoints. Returns
    (state, best) with ``best = {loss_train, loss_val, params}``."""
    from crnn_tpu_torch.infra.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from crnn_tpu_torch.infra.config import snapshot_config, writeback_results
    from crnn_tpu_torch.infra.metrics import MetricsLogger

    setup = build(cfg, dsc=dsc)
    results_dir = os.path.join(out_dir, "cathode", cfg.expr_name)
    os.makedirs(results_dir, exist_ok=True)
    snap_path = None
    if config_yaml and os.path.exists(config_yaml):
        snap_path = snapshot_config(config_yaml, results_dir)

    trainer = setup.trainer
    state = trainer.init(setup.init_params, seed=cfg.seed)
    ckpt = os.path.join(results_dir, "checkpoint.pt")
    if cfg.is_restart and os.path.exists(ckpt):
        state = load_checkpoint(ckpt, state)
        print(f"[cathode] restarted from {ckpt} at epoch {state.epoch}",
              flush=True)

    print_every = max(cfg.n_plot // 10, 1)
    best = {"loss_train": np.inf, "loss_val": np.inf, "params": None}
    t0 = time.perf_counter()
    with MetricsLogger(os.path.join(results_dir, "metrics.jsonl")) as logger:
        for e in range(cfg.n_epoch):
            state, m = trainer.epoch(state)
            lt, lv = float(m.loss_train), float(m.loss_val)
            logger.log(epoch=state.epoch, loss_train=lt, loss_val=lv,
                       grad_norm=float(m.grad_norm))
            if (e + 1) % print_every == 0 or e + 1 == cfg.n_epoch:
                print(f"[cathode] epoch={state.epoch} loss_train={lt:.4e} "
                      f"loss_val={lv:.4e}", flush=True)
            if lt < best["loss_train"]:
                # best-so-far keyed on the train loss (callback.jl:122-126)
                best.update(loss_train=lt, loss_val=lv,
                            params=state.params.detach().cpu().numpy())
            if (e + 1) % cfg.n_plot == 0:
                save_checkpoint(ckpt, state)
    save_checkpoint(ckpt, state)
    if best["params"] is not None:
        np.save(os.path.join(results_dir, "p_opt.npy"), best["params"])
    if snap_path:
        writeback_results(snap_path, {"loss_train": best["loss_train"],
                                      "loss_val": best["loss_val"]})
    print(f"[cathode] {cfg.n_epoch} epochs in {time.perf_counter() - t0:.1f}s;"
          f" best train {best['loss_train']:.4e} val {best['loss_val']:.4e}",
          flush=True)
    return state, best


def main(argv=None):
    import argparse

    from crnn_tpu_torch.infra.config import config_from_yaml

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=None, help="YAML config path")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the config's (cuda)")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP
                    + "; the generic runner in place of the YAML lifecycle")
    args = ap.parse_args(argv)
    cfg = (config_from_yaml(CathodeConfig, args.config) if args.config
           else CathodeConfig())
    if args.epochs is not None:
        cfg.n_epoch = args.epochs
    if args.data_dir:
        cfg.data_dir = args.data_dir
    if args.device:
        cfg.device = args.device
    if args.dp:
        cfg.mode = "batch"  # dp updates are batch updates (dp_runner.py)
        return run_case(build(cfg), n_epoch=cfg.n_epoch, out_dir=args.out,
                        restart=cfg.is_restart, dp=args.dp)
    return run_cathode(cfg, out_dir=args.out, config_yaml=args.config)


if __name__ == "__main__":
    main()
