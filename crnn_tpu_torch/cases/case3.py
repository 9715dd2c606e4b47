"""case3: MAPK signalling cascade (9 species / 8 reactions) and its GRN
variant (port of crnn_tpu/cases/case3.py).

case3: 100 experiments (70 train / 30 test) with log-uniform initial
conditions, 5% noise, the product-tied p2vec (w_out = -w_in * |w_out_raw|),
dy/dt rescaled by the data's max-min scale over t1, a log-space MAE on
predictions and data clipped to [lb, ub], and NADAM clipped at 100. Its
updates visit all 100 experiments, the validation split included, as the
reference does (case3/case3.jl:263; ``n_exp_update = n_exp``). The GRN
(``variant='grn'``, ``grn_config()``, gene-regulatory.jl) shares the
build: its own truth, nr=15, frozen DNA rows of w_out, 40 save points, 1%
noise, the scaled MAE, Adam with coupled weight decay 1e-6 (optionally on a
staircase lr decay) and stochastic prefix horizons of 2-40 save points.
``p_cutoff`` prunes w_out relative to each reaction's row max and w_in
below the cutoff (case3_pruning.jl). On a CUDA device every Tsit5 stage
evaluates the RHS through the isothermal kernel (``ops/csrc/crnn_rhs.cu``);
the data are generated on the chosen device by the port's own solver.

    python -m crnn_tpu_torch.cases.case3 --epochs 2 [--variant grn]
        [--device cpu] [--mode sequential] [--restart]
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import Dataset, generate_dataset_odesolve
from crnn_tpu_torch.data.truth import CASE3_K, GRN_K, case3_truth, grn_truth
from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import (adamw_like, expdecay_adamw,
                                             nadam_like)
from crnn_tpu_torch.transforms.p2vec import init_params_case3, p2vec_case3
from crnn_tpu_torch.transforms.pruning import (hard_threshold,
                                               relative_threshold)

# the GRN's DNA species: constant, their w_out rows frozen at 0
# (gene-regulatory.jl:44)
GRN_FROZEN_ROWS = (0, 3, 6)


@dataclass
class Case3Config:
    # reference constants: case3/case3.jl:15-39 ; grn: gene-regulatory.jl:15-33
    variant: str = "case3"        # 'case3' | 'grn'
    ns: int = 9
    nr: int = 8
    datasize: int = 100
    tstep: float = 0.1
    n_exp_train: int = 70
    n_exp_test: int = 30
    noise: float = 5e-2
    lr: float = 1e-3
    grad_max: float = 100.0
    atol: float = 1e-5
    rtol: float = 1e-2
    lb: float = 1e-5
    ub: float = 100.0
    p_cutoff: float = 0.0
    seed: int = 1234
    max_steps: int = 192
    mode: str = "batch"
    dtype: str = "float32"
    horizon: Optional[tuple] = None
    # GRN: staircase lr decay; 0 steps = constant lr
    lr_decay: float = 0.5
    lr_decay_steps: int = 0
    lr_floor: float = 1e-5
    device: str = "cuda"
    # True runs the plain PyTorch RHS in place of the CUDA kernel: the
    # explicit switch for holding the kernel path against the plain path
    rhs_plain: bool = False

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_test


def grn_config() -> Case3Config:
    """gene-regulatory.jl:15-33: nr=15, 40 save points at 0.1, 1% noise,
    ADAMW, stochastic truncation to rand(2:datasize) save points (:258)."""
    return Case3Config(variant="grn", nr=15, datasize=40, noise=1e-2,
                       horizon=(2, 40))


def build(cfg: Case3Config = Case3Config(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The case3 or GRN setup on ``cfg.device``. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    if cfg.variant not in ("case3", "grn"):
        raise ValueError(f"unknown case3 variant {cfg.variant!r}")
    device = resolve_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)
    g_u0, g_noise, g_p = seed_generators(cfg.seed, 3)
    case3 = cfg.variant == "case3"
    t1 = cfg.datasize * cfg.tstep
    if dataset is None:
        if case3:
            # log-uniform u0 = 10^(-3 U(0,1)); experiments {0, 1, last} zero
            # the activated species [2, 4, 6, 8] (case3/case3.jl:106-107)
            u0 = 10.0 ** (torch.rand((cfg.n_exp, cfg.ns), generator=g_u0,
                                     dtype=dtype) * -3.0)
            u0[[[0], [1], [cfg.n_exp - 1]], [2, 4, 6, 8]] = 0.0
            truth, k = case3_truth, CASE3_K
        else:
            u0 = torch.rand((cfg.n_exp, cfg.ns), generator=g_u0, dtype=dtype)
            truth, k = grn_truth, GRN_K
        saveat = torch.linspace(0.0, t1, cfg.datasize, dtype=dtype,
                                device=device)
        dataset = generate_dataset_odesolve(
            g_noise, truth, Tsit5(), u0.to(device),
            torch.tensor(k, dtype=dtype, device=device), 0.0, t1, saveat,
            rtol=1e-6, atol=1e-8, noise=cfg.noise, scale_lb=cfg.lb)
    # dy/dt scale: the data's scale over t_end (case3/case3.jl:147-149)
    dydt_scale = dataset.yscale / t1
    init_params = init_params_case3(g_p, cfg.ns, cfg.nr, dtype=dtype,
                                    device=device)
    frozen_rows = None if case3 else GRN_FROZEN_ROWS

    def weights_fn(p):
        w = p2vec_case3(p, cfg.ns, cfg.nr, frozen_rows=frozen_rows)
        if cfg.p_cutoff > 0:
            w = w._replace(
                w_out=relative_threshold(w.w_out, dydt_scale, cfg.p_cutoff),
                w_in=hard_threshold(w.w_in, cfg.p_cutoff))
        return w

    rhs = make_crnn_scaled_rhs(cfg.lb, cfg.ub, dydt_scale,
                               plain=cfg.rhs_plain)
    solver = Tsit5()

    def predict_from_u0(p, u0_b, unroll):
        sol = odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                       args=weights_fn(p), rtol=cfg.rtol, atol=cfg.atol,
                       max_steps=cfg.max_steps, unroll=unroll)
        return clip(sol.ys, cfg.lb, cfg.ub)

    if case3:
        # log-space loss with the data clipped into [lb, ub] (case3.jl:183-190)
        loss_fn = make_trajectory_loss("log_mae", clip_lb=cfg.lb,
                                       clip_ub=cfg.ub)
        optimizer = nadam_like(cfg.lr, grad_max=cfg.grad_max or None)
        n_exp_update = cfg.n_exp
    else:
        loss_fn = make_trajectory_loss("mae", yscale=dataset.yscale)
        if cfg.lr_decay_steps > 0:
            optimizer = expdecay_adamw(
                cfg.lr, cfg.lr_decay, cfg.lr_decay_steps, cfg.lr_floor,
                weight_decay=1e-6, grad_max=cfg.grad_max or None)
        else:
            optimizer = adamw_like(cfg.lr, weight_decay=1e-6,
                                   grad_max=cfg.grad_max or None)
        n_exp_update = None

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
        if case3:
            ys_b = clip(ys_b, cfg.lb, cfg.ub)
        return loss_fn(predict_from_u0(p, u0_b, unroll), ys_b, masks)

    def make_loss_i_exp(unroll):
        def loss_i_exp(p, idxs, masks):
            return loss_on_data(p, dataset.u0[idxs], dataset.ys[idxs], masks,
                                unroll)
        return loss_i_exp

    def predict(p, i_exp):
        return predict_from_u0(p, dataset.u0[i_exp:i_exp + 1], "while")[0]

    trainer = Trainer(
        loss_i_exp=make_loss_i_exp("scan"),
        loss_i_exp_eval=make_loss_i_exp("while"),
        optimizer=optimizer,
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
        mode=cfg.mode,
        horizon_range=cfg.horizon,
        n_exp_update=n_exp_update,
    )
    return CaseSetup(name=cfg.variant, trainer=trainer,
                     init_params=init_params, predict=predict,
                     weights_fn=weights_fn, dataset=dataset,
                     dydt_scale=dydt_scale, loss_on_data=loss_on_data,
                     recipe=(build, cfg, {"dataset": dataset}))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--variant", default="case3", choices=("case3", "grn"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="batch", choices=("batch", "sequential"))
    ap.add_argument("--p-cutoff", type=float, default=0.0)
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/<variant>/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--epochs-per-dispatch", type=int, default=1,
                    help="run the epochs in chunks of N")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = replace(grn_config() if args.variant == "grn" else Case3Config(),
                  device=args.device, mode=args.mode, p_cutoff=args.p_cutoff)
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart,
                    epochs_per_dispatch=args.epochs_per_dispatch,
                    dp=args.dp)


if __name__ == "__main__":
    main()
