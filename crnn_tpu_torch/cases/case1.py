"""case1: isothermal synthetic CRNN (5 species / 4 reactions) (port of
crnn_tpu/cases/case1.py).

30 experiments (20 train / 10 test) of a 4-reaction mass-action system with
5% noise; sign-tied p2vec (w_in = clip(-w_out, 0, 2.5), bias offset
b0 = -10); Tsit5 on the per-lane ``odesolve``, all experiments as lanes of
one solve (``mode='batch'``) or one lane per update (``mode='sequential'``,
the reference's per-experiment updates, reverse mode as in JAX);
scaled-MAE loss; Adam with coupled weight decay at a constant lr. On a
CUDA device every Tsit5 stage evaluates the RHS through the isothermal
kernel (``ops/csrc/crnn_rhs.cu``). The data are generated on the
chosen device by the port's own solver. ``p_cutoff`` prunes |w_out| below
the cutoff (case1_hardthreshhold.jl).

    python -m crnn_tpu_torch.cases.case1 --epochs 3 [--device cpu]
        [--mode sequential] [--restart]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import Dataset, generate_dataset_odesolve
from crnn_tpu_torch.data.truth import CASE1_K, case1_truth
from crnn_tpu_torch.models.crnn import make_crnn_rhs
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import adamw_like, expdecay_adamw
from crnn_tpu_torch.transforms.p2vec import init_params_case1, p2vec_case1
from crnn_tpu_torch.transforms.pruning import prune_case2_params


@dataclass
class Case1Config:
    # reference constants: case1/case1.jl:13-33
    ns: int = 5
    nr: int = 4
    datasize: int = 100
    tstep: float = 0.4
    n_exp_train: int = 20
    n_exp_test: int = 10
    noise: float = 5e-2
    lr: float = 1e-3
    lr_decay: float = 1.0          # 1.0 = constant lr (reference default)
    lr_decay_epochs: int = 2000
    lr_floor: float = 1e-4
    grad_max: float = 0.0          # 0 = no clipping (reference default)
    weight_decay: float = 1e-8
    atol: float = 1e-5
    rtol: float = 1e-2
    lb: float = 1e-5
    ub: float = 10.0
    b0: float = -10.0
    p_cutoff: float = 0.0
    seed: int = 1234
    max_steps: int = 128
    mode: str = "batch"        # 'batch' or 'sequential' (the reference's)
    dtype: str = "float32"
    device: str = "cuda"
    # True runs the plain PyTorch RHS in place of the CUDA kernel: the
    # explicit switch for holding the kernel path against the plain path
    rhs_plain: bool = False

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_test


def build(cfg: Case1Config = Case1Config(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The case1 setup on ``cfg.device``. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    device = resolve_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)
    g_u0, g_noise, g_p = seed_generators(cfg.seed, 3)
    t1 = cfg.datasize * cfg.tstep
    if dataset is None:
        # case1/case1.jl:46-67: u0 ~ U(0,1), first two species +0.2, the
        # rest zero; multiplicative noise; max-min + lb global scale
        u0 = torch.rand((cfg.n_exp, cfg.ns), generator=g_u0, dtype=dtype)
        u0[:, :2] += 0.2
        u0[:, 2:] = 0.0
        saveat = torch.linspace(0.0, t1, cfg.datasize, dtype=dtype,
                                device=device)
        dataset = generate_dataset_odesolve(
            g_noise, case1_truth, Tsit5(), u0.to(device),
            torch.tensor(CASE1_K, dtype=dtype, device=device), 0.0, t1,
            saveat, rtol=1e-6, atol=1e-8, noise=cfg.noise, scale_lb=cfg.lb)
    init_params = init_params_case1(g_p, cfg.ns, cfg.nr, dtype=dtype,
                                    device=device)

    def weights_fn(p):
        if cfg.p_cutoff > 0:
            p = prune_case2_params(p, cfg.ns, cfg.nr, cfg.p_cutoff)
        return p2vec_case1(p, cfg.ns, cfg.nr, cfg.b0)

    rhs = make_crnn_rhs(cfg.lb, cfg.ub, plain=cfg.rhs_plain)
    solver = Tsit5()
    loss_fn = make_trajectory_loss(yscale=dataset.yscale)

    def predict_from_u0(p, u0_b, unroll):
        sol = odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                       args=weights_fn(p), rtol=cfg.rtol, atol=cfg.atol,
                       max_steps=cfg.max_steps, unroll=unroll)
        return clip(sol.ys, -cfg.ub, cfg.ub)

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
        return loss_fn(predict_from_u0(p, u0_b, unroll), ys_b, masks)

    def make_loss_i_exp(unroll):
        def loss_i_exp(p, idxs, masks):
            return loss_on_data(p, dataset.u0[idxs], dataset.ys[idxs], masks,
                                unroll)
        return loss_i_exp

    def predict(p, i_exp):
        return predict_from_u0(p, dataset.u0[i_exp:i_exp + 1], "while")[0]

    if cfg.lr_decay >= 1.0:
        optimizer = adamw_like(cfg.lr, weight_decay=cfg.weight_decay,
                               grad_max=cfg.grad_max or None)
    else:
        updates_per_epoch = (cfg.n_exp_train if cfg.mode == "sequential"
                             else 1)
        optimizer = expdecay_adamw(
            cfg.lr, cfg.lr_decay, cfg.lr_decay_epochs * updates_per_epoch,
            cfg.lr_floor, weight_decay=cfg.weight_decay,
            grad_max=cfg.grad_max or None)
    trainer = Trainer(
        loss_i_exp=make_loss_i_exp("scan"),
        loss_i_exp_eval=make_loss_i_exp("while"),
        optimizer=optimizer,
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
        mode=cfg.mode,
    )
    return CaseSetup(name="case1", trainer=trainer, init_params=init_params,
                     predict=predict, weights_fn=weights_fn, dataset=dataset,
                     species=["A", "B", "C", "D", "E"],
                     loss_on_data=loss_on_data,
                     recipe=(build, cfg, {"dataset": dataset}))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="batch", choices=("batch", "sequential"))
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/case1/checkpoint.pt")
    ap.add_argument("--p-cutoff", type=float, default=0.0)
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = Case1Config(device=args.device, mode=args.mode,
                      p_cutoff=args.p_cutoff)
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart, dp=args.dp)


if __name__ == "__main__":
    main()
