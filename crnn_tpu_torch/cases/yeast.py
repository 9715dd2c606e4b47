"""yeast-glycolysis: the hidden-species hybrid CRNN (port of
crnn_tpu/cases/yeast.py).

7 observed species of 12: an MLP (7 -> 5, gelu with a softplus output)
infers the 5 hidden species inside the RHS, and a learned constant influx
w_J is added to each observed species (yeast_glycolysis.jl). 30
experiments (20 train / 10 validation) from the published box of initial
conditions, 300 save points over [0, 5], std-based scales, f32, TRBDF2
with max_steps 384, stochastic prefix horizons of 32-300 save points, and
Adam with coupled weight decay on a staircase lr decay. ``mlp_width`` > 0
widens the MLP's three hidden layers. The params are JAX's ``{"crnn",
"mlp"}`` tree raveled into one flat tensor (``transforms/ravel.py``).

On a CUDA device every f of every TRBDF2 stage runs the MLP in plain torch
and the CRNN core on ``u_full (B, 12)`` through the isothermal kernel
(``ops/csrc/crnn_rhs.cu``); TRBDF2's J is forward mode of the plain twin of
the RHS, the function JAX's ``jacfwd`` differentiates, as the kernel ops
have no forward-mode rule. The truth is generated on the chosen device by
TRBDF2 at rtol 1e-6.

    python -m crnn_tpu_torch.cases.yeast --epochs 2 [--device cpu]
        [--mode sequential] [--restart] [--lr0 LR] [--lr-decay-epochs N]
        [--max-steps N] [--mlp-width W]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import Dataset, generate_dataset_odesolve
from crnn_tpu_torch.data.truth import (YEAST_IC_LB, YEAST_IC_UB, YEAST_K,
                                       yeast_truth)
from crnn_tpu_torch.models.crnn import make_crnn_yeast_rhs
from crnn_tpu_torch.models.mlp import make_mlp
from crnn_tpu_torch.ode import TRBDF2, get_solver
from crnn_tpu_torch.ode.rosenbrock import give_jac, jac_by_forward_mode
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import expdecay_adamw
from crnn_tpu_torch.transforms.p2vec import init_params_yeast, p2vec_yeast
from crnn_tpu_torch.transforms.ravel import ravel_pytree


@dataclass
class YeastConfig:
    # reference constants: yeast_glycolysis.jl:15-40
    ns: int = 7
    ns_: int = 12
    nr: int = 12
    ntotal: int = 300
    batch_min: int = 32
    n_exp_train: int = 20
    n_exp_val: int = 10
    noise: float = 1e-3
    atol: float = 1e-5
    rtol: float = 1e-2
    lr0: float = 5e-3
    lr_decay: float = 0.5
    lr_decay_epochs: int = 100
    lr_floor: float = 1e-5
    weight_decay: float = 1e-6
    seed: int = 1234
    max_steps: int = 384
    solver: str = "trbdf2"
    mode: str = "batch"
    dtype: str = "float32"
    # hidden width of the observed->hidden MLP: 0 is the reference's
    # node = ns_ - ns = 5 (yeast_glycolysis.jl:128-133); > 0 widens the
    # three hidden layers only
    mlp_width: int = 0
    device: str = "cuda"
    # True runs the plain PyTorch RHS in place of the CUDA kernel: the
    # explicit switch for holding the kernel path against the plain path
    rhs_plain: bool = False

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_val

    @property
    def tstep(self) -> float:
        return 5.0 / self.ntotal

    @property
    def lb(self) -> float:
        return self.atol  # yeast_glycolysis.jl:36: lb = atol

    @property
    def ub(self) -> float:
        return 100.0


def build(cfg: YeastConfig = YeastConfig(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The yeast setup on ``cfg.device``. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    device = resolve_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)
    g_u0, g_noise, g_p, g_mlp = seed_generators(cfg.seed, 4)
    t1 = float(cfg.ntotal * cfg.tstep)
    if dataset is None:
        # u0 uniform in the published per-species box
        # (yeast_glycolysis.jl:69-74)
        lo = torch.tensor(YEAST_IC_LB, dtype=dtype)
        hi = torch.tensor(YEAST_IC_UB, dtype=dtype)
        u0 = lo + torch.rand((cfg.n_exp, cfg.ns), generator=g_u0,
                             dtype=dtype) * (hi - lo)
        saveat = torch.linspace(0.0, t1, cfg.ntotal, dtype=dtype,
                                device=device)
        dataset = generate_dataset_odesolve(
            g_noise, yeast_truth, TRBDF2(), u0.to(device),
            torch.tensor(YEAST_K, dtype=dtype, device=device), 0.0, t1,
            saveat, rtol=1e-6, atol=1e-8, noise=cfg.noise, scale_lb=cfg.lb,
            scale_mode="std")

    # the hybrid MLP: observed (7,) -> hidden (5,)
    # (yeast_glycolysis.jl:128-136)
    node = cfg.ns_ - cfg.ns
    width = cfg.mlp_width or node
    mlp_params, mlp_apply = make_mlp(
        g_mlp, [cfg.ns, width, width, width, node],
        ["gelu", "gelu", "gelu", "softplus"], dtype, device)
    init_params, unravel = ravel_pytree({
        "crnn": init_params_yeast(g_p, cfg.ns, cfg.ns_, cfg.nr, dtype=dtype,
                                  device=device),
        "mlp": mlp_params})

    rhs = make_crnn_yeast_rhs(cfg.lb, cfg.ub, cfg.ns, mlp_apply,
                              plain=cfg.rhs_plain)
    # TRBDF2 takes jacfwd of the RHS in JAX: here forward mode of the
    # plain twin (every f stays on the kernel)
    solver = give_jac(get_solver(cfg.solver), jac_by_forward_mode(
        make_crnn_yeast_rhs(cfg.lb, cfg.ub, cfg.ns, mlp_apply, plain=True)))

    def weights_fn(p):
        return p2vec_yeast(unravel(p)["crnn"], cfg.ns, cfg.ns_, cfg.nr)

    def predict_from_u0(p, u0_b, unroll):
        tree = unravel(p)
        w = p2vec_yeast(tree["crnn"], cfg.ns, cfg.ns_, cfg.nr)
        sol = odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                       args=(w, tree["mlp"]), rtol=cfg.rtol, atol=cfg.atol,
                       max_steps=cfg.max_steps, unroll=unroll)
        return clip(sol.ys, cfg.lb, cfg.ub)

    loss_fn = make_trajectory_loss("mae", yscale=dataset.yscale)

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
        return loss_fn(predict_from_u0(p, u0_b, unroll),
                       clip(ys_b, cfg.lb, cfg.ub), masks)

    def make_loss_i_exp(unroll):
        def loss_i_exp(p, idxs, masks):
            return loss_on_data(p, dataset.u0[idxs], dataset.ys[idxs], masks,
                                unroll)
        return loss_i_exp

    def predict(p, i_exp):
        return predict_from_u0(p, dataset.u0[i_exp:i_exp + 1], "while")[0]

    updates_per_epoch = cfg.n_exp_train if cfg.mode == "sequential" else 1
    trainer = Trainer(
        loss_i_exp=make_loss_i_exp("scan"),
        loss_i_exp_eval=make_loss_i_exp("while"),
        optimizer=expdecay_adamw(
            cfg.lr0, cfg.lr_decay, cfg.lr_decay_epochs * updates_per_epoch,
            cfg.lr_floor, weight_decay=cfg.weight_decay),
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.ntotal,
        mode=cfg.mode,
        horizon_range=(cfg.batch_min, cfg.ntotal),
    )
    return CaseSetup(name="yeast", trainer=trainer, init_params=init_params,
                     predict=predict, weights_fn=weights_fn, dataset=dataset,
                     loss_on_data=loss_on_data,
                     extras={"mlp_apply": mlp_apply}, unravel=unravel,
                     recipe=(build, cfg, {"dataset": dataset}))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="batch", choices=("batch", "sequential"))
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/yeast/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--lr0", type=float, default=None)
    ap.add_argument("--lr-decay-epochs", type=int, default=None)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="adaptive-solver step budget per solve (the learned "
                         "RHS can be stiffer than the truth mid-training)")
    ap.add_argument("--mlp-width", type=int, default=0,
                    help="hidden width of the 7->5 MLP (0 = reference 5)")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = YeastConfig(device=args.device, mode=args.mode,
                      mlp_width=args.mlp_width)
    if args.lr0 is not None:
        cfg.lr0 = args.lr0
    if args.lr_decay_epochs is not None:
        cfg.lr_decay_epochs = args.lr_decay_epochs
    if args.max_steps is not None:
        cfg.max_steps = args.max_steps
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart, dp=args.dp)


if __name__ == "__main__":
    main()
