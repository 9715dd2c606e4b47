"""Robertson QSSA hybrid: the fast radical is an MLP, not a solved state
(port of crnn_tpu/cases/robertson_qssa.py).

Inside the RHS the quasi-steady-state species y2 is predicted by an
MLP(y1, y3) (2 -> 4 -> 4 -> 4 -> 1, gelu with an exp output), so the solver
integrates only the slow manifold; after the solve, the y2 trajectory is
re-predicted from the solved (y1, y3) (rober_crnn_qssa.jl:132-147). 30
experiments (20 train / 10 validation), 40 log-spaced save times over
[0, 1e5], f64, the per-lane Rosenbrock23, an unscaled MAE on species
(0, 2) and Adam with coupled weight decay. The params are JAX's ``{"crnn",
"mlp"}`` tree raveled into one flat tensor (``transforms/ravel.py``).

On a CUDA device every RHS call runs the MLP in plain torch and the CRNN
core on ``u_full (B, 3)`` through the isothermal kernel
(``ops/csrc/crnn_rhs.cu``). Rosenbrock23's J is forward mode of the plain
twin of the RHS, the function JAX's ``jacfwd`` differentiates, as the
kernel ops have no forward-mode rule. The truth is generated in f64 on the
chosen device.

    python -m crnn_tpu_torch.cases.robertson_qssa --epochs 2 [--device cpu]
        [--mode sequential] [--restart] [--lr LR]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from crnn_tpu_torch import absolute, clip, resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import Dataset, generate_dataset_odesolve
from crnn_tpu_torch.data.truth import ROBERTSON_K, robertson_truth
from crnn_tpu_torch.models.crnn import make_crnn_qssa_rhs
from crnn_tpu_torch.models.mlp import make_mlp
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23, jac_by_forward_mode
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import adamw_like
from crnn_tpu_torch.transforms.p2vec import CRNNWeights
from crnn_tpu_torch.transforms.ravel import ravel_pytree

# per-species absolute tolerances of the truth solve
TRUTH_ATOL = (1e-10, 1e-12, 1e-10)


@dataclass
class QSSAConfig:
    # reference constants: rober_crnn_qssa.jl:17-35
    ns: int = 3
    nr: int = 3
    datasize: int = 40
    n_exp_train: int = 20
    n_exp_val: int = 10
    noise: float = 1e-4
    lr: float = 5e-3
    weight_decay: float = 1e-6
    atol: float = 1e-5
    rtol: float = 1e-3
    lb: float = 1e-5
    ub: float = 10.0
    seed: int = 1234
    max_steps: int = 256
    mode: str = "batch"
    device: str = "cuda"
    # True runs the plain PyTorch RHS in place of the CUDA kernel: the
    # explicit switch for holding the kernel path against the plain path
    rhs_plain: bool = False

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_val


def p2vec_qssa(p: torch.Tensor, ns: int, nr: int) -> CRNNWeights:
    """Bias scaled by 10|slope|, product-tied w_out = -w_in * |w_out_raw|
    from the unclipped w_in, then w_in clipped to [0, 2.5]
    (rober_crnn_qssa.jl:81-93)."""
    slope = absolute(p[-1]) * 10.0
    w_b = p[:nr] * slope
    w_in = p[nr * (ns + 1):nr * (2 * ns + 1)].reshape(ns, nr)
    w_out = -w_in * absolute(p[nr:nr * (ns + 1)].reshape(ns, nr))
    return CRNNWeights(w_in=clip(w_in, 0.0, 2.5), w_b=w_b, w_out=w_out)


def build(cfg: QSSAConfig = QSSAConfig(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The QSSA setup on ``cfg.device``, in f64. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    device = resolve_device(cfg.device)
    f64 = torch.float64
    g_u0, g_noise, g_p, g_mlp = seed_generators(cfg.seed, 4)
    if dataset is None:
        # u0 ~ U(0, 1) + 0.5, the radical starting at lb
        # (rober_crnn_qssa.jl:38-39)
        u0 = torch.rand((cfg.n_exp, cfg.ns), generator=g_u0, dtype=f64) + 0.5
        u0[:, 1] = cfg.lb
        saveat = 10.0 ** torch.linspace(-2.0, 5.0, cfg.datasize, dtype=f64,
                                        device=device)
        dataset = generate_dataset_odesolve(
            g_noise, robertson_truth, Rosenbrock23(), u0.to(device),
            torch.tensor(ROBERTSON_K, dtype=f64, device=device), 0.0,
            float(saveat[-1]), saveat, rtol=1e-8,
            atol=torch.tensor(TRUTH_ATOL, dtype=f64, device=device),
            noise=cfg.noise, scale_mode="none")
    t1 = float(dataset.ts[-1])

    mlp_params, mlp_apply = make_mlp(g_mlp, [2, 4, 4, 4, 1],
                                     ["gelu", "gelu", "gelu", "exp"], f64,
                                     device)
    lim = (6.0 / (cfg.ns + cfg.nr)) ** 0.5
    pcrnn = (torch.rand(cfg.nr * (2 * cfg.ns + 1) + 1, generator=g_p,
                        dtype=f64) * 2.0 - 1.0) * lim
    pcrnn[-1] = 0.1
    init_params, unravel = ravel_pytree({"crnn": pcrnn.to(device),
                                         "mlp": mlp_params})

    rhs = make_crnn_qssa_rhs(cfg.lb, cfg.ub, mlp_apply, plain=cfg.rhs_plain)
    # J by forward mode of the plain twin (the kernel ops have no
    # forward-mode rule); every f stays on the kernel
    solver = Rosenbrock23(jac=jac_by_forward_mode(
        make_crnn_qssa_rhs(cfg.lb, cfg.ub, mlp_apply, plain=True)))

    def weights_fn(p):
        return p2vec_qssa(unravel(p)["crnn"], cfg.ns, cfg.nr)

    def predict_from_u0(p, u0_b, unroll):
        tree = unravel(p)
        w = p2vec_qssa(tree["crnn"], cfg.ns, cfg.nr)
        ys = odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                      args=(w, tree["mlp"]), rtol=cfg.rtol, atol=cfg.atol,
                      max_steps=cfg.max_steps, unroll=unroll).ys
        # post-solve: re-predict the QSS radical from the solved (y1, y3)
        y2 = mlp_apply(tree["mlp"], ys[..., 0::2].reshape(-1, 2))
        return torch.cat([ys[..., 0:1], y2.reshape(*ys.shape[:2], 1),
                          ys[..., 2:3]], dim=-1)

    # unscaled MAE on the observed species (0, 2) (rober_crnn_qssa.jl:152-157)
    loss_fn = make_trajectory_loss("mae", i_obs=(0, 2))

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
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
        optimizer=adamw_like(cfg.lr, weight_decay=cfg.weight_decay),
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
        mode=cfg.mode,
    )
    return CaseSetup(name="robertson_qssa", trainer=trainer,
                     init_params=init_params, predict=predict,
                     weights_fn=weights_fn, dataset=dataset, logx_plots=True,
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
                    help="resume from <out>/robertson_qssa/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = QSSAConfig(device=args.device, mode=args.mode)
    if args.lr is not None:
        cfg.lr = args.lr
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart, dp=args.dp)


if __name__ == "__main__":
    main()
