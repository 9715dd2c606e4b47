"""case1 rev: reversible-reaction CRNN (A<->B<->C<->D, 2C<->D+E) (port of
crnn_tpu/cases/case1_rev.py).

The truth is a reversible mass-action network with every rate constant 1;
the CRNN proposes nr=10 reversible reactions whose forward and backward
orders both derive from a shared w_out under the equilibrium-constant-1
assumption w_kb = w_kf (case1 rev/case1.jl:72-90). 30 experiments (20
train / 10 test), u0 ~ U(0, 1) with the first two species +0.2, 0.1% noise,
Tsit5, the scaled MAE and Adam with coupled weight decay 1e-8. Gradients
are forward mode (``torch.func.jacfwd``) through the early-exit while
driver, as the JAX case takes them (the reference's ForwardDiff path,
case1 rev/case1.jl:197). The reversible RHS has no kernel in either
package: it is plain torch on every device. ``reaction_mask`` (0/1 over
the nr reactions) zeroes w_out columns, making those reactions inert.

    python -m crnn_tpu_torch.cases.case1_rev --epochs 2 [--device cpu]
        [--mode sequential] [--restart]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from crnn_tpu_torch import resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import Dataset, generate_dataset_odesolve
from crnn_tpu_torch.data.truth import REVERSIBLE_K, reversible_truth
from crnn_tpu_torch.models.crnn import make_crnn_reversible_rhs
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import adamw_like
from crnn_tpu_torch.transforms.p2vec import (init_params_reversible,
                                             p2vec_reversible)


@dataclass
class Case1RevConfig:
    # reference constants: case1 rev/case1.jl:14-35
    ns: int = 5
    nr: int = 10
    datasize: int = 100
    tstep: float = 0.1
    n_exp_train: int = 20
    n_exp_test: int = 10
    noise: float = 1e-3
    lr: float = 1e-3
    weight_decay: float = 1e-8
    atol: float = 1e-5
    rtol: float = 1e-2
    lb: float = 1e-5
    grad_max: float = 0.0          # 0 = no clipping
    seed: int = 1234
    max_steps: int = 512
    mode: str = "batch"
    dtype: str = "float32"
    device: str = "cuda"
    reaction_mask: Optional[tuple] = None

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_test


def build(cfg: Case1RevConfig = Case1RevConfig(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The case1 rev setup on ``cfg.device``. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    device = resolve_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)
    g_u0, g_noise, g_p = seed_generators(cfg.seed, 3)
    t1 = cfg.datasize * cfg.tstep
    if dataset is None:
        # u0 ~ U(0, 1), first two species +0.2, the others not zeroed (:47-49)
        u0 = torch.rand((cfg.n_exp, cfg.ns), generator=g_u0, dtype=dtype)
        u0[:, :2] += 0.2
        saveat = torch.linspace(0.0, t1, cfg.datasize, dtype=dtype,
                                device=device)
        dataset = generate_dataset_odesolve(
            g_noise, reversible_truth, Tsit5(), u0.to(device),
            torch.tensor(REVERSIBLE_K, dtype=dtype, device=device), 0.0, t1,
            saveat, rtol=1e-6, atol=1e-8, noise=cfg.noise, scale_lb=cfg.lb)
    init_params = init_params_reversible(g_p, cfg.ns, cfg.nr, dtype=dtype,
                                         device=device)
    rmask = (None if cfg.reaction_mask is None else
             torch.tensor(cfg.reaction_mask, dtype=dtype, device=device))

    def weights_fn(p):
        w = p2vec_reversible(p, cfg.ns, cfg.nr)
        if rmask is not None:
            w = w._replace(w_out=w.w_out * rmask[None, :])
        return w

    rhs = make_crnn_reversible_rhs(cfg.lb)
    solver = Tsit5()
    loss_fn = make_trajectory_loss("mae", yscale=dataset.yscale)

    def predict_from_u0(p, u0_b, unroll):
        return odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                        args=weights_fn(p), rtol=cfg.rtol, atol=cfg.atol,
                        max_steps=cfg.max_steps, unroll=unroll).ys

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
        optimizer=adamw_like(cfg.lr, weight_decay=cfg.weight_decay,
                             grad_max=cfg.grad_max or None),
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
        mode=cfg.mode,
        # forward mode through the while driver: the reversible RHS develops
        # extreme reverse-mode sensitivities mid-training in the JAX package
        # (crnn_tpu/cases/case1_rev.py:121-129)
        grad_mode="fwd",
    )
    return CaseSetup(name="case1_rev", trainer=trainer,
                     init_params=init_params, predict=predict,
                     weights_fn=weights_fn, dataset=dataset,
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
                    help="resume from <out>/case1_rev/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = Case1RevConfig(device=args.device, mode=args.mode)
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart, dp=args.dp)


if __name__ == "__main__":
    main()
