"""case2: Arrhenius temperature-dependent CRNN (biodiesel, 6 species + T),
batch-major training epoch (port of crnn_tpu/cases/case2.py).

The path ported is the JAX package's batch-major one: f32, Rosenbrock23,
``batch_major=True``, reverse-mode gradients, one update per epoch, with
either W-solve: ``jac_mode='lowrank'`` (the default, rank-nr Woodbury) or
``jac_mode='dense'`` (full W Gauss-Jordan). On a CUDA device each
Rosenbrock stage evaluates the RHS through the CUDA kernel
(``ops/csrc/arrhenius_rhs.cu``), and in dense mode each step's value and
Jacobian through ``ops/csrc/arrhenius_rhs_jac.cu``. The data are generated
on the chosen device by the port's own solver.

    python -m crnn_tpu_torch.cases.case2 --epochs 3 [--device cpu]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import CaseSetup, run_case, seed_generators
from crnn_tpu_torch.data.generate import Dataset, generate_dataset
from crnn_tpu_torch.data.truth import (CASE2_EA, CASE2_LOGA, case2_arrhenius,
                                       case2_truth, case2_truth_jac)
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ops.crnn_kernels import (make_arrhenius_factor_op,
                                             make_arrhenius_ops)
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import expdecay_adamw
from crnn_tpu_torch.transforms.p2vec import init_params_case2, p2vec_case2
from crnn_tpu_torch.transforms.pruning import prune_case2_params


@dataclass
class Case2Config:
    # reference constants: case2/case2.jl:14-34
    ns: int = 6
    nr: int = 3
    datasize: int = 50
    tstep: float = 1.0
    n_exp_train: int = 20
    n_exp_test: int = 10
    noise: float = 0.05
    atol: float = 1e-6
    rtol: float = 1e-3
    lb: float = 1e-6
    ub: float = 10.0
    lr0: float = 5e-3
    lr_decay: float = 0.5
    lr_decay_epochs: int = 500
    lr_floor: float = 1e-4
    weight_decay: float = 1e-6
    grad_max: float = 100.0
    i_obs: Optional[Sequence[int]] = None   # case2_missing: (0,1,3,4,5)
    p_cutoff: float = 0.0                   # case2_pruning: 0.01
    seed: int = 1234
    max_steps: int = 128
    dtype: str = "float32"
    missing_u0: bool = False                # case2_missing u0 tweaks
    # 'lowrank': rank-nr Woodbury W-solve; 'dense': full W Gauss-Jordan on
    # the fused value+Jacobian op
    jac_mode: str = "lowrank"
    device: str = "cuda"
    # True runs the plain PyTorch versions in place of the CUDA kernels:
    # the explicit switch for holding the kernel path against the plain path
    rhs_plain: bool = False

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_test


def make_u0(gen: torch.Generator, cfg: Case2Config, dtype) -> torch.Tensor:
    """Initial states (case2/case2.jl:62-66): u0[:2] ~ U(0,1)*2+0.2, the
    middle species 0, T ~ U(0,1)*20+323 K."""
    u0 = torch.rand((cfg.n_exp, cfg.ns + 1), generator=gen, dtype=dtype)
    u0[:, :2] = u0[:, :2] * 2.0 + 0.2
    u0[:, 2:cfg.ns] = 0.0
    u0[:, cfg.ns] = u0[:, cfg.ns] * 20.0 + 323.0
    if cfg.missing_u0:
        # case2_missing.jl:70-72: some experiments begin mid-cascade
        u0[: cfg.n_exp // 3, 2] = 0.2
    return u0


def build(cfg: Case2Config = Case2Config(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The case2 setup on ``cfg.device``. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    if cfg.jac_mode not in ("lowrank", "dense"):
        raise ValueError(f"unknown jac_mode: {cfg.jac_mode!r}")
    device = resolve_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)
    # the params do not depend on the data
    g_u0, g_noise, g_p = seed_generators(cfg.seed, 3)
    t1 = float(cfg.datasize * cfg.tstep)
    if dataset is None:
        u0 = make_u0(g_u0, cfg, dtype).to(device)
        saveat = torch.linspace(0.0, t1, cfg.datasize, dtype=dtype,
                                device=device)
        k_per_exp = case2_arrhenius(
            torch.tensor(CASE2_LOGA, dtype=dtype, device=device),
            torch.tensor(CASE2_EA, dtype=dtype, device=device), u0[:, -1])
        dataset = generate_dataset(
            g_noise, case2_truth, case2_truth_jac, u0, k_per_exp, 0.0, t1,
            saveat, rtol=1e-6, atol=1e-9, noise=cfg.noise, obs_dim=cfg.ns,
            scale_lb=cfg.lb)
    init_params = init_params_case2(g_p, cfg.ns, cfg.nr, dtype=dtype,
                                    device=device)

    def weights_fn(p):
        if cfg.p_cutoff > 0:
            p = prune_case2_params(p, cfg.ns, cfg.nr, cfg.p_cutoff)
        return p2vec_case2(p, cfg.ns, cfg.nr)

    rhs_op, rhs_jac_op = make_arrhenius_ops(cfg.lb, cfg.ub,
                                            plain=cfg.rhs_plain)
    if cfg.jac_mode == "lowrank":
        factor_op = make_arrhenius_factor_op(cfg.lb, cfg.ub)
        fjac = lambda t, y, w_: factor_op(y, w_.w_in, w_.w_b, w_.w_out)
    else:
        fjac = lambda t, y, w_: rhs_jac_op(y, w_.w_in, w_.w_b, w_.w_out)
    loss_fn = make_trajectory_loss(yscale=dataset.yscale, i_obs=cfg.i_obs)

    def predict_batch(p, u0_b, unroll):
        w = weights_fn(p)
        sol = batch_odesolve_rb23(
            lambda t, y, w_: rhs_op(y, w_.w_in, w_.w_b, w_.w_out), fjac,
            u0_b, 0.0, t1, dataset.ts, args=w, rtol=cfg.rtol, atol=cfg.atol,
            max_steps=cfg.max_steps, unroll=unroll, jac_mode=cfg.jac_mode)
        return clip(sol.ys[:, :, :cfg.ns], -cfg.ub, cfg.ub)

    def make_loss_batch(unroll):
        def loss_batch(p, idxs, masks):
            preds = predict_batch(p, dataset.u0[idxs], unroll)
            return loss_fn(preds, dataset.ys[idxs], masks)
        return loss_batch

    trainer = Trainer(
        loss_batch=make_loss_batch("scan"),
        loss_batch_eval=make_loss_batch("while"),
        optimizer=expdecay_adamw(
            cfg.lr0, cfg.lr_decay, cfg.lr_decay_epochs, cfg.lr_floor,
            weight_decay=cfg.weight_decay, grad_max=cfg.grad_max or None),
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
    )
    return CaseSetup(
        name="case2",
        trainer=trainer,
        init_params=init_params,
        weights_fn=weights_fn,
        dataset=dataset,
    )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--missing", action="store_true",
                    help="case2_missing variant")
    ap.add_argument("--p-cutoff", type=float, default=0.0,
                    help="case2_pruning variant")
    ap.add_argument("--out", default="runs_torch")
    args = ap.parse_args(argv)
    cfg = Case2Config(device=args.device, p_cutoff=args.p_cutoff)
    if args.missing:
        cfg.i_obs = (0, 1, 3, 4, 5)
        cfg.missing_u0 = True
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out)


if __name__ == "__main__":
    main()
