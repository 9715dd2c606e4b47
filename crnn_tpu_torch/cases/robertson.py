"""Robertson: strongly stiff CRNN over t in [0, 1e5] in float64 (port of
crnn_tpu/cases/robertson.py).

25 experiments (20 train / 5 validation) with Latin-hypercube initial
conditions, 40 log-spaced save times, Rosenbrock23 with the closed-form
CRNN Jacobian on the per-lane ``odesolve``, per-species atol,
product-tied 10^w_out p2vec, dy/dt rescaling, global-norm clipping at 10
and stochastic prefix horizons (sample = rand(32:40)); ``mode='batch'`` or
``'sequential'`` (one update per experiment). On a CUDA device
every RHS call goes through the isothermal kernel
(``ops/csrc/crnn_rhs.cu``) and every step's Jacobian through the
value+Jacobian kernel (``ops/csrc/crnn_rhs_jac.cu``). The truth is always
generated in float64 on the chosen device, with a forward-mode Jacobian.

``grad_path='adjoint'`` takes the training gradient by the continuous
backsolve adjoint (``ode/adjoint.py``, the reference's BacksolveAdjoint):
its forward solve runs the kernels, and its backward differentiates the
plain twin of the RHS. ``w_out_mask`` keeps a 0/1 subset of the w_out
entries after p2vec. ``run_lm_finish`` (``--lm-finish``) polishes the
params with Levenberg-Marquardt on the per-experiment losses; its
forward-mode Jacobian runs the plain ops on the early-exit driver, which
takes the accepted steps of the scan driver that JAX differentiates there.

    python -m crnn_tpu_torch.cases.robertson --epochs 2 [--device cpu]
        [--mode sequential] [--restart] [--lm-finish]
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

from crnn_tpu_torch import resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import (Dataset, generate_dataset_odesolve,
                                          latin_hypercube)
from crnn_tpu_torch.data.truth import ROBERTSON_K, robertson_truth
from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs
from crnn_tpu_torch.models.jacobian import make_crnn_scaled_jac
from crnn_tpu_torch.ode.adjoint import odesolve_adjoint
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.train.lm import levenberg_marquardt
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import adamw_like
from crnn_tpu_torch.transforms.p2vec import (init_params_robertson,
                                             p2vec_robertson)

# per-species absolute tolerances of the truth solve
TRUTH_ATOL = (1e-10, 1e-12, 1e-10)


@dataclass
class RobertsonConfig:
    # reference constants: rober_crnn.jl:16-41
    ns: int = 3
    nr: int = 6
    datasize: int = 40
    batchsize: int = 32
    n_exp_train: int = 20
    n_exp_val: int = 5
    noise: float = 1e-4
    lr: float = 5e-3
    weight_decay: float = 1e-6
    grad_max: float = 10.0
    rtol: float = 1e-3
    lb: float = 1e-8
    # the RHS and Jacobian clip y to [lb, ub]: no upper bound by default, as
    # rober_crnn.jl and the JAX package, which ignores its field (10.0)
    ub: float = math.inf
    seed: int = 1234
    max_steps: int = 192
    mode: str = "batch"
    # gradient path: 'rev_scan' (reverse mode through the checkpointed scan)
    # or 'adjoint' (the continuous backsolve adjoint, ode/adjoint.py:
    # O(n_save) memory instead of O(max_steps))
    grad_path: str = "rev_scan"
    # 0/1 keep-mask over the w_out entries, (ns, nr) as a nested tuple, the
    # hard-threshold pruning hook; None keeps every entry
    w_out_mask: Optional[tuple] = None
    # training dtype; the truth is always generated in float64 and cast
    dtype: str = "float64"
    device: str = "cuda"
    # True runs the plain PyTorch RHS and Jacobian in place of the CUDA
    # kernels: the explicit switch for holding the kernel path against the
    # plain path
    rhs_plain: bool = False

    @property
    def n_exp(self) -> int:
        return self.n_exp_train + self.n_exp_val

    @property
    def atol(self) -> torch.Tensor:
        # per-species absolute tolerance of training (rober_crnn.jl:34)
        return torch.tensor([1e-6, 1e-8, 1e-6], dtype=torch.float64)


def build(cfg: RobertsonConfig = RobertsonConfig(),
          dataset: Optional[Dataset] = None) -> CaseSetup:
    """The robertson setup on ``cfg.device``. ``dataset`` (e.g. from
    ``convert.dataset_from_jax``) replaces the generated one."""
    if cfg.grad_path not in ("rev_scan", "adjoint"):
        raise ValueError(f"unknown grad_path: {cfg.grad_path!r}")
    device = resolve_device(cfg.device)
    train_dtype = getattr(torch, cfg.dtype)
    f64 = torch.float64
    g_u0, g_lhc, g_noise, g_p = seed_generators(cfg.seed, 4)
    if dataset is None:
        # rober_crnn.jl:43-47: u0 ~ U(0,1)*2+0.5, then y2 = lb and (y1, y3)
        # from a Latin hypercube / n + 0.5
        u0 = torch.rand((cfg.n_exp, cfg.ns), generator=g_u0, dtype=f64) \
            * 2.0 + 0.5
        u0[:, 1] = cfg.lb
        lhc = latin_hypercube(g_lhc, cfg.n_exp, 2, f64) + 0.5
        u0[:, 0], u0[:, 2] = lhc[:, 0], lhc[:, 1]
        saveat = 10.0 ** torch.linspace(0.0, 5.0, cfg.datasize, dtype=f64,
                                        device=device)
        dataset = generate_dataset_odesolve(
            g_noise, robertson_truth, Rosenbrock23(), u0.to(device),
            torch.tensor(ROBERTSON_K, dtype=f64, device=device), 0.0,
            float(saveat[-1]), saveat, rtol=1e-8,
            atol=torch.tensor(TRUTH_ATOL, dtype=f64, device=device),
            noise=cfg.noise, scale_lb=0.0)
        if train_dtype != f64:
            dataset = dataset._replace(**{
                f: getattr(dataset, f).to(train_dtype)
                for f in ("u0", "ys", "ys_clean", "ts", "yscale")})
    t1 = float(dataset.ts[-1])
    dydt_scale = dataset.yscale / t1
    atol = cfg.atol.to(device, train_dtype)

    def rhs_and_solver(plain):
        return (make_crnn_scaled_rhs(cfg.lb, cfg.ub, dydt_scale, plain=plain),
                Rosenbrock23(jac=make_crnn_scaled_jac(cfg.lb, cfg.ub,
                                                      dydt_scale,
                                                      plain=plain)))

    rhs, solver = rhs_and_solver(cfg.rhs_plain)
    # the plain twins: what forward mode differentiates (the adjoint's
    # backward, the LM Jacobian), as the kernel ops have no forward-mode rule
    rhs_fwd, solver_fwd = rhs_and_solver(True)

    if cfg.w_out_mask is not None:
        keep = torch.tensor(cfg.w_out_mask, dtype=train_dtype, device=device)

        def weights_fn(p):
            w = p2vec_robertson(p, cfg.ns, cfg.nr)
            return w._replace(w_out=w.w_out * keep)
    else:
        def weights_fn(p):
            return p2vec_robertson(p, cfg.ns, cfg.nr)

    loss_fn = make_trajectory_loss(yscale=dataset.yscale)

    def predict_from_u0(p, u0_b, unroll, rhs=rhs, solver=solver):
        w = weights_fn(p)
        if cfg.grad_path == "adjoint" and unroll == "scan":
            # the training gradient by the continuous backsolve adjoint
            return odesolve_adjoint(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                                    args=w, rtol=cfg.rtol, atol=atol,
                                    max_steps=cfg.max_steps, f_plain=rhs_fwd)
        return odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts, args=w,
                        rtol=cfg.rtol, atol=atol, max_steps=cfg.max_steps,
                        unroll=unroll).ys

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
        return loss_fn(predict_from_u0(p, u0_b, unroll), ys_b, masks)

    def make_loss_i_exp(unroll):
        def loss_i_exp(p, idxs, masks):
            return loss_on_data(p, dataset.u0[idxs], dataset.ys[idxs], masks,
                                unroll)
        return loss_i_exp

    def predict(p, i_exp):
        return predict_from_u0(p, dataset.u0[i_exp:i_exp + 1], "while")[0]

    def loss_lm(p, idxs, masks):
        """The per-experiment losses that LM's forward-mode Jacobian
        differentiates: the plain ops on the early-exit driver."""
        return loss_fn(predict_from_u0(p, dataset.u0[idxs], "while",
                                       rhs_fwd, solver_fwd),
                       dataset.ys[idxs], masks)

    trainer = Trainer(
        loss_i_exp=make_loss_i_exp("scan"),
        loss_i_exp_eval=make_loss_i_exp("while"),
        optimizer=adamw_like(cfg.lr, weight_decay=cfg.weight_decay,
                             grad_max=cfg.grad_max),
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
        mode=cfg.mode,
        horizon_range=(cfg.batchsize, cfg.datasize),
    )
    return CaseSetup(
        name="robertson", trainer=trainer,
        init_params=init_params_robertson(g_p, cfg.ns, cfg.nr,
                                          dtype=train_dtype, device=device),
        predict=predict, weights_fn=weights_fn, dataset=dataset,
        dydt_scale=dydt_scale, logx_plots=True, loss_on_data=loss_on_data,
        extras={"loss_lm": loss_lm, "config": cfg},
        recipe=(build, cfg, {"dataset": dataset}))


def run_lm_finish(setup: CaseSetup, params, max_iters: int = 200):
    """LM polish on the per-experiment loss residuals of the training
    experiments (rober_crnn_lm.jl:211-253). Returns ``(p_opt, info)``."""
    cfg = setup.extras["config"]
    loss_lm = setup.extras["loss_lm"]
    device = params.device
    idxs = torch.arange(cfg.n_exp_train, device=device)
    masks = torch.ones((cfg.n_exp_train, cfg.datasize), dtype=torch.float64,
                       device=device)
    return levenberg_marquardt(lambda p: loss_lm(p, idxs, masks), params,
                               max_iters=max_iters, verbose=True)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=500)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="batch", choices=("batch", "sequential"))
    ap.add_argument("--lm-finish", action="store_true",
                    help="polish the trained params with Levenberg-Marquardt")
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/robertson/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    setup = build(RobertsonConfig(device=args.device, mode=args.mode))
    state, hist = run_case(setup, n_epoch=args.epochs, out_dir=args.out,
                           restart=args.restart, dp=args.dp)
    if args.lm_finish:
        _, info = run_lm_finish(setup, state.params)
        print("LM finish:", info["cost"], "converged:", info["converged"])
    return state, hist


if __name__ == "__main__":
    main()
