"""case2: Arrhenius temperature-dependent CRNN (biodiesel, 6 species + T)
(port of crnn_tpu/cases/case2.py).

30 experiments at random temperatures in [323, 343] K; the CRNN learns logA,
Ea and the reaction orders through the features [log X; -1/(R*T)]. Two
solve paths, as in the JAX package:

- ``batch_major=True`` (the default): the batch-major Rosenbrock23
  (``ode/batch_solve.py``) with either W-solve, ``jac_mode='lowrank'``
  (rank-nr Woodbury) or ``'dense'`` (full W Gauss-Jordan). On a CUDA device
  each stage evaluates the RHS through the Arrhenius RHS kernel
  (``ops/csrc/arrhenius_rhs.cu``), and in dense mode each step's value and
  Jacobian through ``ops/csrc/arrhenius_rhs_jac.cu``.
- ``batch_major=False``, and the per-experiment loss of sequential mode:
  the per-lane driver (``ode/solve.py:odesolve``) with ``solver``, any
  name of ``ode/__init__.py:SOLVER_REGISTRY``: Rosenbrock23 with the
  closed-form J, ``auto_tsit5_rosenbrock23`` (AutoSwitch to that
  Rosenbrock23), Tsit5, TRBDF2, Kvaerno3 or ``auto_tsit5_trbdf2``. On a
  CUDA device every f is one launch of the Arrhenius RHS kernel and every
  closed-form J one launch of the value+Jacobian kernel. A solver without a
  closed-form J (the ESDIRKs) takes J by forward mode of the plain twin of
  the RHS, the function JAX's ``jacfwd`` differentiates, since the kernel
  ops have no forward-mode rule; its f evaluations stay on the kernel.

Modes: ``mode='batch'`` (one update per epoch) or ``'sequential'`` (one
update per experiment, the lr-decay steps scaled by the updates per
epoch). ``grad_mode`` defaults to forward mode under sequential (jacfwd
through the early-exit driver, the reference's ForwardDiff.gradient) and
to reverse mode under batch. The loss that forward mode differentiates
runs the plain versions of the ops, exactly where the JAX package takes its
reference ops (crnn_tpu/cases/case2.py:170-178): the kernel ops, like JAX's
custom_vjp ops, have no forward-mode rule. Everything else, the evaluation
pass among it, runs the kernels. The data are generated on the chosen
device by the port's own solver.

    python -m crnn_tpu_torch.cases.case2 --epochs 3 [--device cpu]
        [--mode sequential] [--solver auto_tsit5_rosenbrock23] [--restart]
        [--epochs-per-dispatch N]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import (DP_HELP, CaseSetup, run_case,
                                      seed_generators)
from crnn_tpu_torch.data.generate import Dataset, generate_dataset
from crnn_tpu_torch.data.truth import (CASE2_EA, CASE2_LOGA, case2_arrhenius,
                                       case2_truth, case2_truth_jac)
from crnn_tpu_torch.models.crnn import make_crnn_arrhenius_rhs
from crnn_tpu_torch.models.jacobian import make_crnn_arrhenius_jac
from crnn_tpu_torch.ode import AutoSwitch, Rosenbrock23, Tsit5, get_solver
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ode.rosenbrock import give_jac, jac_by_forward_mode
from crnn_tpu_torch.ode.solve import odesolve
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
    # the per-lane solver, a name of ode/__init__.py:SOLVER_REGISTRY
    # ('rosenbrock23' and 'auto_tsit5_rosenbrock23' with the closed-form
    # J); the batch-major path is Rosenbrock23 whatever this says, as in JAX
    solver: str = "rosenbrock23"
    mode: str = "batch"
    dtype: str = "float32"
    missing_u0: bool = False                # case2_missing u0 tweaks
    batch_major: bool = True
    # 'lowrank': rank-nr Woodbury W-solve; 'dense': full W Gauss-Jordan on
    # the fused value+Jacobian op
    jac_mode: str = "lowrank"
    # None: 'fwd' for sequential, 'rev' for batch
    grad_mode: Optional[str] = None
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
    grad_mode = cfg.grad_mode or (
        "fwd" if cfg.mode == "sequential" else "rev")

    def weights_fn(p):
        if cfg.p_cutoff > 0:
            p = prune_case2_params(p, cfg.ns, cfg.nr, cfg.p_cutoff)
        return p2vec_case2(p, cfg.ns, cfg.nr)

    loss_fn = make_trajectory_loss(yscale=dataset.yscale, i_obs=cfg.i_obs)

    # -- the per-lane path (crnn_tpu/cases/case2.py:126-162)
    def make_predict_lanes(plain):
        rhs = make_crnn_arrhenius_rhs(cfg.lb, cfg.ub, plain=plain)
        jac = make_crnn_arrhenius_jac(cfg.lb, cfg.ub, plain=plain)
        if cfg.solver == "rosenbrock23":
            solver = Rosenbrock23(jac=jac)
        elif cfg.solver == "auto_tsit5_rosenbrock23":
            solver = AutoSwitch(Tsit5(), Rosenbrock23(jac=jac))
        else:
            # a solver without a closed-form J takes jacfwd of the RHS in
            # JAX: here forward mode of the plain twin
            solver = give_jac(get_solver(cfg.solver), jac_by_forward_mode(
                make_crnn_arrhenius_rhs(cfg.lb, cfg.ub, plain=True)))

        def predict_from_u0(p, u0_b, unroll):
            sol = odesolve(rhs, solver, u0_b, 0.0, t1, dataset.ts,
                           args=weights_fn(p), rtol=cfg.rtol, atol=cfg.atol,
                           max_steps=cfg.max_steps, unroll=unroll)
            return clip(sol.ys[:, :, :cfg.ns], -cfg.ub, cfg.ub)
        return predict_from_u0

    # -- the batch-major path (crnn_tpu/cases/case2.py:164-205)
    def make_predict_batch(plain):
        rhs_op, rhs_jac_op = make_arrhenius_ops(cfg.lb, cfg.ub, plain=plain)
        if cfg.jac_mode == "lowrank":
            factor_op = make_arrhenius_factor_op(cfg.lb, cfg.ub)
            fjac = lambda t, y, w_: factor_op(y, w_.w_in, w_.w_b, w_.w_out)
        else:
            fjac = lambda t, y, w_: rhs_jac_op(y, w_.w_in, w_.w_b, w_.w_out)

        def predict_batch(p, u0_b, unroll):
            sol = batch_odesolve_rb23(
                lambda t, y, w_: rhs_op(y, w_.w_in, w_.w_b, w_.w_out), fjac,
                u0_b, 0.0, t1, dataset.ts, args=weights_fn(p),
                rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
                unroll=unroll, jac_mode=cfg.jac_mode)
            return clip(sol.ys[:, :, :cfg.ns], -cfg.ub, cfg.ub)
        return predict_batch

    def make_loss(predict, unroll):
        def loss(p, idxs, masks):
            return loss_fn(predict(p, dataset.u0[idxs], unroll),
                           dataset.ys[idxs], masks)
        return loss

    predict_from_u0 = make_predict_lanes(cfg.rhs_plain)

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
        return loss_fn(predict_from_u0(p, u0_b, unroll), ys_b, masks)

    def predict(p, i_exp):
        return predict_from_u0(p, dataset.u0[i_exp:i_exp + 1], "while")[0]

    loss_batch = loss_batch_eval = None
    if cfg.batch_major:
        predict_batch = make_predict_batch(cfg.rhs_plain)
        loss_batch = make_loss(predict_batch, "scan")
        loss_batch_eval = make_loss(predict_batch, "while")

    loss_fwd = None
    if grad_mode == "fwd":
        # jacfwd differentiates the plain versions: the kernel ops'
        # autograd.Function has no forward-mode rule, as JAX's custom_vjp
        # ops have none, and JAX takes its reference ops here
        # (crnn_tpu/cases/case2.py:170-178). Only this loss takes them: the
        # evaluation pass runs the kernels.
        make_predict = (make_predict_batch
                        if cfg.batch_major and cfg.mode == "batch"
                        else make_predict_lanes)
        loss_fwd = make_loss(make_predict(True), "while")

    updates_per_epoch = cfg.n_exp_train if cfg.mode == "sequential" else 1
    trainer = Trainer(
        loss_i_exp=make_loss(predict_from_u0, "scan"),
        loss_i_exp_eval=make_loss(predict_from_u0, "while"),
        loss_batch=loss_batch,
        loss_batch_eval=loss_batch_eval,
        loss_fwd=loss_fwd,
        mode=cfg.mode,
        grad_mode=grad_mode,
        optimizer=expdecay_adamw(
            cfg.lr0, cfg.lr_decay, cfg.lr_decay_epochs * updates_per_epoch,
            cfg.lr_floor, weight_decay=cfg.weight_decay,
            grad_max=cfg.grad_max or None),
        n_exp_train=cfg.n_exp_train,
        n_exp=cfg.n_exp,
        n_save=cfg.datasize,
    )
    return CaseSetup(
        name="case2",
        trainer=trainer,
        init_params=init_params,
        predict=predict,
        weights_fn=weights_fn,
        dataset=dataset,
        species=["TG", "ROH", "DG", "MG", "GL", "R'CO2R"],
        loss_on_data=loss_on_data,
        recipe=(build, cfg, {"dataset": dataset}))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="batch", choices=("batch", "sequential"))
    ap.add_argument("--solver", default="rosenbrock23")
    ap.add_argument("--missing", action="store_true",
                    help="case2_missing variant")
    ap.add_argument("--p-cutoff", type=float, default=0.0,
                    help="case2_pruning variant")
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/case2/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--epochs-per-dispatch", type=int, default=1,
                    help="run the epochs in chunks of N")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = Case2Config(device=args.device, mode=args.mode, solver=args.solver,
                      p_cutoff=args.p_cutoff)
    if args.missing:
        cfg.i_obs = (0, 1, 3, 4, 5)
        cfg.missing_u0 = True
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart,
                    epochs_per_dispatch=args.epochs_per_dispatch,
                    dp=args.dp)


if __name__ == "__main__":
    main()
