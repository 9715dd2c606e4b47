"""HyChem: gas-phase JP-10 pyrolysis CRNN on mass fractions (port of
crnn_tpu/cases/hychem.py).

The CRNN works on species MASS fractions under T(t) and P(t) interpolated
from a constant-pressure reactor trajectory (crnn_pyrolysis_mass.jl):
inside the RHS the mass fractions become molar concentrations through the
ideal-gas density (Y2density/Y2C, :107-115), the rate features are
[log C; -1/(R T); log T], and the molar production rates go back through
the molecular weights (:121-131). The element-conservation nullspace of
the (C, H, N) composition matrix is computed, and its projection of w_out
is behind ``project_elements`` (present but disabled in the reference,
:60-65,86). One trajectory of 40 log-spaced save points, f64, the per-lane
Rosenbrock23 (J and df/dt by forward mode: the RHS depends on t through the
interpolants), stochastic prefix horizons of 32-40 save points, and Adam
with coupled weight decay behind a global-norm clip at 10.

The reference's Cantera data file is not part of its repo:
``load_trajectory`` reads the same table (rows = samples, columns = [t, T,
P, Y...]), and ``synthetic_pyrolysis`` (the default, ``data_path=None``)
makes a surrogate trajectory from a 4-step global JP-10 mechanism, the
JAX package's own numpy and scipy code. No Pallas kernel backs this RHS in
the JAX package: it is plain torch on every device.

    python -m crnn_tpu_torch.cases.hychem --epochs 2 [--device cpu]
        [--data FILE] [--project-elements] [--lr LR] [--grad-max G]
        [--restart]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.cases.base import DP_HELP, CaseSetup, run_case
from crnn_tpu_torch.data.generate import Dataset
from crnn_tpu_torch.data.interp import make_interpolant, resample_log_grid
from crnn_tpu_torch.ode import get_solver
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss
from crnn_tpu_torch.train.optimizers import adamw_like
from crnn_tpu_torch.transforms.p2vec import CRNNWeights

VARNAMES = ["C10H16", "H2", "CH4", "C2H2", "C2H4", "N2", "C4H81", "H", "CH3"]
MW = np.array([136.238, 2.016, 16.043, 26.038, 28.054, 28.014, 56.108,
               1.008, 15.035])  # kg/kmol (crnn_pyrolysis_mass.jl:55)
E_C = np.array([10, 0, 1, 2, 2, 0, 4, 0, 1])
E_H = np.array([16, 2, 4, 2, 4, 0, 8, 1, 3])
E_N = np.array([0, 0, 0, 0, 0, 2, 0, 0, 0])
R_KCAL = 1.98720425864083e-3


@dataclass
class HyChemConfig:
    # reference constants: crnn_pyrolysis_mass.jl:15-31
    nr: int = 10
    ntotal: int = 40
    batch_size: int = 32
    lr: float = 5e-3
    weight_decay: float = 1e-6
    grad_max: float = 10.0
    atol: float = 1e-8
    rtol: float = 1e-3
    seed: int = 1234
    max_steps: int = 256
    data_path: Optional[str] = None   # raw trajectory table; None: surrogate
    project_elements: bool = False    # element-conservation projection
    solver: str = "rosenbrock23"
    mode: str = "batch"
    device: str = "cuda"


def load_trajectory(path: str) -> np.ndarray:
    """Raw table: rows = samples, columns = [t, T, P, Y1..Yns]."""
    return np.loadtxt(path)


def synthetic_pyrolysis(t_end: float = 5e-3, n_raw: int = 50,
                        T0: float = 1300.0,
                        P0: float = 10.0 * 101325.0) -> np.ndarray:
    """Surrogate JP-10 pyrolysis trajectory from a 4-step global mechanism
    (C10H16 -> products with H/CH3 radicals) at constant pressure with a
    mild temperature rise, in the Cantera table's format."""
    from scipy.integrate import solve_ivp

    ns = len(VARNAMES)
    y0 = np.zeros(ns)
    y0[0] = 0.065   # C10H16 mass fraction (1% molar in N2)
    y0[5] = 1.0 - y0[0]

    k = np.array([8e3, 3e3, 1.5e3, 5e2])

    def rhs(t, y):
        c10, h2, ch4, c2h2, c2h4, n2, c4h8, h, ch3 = np.clip(y, 0, 1)
        r1 = k[0] * c10
        r2 = k[1] * c10 * (h + 0.01)
        r3 = k[2] * c4h8
        r4 = k[3] * ch3 * ch3
        dy = np.zeros(ns)
        dy[0] = -r1 - r2
        dy[6] = 0.8 * r1 + 0.5 * r2 - r3
        dy[4] = 0.15 * r1 + 0.3 * r2 + 0.6 * r3
        dy[3] = 0.15 * r3
        dy[2] = 0.3 * r2 + r4
        dy[8] = 0.05 * r1 + 0.1 * r3 - 2.0 * r4
        dy[7] = 0.05 * r1 - 0.05 * r2
        dy[1] = 0.1 * r2 + 0.25 * r3
        return dy

    t_eval = np.linspace(0.0, t_end, n_raw)
    sol = solve_ivp(rhs, (0, t_end), y0, t_eval=t_eval, method="LSODA",
                    rtol=1e-9, atol=1e-12)
    ys = np.clip(sol.y.T, 0.0, 1.0)
    ys = ys / ys.sum(axis=1, keepdims=True)  # renormalise mass fractions
    progress = 1.0 - ys[:, 0] / y0[0]
    temps = T0 + 150.0 * progress            # mild endothermic-ish rise
    press = np.full(n_raw, P0)
    return np.column_stack([sol.t, temps, press, ys])


def build(cfg: HyChemConfig = HyChemConfig()) -> CaseSetup:
    """The HyChem setup on ``cfg.device``, in f64."""
    from scipy.linalg import null_space

    device = resolve_device(cfg.device)
    f64 = torch.float64

    raw = (load_trajectory(cfg.data_path) if cfg.data_path
           else synthetic_pyrolysis())
    t_raw = raw[:, 0]
    ns = raw.shape[1] - 3
    t_end = float(t_raw[-1])

    # log-spaced resample (crnn_pyrolysis_mass.jl:42-51), interpolated by
    # numpy as the JAX package does
    ts = resample_log_grid(t_end, cfg.ntotal)
    t_np = ts.numpy()
    temps = np.interp(t_np, t_raw, raw[:, 1])
    press = np.interp(t_np, t_raw, raw[:, 2])
    ydata_np = np.stack([np.interp(t_np, t_raw, raw[:, 3 + i])
                         for i in range(ns)], axis=1)     # (ntotal, ns)

    def dev(a):
        return torch.as_tensor(a, dtype=f64).to(device)

    ts, ydata = dev(ts), dev(ydata_np)
    mw = dev(MW[:ns])
    lb = cfg.atol
    yscale = clip(ydata.amax(0) - ydata.amin(0), lb, float("inf"))
    dydt_scale = yscale / t_end
    itp_t = make_interpolant(ts, dev(temps))
    itp_p = make_interpolant(ts, dev(press))
    # element-conservation nullspace, computed even when the projection is
    # off, as the reference does (:60-65)
    e_mat = np.stack([E_C[:ns], E_H[:ns], E_N[:ns]], axis=1)  # (ns, 3)
    e_null = dev(null_space(e_mat.T).T)                     # (n_null, ns)

    def p2vec(p):
        """Slope-scaled [log C; Ea; b (log T)] features, product-tied
        w_out = -w_in * 10^w_out_raw (crnn_pyrolysis_mass.jl:78-90)."""
        nr = cfg.nr
        slope = p[-1] * 10.0
        w_b = p[:nr] * slope
        w_in_b = p[nr:2 * nr]
        w_in_ea = p[2 * nr:3 * nr] * slope
        w_out_raw = p[3 * nr:nr * (ns + 3)].reshape(ns, nr)
        w_in = p[nr * (ns + 3):nr * (2 * ns + 3)].reshape(ns, nr)
        w_out = -w_in * 10.0 ** w_out_raw
        if cfg.project_elements:
            # each reaction's stoichiometry onto the element-conserving
            # subspace: w_out <- N^T (N w_out)
            w_out = e_null.T @ (e_null @ w_out)
        w_in = torch.cat([clip(w_in, 0.0, 2.5), w_in_ea[None, :],
                          w_in_b[None, :]], dim=0)
        return CRNNWeights(w_in=w_in, w_b=w_b, w_out=w_out)

    def rhs(t, y, w):
        p_pa = itp_p(t)
        temp = itp_t(t)
        yc = clip(y, lb, 10.0)
        # ideal-gas density and molar concentrations (Y2density, Y2C)
        density = p_pa / (8.31446261815324e3 * temp * torch.sum(yc / mw,
                                                                 dim=-1))
        conc = density[:, None] * (yc / mw) * 1e3
        feats = torch.cat([torch.log(clip(conc, lb, 10.0)),
                           (-1.0 / R_KCAL / temp)[:, None],
                           torch.log(temp)[:, None]], dim=1)
        z = feats @ w.w_in + w.w_b
        wdot = torch.exp(torch.minimum(z, z.new_full((), 32.0))) @ w.w_out.T
        return wdot * mw / density[:, None] * dydt_scale

    solver = get_solver(cfg.solver)
    u0 = ydata[:1]
    loss_fn = make_trajectory_loss("mae", yscale=yscale)

    def predict_lanes(p, n, unroll):
        """The single trajectory's solve, as ``n`` identical lanes."""
        return odesolve(rhs, solver, u0.expand(n, -1), 0.0, t_end, ts,
                        args=p2vec(p), rtol=cfg.rtol, atol=cfg.atol,
                        max_steps=cfg.max_steps, unroll=unroll).ys

    def loss_on_data(p, u0_b, ys_b, masks, unroll="scan"):
        # a single trajectory from the data's first row: u0_b is unused, one
        # lane per row of ys_b
        return loss_fn(predict_lanes(p, ys_b.shape[0], unroll), ys_b, masks)

    dataset = Dataset(u0=torch.zeros((1, 1), dtype=f64, device=device),
                      ys=ydata[None], ys_clean=ydata[None], ts=ts,
                      yscale=yscale,
                      success=torch.ones(1, dtype=torch.bool, device=device))

    def make_loss_i_exp(unroll):
        def loss_i_exp(p, idxs, masks):
            # single trajectory (crnn_pyrolysis_mass.jl:196-212): every
            # index is experiment 0
            return loss_on_data(p, None, dataset.ys[idxs], masks, unroll)
        return loss_i_exp

    def predict(p, i_exp):
        return predict_lanes(p, 1, "while")[0]

    gen = torch.Generator().manual_seed(cfg.seed)
    init_p = 0.1 * torch.randn(cfg.nr * (2 * ns + 3) + 1, generator=gen,
                               dtype=f64)
    init_p[-1] = 0.1

    trainer = Trainer(
        loss_i_exp=make_loss_i_exp("scan"),
        loss_i_exp_eval=make_loss_i_exp("while"),
        optimizer=adamw_like(cfg.lr, weight_decay=cfg.weight_decay,
                             grad_max=cfg.grad_max),
        n_exp_train=1,
        n_exp=1,
        n_save=cfg.ntotal,
        mode=cfg.mode,
        horizon_range=(cfg.batch_size, cfg.ntotal),
    )
    return CaseSetup(name="hychem", trainer=trainer,
                     init_params=init_p.to(device), predict=predict,
                     weights_fn=p2vec, dataset=dataset,
                     species=VARNAMES[:ns], logx_plots=True,
                     loss_on_data=loss_on_data,
                     extras={"e_null": e_null, "config": cfg},
                     recipe=(build, cfg, {}))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=1000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--data", default=None,
                    help="trajectory table [t, T, P, Y...]; default: the "
                         "synthetic surrogate")
    ap.add_argument("--project-elements", action="store_true")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--grad-max", type=float, default=None)
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/hychem/checkpoint.pt")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = HyChemConfig(data_path=args.data,
                       project_elements=args.project_elements,
                       device=args.device)
    if args.lr is not None:
        cfg.lr = args.lr
    if args.grad_max is not None:
        cfg.grad_max = args.grad_max
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart, dp=args.dp)


if __name__ == "__main__":
    main()
