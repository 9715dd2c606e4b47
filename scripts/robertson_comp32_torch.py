"""Compensated-f32 robertson experiment on crnn_tpu_torch (port of
scripts/robertson_comp32.py).

Question: is robertson's f32 training floor trajectory accumulation
round-off (y += dt*k over ~192 steps with y2 ~ 3.6e-5 under y1 ~ 1), which
compensated (hi, lo) state accumulation (``ode/compensated.py``) removes,
or stage-math round-off (W-solve and stage cancellations), which it does
not reach?

Protocol: identical data (robertson's f64 truth, cast down), identical
init, the full-horizon batch loss over the 20 training experiments, and
Adam at staged learning rates behind a global-norm clip with decoupled
weight decay (optax's ``chain(clip_by_global_norm, adamw)``, written out in
``ClipAdamW``). Three variants, f64 / f32 / f32comp, all on the batch-major
driver with the dense Jacobian, so the only difference is arithmetic. On a
CUDA device every f is one launch of the isothermal RHS kernel
(``ops/csrc/crnn_rhs.cu``) and every step's f0 and J one launch of its
value+Jacobian kernel (``ops/csrc/crnn_rhs_jac.cu``). Quality is judged by
the f64 solver (the early-exit driver, the values of the scan) on each
variant's final params, train and val, so no variant grades itself.

    python3 scripts/robertson_comp32_torch.py [--epochs-per-stage 1500]
        [--lrs 5e-3,1e-3,3e-4] [--seed 11] [--device cuda|cpu]
        [--out runs_torch/robertson_long]

Writes ``<out>/comp32_experiment.md`` and ``<out>/comp32_curves.npz`` and
prints one JSON line of the results.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from crnn_tpu_torch import resolve_device  # noqa: E402
from crnn_tpu_torch.cases.robertson import (  # noqa: E402
    RobertsonConfig, build)
from crnn_tpu_torch.models.crnn import make_crnn_scaled_rhs  # noqa: E402
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23  # noqa: E402
from crnn_tpu_torch.ode.compensated import (  # noqa: E402
    batch_odesolve_rb23_comp)
from crnn_tpu_torch.ops.crnn_kernels import make_crnn_rhs_jac_op  # noqa: E402
from crnn_tpu_torch.transforms.p2vec import (  # noqa: E402
    init_params_robertson, p2vec_robertson)

VARIANTS = (("f64", torch.float64, False), ("f32", torch.float32, False),
            ("f32comp", torch.float32, True))


class ClipAdamWState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


class ClipAdamW:
    """``optax.chain(clip_by_global_norm(grad_max), adamw(lr,
    weight_decay=wd))`` on one flat tensor: the clip rescales by exactly
    ``grad_max / |g|`` (no epsilon, unlike ``clip_grad_norm_``), Adam's
    bias-corrected step, then the decoupled decay ``+ wd * p``, then
    ``-lr``."""

    def __init__(self, lr: float, weight_decay: float, grad_max: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd, self.grad_max = lr, weight_decay, grad_max
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: torch.Tensor) -> ClipAdamWState:
        return ClipAdamWState(torch.zeros_like(params),
                              torch.zeros_like(params), 0)

    def update(self, grad, state: ClipAdamWState, params):
        g_norm = torch.sqrt(torch.sum(grad * grad))
        g = torch.where(g_norm < self.grad_max, grad,
                        (grad / g_norm) * self.grad_max)
        mu = (1 - self.b1) * g + self.b1 * state.mu
        nu = (1 - self.b2) * (g ** 2) + self.b2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1 - self.b1 ** count)
        nu_hat = nu / (1 - self.b2 ** count)
        step = mu_hat / (torch.sqrt(nu_hat) + self.eps) + self.wd * params
        return params + (-self.lr) * step, ClipAdamWState(mu, nu, count)


def make_f_jac(lb: float, ub: float, dydt_scale: torch.Tensor,
               plain: bool = False):
    """``f_jac(t, y, w) -> (f0, J)`` of robertson's scaled CRNN from one
    launch of the value+Jacobian kernel (``plain=True``: its plain
    version)."""
    op = make_crnn_rhs_jac_op(lb, ub, 32.0, plain)

    def f_jac(t, y, w):
        du, jac = op(y, w.w_in, w.w_b, w.w_out)
        return du * dydt_scale, jac * dydt_scale[:, None]

    return f_jac


def make_solve(cfg: RobertsonConfig, setup, dtype, compensated: bool,
               plain: bool = False, unroll: str = "scan", device=None):
    """``solve(p, u0_b) -> BatchODESolution``: robertson's scaled CRNN from
    ``u0_b`` over the full horizon in ``dtype`` on ``device`` (default: the
    dataset's), on the compensated or the plain batch driver; ``plain=True``
    runs the kernels' plain versions."""
    ds = setup.dataset
    dev = device or ds.u0.device
    saveat = ds.ts.to(dev, dtype)
    dscale = setup.dydt_scale.to(dev, dtype)
    t1 = float(ds.ts[-1])
    f = make_crnn_scaled_rhs(cfg.lb, cfg.ub, dscale, exp_cap=32.0,
                             plain=plain)
    f_jac = make_f_jac(cfg.lb, cfg.ub, dscale, plain)
    atol = cfg.atol.to(dev, dtype)

    def solve(p, u0_b):
        kw = dict(args=p2vec_robertson(p.to(dev, dtype), cfg.ns, cfg.nr),
                  rtol=cfg.rtol, atol=atol, max_steps=cfg.max_steps)
        u0_b = u0_b.to(dev, dtype)
        if compensated:
            return batch_odesolve_rb23_comp(f, f_jac, u0_b, 0.0, t1, saveat,
                                            **kw)
        return batch_odesolve_rb23(f, f_jac, u0_b, 0.0, t1, saveat,
                                   unroll=unroll, **kw)

    return solve


def make_variant(cfg: RobertsonConfig, setup, dtype, compensated: bool,
                 unroll: str = "scan"):
    """``(train_loss, val_loss)``, each ``p -> scalar``: the scaled MAE of
    the full-horizon solve of the training / validation experiments in
    ``dtype``."""
    ds = setup.dataset
    n = cfg.n_exp_train
    ys, yscale = ds.ys.to(dtype), ds.yscale.to(dtype)
    solve = make_solve(cfg, setup, dtype, compensated, unroll=unroll)

    def loss_on(p, u0_b, ys_b):
        return torch.mean(torch.abs(solve(p, u0_b).ys - ys_b) / yscale)

    return (lambda p: loss_on(p, ds.u0[:n], ys[:n]),
            lambda p: loss_on(p, ds.u0[n:], ys[n:]))


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(epochs_per_stage: int = 1500, lrs=(5e-3, 1e-3, 3e-4), seed: int = 11,
        device: str = "cuda", setup=None) -> dict:
    """Train the three variants from one init and judge them in f64.
    ``setup``: a robertson ``CaseSetup`` (f64) to take the data and the
    config from; None builds ``RobertsonConfig()`` on ``device``. Returns ``{"results": {name:
    {...}}, "curves": {name: array}}``."""
    dev = resolve_device(device)
    if setup is None:
        setup = build(RobertsonConfig(device=str(dev)))
    cfg = setup.extras["config"]
    judge_train, judge_val = make_variant(cfg, setup, torch.float64, False,
                                          unroll="while")
    p0 = init_params_robertson(torch.Generator().manual_seed(seed), cfg.ns,
                               cfg.nr, dtype=torch.float64, device=dev)
    results, curves = {}, {}
    for name, dtype, comp in VARIANTS:
        train_loss, _ = make_variant(cfg, setup, dtype, comp)
        p = p0.to(dtype)
        curve, n_done = [], 0
        _sync(dev)
        t_start = time.perf_counter()
        for lr in lrs:
            opt = ClipAdamW(lr, cfg.weight_decay, cfg.grad_max)
            state = opt.init(p)
            for e in range(epochs_per_stage):
                q = p.detach().requires_grad_(True)
                loss = train_loss(q)
                (g,) = torch.autograd.grad(loss, q)
                loss = loss.detach()
                g = torch.where(torch.isfinite(g), g, torch.zeros_like(g))
                p, state = opt.update(g, state, p.detach())
                n_done += 1
                if (e + 1) % 50 == 0:
                    curve.append((n_done, float(loss)))
            print(f"[{name}] lr={lr:g} done, last train {float(loss):.4e}",
                  flush=True)
        _sync(dev)
        wall = time.perf_counter() - t_start
        p64 = p.detach().to(torch.float64)
        with torch.no_grad():
            results[name] = {
                "epochs": n_done, "wall_s": wall,
                "ms_per_epoch": wall / n_done * 1e3,
                "own_train": float(loss),
                "f64_train": float(judge_train(p64)),
                "f64_val": float(judge_val(p64)),
            }
        curves[name] = np.asarray(curve)
        print(f"[{name}] {results[name]}", flush=True)
    return {"results": results, "curves": curves}


def verdict(results: dict) -> str:
    f32v = results["f32"]["f64_val"]
    cmpv = results["f32comp"]["f64_val"]
    if cmpv < 0.5 * f32v:
        return ("compensated accumulation recovers most of the f64 descent: "
                "the f32 floor was accumulation round-off.")
    if cmpv < 0.9 * f32v:
        return ("compensation helps but does not close the gap: "
                "accumulation and stage math both contribute.")
    return ("compensation does NOT move the floor: the deficit is stage-math "
            "round-off (W-solve/stage cancellations).")


def write_report(out: dict, path: str, lrs: str, epochs_per_stage: int,
                 device: str) -> str:
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "comp32_curves.npz"), **out["curves"])
    results = out["results"]
    md = os.path.join(path, "comp32_experiment.md")
    with open(md, "w") as f:
        f.write("# Compensated-f32 robertson experiment (crnn_tpu_torch)\n\n")
        f.write(f"Device: **{device}**; stages lr {lrs} x {epochs_per_stage} "
                "epochs; identical init/data; quality judged by the f64 "
                "solver on the final params.\n\n")
        f.write("| variant | ms/epoch | own train loss | f64-judged train "
                "| f64-judged val |\n|---|---|---|---|---|\n")
        for name, r in results.items():
            f.write(f"| {name} | {r['ms_per_epoch']:.1f} | "
                    f"{r['own_train']:.4e} | {r['f64_train']:.4e} | "
                    f"{r['f64_val']:.4e} |\n")
        f.write(f"\nf64-judged val: f64 {results['f64']['f64_val']:.4e} / "
                f"f32 {results['f32']['f64_val']:.4e} / f32comp "
                f"{results['f32comp']['f64_val']:.4e}.\n\n"
                f"**Verdict:** {verdict(results)}\n")
    return md


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs-per-stage", type=int, default=1500)
    ap.add_argument("--lrs", default="5e-3,1e-3,3e-4")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default="runs_torch/robertson_long")
    args = ap.parse_args(argv)
    lrs = [float(x) for x in args.lrs.split(",")]
    out = run(args.epochs_per_stage, lrs, args.seed, args.device)
    dev = resolve_device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu")
    md = write_report(out, args.out, args.lrs, args.epochs_per_stage, name)
    print(f"wrote {md}", flush=True)
    print(json.dumps({"device": name, "results": out["results"]}))
    return out["results"]


if __name__ == "__main__":
    main()
