"""Cathode NCM UQ: a Bayesian CRNN posterior by SVGD particles (port of
crnn_tpu/cases/cathode_uq.py).

A 100-particle SVGD ensemble over the 17 cathode kinetic parameters
(Cathode_NCM333_UQ/src_333/), warm-started from the deterministic optimum
with correlated lnA-Ea perturbations (network.jl:26-46), scored by
per-experiment noise-normalised gradients (dlnprob, network.jl:222-260) of a
replicate-curve MSE likelihood (network.jl:262-275).

Two likelihood paths, as in the JAX package:

- batch-major (``batch_major=True`` with Rosenbrock23, the default): all
  particles integrate as one batch per solver step on
  ``ode/batch_solve.py:batch_odesolve_rb23(..., nonautonomous=True)`` with
  the closed-form J and df/dt of ``models/crnn.py:make_cathode_rhs_batch``;
- per-lane (``batch_major=False``, or ``solver='trbdf2'``): the per-lane
  driver ``ode/solve.py:odesolve`` with one particle a lane, its weights
  lane-batched, J in closed form (df/dt by forward mode in t).

The gradient is reverse mode through the checkpointed ``maxiters``-step
scan, of the sum of the per-particle losses (lanes are independent, so that
is every particle's own gradient). The validation loss, which takes no
gradient, is solved by the early-exit driver (the same values as the scan:
steps past a lane's end change nothing). No Pallas kernel backs the
cathode RHS in the JAX package: this case is plain torch on every device.

Randomness: particles and replicate noise come from ``torch.Generator``s
seeded by ``cfg.seed`` (``build_uq``'s ``particles=``/``reps=`` take given
ones instead, e.g. JAX's); the per-iteration permutations of the training
curves from ``np.random.default_rng(cfg.seed)``, as in the JAX package.

``dp > 0`` shards the particles over ``dp`` ranks
(``parallel/svgd_dp.py``): ``run_uq`` starts the ranks (one per card, or
gloo processes on the CPU), or runs in this process for ``dp=1`` or under
a process group already up.

    python -m crnn_tpu_torch.cases.cathode_uq --iters 200 [--device cpu]
        [--particles 100] [--chunk N] [--resume] [--dp N] [--out DIR]
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from crnn_tpu_torch import clip, resolve_device
from crnn_tpu_torch.data.loaders import synthetic_dsc
from crnn_tpu_torch.models.crnn import (cathode_hrr_batch,
                                        make_cathode_rhs_batch)
from crnn_tpu_torch.ode import get_solver
from crnn_tpu_torch.ode.batch_solve import batch_odesolve_rb23
from crnn_tpu_torch.ode.rosenbrock import give_jac
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.parallel import mesh
from crnn_tpu_torch.transforms.p2vec import init_params_cathode, p2vec_cathode
from crnn_tpu_torch.uq.posterior import ParticleHistory
from crnn_tpu_torch.uq.svgd import svgd_step_tolerant

PARAM_NAMES = [f"{g}{i}" for g in ("lnA", "Ea", "b", "dH", "n")
               for i in range(1, 4)] + ["nu2", "nu3"]


@dataclass
class CathodeUQConfig:
    # mirrors Cathode_NCM333_UQ/config.yaml:27-33
    num_particles: int = 100
    stepsize: float = 2e-4
    stepsize_decay: float = 0.95
    stepsize_decay_epochs: int = 500
    gap: int = 10
    n_iters: int = 500
    n_replicates: int = 100
    noise_level: float = 0.05
    init_jitter: float = 1e-3
    lb: float = 1e-8
    maxiters: int = 512
    rtol: float = 1e-4
    solver: str = "rosenbrock23"
    # all particles as one batch per solver step (the batch-major
    # Rosenbrock23); only with solver == "rosenbrock23"
    batch_major: bool = True
    dtype: str = "float64"
    val_index: int = 3
    seed: int = 0
    data_dir: Optional[str] = None
    # shard the particles over dp ranks (-1: one per card); num_particles
    # must divide over them (parallel/svgd_dp.py)
    dp: int = 0
    device: str = "cuda"


def _param_scales(p_opt: np.ndarray) -> np.ndarray:
    """The per-parameter scales of the normalised coordinates."""
    p_scales = np.array(p_opt[:17], dtype=np.float64)
    slope = p_opt[17] * 10.0
    p_scales[0:3] *= 20.0 * slope      # lnA scaling
    p_scales[9:12] *= 100.0            # delH scaling
    return p_scales


def correlated_init(gen: torch.Generator, p_opt: np.ndarray,
                    cfg: CathodeUQConfig, dtype=torch.float64):
    """Particles (n, 17) in normalised coordinates (1.0 == the deterministic
    optimum) with correlated lnA-Ea perturbations per reaction
    (network.jl:26-46), drawn from the CPU generator ``gen``; and the
    parameter scales (17,)."""
    n, d = cfg.num_particles, 17
    p_scales = torch.as_tensor(_param_scales(p_opt), dtype=dtype)
    particles = 1.0 + cfg.init_jitter * torch.randn((n, d), generator=gen,
                                                    dtype=dtype)
    # correlated lnA-Ea around the R1/R2/R3 peak temperatures
    for i, peak_c in enumerate((270.0, 310.0, 430.0)):
        rt = 8.314 * (peak_c + 273.15)
        picker = torch.randn((n,), generator=gen, dtype=dtype)
        particles[:, i] = (picker + p_scales[i]) / p_scales[i]
        particles[:, 3 + i] = ((picker * rt / 1e5 + p_scales[3 + i])
                               / p_scales[3 + i])
    return particles, p_scales


def build_uq(cfg: CathodeUQConfig = CathodeUQConfig(),
             p_opt: Optional[np.ndarray] = None, *,
             particles: Optional[np.ndarray] = None,
             reps: Optional[np.ndarray] = None):
    """Returns (particles (n, 17), svgd_iteration, extras) on
    ``cfg.device``. ``svgd_iteration(particles, i_exp, stepsize) ->
    (particles, mean loss)`` advances one SVGD update on one experiment's
    likelihood. ``particles`` and ``reps`` (n_exp, n_t, n_rep) replace the
    seeded draws (e.g. with the JAX package's)."""
    device = resolve_device(cfg.device)
    dtype = getattr(torch, cfg.dtype)
    g_init, g_rep = (torch.Generator().manual_seed(s)
                     for s in np.random.SeedSequence(cfg.seed)
                     .generate_state(2).tolist())

    def dev(a):
        if not isinstance(a, torch.Tensor):
            a = torch.tensor(np.asarray(a))
        return a.to(device=device, dtype=dtype)

    # --- data: replicate noisy HRR curves per heating rate ----------------
    if cfg.data_dir:
        # measured replicate curves (UQ dataset.jl:5-24 format)
        from crnn_tpu_torch.data.loaders import load_uncert_dir

        unc = load_uncert_dir(cfg.data_dir)
        ts_np, masks_np, betas_np = unc.ts, unc.mask, unc.betas
        reps_np = unc.reps if reps is None else reps
        mean_curve = np.asarray(reps_np).mean(axis=2)
    else:
        dsc = synthetic_dsc(seed=cfg.seed, noise=0.0)
        ts_np, masks_np, betas_np = dsc.ts, dsc.mask, dsc.betas
        clean = torch.as_tensor(dsc.hrr, dtype=dtype)
        reps_np = reps if reps is not None else (
            clean[:, :, None] * (1.0 + cfg.noise_level * torch.randn(
                clean.shape + (cfg.n_replicates,), generator=g_rep,
                dtype=dtype))).numpy()
        mean_curve = np.asarray(dsc.hrr, dtype=np.float64)
    ts, masks, betas, reps_t = (dev(ts_np), dev(masks_np), dev(betas_np),
                                dev(reps_np))
    n_exp, n_rep = ts.shape[0], reps_t.shape[2]
    spans = [(float(r[0]), float(r[-1])) for r in ts.cpu()]
    # per-experiment noise normaliser: noise_level x peak HRR per heating
    # rate ("based on peak value and noise", UQ dataset.jl:27-32)
    normalizer = dev([float(cfg.noise_level * np.max(mean_curve[i]))
                      for i in range(n_exp)])
    # host copies of the per-experiment constants (no sync per use)
    mask_sums = [float(m) for m in np.asarray(masks_np).sum(axis=1)]

    # --- deterministic optimum (warm start) --------------------------------
    if p_opt is None:
        p_opt = init_params_cathode(torch.Generator().manual_seed(1),
                                    dtype=torch.float64, device="cpu").numpy()
    p_opt = np.asarray(p_opt, dtype=np.float64)
    drawn, p_scales = correlated_init(g_init, p_opt, cfg, dtype)
    particles = dev(drawn if particles is None else particles)
    p_scales = p_scales.to(device)
    slope_div = 20.0 * float(p_opt[17]) * 10.0
    divisor = dev([slope_div] * 3 + [1.0] * 6 + [100.0] * 3 + [1.0] * 5)
    slope = float(p_opt[17])

    def denormalise(p_norm):
        """Normalised particles (B, 17) -> raw (B, 18) for p2vec (the slope
        appended)."""
        raw17 = p_norm * p_scales / divisor
        return torch.cat([raw17, raw17.new_full(raw17.shape[:-1] + (1,),
                                                slope)], dim=-1)

    f_b, f_jac_b = make_cathode_rhs_batch(cfg.lb)
    u0 = torch.zeros((3,), dtype=dtype, device=device)
    u0[0] = 1.0
    use_batch_major = cfg.batch_major and cfg.solver == "rosenbrock23"
    # the per-lane solver: J in closed form (the J of f_jac_b, which equals
    # forward mode of the RHS), df/dt by forward mode in t
    solver = give_jac(get_solver(cfg.solver),
                      lambda t, y, args: f_jac_b(t, y, args)[1])

    def solve_lanes(w_b, i_exp, unroll):
        """ys (B, n_t, 3) of every particle on experiment ``i_exp``."""
        t0, t1 = spans[i_exp]
        u0b = u0.expand(w_b.w_in.shape[0], 3)
        if use_batch_major:
            return batch_odesolve_rb23(
                f_b, f_jac_b, u0b, t0, t1, ts[i_exp],
                args=(w_b, betas[i_exp]), rtol=cfg.rtol, atol=cfg.lb,
                max_steps=cfg.maxiters, unroll=unroll,
                nonautonomous=True).ys
        return odesolve(f_b, solver, u0b, t0, t1, ts[i_exp],
                        args=(w_b, betas[i_exp]), rtol=cfg.rtol, atol=cfg.lb,
                        max_steps=cfg.maxiters, unroll=unroll).ys

    def predict_lanes(p_norms, i_exp, unroll="scan"):
        """Posterior-predictive HRR curves (B, n_t) of particles (B, 17)."""
        w_b = p2vec_cathode(denormalise(p_norms))
        ys = clip(solve_lanes(w_b, i_exp, unroll), 0.0, 10.0)
        return cathode_hrr_batch(ts[i_exp], ys, w_b, betas[i_exp], cfg.lb)

    def loss_lanes(p_norms, i_exp, unroll="scan"):
        """Replicate-MSE likelihood losses (B,) (UQ network.jl:262-275)."""
        pred = predict_lanes(p_norms, i_exp, unroll)
        err = ((pred[:, :, None] - reps_t[i_exp][None]) ** 2
               * masks[i_exp][None, :, None])
        return torch.sum(err, dim=(1, 2)) / n_rep / mask_sums[i_exp]

    def value_and_grad_lanes(p_norms, i_exp):
        """(losses (B,), their gradients (B, 17)): one reverse pass of the
        sum, since the lanes are independent."""
        p = p_norms.detach().requires_grad_(True)
        losses = loss_lanes(p, i_exp)
        (g,) = torch.autograd.grad(torch.sum(losses), p)
        return losses.detach(), g

    def loss_all(p_norms, i_exp):
        """(B,) losses without a gradient, by the early-exit driver."""
        with torch.no_grad():
            return loss_lanes(p_norms, i_exp, "while")

    def predict_one(p_norm, i_exp):
        """One particle's predictive curve (n_t,)."""
        with torch.no_grad():
            return predict_lanes(torch.as_tensor(
                p_norm, dtype=dtype).to(device)[None], i_exp, "while")[0]

    if cfg.dp:
        from crnn_tpu_torch.parallel.svgd_dp import (check_divides,
                                                     make_dp_losses,
                                                     make_dp_svgd_step)

        n_ranks = cfg.dp if cfg.dp > 0 else mesh.world_size()
        check_divides(cfg.num_particles, n_ranks)
        if mesh.world_size() != n_ranks:
            raise ValueError(
                f"dp={cfg.dp} needs a process group of {n_ranks} ranks, not "
                f"{mesh.world_size()}: run it through run_uq, which starts "
                "them")
        dp_step = make_dp_svgd_step(value_and_grad_lanes)

        def svgd_iteration(particles, i_exp, stepsize):
            return dp_step(particles, i_exp, stepsize, normalizer[i_exp])

        loss_all_fn = make_dp_losses(loss_all)
    else:
        def svgd_iteration(particles, i_exp, stepsize):
            losses, grads = value_and_grad_lanes(particles, i_exp)
            # noise normalisation of the score (dlnprob, network.jl:234-250)
            lnpgrad = -grads / normalizer[i_exp] ** 2
            return svgd_step_tolerant(particles, losses, lnpgrad, stepsize)

        loss_all_fn = loss_all

    extras = {
        "ts": ts, "reps": reps_t, "masks": masks, "betas": betas,
        "normalizer": normalizer, "loss_all": loss_all_fn,
        "value_and_grad": value_and_grad_lanes, "predict_one": predict_one,
        "n_exp": n_exp, "p_scales": p_scales, "device": device,
    }
    return particles, svgd_iteration, extras


def _writer() -> bool:
    """Only rank 0 prints and writes files."""
    return mesh.rank() == 0


def _snapshot(checkpoint_dir, particles, losses_train, losses_val, it):
    """The crash-safe snapshot, in the JAX package's numpy formats."""
    if not _writer():
        return
    os.makedirs(checkpoint_dir, exist_ok=True)
    np.save(os.path.join(checkpoint_dir, "particles_ckpt.npy"),
            particles.cpu().numpy())
    np.savez(os.path.join(checkpoint_dir, "losses_ckpt.npz"),
             loss_train=np.asarray(losses_train),
             loss_val=np.asarray(losses_val), it=it)


def run_uq(cfg: CathodeUQConfig = CathodeUQConfig(),
           p_opt: Optional[np.ndarray] = None, verbose: bool = True,
           checkpoint_dir: Optional[str] = None,
           checkpoint_every: int = 2500, chunk: int = 0,
           resume: bool = False, *, particles: Optional[np.ndarray] = None,
           reps: Optional[np.ndarray] = None):
    """The SVGD loop (crnn_cathode.jl:23-78): each iteration one update per
    training curve in a fresh permutation, then the validation loss (once,
    after all of the iteration's updates, as the JAX package takes it).
    Returns (particles, {"loss_train", "loss_val", "history", "extras"}).

    The step size is ``stepsize * decay ** (it // decay_epochs)`` in numpy
    f64, as the JAX chunk path computes it (its plain path decays a float
    in place: the two agree to an ulp a decay). ``chunk`` sets only the
    host syncs: ``chunk`` > 0 syncs, prints and snapshots at the end of
    each chunk of that many iterations; ``chunk=0`` syncs only to print and
    snapshot (eager torch has no dispatch to fuse). ``resume`` restarts
    from ``particles_ckpt.npy`` / ``losses_ckpt.npz`` in
    ``checkpoint_dir`` and continues as the uninterrupted run: the step
    sizes, the history cadence and the permutations follow the absolute
    iteration (the history snapshots before the resume are not kept)."""
    if cfg.dp and not torch.distributed.is_initialized():
        n_ranks = cfg.dp if cfg.dp > 0 else _card_count(cfg)
        if n_ranks > 1:
            return _run_uq_ranks(cfg, n_ranks, p_opt, verbose,
                                 checkpoint_dir, checkpoint_every, chunk,
                                 resume, particles, reps)
        with mesh.process_group(1, 0, device=resolve_device(cfg.device)):
            return run_uq(cfg, p_opt, verbose, checkpoint_dir,
                          checkpoint_every, chunk, resume,
                          particles=particles, reps=reps)
    particles, svgd_iteration, ex = build_uq(cfg, p_opt, particles=particles,
                                             reps=reps)
    verbose = verbose and _writer()
    dtype, device = particles.dtype, particles.device
    rng = np.random.default_rng(cfg.seed)
    history = ParticleHistory(cfg.gap)
    start_it, losses_train, losses_val = 0, [], []
    if resume and checkpoint_dir:
        pf = os.path.join(checkpoint_dir, "particles_ckpt.npy")
        lf = os.path.join(checkpoint_dir, "losses_ckpt.npz")
        if os.path.exists(pf) and os.path.exists(lf):
            particles = torch.as_tensor(np.load(pf), dtype=dtype).to(device)
            saved = np.load(lf)
            start_it = int(saved["it"])
            losses_train = saved["loss_train"].tolist()
            losses_val = saved["loss_val"].tolist()
            if verbose:
                print(f"resuming from {pf} at iter {start_it}", flush=True)
    loss_all = ex["loss_all"]
    val_index = cfg.val_index
    train_ids = np.asarray(
        [i for i in range(ex["n_exp"]) if i != val_index], np.int32)
    # one permutation an iteration: skipping the ones already used makes a
    # resumed run draw what the uninterrupted run draws (the JAX package
    # restarts the stream)
    for _ in range(start_it):
        rng.permutation(train_ids)

    def iteration(particles, perm, stepsize):
        mlosses = []
        for i_exp in perm.tolist():
            particles, mloss = svgd_iteration(particles, i_exp, stepsize)
            mlosses.append(mloss)
        val = torch.mean(loss_all(particles, val_index))
        return particles, torch.mean(torch.stack(mlosses)), val

    pending = []       # device scalars, flushed in bulk

    def flush():
        if pending:
            arr = torch.stack([torch.stack(x) for x in pending]).cpu().numpy()
            losses_train.extend(arr[:, 0].tolist())
            losses_val.extend(arr[:, 1].tolist())
            pending.clear()

    last_sync = start_it
    for it in range(start_it, cfg.n_iters):
        stepsize = float(cfg.stepsize * np.float64(cfg.stepsize_decay) ** (
            it // cfg.stepsize_decay_epochs))
        particles, mtrain, mval = iteration(
            particles, rng.permutation(train_ids), stepsize)
        pending.append((mtrain, mval))
        history.maybe_record(it, particles)
        done = it + 1
        # chunk > 0: one host sync at the end of each chunk, which prints
        # and snapshots if a multiple of checkpoint_every lies in it (and at
        # the end); chunk = 0: every iteration may sync, printing a tenth of
        # the way and snapshotting every checkpoint_every
        if chunk > 0:
            at_sync = (done - start_it) % chunk == 0 or done == cfg.n_iters
            if not at_sync:
                continue
            flush()
            report = verbose
            last = done == cfg.n_iters
        else:
            report = verbose and it % max(cfg.n_iters // 10, 1) == 0
            last = False
        if report:
            flush()
            print(f"svgd iter {it}: train {losses_train[-1]:.4e} "
                  f"val {losses_val[-1]:.4e}", flush=True)
        # periodic crash-safe snapshot (the reference checkpoints p_his
        # every gap iters too, UQ callback.jl:184)
        if checkpoint_dir and (done // checkpoint_every
                               > last_sync // checkpoint_every or last):
            flush()
            _snapshot(checkpoint_dir, particles, losses_train, losses_val,
                      done)
        last_sync = done
    flush()
    return particles, {"loss_train": losses_train, "loss_val": losses_val,
                       "history": history.tensor(), "extras": ex}


def _card_count(cfg: CathodeUQConfig) -> int:
    """``dp=-1``: one rank per card."""
    if resolve_device(cfg.device).type != "cuda":
        raise ValueError("dp=-1 means one rank per card; on the CPU give "
                         "the number of ranks")
    return torch.cuda.device_count()


def _uq_rank(cfg, p_opt, verbose, checkpoint_dir, checkpoint_every, chunk,
             resume, particles, reps):
    """One rank of ``_run_uq_ranks``: rank 0 returns its results on the
    CPU (the extras hold closures and stay behind)."""
    out, info = run_uq(cfg, p_opt, verbose, checkpoint_dir, checkpoint_every,
                       chunk, resume, particles=particles, reps=reps)
    return out.cpu().numpy(), {k: info[k] for k in
                               ("loss_train", "loss_val", "history")}


def _run_uq_ranks(cfg, n_ranks, p_opt, verbose, checkpoint_dir,
                  checkpoint_every, chunk, resume, particles, reps):
    """``run_uq`` on ``n_ranks`` ranks it starts; the extras are rebuilt
    here (the same seeded data)."""
    out, info = mesh.spawn(
        _uq_rank, n_ranks,
        (replace(cfg, dp=n_ranks), p_opt, verbose, checkpoint_dir,
         checkpoint_every, chunk, resume, particles, reps),
        device=str(resolve_device(cfg.device)))
    _, _, ex = build_uq(replace(cfg, dp=0), p_opt, particles=out, reps=reps)
    return (torch.as_tensor(out).to(ex["device"]),
            {**info, "extras": ex})


def write_outputs(out: str, particles: torch.Tensor, info: dict,
                  figures: bool = True) -> dict:
    """The run directory ``out``: ``particles.npy``, ``losses.npz``, the
    posterior moments (``moments.npz``), the particle history
    (``history.npy``) and, with matplotlib, the Kendall-tau heatmap, the
    histograms, a posterior predictive band per heating rate
    (post_Plotting.jl:90-199) and the evolution GIF. Returns the moments."""
    from crnn_tpu_torch.infra.plotting import have_matplotlib
    from crnn_tpu_torch.uq.posterior import posterior_moments

    os.makedirs(out, exist_ok=True)
    p = particles.detach().cpu().numpy()
    np.save(os.path.join(out, "particles.npy"), p)
    np.savez(os.path.join(out, "losses.npz"), loss_train=info["loss_train"],
             loss_val=info["loss_val"])
    moments = posterior_moments(p)
    np.savez(os.path.join(out, "moments.npz"), **moments)
    np.save(os.path.join(out, "history.npy"), info["history"])
    if not (figures and have_matplotlib()):
        print("[cathode_uq] matplotlib is not installed: figures skipped",
              flush=True)
        return moments
    from crnn_tpu_torch.uq.posterior import (animate_particle_evolution,
                                             plot_correlation_heatmap,
                                             plot_particle_histograms,
                                             plot_posterior_band)

    plot_correlation_heatmap(p, os.path.join(out, "corr.png"), PARAM_NAMES)
    plot_particle_histograms(p, os.path.join(out, "hist.png"), PARAM_NAMES)
    ex = info["extras"]
    masks, ts = ex["masks"].cpu().numpy(), ex["ts"].cpu().numpy()
    reps = ex["reps"].cpu().numpy()
    for i in range(ex["n_exp"]):
        n = int(np.sum(masks[i]))
        plot_posterior_band(
            ts[i][:n], reps[i].mean(axis=1)[:n],
            lambda q, i=i, n=n: ex["predict_one"](q, i)[:n].cpu().numpy(),
            p, os.path.join(out, f"band_beta{int(ex['betas'][i])}.png"))
    if info["history"].size:
        animate_particle_evolution(info["history"],
                                   os.path.join(out, "evolution.gif"))
    return moments


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--solver", default="rosenbrock23",
                    help="rosenbrock23 (default; the batch-major likelihood) "
                         "or trbdf2 (per-lane)")
    ap.add_argument("--no-batch-major", action="store_true",
                    help="the per-lane likelihood with rosenbrock23")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--p-opt", default=None,
                    help="the deterministic optimum (p_opt.npy of a cathode "
                         "run) to warm-start the ensemble (UQ network.jl:11)")
    ap.add_argument("--data-dir", default=None,
                    help="directory of UNCERT_cath_*.csv replicate curves; "
                         "omit for the synthetic surrogate")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--maxiters", type=int, default=512)
    ap.add_argument("--decay-epochs", type=int, default=500,
                    help="stepsize decay cadence (UQ config.yaml:32)")
    ap.add_argument("--dp", type=int, default=0,
                    help="shard the particles over N ranks (-1: one per "
                         "card); num_particles must divide over them")
    ap.add_argument("--chunk", type=int, default=0,
                    help="run the iterations in chunks of N, one host sync "
                         "a chunk")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the snapshot in <out>/cathode_uq/")
    ap.add_argument("--checkpoint-every", type=int, default=2500)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cfg = CathodeUQConfig(n_iters=args.iters, num_particles=args.particles,
                          data_dir=args.data_dir, solver=args.solver,
                          stepsize_decay_epochs=args.decay_epochs,
                          maxiters=args.maxiters, dp=args.dp,
                          batch_major=not args.no_batch_major,
                          dtype=args.dtype, device=args.device)
    p_opt = np.load(args.p_opt) if args.p_opt else None
    out = os.path.join(args.out, "cathode_uq")
    t0 = time.perf_counter()
    particles, info = run_uq(cfg, p_opt=p_opt, checkpoint_dir=out,
                             checkpoint_every=args.checkpoint_every,
                             chunk=args.chunk, resume=args.resume)
    print(f"[cathode_uq] {cfg.n_iters} iterations in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    moments = write_outputs(out, particles, info)
    print("posterior std per param:", np.round(moments["std"], 4))
    return particles, info


if __name__ == "__main__":
    main()
