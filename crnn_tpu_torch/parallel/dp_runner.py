"""Data-parallel case training, ``run_case(dp=N)`` (port of
crnn_tpu/parallel/dp_runner.py).

The experiment axis of a ``CaseSetup`` is sharded over N ranks and trained
with one global-mean-loss update per epoch (the Trainer's 'batch' mode,
distributed): each rank solves its shard of the experiments, the gradient
is summed over the ranks (``parallel/dp.py``), the parameters stay
replicated. The evaluation pass shards all experiments the same way and
gathers their losses.

Experiment counts that do not divide over the ranks are padded with lanes
of weight 0, which solve but add nothing to the loss, the gradient or the
metrics. Padded lanes REPEAT the last real experiment rather than holding
zeros: a zero u0 row is out of the RHS's domain (case2's 1/(R T) is inf at
T=0), and reverse mode turns the lane's zero cotangent into 0 * inf = NaN,
which the gradient sum would carry to every rank.

Ranks: N > 1 starts N processes (``parallel/mesh.py:spawn``; gloo on the
CPU, one rank per card with nccl), each rebuilding the case from
``setup.recipe``; N = 1 runs in this process on a world of one; inside a
process group already up (a spawned rank, torchrun) the group is used.
Rank 0 alone prints and writes the run directory, as ``run_case`` does:
``metrics.jsonl``, ``checkpoint.pt``, ``best.pt`` (the best-val carry,
restored on restart), ``p_opt`` and the figures.
"""

from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from crnn_tpu_torch.infra.checkpoint import load_checkpoint
from crnn_tpu_torch.infra.metrics import MetricsLogger
from crnn_tpu_torch.infra.plotting import have_matplotlib
from crnn_tpu_torch.parallel import mesh
from crnn_tpu_torch.parallel.dp import make_dp_eval, make_dp_train_step
from crnn_tpu_torch.train.loop import BestState, TrainState
from crnn_tpu_torch.train.loss import prefix_mask


def _check(setup) -> None:
    if setup.loss_on_data is None:
        raise ValueError(
            f"case {setup.name!r} does not define loss_on_data; "
            "data-parallel training is unavailable for it")
    if setup.trainer.mode == "sequential":
        raise ValueError(
            "dp training uses batch semantics (one global-mean update per "
            "epoch); sequential per-experiment updates cannot shard over "
            "the experiment axis. Use mode 'batch' with dp, or drop dp for "
            "the reference's sequential updates.")
    if setup.trainer.grad_mode == "fwd":
        warnings.warn(
            "dp training always takes reverse-mode gradients through the "
            "scan driver; the case's grad_mode='fwd' (jacfwd through the "
            "early-exit driver) does not apply under dp", stacklevel=3)


def _pad_shard(x: torch.Tensor, n_pad: int, edge: bool = True):
    """This rank's rows of ``x`` padded to ``n_pad`` rows: the last row
    repeated (``edge``, in-domain data, module docstring) or zeros."""
    pad = n_pad - x.shape[0]
    if pad > 0:
        fill = (x[-1:].expand(pad, *x.shape[1:]) if edge
                else x.new_zeros((pad, *x.shape[1:])))
        x = torch.cat([x, fill])
    per = n_pad // mesh.world_size()
    return x[mesh.rank() * per:(mesh.rank() + 1) * per]


def _train(setup, n_epoch: int, out_dir: str, n_plot: int, restart: bool,
           seed: int, log_every: int):
    """The dp epochs on the current process group (every rank runs this)."""
    from crnn_tpu_torch.cases.base import _save_best, _sync, observe_run

    trainer, ds = setup.trainer, setup.dataset
    world = mesh.world_size()
    writer = mesh.rank() == 0
    n_exp, n_train = trainer.n_exp, trainer.n_exp_train
    # experiments visited by the update (case3: all of them)
    n_upd = trainer.n_exp_update or n_train
    n_save = trainer.n_save
    dtype = setup.init_params.dtype
    device = setup.init_params.device
    pad_train = -(-n_upd // world) * world
    pad_all = -(-n_exp // world) * world

    u0_tr = _pad_shard(ds.u0[:n_upd], pad_train)
    ys_tr = _pad_shard(ds.ys[:n_upd], pad_train)
    w_tr = _pad_shard(torch.ones(n_upd, dtype=dtype, device=device),
                      pad_train, edge=False)
    u0_all, ys_all = _pad_shard(ds.u0, pad_all), _pad_shard(ds.ys, pad_all)
    mask_all = torch.ones((pad_all // world, n_save), dtype=dtype,
                          device=device)
    step = make_dp_train_step(setup.loss_on_data, trainer.optimizer)
    eval_fn = make_dp_eval(setup.loss_on_data)
    rng = np.random.default_rng(seed)

    def sample_masks():
        if trainer.horizon_range is None:
            return mask_all[:pad_train // world]
        lo, hi = trainer.horizon_range
        samples = torch.as_tensor(rng.integers(lo, hi + 1, size=(pad_train,)))
        return _pad_shard(prefix_mask(n_save, samples, dtype).to(device),
                          pad_train)

    run_dir = os.path.join(out_dir, setup.name)
    ckpt_path = os.path.join(run_dir, "checkpoint.pt")
    best_path = os.path.join(run_dir, "best.pt")
    state = trainer.init(setup.init_params, seed=seed)
    if restart and os.path.exists(ckpt_path):
        state = load_checkpoint(ckpt_path, state)
        if writer:
            print(f"[{setup.name}] dp restart from {ckpt_path} at epoch "
                  f"{state.epoch}", flush=True)
    best = trainer.init_best(state)
    # the best-val carry survives restarts (run_case's policy and file)
    if restart and os.path.exists(best_path):
        best = load_checkpoint(best_path, best)
        if writer:
            print(f"[{setup.name}] best-val carry restored "
                  f"(val {float(best.loss_val):.4e})", flush=True)
    if writer:
        os.makedirs(run_dir, exist_ok=True)
    figures = writer and have_matplotlib()
    epoch0 = state.epoch
    history: dict = {"loss_train": [], "loss_val": [], "grad_norm": [],
                     "epoch_s": []}
    logger = MetricsLogger(os.path.join(run_dir, "metrics.jsonl")) \
        if writer else None
    t_start = time.perf_counter()
    try:
        for e in range(n_epoch):
            t0 = time.perf_counter()
            params, opt_state, loss, gnorm = step(
                state.params, state.opt_state, u0_tr, ys_tr, sample_masks(),
                w_tr)
            losses = eval_fn(params, u0_all, ys_all, mask_all)[:n_exp]
            lt = torch.mean(losses[:n_train])
            lv = torch.mean(losses[n_train:]) if n_exp > n_train else lt
            state = TrainState(params, opt_state, state.epoch + 1, state.gen)
            lt_f, lv_f, gn_f = float(lt), float(lv), float(gnorm)
            _sync(device)
            epoch_s = time.perf_counter() - t0
            if not (np.isfinite(float(loss)) and np.isfinite(gn_f)):
                best = best._replace(n_skipped=best.n_skipped + 1)
            # best-val fold on the float32 loss (the JAX dp runner's)
            lv32 = np.float32(lv_f)
            if np.isfinite(lv32) and lv32 < best.loss_val:
                best = BestState(params, lv32, np.float32(lt_f),
                                 best.n_skipped)
            row = {"epoch": epoch0 + e + 1, "loss_train": lt_f,
                   "loss_val": lv_f, "grad_norm": gn_f, "epoch_s": epoch_s}
            for name in history:
                history[name].append(row[name])
            if not writer:
                continue
            logger.log(**row)
            if log_every and ((e + 1) % log_every == 0 or e + 1 == n_epoch):
                print(f"[dp x{world}] epoch={epoch0 + e + 1} "
                      f"loss_train={lt_f:.4e} loss_val={lv_f:.4e} "
                      f"epoch_s={epoch_s:.4f}", flush=True)
            if (e + 1) % n_plot == 0 or e + 1 == n_epoch:
                observe_run(setup, run_dir, state, best, history, e + 1,
                            figures)
    finally:
        if logger is not None:
            logger.close()
    if writer:
        wall = time.perf_counter() - t_start
        print(f"[{setup.name}] dp x{world}: {n_epoch} epochs in {wall:.1f}s "
              f"({wall / max(n_epoch, 1) * 1e3:.1f} ms/epoch)", flush=True)
        if best.n_skipped:
            print(f"[{setup.name}] WARNING: {best.n_skipped} dp epochs "
                  "produced a non-finite loss or gradient; their updates "
                  "were discarded", flush=True)
        _save_best(run_dir, setup.name, best, unravel=setup.unravel)
    history.update(best_val=best.loss_val, best_train=best.loss_train,
                   n_skipped=best.n_skipped, best_params=best.params)
    return state, history


def _moved(x, device):
    """``x`` with its tensors (in tuples, named tuples and dicts) on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_moved(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    return x


def _rank_train(recipe, init_params, device_type: str, *args):
    """One spawned rank: rebuild the case on this rank's device from its
    recipe, start from the caller's ``init_params``, train, and return
    (rank 0) the history with its tensors on the CPU."""
    build_fn, cfg, kwargs = recipe
    setup = build_fn(dataclasses.replace(cfg, device=device_type),
                    **_moved(kwargs, device_type))
    setup.init_params = init_params.to(setup.init_params.device)
    _, history = _train(setup, *args)
    return _moved(history, "cpu")


def run_case_dp(setup, n_epoch: int, n_ranks: Optional[int] = None,
                out_dir: str = "runs", n_plot: int = 50,
                restart: bool = False, seed: int = 0, log_every: int = 10):
    """Train ``setup`` data-parallel over ``n_ranks`` ranks (None: one per
    card, or the process group already up). Semantics: the Trainer's
    'batch' mode, distributed. Returns (TrainState, history) as
    ``run_case`` does."""
    _check(setup)
    args = (n_epoch, out_dir, n_plot, restart, seed, log_every)
    if dist.is_initialized():
        if n_ranks is not None and n_ranks != mesh.world_size():
            raise ValueError(
                f"dp={n_ranks} needs a process group of {n_ranks} ranks, not "
                f"the {mesh.world_size()} already up")
        return _train(setup, *args)
    device = setup.init_params.device
    if n_ranks is None:
        if device.type != "cuda":
            raise ValueError("dp=-1 means one rank per card; on the CPU give "
                             "the number of ranks")
        n_ranks = torch.cuda.device_count()
    if n_ranks == 1:
        with mesh.process_group(1, 0, device=device):
            return _train(setup, *args)
    if setup.recipe is None:
        raise ValueError(
            f"case {setup.name!r} records no recipe (CaseSetup.recipe): its "
            "ranks cannot rebuild it")
    build_fn, cfg, kwargs = setup.recipe
    history = mesh.spawn(
        _rank_train, n_ranks,
        ((build_fn, cfg, _moved(kwargs, "cpu")), setup.init_params.cpu(),
         device.type, *args), device=device.type)
    # rank 0's final state is its last checkpoint
    state = load_checkpoint(
        os.path.join(out_dir, setup.name, "checkpoint.pt"),
        setup.trainer.init(setup.init_params, seed=seed))
    return state, _moved(history, device)
