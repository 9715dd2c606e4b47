"""Case runner (port of crnn_tpu/cases/base.py:run_case, without figures
and checkpoints): guarded epochs and a ``metrics.jsonl`` log."""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable

import torch

from crnn_tpu_torch.train.loop import Trainer, TrainState


@dataclass
class CaseSetup:
    name: str
    trainer: Trainer
    init_params: torch.Tensor
    weights_fn: Callable           # params -> CRNNWeights
    dataset: Any                   # data.generate.Dataset


def seed_generators(seed: int, n: int) -> list[torch.Generator]:
    """``n`` independent CPU generators from one seed, as JAX splits its key
    (e.g. into u0, noise and params): no stream depends on another's use."""
    seeds = torch.randint(2**62, (n,),
                          generator=torch.Generator().manual_seed(seed))
    return [torch.Generator().manual_seed(int(s)) for s in seeds]


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_case(setup: CaseSetup, n_epoch: int, out_dir: str = "runs",
             seed: int = 0, log_every: int = 10) -> tuple[TrainState, dict]:
    """Train ``n_epoch`` guarded epochs; append one JSON line per epoch to
    ``<out_dir>/<name>/metrics.jsonl``. Returns (state, history) with the
    per-epoch losses, grad norms and seconds, and the best-val carry."""
    run_dir = os.path.join(out_dir, setup.name)
    os.makedirs(run_dir, exist_ok=True)
    trainer = setup.trainer
    state = trainer.init(setup.init_params, seed=seed)
    best = trainer.init_best(state)
    device = state.params.device
    history: dict = {"loss_train": [], "loss_val": [], "grad_norm": [],
                     "epoch_s": []}
    t_start = time.perf_counter()
    with open(os.path.join(run_dir, "metrics.jsonl"), "a") as log:
        for e in range(n_epoch):
            t0 = time.perf_counter()
            state, best, m = trainer.guarded_epoch(state, best)
            _sync(device)
            row = {"epoch": state.epoch, "loss_train": float(m.loss_train),
                   "loss_val": float(m.loss_val),
                   "grad_norm": float(m.grad_norm),
                   "epoch_s": time.perf_counter() - t0}
            log.write(json.dumps(row) + "\n")
            log.flush()
            for k in ("loss_train", "loss_val", "grad_norm", "epoch_s"):
                history[k].append(row[k])
            if log_every and ((e + 1) % log_every == 0 or e + 1 == n_epoch):
                print(f"[{setup.name}] epoch={row['epoch']} "
                      f"loss_train={row['loss_train']:.4e} "
                      f"loss_val={row['loss_val']:.4e} "
                      f"epoch_s={row['epoch_s']:.4f}", flush=True)
    wall = time.perf_counter() - t_start
    print(f"[{setup.name}] {n_epoch} epochs in {wall:.1f}s "
          f"({wall / max(n_epoch, 1) * 1e3:.1f} ms/epoch)", flush=True)
    if best.n_skipped:
        print(f"[{setup.name}] WARNING: {best.n_skipped} epochs produced "
              "non-finite loss/grad; their updates were discarded", flush=True)
    history.update(best_val=best.loss_val, best_train=best.loss_train,
                   n_skipped=best.n_skipped, best_params=best.params)
    return state, history
