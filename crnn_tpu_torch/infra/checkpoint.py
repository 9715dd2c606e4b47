"""Checkpoint / restart with ``torch.save`` (port of
crnn_tpu/infra/checkpoint.py).

A ``TrainState`` is stored with its params, the Adam state, the epoch and
the state of its ``torch.Generator`` (the counterpart of JAX's carried PRNG
key), so a restart draws the permutations and horizons the interrupted run
would have drawn; a ``BestState`` with its params, losses and skip count.
Both are written as plain dicts of tensors and numbers, which
``torch.load(weights_only=True)`` reads back, and atomically: a crash while
writing never leaves a torn checkpoint.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np
import torch

from crnn_tpu_torch.train.loop import BestState, TrainState
from crnn_tpu_torch.train.optimizers import AdamState


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu()


def save_checkpoint(path: str, state: Union[TrainState, BestState]) -> None:
    """Write ``state`` to ``path`` (``.tmp`` first, then ``os.replace``)."""
    if isinstance(state, TrainState):
        data = {"kind": "TrainState", "params": _cpu(state.params),
                "mu": _cpu(state.opt_state.mu), "nu": _cpu(state.opt_state.nu),
                "count": int(state.opt_state.count), "epoch": int(state.epoch),
                "gen_state": state.gen.get_state()}
    elif isinstance(state, BestState):
        data = {"kind": "BestState", "params": _cpu(state.params),
                "loss_val": float(state.loss_val),
                "loss_train": float(state.loss_train),
                "n_skipped": int(state.n_skipped)}
    else:
        raise TypeError(f"cannot checkpoint a {type(state).__name__}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(data, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str, target: Union[TrainState, BestState]):
    """The state stored at ``path``, of ``target``'s type, its tensors on
    ``target.params``' device. A restored ``TrainState`` carries a new CPU
    generator set to the stored state."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    kind = type(target).__name__
    if data.get("kind") != kind:
        raise ValueError(f"{path} holds a {data.get('kind')}, not a {kind}")
    device = target.params.device

    def dev(t):
        return t.to(device)

    if isinstance(target, TrainState):
        gen = torch.Generator()
        gen.set_state(data["gen_state"])
        return TrainState(dev(data["params"]),
                          AdamState(dev(data["mu"]), dev(data["nu"]),
                                    data["count"]),
                          data["epoch"], gen)
    # the best losses are float32, as the guarded epoch keeps them
    return BestState(dev(data["params"]), np.float32(data["loss_val"]),
                     np.float32(data["loss_train"]), data["n_skipped"])
