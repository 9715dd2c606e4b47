"""Profiling: traces and wall-clock accounting (port of
crnn_tpu/infra/profiling.py).

- ``trace(logdir)``: ``torch.profiler`` around the enclosed block, CPU ops
  and, where a card is present, CUDA kernels, written by
  ``tensorboard_trace_handler`` as one ``*.pt.trace.json`` that TensorBoard
  and Perfetto load (the counterpart of ``jax.profiler``'s trace).
- ``annotate(name)``: a named range inside a trace.
- ``Stopwatch``: a named wall-clock accumulator for per-phase timing,
  dumped as JSON next to the metrics; ``block_on`` waits for the card as
  ``jax.block_until_ready`` waits for the device.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def _tensors(x):
    """The tensors of a tensor or a (nested) tuple, list or dict of them."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _block_until_ready(x):
    """Wait until the devices of every tensor in ``x`` have finished their
    queued work; returns ``x``."""
    for dev in {t.device for t in _tensors(x) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    return x


@contextlib.contextmanager
def trace(logdir: str = "runs_torch/trace"):
    """Profile the enclosed block into ``logdir`` and yield the
    ``torch.profiler.profile``. CUDA kernels are traced whenever a card is
    present."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-range inside a trace (shows up in the timeline)."""
    with torch.profiler.record_function(name):
        yield


class Stopwatch:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                _block_until_ready(block_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k],
                "mean_ms": 1e3 * self.totals[k] / max(self.counts[k], 1)}
            for k in self.totals
        }

    def dump(self, path: str) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)
