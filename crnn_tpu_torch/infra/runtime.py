"""Runtime helpers: the host device and the default-dtype scope (port of
crnn_tpu/infra/runtime.py, the parts with a torch meaning).

The JAX module's ``setup_cache``, ``enable_x64`` and ``f64_device_ok`` have
no torch counterpart: the kernels' build cache is ``ops/_build.py``'s, torch
dtypes are explicit per tensor, and the H100 runs f64 natively, with no
emulated-f64 path to probe.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch


def host_device() -> torch.device:
    """The host CPU, where the f64 truth generation of a case may run."""
    return torch.device("cpu")


@contextmanager
def host_generation():
    """Create tensors on the host CPU by default inside the block (a
    ``torch.device`` default-device scope)."""
    with host_device():
        yield


@contextmanager
def x64_scope(enable: bool = True):
    """Snapshot and restore ``torch.get_default_dtype()``, torch's one
    process-global precision switch, around a block; ``enable`` sets
    float64 inside. Restores on an exception too."""
    prev = torch.get_default_dtype()
    try:
        if enable:
            torch.set_default_dtype(torch.float64)
        yield
    finally:
        torch.set_default_dtype(prev)
