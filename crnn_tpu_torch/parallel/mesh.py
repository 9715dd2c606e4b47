"""Process groups for data parallelism (port of crnn_tpu/parallel/mesh.py,
rewritten for ``torch.distributed``).

The JAX package shards the experiment (or particle) axis over a 1-D device
mesh in one process. Here every rank is a process of its own: ``gloo`` on
the CPU, ``nccl`` on the card, one rank per card (rank r drives
``cuda:r``). Nothing tells a process of a cluster, so the group is given
its address (``tcp://localhost:<port>``), world size and rank explicitly;
``init_distributed`` reads them from torchrun's environment instead.

``spawn`` runs a function on N ranks it starts (``torch.multiprocessing``,
start method spawn, so a rank owns its CUDA context) and returns rank 0's
result. Ranks share no closures: each rebuilds what it runs from picklable
arguments (a case's ``CaseSetup.recipe``).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import socket
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def backend_for(device: torch.device | str) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def free_port() -> int:
    """A free localhost TCP port, found by binding port 0 (concurrent test
    workers each get their own)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# seconds a collective waits for the other ranks before it fails
GROUP_TIMEOUT_S = 300.0
# seconds ``spawn`` waits for its ranks
SPAWN_TIMEOUT_S = 24 * 3600.0


def init_process_group(world_size: int, rank: int, port: int,
                       device: torch.device | str = "cpu") -> torch.device:
    """Join the ``world_size``-rank group at ``tcp://localhost:port`` as
    ``rank``. On the card rank r drives ``cuda:r`` (made the current
    device, so ``"cuda"`` means it). Returns the rank's device."""
    import datetime

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        backend_for(dev), init_method=f"tcp://localhost:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S), **kwargs)
    return dev


def init_distributed(device: torch.device | str = "cuda") -> torch.device:
    """Join the group torchrun describes (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``; ``LOCAL_RANK`` picks the card). A
    no-op without those variables or with a group already up. Returns the
    rank's device."""
    dev = torch.device(device)
    if "RANK" not in os.environ or dist.is_initialized():
        return dev
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(dev), init_method="env://")
    return dev


@contextlib.contextmanager
def process_group(world_size: int, rank: int, port: Optional[int] = None,
                  device: torch.device | str = "cpu"):
    """``init_process_group`` for the block, always destroyed after it.
    A world of 1 runs in this process (e.g. ``dp=1`` on one card)."""
    port = port or free_port()
    dev = init_process_group(world_size, rank, port, device)
    try:
        yield dev
    finally:
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def all_gather_cat(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along axis 0 in rank
    order, on every rank."""
    parts = [torch.empty_like(x) for _ in range(world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def _rank_main(rank_: int, world: int, port: int, device: str,
               fn: Callable, args: tuple, queue) -> None:
    if torch.device(device).type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    with process_group(world, rank_, port, device):
        out = fn(*args)
    if rank_ == 0:
        # as bytes: a tensor put on the queue as is would travel as a
        # shared-memory handle, which dies with this process
        queue.put(pickle.dumps(out))


def spawn(fn: Callable, world: int, args: tuple = (), device: str = "cpu"):
    """``fn(*args)`` on ``world`` new ranks (one process each, inside a
    process group on ``device``'s backend); returns rank 0's result, which
    must pickle. A rank that raises fails the call; ranks still running
    after ``SPAWN_TIMEOUT_S`` are ended and the call raises
    ``TimeoutError``."""
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(
        _rank_main, args=(world, free_port(), str(device), fn, args, queue),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    result, have = None, False
    try:
        while True:
            # drain rank 0's result first: a large one blocks its writer
            if not have and not queue.empty():
                result, have = pickle.loads(queue.get()), True
            if procs.join(timeout=0.2):
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"{world} ranks still running after {SPAWN_TIMEOUT_S} s")
        if not have and not queue.empty():
            result, have = pickle.loads(queue.get()), True
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    if not have:
        raise RuntimeError("rank 0 returned no result")
    return result


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = 0):
    """Zero-pad ``axis`` to a multiple (each rank takes an equal shard).
    Returns (padded, true_size); pair it with weights so padded lanes carry
    zero loss weight."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, x.new_zeros(shape)], dim=axis), n
