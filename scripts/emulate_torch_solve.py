"""CPU emulation of the whole-solve Rosenbrock23 kernel (kernel 3,
``crnn_tpu_torch/ops/csrc/arrh_rb23_solve.cu``): the CUDA source itself,
compiled with g++ against a small stand-in for the CUDA runtime, run on
the CPU and held against the plain version, without a card.

    python scripts/emulate_torch_solve.py [--parent DIR] [--contract]
        [--batches 1 3 30] [--shapes 6,3 1,1 8,4 | --all-shapes]

A block's threads run as ``std::thread``s. ``__shfl_sync``,
``__shfl_xor_sync`` and ``__any_sync`` meet at a barrier of their warp's
32 threads, so a warp that is not converged at a shuffle (a thread that
left the loop early) hangs here, as it may on the card; the script runs
each solve under a time limit and fails on a hang. The math library is
glibc's, not CUDA's, so the comparison with the plain version is an
estimate of the gates (f32: ys within 5e-4 of each state component's
largest value and success equal; f64: n_steps and status exact, ys within
1e-9), not a measurement. With ``--parent DIR`` (a tree unpacked from
``git archive <commit> crnn_tpu_torch``) it also runs that tree's kernel
(the one-thread-per-lane design, without the geometry arguments) and says
whether the two agree bit for bit. g++ contracts multiply-adds by its own
rules (``--contract``), which differ from nvcc's; by default it compiles
with contraction off, so that equal bits mean the same operations in the
same order. Needs g++ with C++20 (``<barrier>``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import multiprocessing as mp
import queue as queue_mod
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from crnn_tpu_torch.ops import rb23_solve_kernel as rk  # noqa: E402

CONSTS = dict(max_steps=128, t0=0.0, t1=50.0, rtol=1e-3, atol=1e-6, lb=1e-6,
              ub=10.0)
TIMEOUT_S = 600

RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::isfinite;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct uint3_ { unsigned x, y, z; };
thread_local uint3_ threadIdx, blockIdx;
uint3_ blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct Warp { std::unique_ptr<std::barrier<>> bar; uint64_t slot[32]; };
thread_local Warp* tl_warp;
thread_local int tl_lane;
thread_local std::barrier<>* tl_block;
thread_local unsigned char* tl_smem;
inline void __syncthreads() { tl_block->arrive_and_wait(); }
template <typename T> T exchange(T v, int src) {
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  tl_warp->slot[tl_lane] = bits;
  tl_warp->bar->arrive_and_wait();
  const uint64_t r = tl_warp->slot[src];
  tl_warp->bar->arrive_and_wait();
  T out;
  std::memcpy(&out, &r, sizeof(T));
  return out;
}
template <typename T> T __shfl_sync(unsigned, T v, int src, int width = 32) {
  return exchange(v, (tl_lane / width) * width + src % width);
}
template <typename T> T __shfl_xor_sync(unsigned, T v, int o, int width = 32) {
  return exchange(v, (tl_lane / width) * width + ((tl_lane % width) ^ o));
}
inline bool __any_sync(unsigned, bool p) {
  bool any = false;
  for (int i = 0; i < 32; ++i) any = any || exchange<int>(p, i);
  return any;
}
template <typename K, typename... A>
void emu_launch(K kernel, unsigned blocks, unsigned threads, A... args) {
  blockDim = {threads, 1, 1};
  for (unsigned b = 0; b < blocks; ++b) {
    std::vector<Warp> warps((threads + 31) / 32);
    for (auto& w : warps) w.bar = std::make_unique<std::barrier<>>(32);
    std::barrier<> block(threads);
    std::vector<unsigned char> smem(64 * 1024);
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {b, 0, 0};
        tl_warp = &warps[t / 32];
        tl_lane = t % 32;
        tl_block = &block;
        tl_smem = smem.data();
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""


def _emulated_source(cu: str) -> str:
    """The kernel source with the runtime header, shared memory and the
    <<<>>> launch rewritten for ``RUNTIME_H``."""
    s = cu.replace("#include <cuda_runtime.h>", '#include "runtime.h"')
    s = s.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                  "unsigned char* smem_raw = tl_smem;")
    s, n = re.subn(r"(\w+(?:<T>)?)<<<([^,]+),\s*([^,]+),\s*[^,]+,\s*"
                   r"static_cast<cudaStream_t>\(stream\)>>>\(",
                   r"emu_launch(\1, \2, \3, ", s, flags=re.S)
    if n != 1:
        raise RuntimeError(f"expected one kernel launch, found {n}")
    return s


def build(tree: Path, name: str, contract: bool, out_dir: Path) -> Path:
    """g++ build of ``tree``'s kernel source into ``out_dir/<name>.so``."""
    (out_dir / "runtime.h").write_text(RUNTIME_H)
    src = out_dir / f"{name}.cpp"
    cu = (tree / "crnn_tpu_torch/ops/csrc/arrh_rb23_solve.cu").read_text()
    src.write_text(_emulated_source(cu))
    lib = src.with_suffix(".so")
    subprocess.run(
        ["g++", "-std=c++20", "-O2", "-fPIC", "-shared", "-pthread",
         "-Wno-unknown-pragmas",
         "-mfma" if contract else "-ffp-contract=off",
         *(["-ffp-contract=fast"] if contract else []),
         "-I", str(out_dir), "-o", str(lib), str(src)], check=True)
    return lib


def run(lib: Path, grouped: bool, u0, w):
    """The emulated kernel's outputs, batch-major as the wrapper returns
    them; histories start as NaN."""
    b, ns1 = u0.shape
    ns, nr = w.w_out.shape
    k, dtype = CONSTS["max_steps"], u0.dtype
    outs = ([torch.full((k, b), math.nan, dtype=dtype) for _ in range(2)]
            + [torch.zeros((k, b), dtype=dtype)]
            + [torch.full((k, ns1, b), math.nan, dtype=dtype)
               for _ in range(4)]
            + [torch.zeros(b, dtype=torch.int32) for _ in range(2)]
            + [torch.empty_like(u0)])
    weights = [t.contiguous() for t in (w.w_in, w.w_b, w.w_out)]
    fn = getattr(ctypes.CDLL(str(lib)), "arrh_rb23_solve_" + (
        "f32" if dtype == torch.float32 else "f64"))
    ptr, dbl, i32 = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    fn.argtypes = ([ptr] * 14 + [ctypes.c_longlong, i32, i32, i32]
                   + [dbl] * 11 + [i32, i32] * grouped + [ptr])
    fn.restype = i32
    geometry = list(rk.solve_geometry(b, ns, nr, u0.element_size())[:2])
    rc = fn(u0.data_ptr(), *(t.data_ptr() for t in weights),
            *(o.data_ptr() for o in outs), b, ns, nr, k, CONSTS["t0"],
            CONSTS["t1"], CONSTS["rtol"], CONSTS["atol"], CONSTS["lb"],
            CONSTS["ub"], 32.0, 0.9, 0.2, 10.0,
            1e-12 * (CONSTS["t1"] - CONSTS["t0"]),
            *(geometry if grouped else []), None)
    if rc != 0:
        raise RuntimeError(f"emulated launch refused: cudaError {rc}")
    return rk._batch_major(outs)


def _bits(t):
    if not t.is_floating_point():
        return t
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)


def case(lib, parent_lib, batch, ns, nr, dtype) -> dict:
    """One input (``chip_smoke.py:solve_inputs``) through the emulated
    kernel (and the parent's), against the plain version at the gates."""
    u0, w = chip_smoke.solve_inputs(batch, ns, nr, dtype, device="cpu")
    out = run(lib, True, u0, w)
    ref = rk.arrh_rb23_solve_reference(u0, w.w_in, w.w_b, w.w_out, **CONSTS)
    saveat = torch.linspace(0.0, CONSTS["t1"], 50, dtype=dtype)
    ys = rk._dense_output(saveat, 0.0, u0, *out[:7])
    ys_ref = rk._dense_output(saveat, 0.0, u0, *ref[:7])
    rel = float(((ys - ys_ref).abs().amax(dim=(0, 1))
                 / ys_ref.abs().amax(dim=(0, 1))).max())
    ok = bool(torch.isfinite(ys).all()) and torch.equal(out[7] == 1,
                                                        ref[7] == 1)
    if dtype == torch.float32:
        ok = ok and rel < 5e-4
    else:
        ok = (ok and torch.equal(out[7], ref[7]) and torch.equal(out[8], ref[8])
              and rel < 1e-9)
    row = {"B": batch, "shape": [ns, nr], "dtype": str(dtype)[6:], "ok": ok,
           "err_over_largest": rel,
           "steps": [int(out[8].min()), int(out[8].max())]}
    if parent_lib is not None:
        par = run(parent_lib, False, u0, w)
        row["bitwise_equal_parent"] = all(
            torch.equal(_bits(a), _bits(b)) for a, b in zip(out, par))
    return row


def _worker(args, queue):
    queue.put(case(*args))


def run_case(ctx, args) -> dict:
    """``case(*args)`` in a fresh process, read from its queue before the
    join; a process that gives no row within ``TIMEOUT_S`` (a hang at a
    shuffle) is killed and reported."""
    queue = ctx.Queue()
    proc = ctx.Process(target=_worker, args=(args, queue))
    proc.start()
    deadline = time.monotonic() + TIMEOUT_S
    row = None
    while row is None:
        try:
            row = queue.get(timeout=1)
        except queue_mod.Empty:
            if not proc.is_alive() and queue.empty():
                row = {"ok": False, "exitcode": proc.exitcode}
            elif time.monotonic() > deadline:
                proc.kill()
                row = {"ok": False, "hang": True}
    proc.join()
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--contract", action="store_true",
                    help="let g++ contract multiply-adds (its rules, not nvcc's)")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 3, 30])
    ap.add_argument("--shapes", nargs="+", default=["6,3", "1,1", "3,2",
                                                    "7,4", "8,4"])
    ap.add_argument("--all-shapes", action="store_true",
                    help="every (ns, nr) within the caps")
    args = ap.parse_args()
    shapes = ([(ns, nr) for ns in range(1, rk._MAX_NS + 1)
               for nr in range(1, rk._MAX_NR + 1)] if args.all_shapes else
              [tuple(int(v) for v in s.split(",")) for s in args.shapes])
    ctx = mp.get_context("spawn")
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(ROOT, "new", args.contract, Path(tmp))
        parent = (build(args.parent, "parent", args.contract, Path(tmp))
                  if args.parent else None)
        for ns, nr in shapes:
            for dtype in (torch.float32, torch.float64):
                for batch in args.batches:
                    row = {"B": batch, "shape": [ns, nr],
                           "dtype": str(dtype)[6:]}
                    row.update(run_case(ctx, (lib, parent, batch, ns, nr,
                                              dtype)))
                    print(json.dumps(row), flush=True)
                    rows.append(row)
    failed = not all(row["ok"] for row in rows)
    print(json.dumps({"cases": len(rows), "all_ok": not failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
