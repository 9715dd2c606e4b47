"""Build the CUDA sources in ``ops/csrc`` with plain ``nvcc`` and load them
with ``ctypes``.

Each source has a plain C interface (no PyTorch headers), so a build takes
seconds. Libraries go into ``ops/_build/`` (ignored by git), keyed by a hash
of the source and the flags, and are built at first use. All missing
sources are compiled together, one ``nvcc`` process each. A missing
``nvcc`` or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_BUILD_TIMEOUT_S = 300


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin):"
                       " the CUDA kernels of crnn_tpu_torch cannot be built")


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` goes, keyed by source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every missing library among ``names`` in parallel; return the
    paths of all. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``<lib>.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        log = open(p.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                    tmp, log)
    failed = []
    for n, (proc, tmp, log) in procs.items():
        try:
            rc = proc.wait(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        finally:
            log.close()
        if rc == 0:
            os.replace(tmp, paths[n])
        else:
            tmp.unlink(missing_ok=True)
            failed.append(f"{n} (rc={rc}):\n"
                          + paths[n].with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if missing."""
    return ctypes.CDLL(str(build(name)[name]))
