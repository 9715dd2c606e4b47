"""One console entry point for every case (port of crnn_tpu/cli.py):

    crnn-tpu-torch <case> [case args...]
    python -m crnn_tpu_torch.cli <case> [case args...]

    crnn-tpu-torch case2 --epochs 10000 --mode batch
    crnn-tpu-torch robertson --epochs 20000 --device cpu
    crnn-tpu-torch list

It runs ``crnn_tpu_torch.cases.<case>`` as ``__main__`` with the remaining
arguments. Every case runs on the CUDA card unless ``--device cpu`` is
passed on to it.
"""

from __future__ import annotations

import runpy
import sys

CASES = (
    "case1",
    "case1_rev",
    "case2",
    "case3",
    "grn",
    "robertson",
    "robertson_qssa",
    "yeast",
    "hychem",
    "cathode",
    "cathode_uq",
)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "list"):
        print(__doc__)
        print("cases: " + " ".join(CASES))
        return 0
    case, rest = argv[0], argv[1:]
    if case not in CASES:
        print(f"unknown case {case!r}; available: {' '.join(CASES)}",
              file=sys.stderr)
        return 2
    saved = sys.argv
    sys.argv = [f"crnn-tpu-torch {case}"] + rest
    try:
        runpy.run_module(f"crnn_tpu_torch.cases.{case}", run_name="__main__")
    finally:
        sys.argv = saved
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
