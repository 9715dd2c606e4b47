"""gene-regulatory network: the GRN variant of case3 with its own CLI (port
of crnn_tpu/cases/grn.py).

The build is ``case3.build(case3.grn_config())``; this entry point adds the
long-run default of a staircase lr halving every 20 000 epochs (the
reference's manual restart with a lowered lr, gene-regulatory.jl:15,
automated).

    python -m crnn_tpu_torch.cases.grn --epochs 2 [--device cpu]
        [--mode sequential] [--restart]
"""

from __future__ import annotations

from dataclasses import replace

from crnn_tpu_torch.cases.base import DP_HELP, run_case
from crnn_tpu_torch.cases.case3 import Case3Config, build, grn_config

__all__ = ["Case3Config", "build", "grn_config"]


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=160000)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--mode", default="batch", choices=("batch", "sequential"))
    ap.add_argument("--p-cutoff", type=float, default=0.0)
    ap.add_argument("--lr-decay-steps", type=int, default=20000,
                    help="staircase lr halving period (0 = constant lr)")
    ap.add_argument("--restart", action="store_true",
                    help="resume from <out>/grn/checkpoint.pt")
    ap.add_argument("--out", default="runs_torch")
    ap.add_argument("--dp", type=int, default=0, help=DP_HELP)
    args = ap.parse_args(argv)
    cfg = replace(grn_config(), device=args.device, mode=args.mode,
                  p_cutoff=args.p_cutoff, lr_decay_steps=args.lr_decay_steps)
    return run_case(build(cfg), n_epoch=args.epochs, out_dir=args.out,
                    restart=args.restart, dp=args.dp)


if __name__ == "__main__":
    main()
