"""crnn_tpu_torch/cli.py, the ``crnn-tpu-torch`` console entry point,
against crnn_tpu/cli.py: the same cases, ``list``, an unknown case, and one
real dispatch on the CPU."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

from crnn_tpu import cli as jcli
from crnn_tpu_torch import cli

ROOT = Path(__file__).resolve().parent.parent


def test_cases_equal_jax():
    assert cli.CASES == jcli.CASES


def test_every_case_module_has_main():
    for case in cli.CASES:
        module = importlib.import_module(f"crnn_tpu_torch.cases.{case}")
        assert callable(getattr(module, "main", None)), case


def test_list_and_unknown_case(capsys):
    assert cli.main(["list"]) == 0
    assert "cases: " + " ".join(cli.CASES) in capsys.readouterr().out
    assert cli.main([]) == 0
    assert cli.main(["-h"]) == 0
    assert cli.main(["case9"]) == 2
    assert "unknown case 'case9'" in capsys.readouterr().err
    run = subprocess.run([sys.executable, "-m", "crnn_tpu_torch.cli", "list"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert run.returncode == 0 and "cathode_uq" in run.stdout


def test_dispatch_runs_a_case_on_the_cpu(tmp_path):
    argv = list(sys.argv)
    assert cli.main(["case1_rev", "--epochs", "1", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    assert sys.argv == argv
    lines = (tmp_path / "case1_rev" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["epoch"] == 1
