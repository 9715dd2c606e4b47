"""Device rule of crnn_tpu_torch: entry points run on 'cuda' unless the
caller passes device='cpu', and asking for 'cuda' without a card raises
(nothing falls back to the CPU). Also a short end-to-end CPU run of the
case2 CLI and run_case."""

import json

import numpy as np
import pytest
import torch

import crnn_tpu_torch
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import case1, case2, robertson
from crnn_tpu_torch.transforms.p2vec import (init_params_case1,
                                             init_params_case2,
                                             init_params_robertson)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card error cannot show")


def test_resolve_device():
    assert crnn_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        crnn_tpu_torch.resolve_device("meta")


@pytest.mark.parametrize("entry", [
    lambda: crnn_tpu_torch.resolve_device("cuda"),
    lambda: case2.build(case2.Case2Config()),
    lambda: case2.main(["--epochs", "1"]),
    lambda: init_params_case2(torch.Generator(), 6, 3),
    lambda: convert.params_from_jax(np.zeros(3)),
    lambda: convert.opt_state_from_jax(np.zeros(3), np.zeros(3), 0),
    lambda: convert.dataset_from_jax(*[np.zeros((2, 3))] * 5),
    lambda: case1.build(case1.Case1Config()),
    lambda: case1.main(["--epochs", "1"]),
    lambda: init_params_case1(torch.Generator(), 5, 4),
    lambda: robertson.build(robertson.RobertsonConfig()),
    lambda: robertson.main(["--epochs", "1"]),
    lambda: init_params_robertson(torch.Generator(), 3, 6),
], ids=["resolve_device", "build", "cli", "init_params", "params_from_jax",
        "opt_state_from_jax", "dataset_from_jax", "case1_build", "case1_cli",
        "case1_init_params", "robertson_build", "robertson_cli",
        "robertson_init_params"])
def test_cuda_default_raises_without_a_card(no_cuda, entry):
    with pytest.raises(RuntimeError, match="cuda"):
        entry()


def test_dense_jac_mode_waits_for_its_kernel():
    """The dense value+Jacobian kernel is ported: jac_mode='dense' builds and
    trains on the CPU (its plain version), and an unknown mode raises."""
    cfg = case2.Case2Config(device="cpu", jac_mode="dense", n_exp_train=2,
                            n_exp_test=1, datasize=8, max_steps=16)
    setup = case2.build(cfg)
    state, m = setup.trainer.epoch(setup.trainer.init(setup.init_params))
    assert state.epoch == 1
    assert bool(torch.isfinite(m.loss_exp).all() & torch.isfinite(m.grad_norm))
    with pytest.raises(ValueError, match="jac_mode"):
        case2.build(case2.Case2Config(device="cpu", jac_mode="banded"))


def test_case2_cli_on_cpu_writes_metrics(tmp_path):
    """Two epochs of the case2_missing + pruning variant through the CLI at
    a reduced size: finite losses, one metrics line per epoch."""
    cfg = case2.Case2Config(device="cpu", n_exp_train=3, n_exp_test=1,
                            datasize=10, max_steps=24, i_obs=(0, 1, 3, 4, 5),
                            missing_u0=True, p_cutoff=0.01)
    setup = case2.build(cfg)
    assert setup.dataset.ys.shape == (4, 10, 6)
    assert setup.dataset.u0[0, 2].item() == pytest.approx(0.2)  # missing u0
    # the params come from their own stream: a passed-in dataset keeps them
    again = case2.build(cfg, dataset=setup.dataset)
    assert torch.equal(again.init_params, setup.init_params)
    state, hist = case2.run_case(setup, n_epoch=2, out_dir=str(tmp_path),
                                 log_every=0)
    rows = [json.loads(line) for line in
            (tmp_path / "case2" / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2] and state.epoch == 2
    assert all(np.isfinite(r["loss_train"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert np.isfinite(hist["best_val"]) and hist["n_skipped"] == 0


@pytest.mark.parametrize("name", ["case1", "robertson"])
def test_case1_and_robertson_run_on_cpu_and_write_metrics(tmp_path, name):
    """Two guarded epochs of each per-lane case at a reduced size on the
    CPU: the truth generated by the port, finite losses, one metrics line
    per epoch, a non-increasing best val loss kept in float32."""
    if name == "case1":
        setup = case1.build(case1.Case1Config(
            device="cpu", n_exp_train=3, n_exp_test=1, datasize=12,
            max_steps=32))
        shape = (4, 12, 5)
    else:
        setup = robertson.build(robertson.RobertsonConfig(
            device="cpu", n_exp_train=3, n_exp_val=1, datasize=10,
            batchsize=8, max_steps=48))
        shape = (4, 10, 3)
        u0 = setup.dataset.u0
        assert torch.all(u0[:, 1] == 1e-8) and setup.dataset.ys.dtype == \
            torch.float64
        lhc = torch.sort(u0[:, 0] - 0.5).values   # a Latin hypercube / n
        torch.testing.assert_close(lhc, torch.arange(1, 5,
                                                     dtype=torch.float64) / 4)
    assert setup.dataset.ys.shape == shape and bool(setup.dataset.success.all())
    state, hist = case1.run_case(setup, n_epoch=2, out_dir=str(tmp_path),
                                 log_every=0)
    rows = [json.loads(line) for line in
            (tmp_path / name / "metrics.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2] and state.epoch == 2
    assert all(np.isfinite(r["loss_train"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    assert isinstance(hist["best_val"], np.float32) and hist["n_skipped"] == 0
    assert hist["best_val"] == np.float32(min(r["loss_val"] for r in rows))
