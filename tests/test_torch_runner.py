"""The port's case runner and Trainer chunking (crnn_tpu_torch/cases/base.py,
crnn_tpu_torch/train/loop.py, crnn_tpu_torch/infra/): checkpoints, restart,
the best-val params, figures, metrics, k-epoch chunks, fit and the CLIs.
The counterparts of tests/test_cases.py::test_checkpoint_roundtrip and of
tests/test_fused_epochs.py. Everything runs on the CPU at a reduced size."""

import functools
import json

import numpy as np
import pytest
import torch

from crnn_tpu_torch.cases import base, case1, case2, robertson
from crnn_tpu_torch.infra.checkpoint import load_checkpoint, save_checkpoint
from crnn_tpu_torch.infra.metrics import MetricsLogger
from crnn_tpu_torch.ode import ESDIRK, Rosenbrock23, Tsit5, get_solver
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.optimizers import adamw_like

SMALL_CASE2 = dict(device="cpu", n_exp_train=3, n_exp_test=1, datasize=10,
                   max_steps=32)


def _rows(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_metrics_logger_appends_jsonl_with_ts(tmp_path):
    path = tmp_path / "m" / "metrics.jsonl"
    with MetricsLogger(str(path)) as log:
        log.log(epoch=1, loss=0.5)
        log.log(epoch=2, loss=0.25)
    with MetricsLogger(str(path)) as log:
        log.log(epoch=3, loss=0.125)
    rows = _rows(path)
    assert [r["epoch"] for r in rows] == [1, 2, 3]
    assert [r["loss"] for r in rows] == [0.5, 0.25, 0.125]
    assert all(isinstance(r["ts"], float) for r in rows)


def test_checkpoint_roundtrip_is_bitwise(tmp_path):
    """A TrainState after one epoch (params, Adam state, epoch and the
    generator's state) and a BestState survive torch.save/torch.load
    (weights_only) exactly, and training continues bit for bit."""
    setup = case1.build(case1.Case1Config(
        device="cpu", n_exp_train=3, n_exp_test=1, datasize=10, max_steps=64))
    trainer = setup.trainer
    state, _ = trainer.epoch(trainer.init(setup.init_params))
    best = trainer.init_best(state)._replace(loss_val=np.float32(0.1),
                                             loss_train=np.float32(0.2),
                                             n_skipped=3)
    save_checkpoint(str(tmp_path / "ck.pt"), state)
    save_checkpoint(str(tmp_path / "best.pt"), best)
    raw = torch.load(tmp_path / "ck.pt", weights_only=True)
    assert raw["kind"] == "TrainState" and raw["count"] == 1
    restored = load_checkpoint(str(tmp_path / "ck.pt"),
                               trainer.init(setup.init_params, seed=5))
    assert torch.equal(restored.params, state.params)
    assert torch.equal(restored.opt_state.mu, state.opt_state.mu)
    assert torch.equal(restored.opt_state.nu, state.opt_state.nu)
    assert restored.opt_state.count == 1 and restored.epoch == 1
    assert torch.equal(restored.gen.get_state(), state.gen.get_state())
    b = load_checkpoint(str(tmp_path / "best.pt"), trainer.init_best(state))
    assert isinstance(b.loss_val, np.float32) and b.loss_val == best.loss_val
    assert b.loss_train == best.loss_train and b.n_skipped == 3
    assert torch.equal(b.params, best.params)
    with pytest.raises(ValueError, match="BestState"):
        load_checkpoint(str(tmp_path / "best.pt"), state)
    s1, m1 = trainer.epoch(state)
    s2, m2 = trainer.epoch(restored)
    assert torch.equal(s1.params, s2.params)
    assert torch.equal(m1.loss_exp, m2.loss_exp)


def _quad_trainer(nan_above=None, horizon_range=None, mode="batch"):
    """A toy Trainer (the losses of tests/test_fused_epochs.py): a quadratic
    per experiment with a mask-dependent factor, or a loss that turns NaN
    once params[0] passes ``nan_above``."""
    tgt = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)

    def loss(p, idxs, masks):
        if nan_above is not None:
            v = torch.where(p[0] <= nan_above, (p[0] - 10.0) ** 2,
                            torch.full_like(p[0], float("nan")))
            return v * torch.ones(idxs.shape[0], dtype=p.dtype)
        return ((p[None, :] - tgt[idxs, None]) ** 2).sum(-1) * masks.mean(-1)

    return Trainer(loss_i_exp=loss, optimizer=adamw_like(0.1),
                   n_exp_train=2, n_exp=3, n_save=4, mode=mode,
                   horizon_range=horizon_range)


@pytest.mark.parametrize("kind", ["plain", "guarded_nan_mid_chunk",
                                  "sequential"])
def test_k_epoch_chunk_equals_k_single_epochs(kind):
    """epochs_fn(k) / guarded_epochs_fn(k) give the states, best carry and
    per-epoch metrics (stacked (k,)) of k single epochs; a NaN epoch inside
    a chunk is discarded as a single guarded epoch discards it."""
    k = 5
    if kind == "guarded_nan_mid_chunk":
        trainer = _quad_trainer(nan_above=0.25)
    else:
        trainer = _quad_trainer(horizon_range=(2, 4),
                                mode="batch" if kind == "plain"
                                else "sequential")
    p0 = torch.zeros(3, dtype=torch.float64)
    if kind == "guarded_nan_mid_chunk":
        s_ref = trainer.init(p0, seed=7)
        b_ref = trainer.init_best(s_ref)
        ms_ref = []
        for _ in range(k):
            s_ref, b_ref, m = trainer.guarded_epoch_fn()(s_ref, b_ref)
            ms_ref.append(m)
        s, b = trainer.init(p0, seed=7), None
        s, b, ms = trainer.guarded_epochs_fn(k)(s, trainer.init_best(s))
        assert b.n_skipped == b_ref.n_skipped == 3
        assert b.loss_val == b_ref.loss_val
        assert torch.equal(b.params, b_ref.params)
        assert int((~torch.isfinite(ms.loss_train)).sum()) == 3
    else:
        s_ref = trainer.init(p0, seed=7)
        ms_ref = []
        for _ in range(k):
            s_ref, m = trainer.epoch_fn()(s_ref)
            ms_ref.append(m)
        s, ms = trainer.epochs_fn(k)(trainer.init(p0, seed=7))
    assert ms.loss_train.shape == (k,) and ms.loss_exp.shape == (k, 3)
    assert torch.equal(s.params, s_ref.params) and s.epoch == s_ref.epoch == k
    assert s.opt_state.count == s_ref.opt_state.count
    for name in ("loss_train", "loss_val", "grad_norm"):
        torch.testing.assert_close(
            getattr(ms, name), torch.stack([getattr(m, name) for m in ms_ref]),
            rtol=0, atol=0, equal_nan=True)


def test_fit_history_remainder_and_callbacks():
    """fit in chunks of 3 (3 + 3 + 1) equals fit one epoch at a time, and
    the callbacks fire at chunk boundaries and at the end."""
    trainer = _quad_trainer(horizon_range=(2, 4))
    p0 = torch.zeros(3, dtype=torch.float64)
    calls_a, calls_b = [], []
    s_a, h_a = trainer.fit(trainer.init(p0, seed=3), 7,
                           callback=lambda e, s, m: calls_a.append(e),
                           callback_every=2)
    s_b, h_b = trainer.fit(trainer.init(p0, seed=3), 7,
                           callback=lambda e, s, m: calls_b.append(
                               (e, float(m.loss_train))),
                           callback_every=3, epochs_per_dispatch=3)
    assert len(h_b["loss_train"]) == 7 and h_b == h_a
    assert torch.equal(s_a.params, s_b.params) and s_b.epoch == 7
    assert calls_a == [1, 3, 5]
    assert [e for e, _ in calls_b] == [2, 5, 6]
    assert calls_b[1][1] == h_b["loss_train"][5]


def test_restart_continues_the_run_bitwise(tmp_path):
    """case2 for 2 epochs, then --restart for 2 more in one 2-epoch chunk,
    equals 4 epochs uninterrupted: the same per-epoch losses bit for bit,
    a metrics.jsonl with epochs 1-4, the best carry restored from best.pt
    and the same p_opt.npy."""
    setup = case2.build(case2.Case2Config(**SMALL_CASE2))
    _, h4 = base.run_case(setup, 4, out_dir=str(tmp_path / "a"), log_every=0)
    base.run_case(setup, 2, out_dir=str(tmp_path / "b"), log_every=0)
    s, h2 = base.run_case(setup, 2, out_dir=str(tmp_path / "b"), log_every=0,
                          restart=True, epochs_per_dispatch=2)
    rows_a = _rows(tmp_path / "a" / "case2" / "metrics.jsonl")
    rows_b = _rows(tmp_path / "b" / "case2" / "metrics.jsonl")
    assert [r["epoch"] for r in rows_b] == [1, 2, 3, 4] and s.epoch == 4
    for name in ("loss_train", "loss_val", "grad_norm"):
        assert [r[name] for r in rows_b] == [r[name] for r in rows_a]
    assert h2["loss_train"] == h4["loss_train"][2:]
    assert h2["best_val"] == h4["best_val"] == np.float32(
        min(r["loss_val"] for r in rows_a))
    np.testing.assert_array_equal(
        np.load(tmp_path / "b" / "case2" / "p_opt.npy"),
        np.load(tmp_path / "a" / "case2" / "p_opt.npy"))


def test_best_carry_survives_a_worse_continuation(tmp_path):
    """A continuation whose every val loss is worse than the first
    segment's best keeps that best in best.pt and p_opt.npy."""
    vals = iter([0.5, 0.1, 0.4, 0.3])

    def loss_eval(p, idxs, masks):
        return torch.tensor([0.2, next(vals)], dtype=p.dtype)

    trainer = Trainer(loss_batch=lambda p, i, m: (p ** 2).sum() * torch.ones(
        i.shape[0], dtype=p.dtype), loss_batch_eval=loss_eval,
        optimizer=adamw_like(0.1), n_exp_train=1, n_exp=2, n_save=3)
    setup = base.CaseSetup(
        name="toy", trainer=trainer,
        init_params=torch.ones(2, dtype=torch.float64), predict=None,
        weights_fn=lambda p: None, dataset=None)
    run = functools.partial(base.run_case, setup, out_dir=str(tmp_path),
                            log_every=0, n_plot=10 ** 6)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(base, "display_weights", lambda *a: "")
        mp.setattr(base, "have_matplotlib", lambda: False)
        _, h1 = run(2)
        p_first = np.load(tmp_path / "toy" / "p_opt.npy")
        _, h2 = run(2, restart=True)
    assert h1["best_val"] == h2["best_val"] == np.float32(0.1)
    np.testing.assert_array_equal(np.load(tmp_path / "toy" / "p_opt.npy"),
                                  p_first)


def test_figures_and_p_opt_are_written(tmp_path):
    pytest.importorskip("matplotlib")
    setup = robertson.build(robertson.RobertsonConfig(
        device="cpu", n_exp_train=2, n_exp_val=1, datasize=8, batchsize=6,
        max_steps=48))
    base.run_case(setup, 2, out_dir=str(tmp_path), log_every=0, n_plot=1)
    run_dir = tmp_path / "robertson"
    figs = sorted(p.name for p in (run_dir / "figs").iterdir())
    assert "loss.png" in figs and any(f.startswith("i_exp_") for f in figs)
    p_opt = np.load(run_dir / "p_opt.npy")
    assert p_opt.shape == tuple(setup.init_params.shape)
    assert (run_dir / "checkpoint.pt").exists() and (run_dir / "best.pt").exists()


def test_without_matplotlib_figures_are_skipped(tmp_path, capsys,
                                                monkeypatch):
    monkeypatch.setattr(base, "have_matplotlib", lambda: False)
    setup = case2.build(case2.Case2Config(**SMALL_CASE2))
    base.run_case(setup, 1, out_dir=str(tmp_path), log_every=0)
    out = capsys.readouterr().out
    assert out.count("figures skipped") == 1
    run_dir = tmp_path / "case2"
    assert not any((run_dir / "figs").glob("*.png"))
    for name in ("checkpoint.pt", "best.pt", "p_opt.npy", "metrics.jsonl"):
        assert (run_dir / name).exists()


@pytest.mark.parametrize("name", ["case1", "case2", "case2_chunks",
                                  "robertson"])
def test_cli_sequential_and_restart_on_cpu(tmp_path, monkeypatch, name):
    """Each CLI with --device cpu --mode sequential, then --restart (and
    case2's --epochs-per-dispatch 2), at a reduced size: exit without an
    error, one metrics line per epoch, epochs continuing across the
    restart, and the checkpoint, best and p_opt files."""
    mod = {"case1": case1, "robertson": robertson}.get(name, case2)
    if mod is case1:
        small = dict(n_exp_train=2, n_exp_test=1, datasize=8, max_steps=32)
        monkeypatch.setattr(mod, "Case1Config",
                            functools.partial(mod.Case1Config, **small))
    elif mod is robertson:
        small = dict(n_exp_train=2, n_exp_val=1, datasize=8, batchsize=6,
                     max_steps=48)
        monkeypatch.setattr(mod, "RobertsonConfig",
                            functools.partial(mod.RobertsonConfig, **small))
    else:
        small = {k: v for k, v in SMALL_CASE2.items() if k != "device"}
        small["n_exp_train"] = 2
        monkeypatch.setattr(mod, "Case2Config",
                            functools.partial(mod.Case2Config, **small))
    monkeypatch.setattr(base, "have_matplotlib", lambda: False)
    args = ["--device", "cpu", "--mode", "sequential", "--out", str(tmp_path)]
    state, _ = mod.main(["--epochs", "1", *args])
    assert state.opt_state.count == 2        # one update per experiment
    more = ["--epochs-per-dispatch", "2"] if name == "case2_chunks" else []
    state, hist = mod.main(["--epochs", "2", "--restart", *args, *more])
    run_dir = tmp_path / mod.__name__.rsplit(".", 1)[1]
    assert [r["epoch"] for r in _rows(run_dir / "metrics.jsonl")] == [1, 2, 3]
    assert state.epoch == 3 and state.opt_state.count == 6
    assert all(np.isfinite(hist["loss_train"]))
    for f in ("checkpoint.pt", "best.pt", "p_opt.npy"):
        assert (run_dir / f).exists()


def test_get_solver_registry():
    assert isinstance(get_solver("tsit5"), Tsit5)
    assert isinstance(get_solver("rosenbrock23"), Rosenbrock23)
    assert isinstance(get_solver("trbdf2"), ESDIRK)
    # case2 builds its AutoSwitch around the closed-form Rosenbrock23, as
    # crnn_tpu/cases/case2.py:123-124 does
    setup = case2.build(case2.Case2Config(**SMALL_CASE2,
                                          solver="auto_tsit5_rosenbrock23"))
    assert setup.trainer.loss_i_exp is not None
    with pytest.raises(ValueError, match="unknown solver"):
        get_solver("euler")
