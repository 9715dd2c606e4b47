"""``run_case(dp=N)`` on ``torch.distributed`` (crnn_tpu_torch/parallel/)
against the port's batch trainer and against the JAX package's
``run_case(dp=2)`` on its 8-device CPU mesh (tests/conftest.py).

Each spawned run starts 2 gloo ranks (``parallel/mesh.py:spawn``) that
rebuild the case from its recipe; each joins within ``SPAWN_TIMEOUT_S``.

- one dp=2 epoch of per-lane case2 (f64, 4 + 2 experiments, 10 save
  points) equals one batch epoch of the port at rtol 1e-12 (the same
  arithmetic up to summation order) and JAX's dp=2 epoch on the same data
  and initial params at rtol 1e-9;
- dp=1 runs in this process on a world of one, with the same result;
- an experiment count that does not divide 2 (5 training experiments):
  the padded lane adds nothing (case1 against its batch epoch; case2,
  whose features are singular at u0=0, keeps finite gradients);
- the refusals: sequential mode, no ``loss_on_data``, no recipe, a dp that
  is not the size of the process group already up;
- a restart keeps the best-val carry (``best.pt``, ``p_opt.npy``);
- cathode's ``loss_on_data`` equals its trainer's loss; ``--dp`` exists on
  every port CLI whose JAX twin has it.
"""

import importlib

import numpy as np
import pytest
import torch

from crnn_tpu_torch import convert
from crnn_tpu_torch.cases.base import run_case
from crnn_tpu_torch.parallel import mesh

SPAWN_TIMEOUT_S = 300.0
CASE2 = dict(n_exp_train=4, n_exp_test=2, datasize=10, max_steps=96,
             solver="rosenbrock23", batch_major=False, dtype="float64")


@pytest.fixture(autouse=True)
def _spawn_timeout(monkeypatch):
    monkeypatch.setattr(mesh, "SPAWN_TIMEOUT_S", SPAWN_TIMEOUT_S)


def _case2(**kw):
    from crnn_tpu_torch.cases import case2

    return case2.build(case2.Case2Config(**{**CASE2, **kw}, device="cpu"))


def _batch_epoch(setup):
    state = setup.trainer.init(setup.init_params)
    return setup.trainer.epoch(state)


def test_dp2_epoch_matches_the_batch_epoch_and_dp1(tmp_path):
    state1, m = _batch_epoch(_case2())
    state, hist = run_case(_case2(), n_epoch=1, out_dir=str(tmp_path / "a"),
                           dp=2, log_every=0, n_plot=10)
    np.testing.assert_allclose(hist["loss_train"], [m.loss_train.item()],
                               rtol=1e-12)
    np.testing.assert_allclose(hist["loss_val"], [m.loss_val.item()],
                               rtol=1e-12)
    np.testing.assert_allclose(hist["grad_norm"], [m.grad_norm.item()],
                               rtol=1e-12)
    np.testing.assert_allclose(state.params.numpy(), state1.params.numpy(),
                               rtol=1e-12)
    assert state.epoch == 1 and state.opt_state.count == 1
    rows = (tmp_path / "a" / "case2" / "metrics.jsonl").read_text()
    assert len(rows.splitlines()) == 1
    assert (tmp_path / "a" / "case2" / "p_opt.npy").exists()
    # dp=1: a world of one in this process
    state_1, hist_1 = run_case(_case2(), n_epoch=1,
                               out_dir=str(tmp_path / "b"), dp=1,
                               log_every=0, n_plot=10)
    np.testing.assert_allclose(state_1.params.numpy(), state1.params.numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(hist_1["loss_val"], hist["loss_val"],
                               rtol=1e-12)


def test_dp2_epoch_matches_jax_dp2(tmp_path):
    from crnn_tpu.cases import case2 as jcase2
    from crnn_tpu.cases.base import run_case as j_run_case

    js = jcase2.build(jcase2.Case2Config(**CASE2))
    j_state, j_hist = j_run_case(js, n_epoch=2, out_dir=str(tmp_path / "j"),
                                 dp=2, log_every=0, n_plot=10)
    js0 = jcase2.build(jcase2.Case2Config(**CASE2))
    ds = js0.dataset
    dataset = convert.dataset_from_jax(
        *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean, ds.ts,
                                  ds.yscale)),
        success=np.asarray(ds.success), device="cpu")
    from crnn_tpu_torch.cases import case2

    setup = case2.build(case2.Case2Config(**CASE2, device="cpu"),
                        dataset=dataset)
    setup.init_params = convert.params_from_jax(np.asarray(js0.init_params),
                                                device="cpu")
    state, hist = run_case(setup, n_epoch=2, out_dir=str(tmp_path / "t"),
                           dp=2, log_every=0, n_plot=10)
    for k in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(hist[k], j_hist[k], rtol=1e-9)
    np.testing.assert_allclose(state.params.numpy(),
                               np.asarray(j_state.params), rtol=1e-9)
    np.testing.assert_allclose(float(hist["best_val"]),
                               float(j_hist["best_val"]), rtol=1e-6)


def test_dp_pads_an_indivisible_experiment_count(tmp_path):
    from crnn_tpu_torch.cases import case1

    cfg = case1.Case1Config(n_exp_train=5, n_exp_test=2, datasize=12,
                            max_steps=96, device="cpu", dtype="float64")
    _, m = _batch_epoch(case1.build(cfg))
    _, hist = run_case(case1.build(cfg), n_epoch=1,
                       out_dir=str(tmp_path / "c1"), dp=2, log_every=0,
                       n_plot=10)
    np.testing.assert_allclose(hist["loss_train"], [m.loss_train.item()],
                               rtol=1e-12)
    np.testing.assert_allclose(hist["grad_norm"], [m.grad_norm.item()],
                               rtol=1e-12)
    # case2's features are singular at u0 = 0: the padded lane repeats the
    # last experiment, so the gradient stays finite
    _, hist = run_case(_case2(n_exp_train=5, max_steps=64, dtype="float32"),
                       n_epoch=2, out_dir=str(tmp_path / "c2"), dp=2,
                       log_every=0, n_plot=10)
    assert np.isfinite(hist["loss_train"]).all()
    assert np.isfinite(hist["grad_norm"]).all() and hist["n_skipped"] == 0


def test_dp_refusals(tmp_path):
    from crnn_tpu_torch.cases import case1

    small = dict(n_exp_train=2, n_exp_test=1, datasize=8, device="cpu")
    with pytest.raises(ValueError, match="sequential"):
        run_case(case1.build(case1.Case1Config(**small, mode="sequential")),
                 n_epoch=1, out_dir=str(tmp_path), dp=2)
    setup = case1.build(case1.Case1Config(**small))
    setup.loss_on_data = None
    with pytest.raises(ValueError, match="loss_on_data"):
        run_case(setup, n_epoch=1, out_dir=str(tmp_path), dp=2)
    setup = case1.build(case1.Case1Config(**small))
    setup.recipe = None
    with pytest.raises(ValueError, match="recipe"):
        run_case(setup, n_epoch=1, out_dir=str(tmp_path), dp=2)
    with pytest.raises(ValueError, match="one rank per card"):
        run_case(case1.build(case1.Case1Config(**small)), n_epoch=1,
                 out_dir=str(tmp_path), dp=-1)
    with mesh.process_group(1, 0):
        with pytest.raises(ValueError, match="process group of 2 ranks"):
            run_case(case1.build(case1.Case1Config(**small)), n_epoch=1,
                     out_dir=str(tmp_path), dp=2)
    with pytest.warns(UserWarning, match="reverse-mode"):
        from crnn_tpu_torch.parallel.dp_runner import _check

        fwd = case1.build(case1.Case1Config(**small))
        fwd.trainer.grad_mode = "fwd"
        _check(fwd)


def test_dp_restart_preserves_the_best_val_carry(tmp_path):
    from crnn_tpu_torch.cases import case1

    cfg = dict(n_exp_train=4, n_exp_test=2, datasize=8, max_steps=64,
               device="cpu")
    _, h1 = run_case(case1.build(case1.Case1Config(lr=1e-3, **cfg)),
                     n_epoch=2, out_dir=str(tmp_path), dp=2, log_every=0,
                     n_plot=10)
    p1 = np.load(tmp_path / "case1" / "p_opt.npy").copy()
    state, h2 = run_case(case1.build(case1.Case1Config(lr=50.0, **cfg)),
                         n_epoch=2, out_dir=str(tmp_path), dp=2,
                         log_every=0, n_plot=10, restart=True)
    assert state.epoch == 4
    assert h2["best_val"] <= h1["best_val"]
    if h2["best_val"] == h1["best_val"]:
        np.testing.assert_array_equal(
            np.load(tmp_path / "case1" / "p_opt.npy"), p1)
    epochs = [int(line.split('"epoch": ')[1].split(",")[0]) for line in
              (tmp_path / "case1" / "metrics.jsonl").read_text().splitlines()]
    assert epochs == [1, 2, 3, 4]


def test_cathode_loss_on_data_is_its_trainer_loss():
    from crnn_tpu_torch.cases import cathode
    from crnn_tpu_torch.data.loaders import synthetic_dsc

    dsc = synthetic_dsc(heating_rates=(20.0, 15.0), t0_celsius=150.0,
                        t1_celsius=250.0, dT=10.0)
    s = cathode.build(cathode.CathodeConfig(val_index=1, maxiters=96,
                                            device="cpu"), dsc=dsc)
    idx = torch.arange(2)
    masks = torch.ones((2, s.trainer.n_save), dtype=torch.float64)
    masks[0, 5:] = 0.0
    with torch.no_grad():
        want = s.trainer.loss_i_exp(s.init_params, idx, masks)
        got = s.loss_on_data(s.init_params, s.dataset.u0[idx],
                             s.dataset.ys[idx], masks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", [
    "case1", "case1_rev", "case2", "case3", "cathode", "cathode_uq", "grn",
    "hychem", "robertson", "robertson_qssa", "yeast"])
def test_dp_flag_on_every_cli_whose_jax_twin_has_it(name, capsys):
    jax_src = importlib.util.find_spec(f"crnn_tpu.cases.{name}").origin
    assert '"--dp"' in open(jax_src).read()
    mod = importlib.import_module(f"crnn_tpu_torch.cases.{name}")
    with pytest.raises(SystemExit):
        mod.main(["--help"])
    assert "--dp" in capsys.readouterr().out


def test_pad_to_multiple_matches_jax():
    from crnn_tpu.parallel.mesh import pad_to_multiple as j_pad

    x = np.arange(15.0).reshape(5, 3)
    for multiple, axis in ((2, 0), (4, 0), (5, 0), (2, 1)):
        got, n = mesh.pad_to_multiple(torch.from_numpy(x), multiple, axis)
        want, j_n = j_pad(x, multiple, axis)
        assert n == j_n
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_distributed_from_torchrun_variables(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("RANK", raising=False)
    assert mesh.init_distributed("cpu") == torch.device("cpu")
    assert not dist.is_initialized()            # no variables: a no-op
    for k, v in (("RANK", "0"), ("WORLD_SIZE", "1"),
                 ("MASTER_ADDR", "localhost"),
                 ("MASTER_PORT", str(mesh.free_port()))):
        monkeypatch.setenv(k, v)
    mesh.init_distributed("cpu")
    try:
        assert dist.get_backend() == "gloo" and mesh.world_size() == 1
        assert mesh.all_gather_cat(torch.ones(2)).tolist() == [1.0, 1.0]
    finally:
        dist.destroy_process_group()
