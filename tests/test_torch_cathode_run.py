"""Cathode's data and lifecycle in the port against the JAX package: the
DSC loaders on CSVs the test writes (duplicate temperatures dropped, T ->
t, ragged curves padded with masks, the UQ replicate files), the YAML
config flow (unknown keys refused, the snapshot, the loss write-back),
``run_cathode`` writing its results dir (``metrics.jsonl``, the snapshot
with the best losses, ``p_opt.npy`` of the best train loss,
``checkpoint.pt``) and resuming from it, and the CLI with ``--device cpu``
on a data dir of short curves.
"""

import json

import numpy as np
import pytest
import torch
import yaml

from crnn_tpu.data import loaders as jl
from crnn_tpu.infra import config as jcfg
from crnn_tpu_torch.cases import cathode as tc
from crnn_tpu_torch.data import loaders as tl
from crnn_tpu_torch.infra import config as tcfg


def _write_curves(path, rates=tl.HEATING_RATES, n=12, replicates=0,
                  prefix="cath_1"):
    """CSV curves of [T_C, HRR (, replicates)], one per heating rate, with
    a duplicated temperature row each and lengths that differ."""
    rng = np.random.default_rng(0)
    for k, beta in enumerate(rates):
        temps = np.linspace(150.0, 250.0, n + k)
        temps = np.insert(temps, 3, temps[3])      # a duplicate temperature
        hrr = np.exp(-((temps - 200.0) / 20.0) ** 2) * (1.0 + 0.1 * k)
        cols = [temps, hrr] + [hrr * rng.uniform(0.9, 1.1, size=hrr.shape)
                               for _ in range(replicates)]
        np.savetxt(path / f"{prefix}_{int(beta)}.csv",
                   np.stack(cols[:2] if not replicates else
                            [cols[0]] + cols[2:], axis=1), delimiter=",")


def test_loaders_match_jax(tmp_path):
    _write_curves(tmp_path)
    one = tmp_path / "cath_1_10.csv"
    np.testing.assert_array_equal(tl.load_cathode_csv(str(one), 10.0),
                                  jl.load_cathode_csv(str(one), 10.0))
    got = tl.load_cathode_dir(str(tmp_path), 1)
    want = jl.load_cathode_dir(str(tmp_path), 1)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    # the duplicate dropped, ragged lengths padded with t_end and masked
    np.testing.assert_array_equal(got.n_points, 12 + np.arange(5))
    assert got.ts.shape == (5, 16)
    assert got.ts[0, -1] == got.ts[0, 11] and got.mask[0, 12:].sum() == 0
    np.testing.assert_allclose(got.ts[2, 0], (150.0 - 100.0) * 60.0 / 10.0)
    packed = tl.pack_curves([np.ones((3, 2)), np.ones((5, 2))], (2.0, 5.0))
    assert packed.mask.sum() == 8 and packed.ts.shape == (2, 5)


def test_replicate_loaders_match_jax(tmp_path):
    _write_curves(tmp_path, replicates=3, prefix="UNCERT_cath_1")
    got = tl.load_uncert_dir(str(tmp_path), 1)
    want = jl.load_uncert_dir(str(tmp_path), 1)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.reps.shape == (5, 16, 3)


def test_yaml_round_trip_and_write_back(tmp_path):
    """A YAML config into ``CathodeConfig`` (unknown keys refused), its
    snapshot into a results dir, and the write-back, which leaves the same
    file as the JAX package's."""
    path = tmp_path / "config.yaml"
    path.write_text("expr_name: t1\nn_epoch: 3\nadam_lr: 0.002\n"
                    "is_restart: false\n")
    cfg = tcfg.config_from_yaml(tc.CathodeConfig, str(path), device="cpu")
    assert (cfg.expr_name, cfg.n_epoch, cfg.adam_lr, cfg.device) == (
        "t1", 3, 0.002, "cpu")
    bad = tmp_path / "bad.yaml"
    bad.write_text("n_epoch: 3\nbogus: 1\n")
    with pytest.raises(ValueError, match="unknown config keys"):
        tcfg.config_from_yaml(tc.CathodeConfig, str(bad))
    snaps = [tcfg.snapshot_config(str(path), str(tmp_path / "a")),
             jcfg.snapshot_config(str(path), str(tmp_path / "b"))]
    tcfg.writeback_results(snaps[0], {"loss_train": 0.25, "loss_val": 0.5})
    jcfg.writeback_results(snaps[1], {"loss_train": 0.25, "loss_val": 0.5})
    a, b = (open(s).read() for s in snaps)
    assert a == b and yaml.safe_load(a)["loss_val"] == 0.5
    assert tcfg.load_yaml(snaps[0])["expr_name"] == "t1"


def _short_dsc():
    return tl.synthetic_dsc(heating_rates=(20.0, 15.0), t0_celsius=150.0,
                            t1_celsius=250.0, dT=10.0)


def test_run_cathode_writes_its_results_and_resumes(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("expr_name: t2\nn_epoch: 2\nn_plot: 1\nval_index: 1\n")
    cfg = tcfg.config_from_yaml(tc.CathodeConfig, str(path), device="cpu")
    out = tmp_path / "out"
    state, best = tc.run_cathode(cfg, out_dir=str(out),
                                 config_yaml=str(path), dsc=_short_dsc())
    rdir = out / "cathode" / "t2"
    rows = [json.loads(x) for x in (rdir / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["epoch"] for r in rows] == [1, 2]
    assert best["loss_train"] == min(r["loss_train"] for r in rows)
    snap = yaml.safe_load((rdir / "config.yaml").read_text())
    assert snap["loss_train"] == best["loss_train"]
    assert snap["loss_val"] == best["loss_val"] and snap["expr_name"] == "t2"
    np.testing.assert_array_equal(np.load(rdir / "p_opt.npy"), best["params"])
    assert (rdir / "checkpoint.pt").exists() and state.epoch == 2
    # a restart resumes at the checkpoint's epoch and appends to metrics
    cfg.is_restart, cfg.n_epoch = True, 1
    state2, _ = tc.run_cathode(cfg, out_dir=str(out), dsc=_short_dsc())
    assert state2.epoch == 3
    lines = (rdir / "metrics.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["epoch"] == 3 and len(lines) == 3


def test_cli_runs_on_cpu_from_a_data_dir(tmp_path):
    _write_curves(tmp_path, n=8)
    path = tmp_path / "c.yaml"
    path.write_text("expr_name: cli\nn_plot: 1\n")
    state, best = tc.main(["--config", str(path), "--epochs", "1",
                           "--data-dir", str(tmp_path), "--out",
                           str(tmp_path / "out"), "--device", "cpu"])
    assert state.epoch == 1 and np.isfinite(best["loss_train"])
    assert state.params.device == torch.device("cpu")
    assert "loss_val" in yaml.safe_load(
        (tmp_path / "out" / "cathode" / "cli" / "c.yaml").read_text())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tc.build(tc.CathodeConfig(), dsc=_short_dsc())
