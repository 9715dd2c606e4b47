"""The port's own paths of the cathode UQ case (``run_uq``): ``chunk=2``
equals ``chunk=0``; a resume from a snapshot continues as the uninterrupted
run (the permutations included); the f32 build stays finite and moves the
ensemble (as tests/test_svgd.py holds the JAX package's); the CLI writes its
run directory; ``dp=2`` on two spawned gloo ranks equals the one-process
run. Parity with the JAX package is in tests/test_torch_uq.py.

Reduced size: 4 particles, 24 solver steps at rtol 1e-3 (the values need
not be converged to compare two runs of the port); the data as shipped.
"""

import numpy as np
import pytest
import torch

from crnn_tpu_torch.cases import cathode_uq as T

SMALL = dict(num_particles=8, maxiters=64, rtol=1e-3)


def _port(**cfg):
    """The port's own paths at a smaller size (4 particles, 24 steps)."""
    return T.CathodeUQConfig(**{**SMALL, "num_particles": 4, "maxiters": 24,
                                **cfg}, device="cpu")


def test_chunked_iterations_equal_the_plain_loop():
    cfg = _port(n_iters=3, gap=1, stepsize_decay_epochs=2)
    p0, info0 = T.run_uq(cfg, verbose=False)
    p2, info2 = T.run_uq(cfg, verbose=False, chunk=2)
    np.testing.assert_allclose(p2.numpy(), p0.numpy(), rtol=1e-13)
    for k in ("loss_train", "loss_val", "history"):
        np.testing.assert_allclose(info2[k], info0[k], rtol=1e-13)


@pytest.mark.parametrize("chunk", [0, 2])
def test_resume_continues_as_the_uninterrupted_run(tmp_path, chunk):
    cfg = _port(n_iters=3)
    p_full, info_full = T.run_uq(cfg, verbose=False)
    ckpt = str(tmp_path / "uq")
    T.run_uq(_port(n_iters=2), verbose=False, checkpoint_dir=ckpt,
             checkpoint_every=2, chunk=chunk)
    saved = np.load(tmp_path / "uq" / "losses_ckpt.npz")
    assert int(saved["it"]) == 2 and saved["loss_train"].shape == (2,)
    assert np.load(tmp_path / "uq" / "particles_ckpt.npy").shape == (4, 17)
    p_res, info_res = T.run_uq(cfg, verbose=False, checkpoint_dir=ckpt,
                               checkpoint_every=2, chunk=chunk, resume=True)
    np.testing.assert_allclose(p_res.numpy(), p_full.numpy(), rtol=1e-13)
    for k in ("loss_train", "loss_val"):
        np.testing.assert_allclose(info_res[k], info_full[k], rtol=1e-13)
    # the chunked loop snapshots at its end too, the plain one every 2
    assert int(np.load(tmp_path / "uq" / "losses_ckpt.npz")["it"]) == (
        3 if chunk else 2)


def test_f32_build_stays_finite_and_moves_the_ensemble():
    particles, step, ex = T.build_uq(T.CathodeUQConfig(
        num_particles=4, dtype="float32", device="cpu"))
    assert particles.dtype == ex["p_scales"].dtype == ex["reps"].dtype \
        == torch.float32
    new_p, loss = step(particles, 0, 2e-4)
    assert new_p.dtype == torch.float32
    assert np.isfinite(loss.item()) and bool(torch.isfinite(new_p).all())
    assert not torch.equal(new_p, particles)


def test_cli_writes_the_run_directory(tmp_path):
    T.main(["--iters", "2", "--particles", "4", "--maxiters", "32",
            "--device", "cpu", "--out", str(tmp_path)])
    out = tmp_path / "cathode_uq"
    assert np.load(out / "particles.npy").shape == (4, 17)
    assert np.load(out / "losses.npz")["loss_train"].shape == (2,)
    assert set(np.load(out / "moments.npz").files) >= {"mean", "std",
                                                       "median"}
    assert np.load(out / "history.npy").size == 0   # gap 10 > 2 iterations
    pytest.importorskip("matplotlib")
    for name in ("corr.png", "hist.png", "band_beta5.png"):
        assert (out / name).exists()


def test_run_uq_on_two_ranks_equals_one_process(monkeypatch):
    """``dp=2``: ``run_uq`` starts 2 gloo ranks, each scoring half the
    particles; the particles and losses equal the local run's."""
    from crnn_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "SPAWN_TIMEOUT_S", 300.0)
    cfg = _port(n_iters=1, maxiters=16)
    p_local, info_local = T.run_uq(cfg, verbose=False)
    p_dp, info_dp = T.run_uq(_port(n_iters=1, maxiters=16, dp=2),
                             verbose=False)
    np.testing.assert_allclose(p_dp.numpy(), p_local.numpy(), rtol=1e-12)
    for k in ("loss_train", "loss_val"):
        np.testing.assert_allclose(info_dp[k], info_local[k], rtol=1e-12)
    assert info_dp["extras"]["n_exp"] == 5
