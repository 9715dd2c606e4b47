"""crnn_tpu_torch/uq (SVGD, posterior analysis) and the sharded SVGD step
against crnn_tpu/uq on the same numpy inputs.

- ``median`` and ``rbf_kernel``'s bandwidth: ``jnp.median`` averages the two
  middle values of an even count (``torch.median`` returns the lower one);
  the kernel at n=4 and n=100 (an even count of pairwise distances) in f64,
  bandwidth and both outputs at rtol 1e-12;
- ``svgd_step`` / ``make_svgd_step`` at 1e-12; the failed-solve-tolerant
  update of the UQ case against its JAX expression;
- ``posterior_moments`` and ``kendall_correlation`` exactly (both numpy),
  ``ParticleHistory``'s cadence and copies, the figures written;
- the sharded step on 2 gloo ranks against the local step (the cathode UQ
  likelihood, 8 particles, f64, 1e-12) and the "divide" refusal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.uq import posterior as jpost
from crnn_tpu.uq import svgd as jsvgd
from crnn_tpu_torch.parallel import mesh
from crnn_tpu_torch.uq import posterior as tpost
from crnn_tpu_torch.uq import svgd as tsvgd

SPAWN_TIMEOUT_S = 300.0


def _particles(n, d=17, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d))


@pytest.mark.parametrize("shape", [(4,), (5,), (4, 4), (3, 3), (100, 100)])
def test_median_is_jnp_median(shape):
    x = np.random.default_rng(1).normal(size=shape)
    got = tsvgd.median(torch.from_numpy(x)).item()
    assert got == float(jnp.median(jnp.asarray(x)))
    if x.size % 2 == 0:   # torch.median differs there: the lower value
        assert torch.median(torch.from_numpy(x)).item() != got


@pytest.mark.parametrize("n", [4, 100])
def test_rbf_kernel_matches_jax(n):
    x = _particles(n)
    kxy, dxkxy = tsvgd.rbf_kernel(torch.from_numpy(x))
    j_kxy, j_dxkxy = jsvgd.rbf_kernel(jnp.asarray(x))
    sq = ((x[:, None] - x[None]) ** 2).sum(-1)
    h = float(jnp.median(jnp.asarray(sq))) / np.log(n + 1.0)
    # the bandwidth, read back from one kernel entry: k = exp(-d2 / 2h)
    i, j = 0, n - 1
    h_got = -sq[i, j] / (2.0 * np.log(kxy[i, j].item()))
    np.testing.assert_allclose(h_got, h, rtol=1e-12)
    np.testing.assert_allclose(kxy.numpy(), np.asarray(j_kxy), rtol=1e-12,
                               atol=1e-300)
    np.testing.assert_allclose(dxkxy.numpy(), np.asarray(j_dxkxy),
                               rtol=1e-12, atol=1e-12 * np.abs(
                                   np.asarray(j_dxkxy)).max())


def test_rbf_kernel_fixed_bandwidth_and_steps_match_jax():
    x = _particles(10, 3, seed=2)
    g = -x + 0.1 * _particles(10, 3, seed=3)
    for bw in (None, 0.7):
        got = tsvgd.svgd_step(torch.from_numpy(x), torch.from_numpy(g), 0.1,
                              bw)
        want = jsvgd.svgd_step(jnp.asarray(x), jnp.asarray(g), 0.1, bw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    cfg = tsvgd.SVGDConfig(stepsize=5e-2)
    step = tsvgd.make_svgd_step(lambda p: -p, cfg)
    j_step = jsvgd.make_svgd_step(lambda p: -p, jsvgd.SVGDConfig(stepsize=5e-2))
    p, jp = torch.from_numpy(x), jnp.asarray(x)
    for _ in range(5):
        p, jp = step(p), j_step(jp)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-11)
    # toward the mode of the standard normal score
    assert p.abs().mean() < torch.from_numpy(x).abs().mean()


def test_tolerant_update_matches_the_jax_expression():
    """crnn_tpu/cases/cathode_uq.py:252-267 on scores with a failed row."""
    x = _particles(6, 4, seed=4)
    lnp = _particles(6, 4, seed=5)
    lnp[2, 1] = np.nan                      # a failed solve: no data force
    losses = np.abs(_particles(6, 1, seed=6)[:, 0])
    losses[2] = np.inf
    new, mean = tsvgd.svgd_step_tolerant(
        torch.from_numpy(x), torch.from_numpy(losses),
        torch.from_numpy(lnp), 1e-2)
    jl = jnp.asarray(lnp)
    finite = jnp.isfinite(jl).all(axis=1, keepdims=True)
    jl = jnp.where(finite, jl, 0.0)
    kxy, dxkxy = jsvgd.rbf_kernel(jnp.asarray(x))
    phi = (kxy @ jl + dxkxy) / 6
    phi = jnp.where(jnp.isfinite(phi), phi, 0.0)
    np.testing.assert_allclose(new.numpy(), np.asarray(x + 1e-2 * phi),
                               rtol=1e-12)
    np.testing.assert_allclose(mean.item(), np.mean(np.delete(losses, 2)),
                               rtol=1e-14)


def test_posterior_moments_and_kendall_match_jax():
    p = _particles(40, 5, seed=7)
    got, want = tpost.posterior_moments(p), jpost.posterior_moments(p)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(tpost.kendall_correlation(p),
                                  jpost.kendall_correlation(p))


def test_particle_history_and_figures(tmp_path):
    hist = tpost.ParticleHistory(gap=2)
    p = torch.zeros((5, 4), dtype=torch.float64)
    for it in range(6):
        p = p + 1.0
        hist.maybe_record(it, p)
    host = tpost.ParticleHistory(gap=2)
    buf = np.zeros((5, 4))
    for it in range(4):
        buf += 1.0                      # one buffer, updated in place
        host.maybe_record(it, buf)
    t = hist.tensor()
    assert t.shape == (3, 5, 4) and t.dtype == np.float64
    np.testing.assert_array_equal(t[:, 0, 0], [2.0, 4.0, 6.0])
    np.testing.assert_array_equal(host.tensor()[:, 0, 0], [2.0, 4.0])
    assert tpost.ParticleHistory().tensor().size == 0
    pytest.importorskip("matplotlib")
    x = _particles(30, 4, seed=8)
    tpost.plot_correlation_heatmap(x, str(tmp_path / "corr.png"),
                                   ["a", "b", "c", "d"])
    tpost.plot_particle_histograms(x, str(tmp_path / "hist.png"))
    ts = np.linspace(0.0, 1.0, 9)
    tpost.plot_posterior_band(ts, ts ** 2, lambda q: ts ** 2 * q[0], x,
                              str(tmp_path / "band.png"))
    tpost.animate_particle_evolution(np.stack([x, x + 0.1]),
                                     str(tmp_path / "evo.gif"))
    for name in ("corr.png", "hist.png", "band.png", "evo.gif"):
        assert (tmp_path / name).stat().st_size > 0


# --- the sharded step --------------------------------------------------------

_UQ = dict(num_particles=8, maxiters=64, rtol=1e-3, device="cpu")


def _sharded_step(particles, reps, p_opt):
    """One sharded SVGD step on this rank (the spawned ranks run this)."""
    from crnn_tpu_torch.cases.cathode_uq import CathodeUQConfig, build_uq

    cfg = CathodeUQConfig(**_UQ, dp=mesh.world_size())
    p, step, _ = build_uq(cfg, p_opt, particles=particles, reps=reps)
    new, loss = step(p, 0, 1e-4)
    return new.numpy(), loss.item()


def test_sharded_svgd_step_matches_local_step(monkeypatch):
    from crnn_tpu_torch.cases.cathode_uq import CathodeUQConfig, build_uq

    monkeypatch.setattr(mesh, "SPAWN_TIMEOUT_S", SPAWN_TIMEOUT_S)
    p_opt = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (18,))) \
        * 0.01 + np.r_[np.ones(17), 0.1]
    p, step, ex = build_uq(CathodeUQConfig(**_UQ), p_opt)
    reps = ex["reps"].numpy()
    new, loss = step(p, 0, 1e-4)
    new_dp, loss_dp = mesh.spawn(_sharded_step, 2, (p.numpy(), reps, p_opt))
    np.testing.assert_allclose(loss_dp, loss.item(), rtol=1e-12)
    np.testing.assert_allclose(new_dp, new.numpy(), rtol=1e-12)
    assert not np.array_equal(new.numpy(), p.numpy())
    # in this process on a world of one, through the same code path
    with mesh.process_group(1, 0):
        new_1, loss_1 = _sharded_step(p.numpy(), reps, p_opt)
    np.testing.assert_allclose(new_1, new.numpy(), rtol=1e-12)
    np.testing.assert_allclose(loss_1, loss.item(), rtol=1e-12)


def test_sharded_svgd_refuses_indivisible_particles():
    from crnn_tpu_torch.cases.cathode_uq import CathodeUQConfig, build_uq

    with pytest.raises(ValueError, match="divide"):
        build_uq(CathodeUQConfig(num_particles=10, dp=4, maxiters=64,
                                 device="cpu"))
    # a group of the wrong size is refused too
    with mesh.process_group(1, 0), pytest.raises(ValueError, match="ranks"):
        build_uq(CathodeUQConfig(num_particles=8, dp=2, maxiters=64,
                                 device="cpu"))
