"""case1 rev in the port against the JAX package: the reversible p2vec, the
reversible truth, the reversible CRNN RHS (plain torch on every device, as
it is plain XLA in JAX), the ``reaction_mask``, and one whole forward-mode
training epoch in f64 at rtol 1e-6, continued in the port from a JAX epoch
whose gradient is ``jax.jacfwd`` through the early-exit while driver (see
tests/_case2_epoch_parity.py).

Reduced to 4 training and 2 held-out experiments and 20 save points; ns=5,
nr=10, Tsit5 at rtol 1e-2 / atol 1e-5 and max_steps 512 as shipped.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import case1_rev as jrev
from crnn_tpu.data import truth as jt
from crnn_tpu.models.crnn import make_crnn_reversible_rhs as j_rev_rhs
from crnn_tpu.transforms.p2vec import p2vec_reversible as j_p2vec_rev
from crnn_tpu_torch.cases import base
from crnn_tpu_torch.cases import case1_rev as trev
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.models.crnn import make_crnn_reversible_rhs
from crnn_tpu_torch.ode.base import is_autonomous
from crnn_tpu_torch.transforms.p2vec import (init_params_reversible,
                                             p2vec_reversible)

NS, NR, LB = 5, 10, 1e-5
N_TRAIN, N_TEST, DATASIZE = 4, 2, 20


def _p(seed=0):
    p = np.random.default_rng(seed).normal(size=NR * (NS + 1)) * 1.5
    p[NR + 4] = 0.0              # w_out == 0: the tie of both order clips
    p[NR + 7] = 2.5              # w_out at the clip bound
    return p


def test_p2vec_reversible_matches_jax_with_gradients():
    p = _p()
    got = p2vec_reversible(torch.from_numpy(p), NS, NR)
    want = j_p2vec_rev(jnp.asarray(p), NS, NR)
    for name in ("w_in", "w_b", "w_out", "w_kb"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert float(got.w_out.abs().max()) == 2.5

    def j_f(p_):
        w = j_p2vec_rev(p_, NS, NR)
        return jnp.sum(w.w_out ** 3) + jnp.sum(w.w_b ** 2) + jnp.sum(
            jnp.sin(w.w_kb))

    pt = torch.from_numpy(p).requires_grad_(True)
    w = p2vec_reversible(pt, NS, NR)
    (g,) = torch.autograd.grad(torch.sum(w.w_out ** 3) + torch.sum(
        w.w_b ** 2) + torch.sum(torch.sin(w.w_kb)), pt)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(j_f)(jnp.asarray(p))),
                               rtol=1e-15, atol=0)


def test_init_params_reversible_layout():
    p = init_params_reversible(torch.Generator().manual_seed(0), NS, NR,
                               device="cpu")
    assert p.shape == (NR * (NS + 1),) and p.dtype == torch.float32
    assert 0.35 < float(p.std()) < 0.65 and abs(float(p.mean())) < 0.15


def test_reversible_truth_matches_jax():
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 1.5, size=(6, NS))
    k = rng.uniform(0.5, 2.0, size=(6, 8))
    want = jax.vmap(lambda yy, kk: jt.reversible_truth(0.0, yy, kk))(
        jnp.asarray(y), jnp.asarray(k))
    got = tt.reversible_truth(0.0, torch.from_numpy(y), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=1e-300)
    np.testing.assert_array_equal(np.asarray(tt.REVERSIBLE_K),
                                  np.asarray(jt.REVERSIBLE_K))
    # every reaction conserves A + B + C + D + E
    mass = got.numpy().sum(axis=1)
    np.testing.assert_allclose(mass, 0.0, atol=1e-14)


def test_reversible_rhs_matches_jax_with_gradients():
    """Values over lanes (one below lb, one with an exact zero) and the
    gradient w.r.t. the parameter vector through p2vec and the RHS."""
    rng = np.random.default_rng(2)
    p = _p(3) * 0.5
    y = rng.uniform(0.0, 1.5, size=(7, NS))
    y[0, 2] = 0.0
    y[1, 4] = 1e-7
    j_rhs, t_rhs = j_rev_rhs(LB), make_crnn_reversible_rhs(LB)
    assert is_autonomous(t_rhs)

    def j_du(p_):
        w = j_p2vec_rev(p_, NS, NR)
        return jax.vmap(lambda yy: j_rhs(0.0, yy, w))(jnp.asarray(y))

    pt = torch.from_numpy(p).requires_grad_(True)
    du = t_rhs(None, torch.from_numpy(y), p2vec_reversible(pt, NS, NR))
    want = j_du(jnp.asarray(p))
    np.testing.assert_allclose(du.detach().numpy(), np.asarray(want),
                               rtol=1e-13, atol=1e-13 * float(
                                   jnp.abs(want).max()))
    cot = rng.normal(size=du.shape)
    (g,) = torch.autograd.grad(du, pt, torch.from_numpy(cot))
    want_g = jax.grad(lambda q: jnp.sum(j_du(q) * cot))(jnp.asarray(p))
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-12,
                               atol=1e-12 * float(jnp.abs(want_g).max()))


def test_reaction_mask_makes_reactions_inert():
    """A masked reaction's w_out column is zero, so it neither changes the
    RHS nor receives a gradient on its stoichiometry, as in JAX."""
    mask = (1, 0, 1, 1, 0, 1, 1, 1, 1, 1)
    kw = dict(n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=DATASIZE,
              dtype="float64")
    jsetup = jrev.build(jrev.Case1RevConfig(reaction_mask=mask, **kw))
    tsetup = trev.build(trev.Case1RevConfig(reaction_mask=mask, device="cpu",
                                            **kw))
    p = _p(4)
    w = tsetup.weights_fn(torch.from_numpy(p))
    jw = jsetup.weights_fn(jnp.asarray(p))
    np.testing.assert_array_equal(w.w_out.numpy(), np.asarray(jw.w_out))
    assert (w.w_out.numpy()[:, [1, 4]] == 0).all()
    assert (w.w_out.numpy()[:, [0, 2]] != 0).any()

    pt = torch.from_numpy(p).requires_grad_(True)
    y = torch.rand((3, NS), generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64) + 0.1
    du = make_crnn_reversible_rhs(LB)(None, y, tsetup.weights_fn(pt))
    (g,) = torch.autograd.grad(du.sum(), pt)
    w_out_grad = g[NR:].reshape(NS, NR)
    assert (w_out_grad[:, [1, 4]] == 0).all()
    assert (w_out_grad[:, [0, 2]] != 0).any()


def test_case1_rev_forward_mode_epoch_matches_jax_f64():
    kw = dict(n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=DATASIZE,
              dtype="float64")
    jsetup = jrev.build(jrev.Case1RevConfig(**kw))
    assert jsetup.trainer.grad_mode == "fwd"

    def build_port(dataset):
        setup = trev.build(trev.Case1RevConfig(device="cpu", **kw),
                           dataset=dataset)
        assert setup.trainer.grad_mode == "fwd"
        return setup

    masks = check_epoch_vs_jax(jsetup, build_port, N_TRAIN, rtol=1e-6)
    assert bool((masks == 1).all())     # case1 rev has no stochastic horizon


def test_generated_u0_and_data():
    """u0 ~ U(0, 1) with the first two species +0.2 and none zeroed; the
    port's truth solve is healthy and its noise is 0.1%."""
    cfg = trev.Case1RevConfig(n_exp_train=N_TRAIN, n_exp_test=N_TEST,
                              datasize=DATASIZE, dtype="float64",
                              device="cpu")
    ds = trev.build(cfg).dataset
    u0 = ds.u0.numpy()
    assert (u0[:, :2] >= 0.2).all() and (u0[:, :2] <= 1.2).all()
    assert (u0[:, 2:] > 0).all() and (u0[:, 2:] < 1).all()
    assert bool(ds.success.all())
    rel = np.abs(ds.ys.numpy() - ds.ys_clean.numpy()) / np.maximum(
        np.abs(ds.ys_clean.numpy()), 1e-300)
    assert 2e-4 < float(np.median(rel[ds.ys_clean.numpy() > 0])) < 2e-3


@pytest.mark.parametrize("mode", ["batch", "sequential"])
def test_cli_and_restart_on_cpu(tmp_path, monkeypatch, mode):
    """``python -m crnn_tpu_torch.cases.case1_rev --device cpu`` at a reduced
    size, then ``--restart``: the epochs continue and the run files are
    written."""
    small = dict(n_exp_train=2, n_exp_test=1, datasize=8, max_steps=64)
    monkeypatch.setattr(trev, "Case1RevConfig",
                        functools.partial(trev.Case1RevConfig, **small))
    monkeypatch.setattr(base, "have_matplotlib", lambda: False)
    args = ["--device", "cpu", "--mode", mode, "--out", str(tmp_path)]
    per_epoch = 2 if mode == "sequential" else 1
    state, _ = trev.main(["--epochs", "1", *args])
    assert state.opt_state.count == per_epoch
    state, hist = trev.main(["--epochs", "1", "--restart", *args])
    run_dir = tmp_path / "case1_rev"
    assert state.epoch == 2 and state.opt_state.count == 2 * per_epoch
    assert all(np.isfinite(hist["loss_train"]))
    for f in ("metrics.jsonl", "checkpoint.pt", "best.pt", "p_opt.npy"):
        assert (run_dir / f).exists()
