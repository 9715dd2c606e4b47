"""case3 and the GRN in the port against the JAX package: the product-tied
p2vec with its frozen rows, the init layout, the MAPK and GRN truths, the
relative pruning, the log-space and squared losses, NAdam, and one whole
training epoch of each variant in f64 at rtol 1e-6, continued in the port
from a JAX epoch (see tests/_case2_epoch_parity.py).

Reduced sizes: case3 with 4 training and 2 held-out experiments and 20 save
points (ns=9, nr=8); the GRN with the same split, nr=15, 20 save points and
horizons in [2, 20]. Tsit5 at rtol 1e-2 / atol 1e-5 and max_steps 192 as
shipped. case3 updates on every experiment, the held-out ones included
(``n_exp_update = n_exp``), so its permutation is n_exp long.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import case3 as jcase3
from crnn_tpu.data import truth as jt
from crnn_tpu.train.loss import make_trajectory_loss as j_loss
from crnn_tpu.train.optimizers import nadam_like as j_nadam_like
from crnn_tpu.transforms.p2vec import p2vec_case3 as j_p2vec_case3
from crnn_tpu.transforms.pruning import relative_threshold as j_relative
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import base
from crnn_tpu_torch.cases import case3 as tcase3
from crnn_tpu_torch.cases import grn as tgrn
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.data.generate import generate_dataset_odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5
from crnn_tpu_torch.train.loss import make_trajectory_loss as t_loss
from crnn_tpu_torch.train.optimizers import nadam_like
from crnn_tpu_torch.transforms.p2vec import init_params_case3, p2vec_case3
from crnn_tpu_torch.transforms.pruning import relative_threshold

NS = 9
N_TRAIN, N_TEST, DATASIZE = 4, 2, 20


def _p(nr, seed=0):
    p = np.random.default_rng(seed).uniform(-0.9, 0.9,
                                            size=nr * (2 * NS + 1) + 1)
    p[nr * (NS + 1) + 3] = 0.0        # a w_in == 0 tie of the clip
    p[nr + 5] = 0.0                   # a w_out_raw == 0: the |.| kink
    return p


@pytest.mark.parametrize("nr,frozen", [(8, None), (15, (0, 3, 6))])
def test_p2vec_case3_matches_jax_with_gradients(nr, frozen):
    """Values exactly and gradients to the ulp in f64, the kinks of the clip
    and of |.| (JAX's gradient 1 at 0) included; the product tie takes the
    unclipped w_in (negative entries of w_in still give w_out), and the
    frozen rows of w_out are zeroed before the tie."""
    p = _p(nr)
    got = p2vec_case3(torch.from_numpy(p), NS, nr, frozen_rows=frozen)
    want = j_p2vec_case3(jnp.asarray(p), NS, nr, frozen_rows=frozen)
    for name in ("w_in", "w_b", "w_out"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    w_in_raw = p[nr * (NS + 1):nr * (2 * NS + 1)].reshape(NS, nr)
    neg = w_in_raw < 0
    assert neg.any() and (got.w_in.numpy()[neg] == 0).all()
    live = np.ones(NS, bool)
    if frozen is not None:
        live[list(frozen)] = False
        assert (got.w_out.numpy()[~live] == 0).all()
    assert (got.w_out.numpy()[live][neg[live]] != 0).any()

    def j_f(p_):
        w = j_p2vec_case3(p_, NS, nr, frozen_rows=frozen)
        return (jnp.sum(w.w_in ** 2) + jnp.sum(w.w_b ** 3)
                + jnp.sum(jnp.sin(w.w_out)))

    pt = torch.from_numpy(p).requires_grad_(True)
    w = p2vec_case3(pt, NS, nr, frozen_rows=frozen)
    (g,) = torch.autograd.grad(torch.sum(w.w_in ** 2) + torch.sum(w.w_b ** 3)
                               + torch.sum(torch.sin(w.w_out)), pt)
    # w_in's two paths (the clip, the tie) sum in either order: one ulp
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(j_f)(jnp.asarray(p))),
                               rtol=1e-15, atol=0)


def test_init_params_case3_layout():
    p = init_params_case3(torch.Generator().manual_seed(0), NS, 8,
                          device="cpu")
    assert p.shape == (8 * (2 * NS + 1) + 1,) and p.dtype == torch.float32
    assert p[-1].item() == pytest.approx(0.1)
    lim = (6.0 / (NS + 8)) ** 0.5
    body = p[:-1]
    assert float(body.abs().max()) <= lim
    assert float(body.min()) < -0.5 * lim and float(body.max()) > 0.5 * lim
    p64 = init_params_case3(torch.Generator().manual_seed(0), NS, 15,
                            dtype=torch.float64, device="cpu")
    assert p64.shape == (15 * (2 * NS + 1) + 1,) and p64.dtype == torch.float64


@pytest.mark.parametrize("name", ["case3", "grn"])
def test_truths_match_jax(name):
    t_fn, j_fn, k = {"case3": (tt.case3_truth, jt.case3_truth, tt.CASE3_K),
                     "grn": (tt.grn_truth, jt.grn_truth, tt.GRN_K)}[name]
    j_k = {"case3": jt.CASE3_K, "grn": jt.GRN_K}[name]
    np.testing.assert_array_equal(np.asarray(k), np.asarray(j_k))
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 2.0, size=(7, NS))
    kk = np.broadcast_to(np.asarray(k), (7, len(k)))
    want = jax.vmap(lambda yy, ka: j_fn(0.0, yy, ka))(jnp.asarray(y),
                                                      jnp.asarray(kk))
    got = t_fn(0.0, torch.from_numpy(y), torch.from_numpy(kk.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=1e-300)
    zero_rows = (0,) if name == "case3" else (0, 3, 6)
    assert (got.numpy()[:, list(zero_rows)] == 0.0).all()


def test_relative_threshold_matches_jax_with_gradient():
    """The row max is the signed max of ``w_out^T * dy_scale``, so a row
    whose largest entry is negative flips the ratio's sign; the mask carries
    no gradient."""
    rng = np.random.default_rng(2)
    w_out = rng.normal(size=(NS, 8))
    w_out[:, 2] = -np.abs(w_out[:, 2])   # a reaction with every entry < 0
    dy = rng.uniform(0.2, 3.0, size=NS)
    for cutoff in (0.05, 0.3):
        got = relative_threshold(torch.from_numpy(w_out), torch.from_numpy(dy),
                                 cutoff)
        want = j_relative(jnp.asarray(w_out), jnp.asarray(dy), cutoff)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 0).any() and (got.numpy() != 0).any()
    signed = (w_out.T * dy).max(axis=1)
    assert signed[2] < 0 and np.abs(w_out.T * dy).max(axis=1)[2] > 0

    def j_f(w):
        return jnp.sum(j_relative(w, jnp.asarray(dy), 0.3) ** 2)

    wt = torch.from_numpy(w_out).requires_grad_(True)
    (g,) = torch.autograd.grad(
        torch.sum(relative_threshold(wt, torch.from_numpy(dy), 0.3) ** 2), wt)
    np.testing.assert_array_equal(
        g.numpy(), np.asarray(jax.grad(j_f)(jnp.asarray(w_out))))


@pytest.mark.parametrize("kind,kw", [
    ("log_mae", dict(clip_lb=1e-5, clip_ub=100.0)),
    ("log_mae", dict(clip_lb=1e-5)),
    ("mse", dict(yscale=True)),
    ("mse", dict()),
])
@pytest.mark.parametrize("i_obs", [None, (0, 2, 3, 7)])
@pytest.mark.parametrize("masked", [False, True])
def test_log_mae_and_mse_match_jax(kind, kw, i_obs, masked):
    """The log-space MAE clips pred and data and ignores ``yscale``; the
    MSE is scaled by it. Values and the gradient w.r.t. pred."""
    rng = np.random.default_rng(3)
    pred = rng.uniform(-0.1, 3.0, size=(4, 11, NS))
    pred[0, 0, 0] = 1e-9                 # below clip_lb
    data = rng.uniform(1e-6, 3.0, size=(4, 11, NS))
    yscale = rng.uniform(0.5, 2.0, size=NS)
    masks = (np.arange(11)[None, :] < np.array([3, 11, 5, 7])[:, None]) * 1.0
    kw = dict(kw)
    use_ys = kw.pop("yscale", kind == "log_mae")
    jl = j_loss(kind, yscale=jnp.asarray(yscale) if use_ys else None,
                i_obs=i_obs, **kw)
    tl = t_loss(kind, yscale=torch.from_numpy(yscale) if use_ys else None,
                i_obs=i_obs, **kw)
    m_j = (jnp.asarray(masks),) if masked else ()
    m_t = (torch.from_numpy(masks),) if masked else ()

    def j_total(pp):
        return jnp.sum(jax.vmap(jl)(pp, jnp.asarray(data), *m_j))

    want = jax.vmap(jl)(jnp.asarray(pred), jnp.asarray(data), *m_j)
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = tl(pt, torch.from_numpy(data), *m_t)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-14)
    (g,) = torch.autograd.grad(got.sum(), pt)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(j_total)(jnp.asarray(pred))),
                               rtol=1e-13, atol=1e-15)


def test_unknown_loss_kind_raises():
    with pytest.raises(ValueError, match="unknown loss kind"):
        t_loss("huber")


@pytest.mark.parametrize("grad_max", [None, 1.0])
def test_nadam_like_matches_optax_nadam(grad_max):
    """25 steps of ``nadam_like`` against ``optax.nadam`` behind the
    optional global-norm clip, which switches on and off; the port's
    ``mu_hat`` is optax's Nesterov form, not ``torch.optim.NAdam``'s."""
    j_opt, t_opt = j_nadam_like(5e-3, grad_max=grad_max), nadam_like(
        5e-3, grad_max=grad_max)
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=17)
    jp, js = jnp.asarray(p0), j_opt.init(jnp.asarray(p0))
    tp, ts = torch.from_numpy(p0), t_opt.init(torch.from_numpy(p0))
    for step in range(25):
        g = rng.normal(size=17) * (2.0 if step % 3 == 0 else 0.05)
        upd, js = j_opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = t_opt.update(torch.from_numpy(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-13,
                                   atol=1e-15)
    crossed = convert.adam_state_from_optax(js, device="cpu")
    np.testing.assert_allclose(ts.mu.numpy(), crossed.mu.numpy(), rtol=1e-13)
    np.testing.assert_allclose(ts.nu.numpy(), crossed.nu.numpy(), rtol=1e-13)
    assert ts.count == crossed.count == 25
    # the plain Adam step differs from NAdam's: the test can see mu_hat
    adam = dataclasses.replace(t_opt, nesterov=False)
    a_p, _ = adam.update(torch.ones(17), adam.init(torch.zeros(17)),
                         torch.zeros(17))
    n_p, _ = t_opt.update(torch.ones(17), t_opt.init(torch.zeros(17)),
                          torch.zeros(17))
    assert not torch.allclose(a_p, n_p, rtol=1e-3)


def _jax_and_port(variant):
    kw = dict(n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=DATASIZE,
              dtype="float64")
    if variant == "grn":
        jcfg = dataclasses.replace(jcase3.grn_config(), horizon=(2, DATASIZE),
                                   **kw)
        tcfg = dataclasses.replace(tgrn.grn_config(), horizon=(2, DATASIZE),
                                   device="cpu", **kw)
    else:
        jcfg = jcase3.Case3Config(**kw)
        tcfg = tcase3.Case3Config(device="cpu", **kw)
    return jcfg, tcfg


def test_case3_epoch_matches_jax_f64():
    """The log-space MAE, NAdam clipped at 100, data clipped in the loss,
    and updates over all n_exp experiments."""
    jcfg, tcfg = _jax_and_port("case3")
    jsetup = jcase3.build(jcfg)
    n_upd = jsetup.trainer.n_exp_update
    assert n_upd == tcfg.n_exp == N_TRAIN + N_TEST

    def build_port(dataset):
        setup = tcase3.build(tcfg, dataset=dataset)
        assert setup.trainer.n_exp_update == n_upd
        assert setup.trainer.mode == jsetup.trainer.mode == "batch"
        return setup

    masks = check_epoch_vs_jax(jsetup, build_port, n_upd, rtol=1e-6)
    assert masks.shape == (n_upd, DATASIZE) and bool((masks == 1).all())


def test_grn_epoch_matches_jax_f64():
    """The scaled MAE, Adam with coupled weight decay 1e-6, frozen DNA rows
    and the stochastic prefix horizons JAX drew."""
    jcfg, tcfg = _jax_and_port("grn")
    jsetup = jcase3.build(jcfg)

    def build_port(dataset):
        return tgrn.build(tcfg, dataset=dataset)

    masks = check_epoch_vs_jax(jsetup, build_port, N_TRAIN, rtol=1e-6)
    lengths = masks.sum(dim=1)
    assert bool(((lengths >= 2) & (lengths <= DATASIZE)).all())
    assert bool((lengths < DATASIZE).any())


@pytest.mark.parametrize("variant", ["case3", "grn"])
def test_generated_data_match_jax_truth(variant):
    """The port's own data (its Tsit5 at rtol 1e-6 / atol 1e-8) from JAX's
    u0: the clean trajectories take JAX's steps and agree at rtol 1e-12,
    and the case3 u0 rows {0, 1, last} have the activated species zeroed."""
    jcfg, tcfg = _jax_and_port(variant)
    jds = jcase3.build(jcfg).dataset
    setup = tcase3.build(tcfg)
    u0 = setup.dataset.u0.numpy()
    assert u0.shape == (N_TRAIN + N_TEST, NS)
    if variant == "case3":
        rows = [0, 1, N_TRAIN + N_TEST - 1]
        assert (u0[np.ix_(rows, [2, 4, 6, 8])] == 0).all()
        assert (u0[2:-1] > 0).all() and u0.min() >= 0 and u0.max() <= 1
    # the port's truth solve from JAX's u0
    truth, k = ((tt.case3_truth, tt.CASE3_K) if variant == "case3"
                else (tt.grn_truth, tt.GRN_K))
    ts = torch.from_numpy(np.array(jds.ts))
    ds = generate_dataset_odesolve(
        torch.Generator().manual_seed(0), truth, Tsit5(),
        torch.from_numpy(np.array(jds.u0)),
        torch.tensor(k, dtype=torch.float64), 0.0, float(ts[-1]), ts,
        rtol=1e-6, atol=1e-8, noise=0.0, scale_lb=1e-5)
    assert bool(ds.success.all())
    np.testing.assert_allclose(ds.ys_clean.numpy(), np.asarray(jds.ys_clean),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("name", ["case3", "grn_variant", "grn"])
def test_cli_and_restart_on_cpu(tmp_path, monkeypatch, name):
    """The case3 CLI (``--variant case3|grn``, with ``--epochs-per-dispatch
    2`` on the restart) and the GRN's own CLI with its lr decay, on the CPU
    at a reduced size: the epochs continue across ``--restart`` and the run
    files are written."""
    small = dict(n_exp_train=2, n_exp_test=1, datasize=8, max_steps=48)
    monkeypatch.setattr(tcase3, "Case3Config",
                        functools.partial(tcase3.Case3Config, **small))
    monkeypatch.setattr(base, "have_matplotlib", lambda: False)
    args = ["--device", "cpu", "--out", str(tmp_path)]
    if name == "grn":
        main, more = tgrn.main, ["--lr-decay-steps", "1"]
    else:
        variant = "case3" if name == "case3" else "grn"
        main, more = tcase3.main, ["--variant", variant]
    state, _ = main(["--epochs", "1", *args, *more])
    assert state.opt_state.count == 1
    chunks = ["--epochs-per-dispatch", "2"] if main is tcase3.main else []
    state, hist = main(["--epochs", "2", "--restart", *args, *more, *chunks])
    run_dir = tmp_path / ("case3" if name == "case3" else "grn")
    assert state.epoch == 3 and state.opt_state.count == 3
    assert all(np.isfinite(hist["loss_train"]))
    for f in ("metrics.jsonl", "checkpoint.pt", "best.pt", "p_opt.npy"):
        assert (run_dir / f).exists()
