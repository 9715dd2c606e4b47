"""crnn_tpu_torch/train and transforms against the JAX package (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crnn_tpu.train.loss import make_trajectory_loss as j_loss
from crnn_tpu.train.loss import prefix_mask as j_prefix_mask
from crnn_tpu.train.loop import Trainer as JTrainer
from crnn_tpu.train.optimizers import adamw_like as j_adamw_like
from crnn_tpu.train.optimizers import expdecay_adamw as j_expdecay_adamw
from crnn_tpu.transforms.p2vec import p2vec_case1 as j_p2vec_case1
from crnn_tpu.transforms.p2vec import p2vec_case2 as j_p2vec
from crnn_tpu.transforms.p2vec import p2vec_robertson as j_p2vec_robertson
from crnn_tpu.transforms.pruning import hard_threshold as j_hard
from crnn_tpu.transforms.pruning import prune_case2_params as j_prune
from crnn_tpu_torch import convert
from crnn_tpu_torch.train.loop import Trainer
from crnn_tpu_torch.train.loss import make_trajectory_loss as t_loss
from crnn_tpu_torch.train.loss import prefix_mask as t_prefix_mask
from crnn_tpu_torch.train.optimizers import adamw_like as t_adamw_like
from crnn_tpu_torch.train.optimizers import expdecay_adamw as t_expdecay_adamw
from crnn_tpu_torch.transforms.p2vec import (init_params_case1,
                                             init_params_case2,
                                             init_params_robertson,
                                             p2vec_case1, p2vec_case2,
                                             p2vec_robertson)
from crnn_tpu_torch.transforms.pruning import hard_threshold, prune_case2_params

NS, NR = 6, 3


def _p(seed=0):
    p = np.random.default_rng(seed).normal(size=NR * (NS + 2) + 1)
    p[NR + 2] = 0.0          # an exact w_out == 0: the clip tie
    p[NR + 5] = 0.004        # below the pruning cutoff
    return p


def test_p2vec_case2_matches_jax_exactly():
    p = _p()
    got = p2vec_case2(torch.from_numpy(p), NS, NR)
    want = j_p2vec(jnp.asarray(p), NS, NR)
    for name in ("w_in", "w_b", "w_out"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def test_p2vec_case2_gradient_at_clip_tie_is_half_as_in_jax():
    p = _p()

    def j_f(p_):
        w = j_p2vec(p_, NS, NR)
        return jnp.sum(w.w_in) + jnp.sum(w.w_b ** 2) + jnp.sum(w.w_out ** 3)

    want = np.asarray(jax.grad(j_f)(jnp.asarray(p)))
    pt = torch.from_numpy(p).requires_grad_(True)
    w = p2vec_case2(pt, NS, NR)
    (got,) = torch.autograd.grad(
        torch.sum(w.w_in) + torch.sum(w.w_b ** 2) + torch.sum(w.w_out ** 3), pt)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-15)
    # d w_in / d w_out at w_out == 0 is -0.5 (jnp.clip), not -1 (torch.clamp)
    assert got[NR + 2].item() == pytest.approx(-0.5) == want[NR + 2]


def test_pruning_matches_jax_exactly():
    p = _p(1)
    got = prune_case2_params(torch.from_numpy(p), NS, NR, 0.01)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_prune(jnp.asarray(p), NS, NR, 0.01)))
    assert got[NR + 5] == 0.0
    w = np.random.default_rng(2).normal(size=(NS, NR)) * 0.02
    np.testing.assert_array_equal(hard_threshold(torch.from_numpy(w), 0.01).numpy(),
                                  np.asarray(j_hard(jnp.asarray(w), 0.01)))
    # the mask carries no gradient: d(pruned)/dp is 1 on kept entries, 0 else
    pt = torch.from_numpy(p).requires_grad_(True)
    (g,) = torch.autograd.grad(prune_case2_params(pt, NS, NR, 0.01).sum(), pt)
    want = jax.grad(lambda q: jnp.sum(j_prune(q, NS, NR, 0.01)))(jnp.asarray(p))
    np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_init_params_case2_layout():
    p = init_params_case2(torch.Generator().manual_seed(0), NS, NR,
                          dtype=torch.float64, device="cpu")
    assert p.shape == (NR * (NS + 2) + 1,) and p.dtype == torch.float64
    assert p[-1].item() == 0.1
    assert 0.4 < p[:NR].mean().item() < 1.2
    assert 0.4 < p[NR * (NS + 1):NR * (NS + 2)].mean().item() < 1.2


@pytest.mark.parametrize("i_obs", [None, (0, 1, 3, 4, 5)])
@pytest.mark.parametrize("masked", [False, True])
def test_trajectory_loss_matches_jax(i_obs, masked):
    rng = np.random.default_rng(3)
    pred, data = rng.normal(size=(2, 4, 9, NS))
    yscale = rng.uniform(0.5, 2.0, size=NS)
    masks = np.stack([np.asarray(j_prefix_mask(9, s, jnp.float64))
                      for s in (3, 9, 5, 7)])
    np.testing.assert_array_equal(
        t_prefix_mask(9, torch.tensor([3, 9, 5, 7]), torch.float64).numpy(), masks)
    jl = j_loss("mae", yscale=jnp.asarray(yscale), i_obs=i_obs)
    tl = t_loss(yscale=torch.from_numpy(yscale), i_obs=i_obs)
    if masked:
        want = jax.vmap(jl)(jnp.asarray(pred), jnp.asarray(data), jnp.asarray(masks))
        got = tl(torch.from_numpy(pred), torch.from_numpy(data),
                 torch.from_numpy(masks))
    else:
        want = jax.vmap(jl)(jnp.asarray(pred), jnp.asarray(data))
        got = tl(torch.from_numpy(pred), torch.from_numpy(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14)


def test_optimizer_matches_optax_across_decay_boundaries_and_floor():
    """30 steps of lr0 5e-3 halving every 4 steps, floored at 2e-4 from step
    20 on; the gradients' norm crosses grad_max, so clipping switches on and
    off."""
    kw = dict(lr0=5e-3, decay_rate=0.5, decay_steps=4, lr_floor=2e-4,
              weight_decay=1e-3, grad_max=1.0)
    j_opt = j_expdecay_adamw(**kw)
    t_opt = t_expdecay_adamw(**kw)
    rng = np.random.default_rng(5)
    p0 = rng.normal(size=25)
    jp, js = jnp.asarray(p0), j_opt.init(jnp.asarray(p0))
    tp, ts = torch.from_numpy(p0), t_opt.init(torch.from_numpy(p0))
    for step in range(30):
        g = rng.normal(size=25) * (2.0 if step % 3 == 0 else 0.05)
        upd, js = j_opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = t_opt.update(torch.from_numpy(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-13,
                                   atol=1e-15)
    adam = js[1][1][0]   # (clip, (decay, (ScaleByAdamState, schedule)))
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(adam.mu), rtol=1e-13)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(adam.nu), rtol=1e-13)
    assert ts.count == int(adam.count) == 30
    assert [t_opt.lr(c) for c in (0, 3, 4, 29)] == [
        float(np.float32(v)) for v in (5e-3, 5e-3, 2.5e-3, 2e-4)]


def test_guarded_epoch_discards_non_finite_updates_and_keeps_best():
    """The NaN guard of crnn_tpu/train/loop.py:237-259 on a toy loss: a
    finite epoch updates params and the best-val carry; an epoch whose
    loss is NaN leaves params and optimizer state as they were."""
    target = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    poison = {"on": False}

    def loss_batch(p, idxs, masks):
        loss = ((p - target) ** 2).sum() * torch.ones(idxs.shape[0],
                                                      dtype=p.dtype)
        return loss * float("nan") if poison["on"] else loss

    trainer = Trainer(loss_batch=loss_batch, loss_batch_eval=loss_batch,
                      optimizer=t_expdecay_adamw(0.1, 0.5, 100, 1e-3),
                      n_exp_train=2, n_exp=3, n_save=4)
    state = trainer.init(torch.zeros(3, dtype=torch.float64), seed=1)
    best = trainer.init_best(state)
    state, best, m = trainer.guarded_epoch(state, best)
    assert state.epoch == 1 and state.opt_state.count == 1
    assert best.loss_val == pytest.approx(float(m.loss_val)) and best.n_skipped == 0
    assert torch.equal(best.params, state.params)
    poison["on"] = True
    before = state
    state, best2, m = trainer.guarded_epoch(state, best)
    assert not np.isfinite(float(m.loss_train))
    assert torch.equal(state.params, before.params)
    assert state.opt_state is before.opt_state and state.epoch == 2
    assert best2.n_skipped == 1 and best2.loss_val == best.loss_val


def _toy_trainer(val_losses, dtype=torch.float64):
    """A Trainer whose k-th eval pass reports ``val_losses[k]`` as the
    validation loss (and a fixed train loss)."""
    calls = {"n": 0}

    def loss_batch(p, idxs, masks):
        return ((p - 1.0) ** 2).sum() * torch.ones(idxs.shape[0], dtype=dtype)

    def loss_batch_eval(p, idxs, masks):
        v = val_losses[calls["n"]]
        calls["n"] += 1
        return torch.tensor([0.5, v], dtype=dtype)

    return Trainer(loss_batch=loss_batch, loss_batch_eval=loss_batch_eval,
                   optimizer=t_adamw_like(0.1), n_exp_train=1, n_exp=2,
                   n_save=3)


@pytest.mark.parametrize("direction", ["down", "up"])
def test_best_val_carry_is_float32_as_in_jax(direction):
    """An f64 run whose second val loss ties the first within f32
    rounding: JAX compares the new f64 loss against the best stored as
    float32 (crnn_tpu/train/loop.py:253-256). When f32 rounds the first
    loss down, a slightly lower f64 loss above that f32 value is not a new
    best; when it rounds up, a slightly higher f64 loss below it is one."""
    v1 = 0.1                                  # f32(0.1) > 0.1
    f32_v1 = float(np.float32(v1))
    if direction == "down":
        v1 = float(np.nextafter(np.float32(0.1), np.float32(0))) + 1e-10
        f32_v1 = float(np.float32(v1))        # rounds down, below v1
        assert f32_v1 < v1
        v2 = (f32_v1 + v1) / 2                # below v1, above f32(v1)
    else:
        assert f32_v1 > v1
        v2 = (f32_v1 + v1) / 2                # above v1, below f32(v1)
    trainer = _toy_trainer([v1, v2])
    state = trainer.init(torch.zeros(2, dtype=torch.float64))
    best = trainer.init_best(state)
    state, best, _ = trainer.guarded_epoch(state, best)
    p1 = state.params
    assert isinstance(best.loss_val, np.float32) and best.loss_val == f32_v1
    assert isinstance(best.loss_train, np.float32)
    state, best2, m = trainer.guarded_epoch(state, best)

    # what the JAX package's guarded step decides on the same losses: an
    # f64 loss (a strongly typed array) against the f32 best
    j_best = jnp.asarray(best.loss_val, jnp.float32)
    j_is_best = bool(jnp.asarray(float(m.loss_val), jnp.float64) < j_best)
    assert j_is_best == (direction == "up")
    new_best = torch.equal(best2.params, state.params)
    assert new_best == j_is_best
    assert torch.equal(best2.params, state.params if j_is_best else p1)
    assert best2.loss_val == (np.float32(v2) if j_is_best else best.loss_val)


@pytest.mark.parametrize("grad_max", [None, 1.0])
def test_adamw_like_matches_optax(grad_max):
    """25 steps of ``adamw_like`` (constant lr, coupled decay, optional
    global-norm clip that switches on and off); the optax state crosses
    through ``convert.adam_state_from_optax`` whatever the chain."""
    kw = dict(weight_decay=1e-3, grad_max=grad_max)
    j_opt, t_opt = j_adamw_like(5e-3, **kw), t_adamw_like(5e-3, **kw)
    rng = np.random.default_rng(7)
    p0 = rng.normal(size=19)
    jp, js = jnp.asarray(p0), j_opt.init(jnp.asarray(p0))
    tp, ts = torch.from_numpy(p0), t_opt.init(torch.from_numpy(p0))
    for step in range(25):
        g = rng.normal(size=19) * (2.0 if step % 3 == 0 else 0.05)
        upd, js = j_opt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = t_opt.update(torch.from_numpy(g), ts, tp)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-13,
                                   atol=1e-15)
    crossed = convert.adam_state_from_optax(js, device="cpu")
    np.testing.assert_allclose(ts.mu.numpy(), crossed.mu.numpy(), rtol=1e-13)
    np.testing.assert_allclose(ts.nu.numpy(), crossed.nu.numpy(), rtol=1e-13)
    assert ts.count == crossed.count == 25 and t_opt.lr(7) == 5e-3
    with pytest.raises(ValueError, match="Adam state"):
        convert.adam_state_from_optax((optax.EmptyState(),), device="cpu")


def test_p2vec_case1_and_robertson_match_jax_with_gradients():
    rng = np.random.default_rng(8)
    p1 = rng.normal(size=4 * 6)
    p1[5] = 0.0                      # w_out == 0: the clip tie of w_in
    pr = rng.uniform(-0.8, 0.8, size=6 * 7 + 1)
    pr[6 * 4 + 1] = 0.0              # a w_in == 0 tie
    cases = ((p2vec_case1, j_p2vec_case1, p1, (5, 4)),
             (p2vec_robertson, j_p2vec_robertson, pr, (3, 6)))
    for t_fn, j_fn, p, dims in cases:
        got = t_fn(torch.from_numpy(p), *dims)
        want = j_fn(jnp.asarray(p), *dims)
        for name in ("w_in", "w_b", "w_out"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-15, atol=1e-300)

        def j_f(p_):
            w = j_fn(p_, *dims)
            return (jnp.sum(w.w_in ** 2) + jnp.sum(w.w_b ** 2)
                    + jnp.sum(w.w_out ** 3))

        pt = torch.from_numpy(p).requires_grad_(True)
        w = t_fn(pt, *dims)
        (g,) = torch.autograd.grad(torch.sum(w.w_in ** 2) + torch.sum(
            w.w_b ** 2) + torch.sum(w.w_out ** 3), pt)
        np.testing.assert_allclose(g.numpy(), np.asarray(jax.grad(j_f)(
            jnp.asarray(p))), rtol=1e-13, atol=1e-15)


def test_init_params_case1_and_robertson_layout():
    p1 = init_params_case1(torch.Generator().manual_seed(0), 5, 4,
                           dtype=torch.float64, device="cpu")
    assert p1.shape == (24,) and 0.05 < float(p1.std()) < 0.2
    pr = init_params_robertson(torch.Generator().manual_seed(0), 3, 6,
                               device="cpu")
    assert pr.shape == (43,) and pr.dtype == torch.float64
    assert pr[-1].item() == 0.1
    lim = (6.0 / 9.0) ** 0.5
    assert float(pr[:-1].abs().max()) <= lim and float(pr[:-1].min()) < 0


def test_sample_masks_match_jax_horizon_semantics():
    """``horizon_range=(lo, hi)`` draws prefix lengths in [lo, hi] per
    experiment, as JAX's _sample_masks does; without it all ones."""
    kw = dict(loss_batch=None, loss_batch_eval=None,
              optimizer=t_adamw_like(1e-3), n_exp_train=4, n_exp=5, n_save=9)
    gen = torch.Generator().manual_seed(0)
    masks = Trainer(horizon_range=(3, 9), **kw).sample_masks(
        gen, 400, torch.float64)
    lengths = masks.sum(dim=1)
    assert set(lengths.long().tolist()) == set(range(3, 10))
    assert torch.equal(masks, t_prefix_mask(9, lengths.long(), torch.float64))
    j_masks = JTrainer(loss_i_exp=None, optimizer=j_adamw_like(1e-3),
                       n_exp_train=4, n_exp=5, n_save=9,
                       horizon_range=(3, 9))._sample_masks(
                           jax.random.PRNGKey(0), 400, jnp.float64)
    assert set(np.asarray(j_masks).sum(axis=1).astype(int)) == set(range(3, 10))
    assert torch.equal(Trainer(**kw).sample_masks(gen, 4),
                       torch.ones((4, 9)))
