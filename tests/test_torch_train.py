"""crnn_tpu_torch/train and transforms against the JAX package (f64)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crnn_tpu.train.loss import make_trajectory_loss as j_loss
from crnn_tpu.train.loss import prefix_mask as j_prefix_mask
from crnn_tpu.train.optimizers import expdecay_adamw as j_expdecay_adamw
from crnn_tpu.transforms.p2vec import p2vec_case2 as j_p2vec
from crnn_tpu.transforms.pruning import hard_threshold as j_hard
from crnn_tpu.transforms.pruning import prune_case2_params as j_prune
from crnn_tpu_torch.train.loss import make_trajectory_loss as t_loss
from crnn_tpu_torch.train.loss import prefix_mask as t_prefix_mask
from crnn_tpu_torch.train.optimizers import expdecay_adamw as t_expdecay_adamw
from crnn_tpu_torch.transforms.p2vec import init_params_case2, p2vec_case2
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
    from crnn_tpu_torch.train.loop import Trainer

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
