"""Sequential mode, forward-mode gradients and ``n_exp_update`` of the port's
Trainer (crnn_tpu_torch/train/loop.py) against the JAX package.

Each parity test continues a JAX run in the port: JAX trains one epoch, its
params, optax state and dataset cross through crnn_tpu_torch.convert, and
both packages run the second epoch on the permutation and horizon masks
that JAX drew from its key. In f64 the two agree at rtol 1e-6 on the
updated params, the eval losses, the metrics and the Adam state, whose
count advances once per update in sequential mode.

Sizes: case2 with 3 training and 1 held-out experiment and 20 save points
(t1 = 20), case1 with 3 + 1 and 12 save points; the rest as shipped."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import case1 as jcase1
from crnn_tpu.cases import case2 as jcase2
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import case1 as tcase1
from crnn_tpu_torch.cases import case2 as tcase2
from crnn_tpu_torch.train.loop import Trainer, TrainState
from crnn_tpu_torch.train.optimizers import adamw_like

N_TRAIN, N_TEST = 3, 1


def _crossed_dataset(jsetup):
    ds = jsetup.dataset
    return convert.dataset_from_jax(
        *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean, ds.ts,
                                  ds.yscale)),
        success=np.asarray(ds.success), device="cpu")


def check_second_epoch_vs_jax(jsetup, build_port, rtol=1e-6):
    """The second epoch of ``jsetup``'s trainer in JAX and in the port
    (``build_port(dataset)``), from the state JAX reached after its first.
    Returns the port's setup."""
    jtrainer = jsetup.trainer
    epoch = jtrainer.epoch_fn()
    state1, _ = epoch(jtrainer.init(jsetup.init_params, seed=0))
    state2, jm = epoch(state1)
    # the draws of the JAX epoch from its key (crnn_tpu/train/loop.py:119-123)
    _, k_perm, k_hor = jax.random.split(state1.key, 3)
    n_upd = jtrainer.n_exp_update or jtrainer.n_exp_train
    perm = jax.random.permutation(k_perm, n_upd)
    masks = jtrainer._sample_masks(k_hor, n_upd, state1.params.dtype)

    setup = build_port(_crossed_dataset(jsetup))
    trainer = setup.trainer
    assert (trainer.mode, trainer.grad_mode) == (jtrainer.mode,
                                                 jtrainer.grad_mode)
    state = TrainState(
        convert.params_from_jax(np.asarray(state1.params), device="cpu"),
        convert.adam_state_from_optax(state1.opt_state, device="cpu"),
        1, torch.Generator().manual_seed(0))
    new_state, m = trainer.epoch(state, perm=torch.from_numpy(np.array(perm)),
                                 masks=torch.from_numpy(np.array(masks)))
    np.testing.assert_allclose(new_state.params.numpy(),
                               np.asarray(state2.params), rtol=rtol)
    np.testing.assert_allclose(m.loss_exp.numpy(), np.asarray(jm.loss_exp),
                               rtol=rtol)
    for name in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(getattr(jm, name)), rtol=rtol)
    adam2 = convert.adam_state_from_optax(state2.opt_state, device="cpu")
    per_epoch = n_upd if trainer.mode == "sequential" else 1
    assert new_state.opt_state.count == adam2.count == 2 * per_epoch
    np.testing.assert_allclose(new_state.opt_state.mu.numpy(),
                               adam2.mu.numpy(), rtol=rtol,
                               atol=rtol * float(adam2.mu.abs().max()))
    np.testing.assert_allclose(new_state.opt_state.nu.numpy(),
                               adam2.nu.numpy(), rtol=rtol)
    return setup


CASE2_SMALL = dict(n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=20,
                   dtype="float64")


def test_case2_sequential_forward_mode_epoch_matches_jax_f64():
    """``mode='sequential'``: forward mode by default, one update per
    experiment through the per-lane early-exit driver, the eval pass on the
    batch-major driver; the lr decay's steps scaled by the updates."""
    jsetup = jcase2.build(jcase2.Case2Config(mode="sequential",
                                             **CASE2_SMALL))
    setup = check_second_epoch_vs_jax(jsetup, lambda ds: tcase2.build(
        tcase2.Case2Config(mode="sequential", device="cpu", **CASE2_SMALL),
        dataset=ds))
    assert setup.trainer.optimizer.decay_steps == 500 * N_TRAIN


def test_case2_batch_forward_mode_epoch_matches_jax_f64():
    """``grad_mode='fwd'`` in batch mode: jacfwd of the mean loss through the
    batch-major early-exit driver; its gradient against JAX's reverse-mode
    gradient through the scan, then the whole epoch."""
    kw = dict(grad_mode="fwd", **CASE2_SMALL)
    jsetup = jcase2.build(jcase2.Case2Config(**kw))
    check_epoch_vs_jax(jsetup, lambda ds: tcase2.build(
        tcase2.Case2Config(device="cpu", **kw), dataset=ds), N_TRAIN,
        rtol=1e-6)


def test_case1_sequential_epoch_matches_jax_f64():
    """case1 in sequential mode keeps reverse mode (the JAX Trainer's
    default): one lane per update through the checkpointed scan."""
    kw = dict(n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=12,
              dtype="float64", mode="sequential")
    jsetup = jcase1.build(jcase1.Case1Config(**kw))
    setup = check_second_epoch_vs_jax(jsetup, lambda ds: tcase1.build(
        tcase1.Case1Config(device="cpu", **kw), dataset=ds))
    assert setup.trainer.grad_mode == "rev"


def test_fwd_grad_mode_matches_rev():
    """The counterpart of tests/test_cases.py::test_fwd_grad_mode_matches_rev
    (same sizes and tolerances): a case1 epoch with jacfwd through the while
    driver equals one with reverse mode through the scan. Forward mode
    takes the plain ops (``rhs_plain``): the kernel ops have no
    forward-mode rule, which the kernel-op build shows."""
    cfg = tcase1.Case1Config(device="cpu", n_exp_train=3, n_exp_test=1,
                             datasize=10, max_steps=96)
    s_rev = tcase1.build(cfg)
    s_fwd = tcase1.build(dataclasses.replace(cfg, rhs_plain=True),
                         dataset=s_rev.dataset)
    s_fwd.trainer.grad_mode = "fwd"
    st_r, m_r = s_rev.trainer.epoch(s_rev.trainer.init(s_rev.init_params))
    st_f, m_f = s_fwd.trainer.epoch(s_fwd.trainer.init(s_fwd.init_params))
    np.testing.assert_allclose(st_f.params.numpy(), st_r.params.numpy(),
                               rtol=2e-4, atol=2e-6)
    np.testing.assert_allclose(float(m_f.loss_train), float(m_r.loss_train),
                               rtol=1e-5)
    s_rev.trainer.grad_mode = "fwd"
    with pytest.raises(RuntimeError, match="setup_context"):
        s_rev.trainer.epoch(s_rev.trainer.init(s_rev.init_params))


@pytest.mark.parametrize("mode,batch_major", [("sequential", True),
                                              ("sequential", False),
                                              ("batch", True)])
def test_case2_forward_mode_takes_plain_ops_only_for_jacfwd(mode,
                                                            batch_major):
    """Forward mode differentiates ``loss_fwd``, built from the plain ops;
    the evaluation pass's loss is built from the kernel ops, whose
    autograd.Function refuses jacfwd (on the CPU they run their plain
    version, so the refusal is what shows which ops a loss was built on)."""
    setup = tcase2.build(tcase2.Case2Config(
        device="cpu", mode=mode, grad_mode="fwd", batch_major=batch_major,
        n_exp_train=2, n_exp_test=1, datasize=8, max_steps=32))
    trainer = setup.trainer
    assert trainer._grad_loss() is trainer.loss_fwd
    idxs, masks = torch.arange(1), torch.ones((1, 8))

    def grad_of(loss):
        return torch.func.jacfwd(
            lambda p: torch.mean(loss(p, idxs, masks)))(setup.init_params)

    assert bool(torch.isfinite(grad_of(trainer.loss_fwd)).all())
    with pytest.raises(RuntimeError, match="setup_context"):
        grad_of(trainer.loss_batch_eval)


@pytest.mark.parametrize("mode", ["batch", "sequential"])
def test_n_exp_update_visits_every_experiment(mode):
    """``n_exp_update = n_exp``: the updates visit all experiments, the
    validation split included (case3's quirk), once each per epoch."""
    seen = []

    def loss(p, idxs, masks):
        seen.append(idxs.tolist())
        return ((p - idxs[:, None].to(p.dtype)) ** 2).sum(-1)

    trainer = Trainer(loss_i_exp=loss, optimizer=adamw_like(0.1),
                      n_exp_train=3, n_exp=5, n_save=2, mode=mode,
                      n_exp_update=5)
    state, _ = trainer.epoch(trainer.init(torch.zeros(2,
                                                      dtype=torch.float64)))
    updates = seen[:-1]                    # the last call is the eval pass
    assert sorted(sum(updates, [])) == [0, 1, 2, 3, 4]
    assert len(updates) == (5 if mode == "sequential" else 1)
    assert state.opt_state.count == len(updates)
    assert seen[-1] == [0, 1, 2, 3, 4]
