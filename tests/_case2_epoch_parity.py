"""Helper of tests/test_torch_case2_epoch*.py: one whole case2 batch-mode
training epoch, crnn_tpu_torch against
crnn_tpu on the same dataset, params, optimizer state and permutation,
all carried across through crnn_tpu_torch.convert.

Reduced to 4 training and 2 held-out experiments; ns=6, nr=3, 50 save
points and max_steps 128 as shipped. The epoch compared is the second one,
so the optimizer state (mu, nu, count=1) is not trivial. In f64 the two
packages run the same arithmetic up to summation order: loss, gradient,
updated params and eval losses agree at rtol 1e-6. In f32 the rounding of
~128 solver steps accumulates: rtol 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from crnn_tpu.cases import case2 as jcase2
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import case2 as tcase2
from crnn_tpu_torch.train.loop import TrainState

N_TRAIN, N_TEST = 4, 2


def _adam_state(opt_state):
    # expdecay_adamw = chain(clip, chain(decay, chain(adam, schedule)))
    return opt_state[1][1][0]


def check_case2_epoch(dtype: str, rtol: float):
    jcfg = jcase2.Case2Config(n_exp_train=N_TRAIN, n_exp_test=N_TEST,
                              dtype=dtype, max_steps=128)
    jsetup = jcase2.build(jcfg)
    jtrainer = jsetup.trainer
    epoch = jtrainer.epoch_fn()
    state1, _ = epoch(jtrainer.init(jsetup.init_params, seed=0))
    state2, jm = epoch(state1)
    # the permutation the JAX epoch drew from its key (train/loop.py:119-122)
    perm = np.asarray(jax.random.permutation(
        jax.random.split(state1.key, 3)[1], N_TRAIN))
    masks = jnp.ones((N_TRAIN, jcfg.datasize), jnp.dtype(dtype))
    j_loss, j_grad = jax.value_and_grad(
        lambda p: jnp.mean(jtrainer.loss_batch(p, jnp.asarray(perm), masks))
    )(state1.params)

    ds = jsetup.dataset
    dataset = convert.dataset_from_jax(*(np.asarray(a) for a in (
        ds.u0, ds.ys, ds.ys_clean, ds.ts, ds.yscale)), device="cpu")
    setup = tcase2.build(tcase2.Case2Config(
        n_exp_train=N_TRAIN, n_exp_test=N_TEST, dtype=dtype, device="cpu"),
        dataset=dataset)
    adam = _adam_state(state1.opt_state)
    trainer = setup.trainer
    state = TrainState(
        convert.params_from_jax(np.asarray(state1.params), device="cpu"),
        convert.opt_state_from_jax(np.asarray(adam.mu), np.asarray(adam.nu),
                                   adam.count, device="cpu"),
        1, torch.Generator().manual_seed(0))

    loss, grad = trainer.value_and_grad(state.params, torch.tensor(perm))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=rtol,
                               atol=rtol * float(jnp.abs(j_grad).max()))
    new_state, m = trainer.epoch(state, perm=torch.tensor(perm))
    np.testing.assert_allclose(new_state.params.numpy(),
                               np.asarray(state2.params), rtol=rtol)
    np.testing.assert_allclose(m.loss_exp.numpy(), np.asarray(jm.loss_exp),
                               rtol=rtol)
    for name in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(getattr(jm, name)), rtol=rtol)
    assert new_state.epoch == int(state2.epoch) == 2
    assert new_state.opt_state.count == int(_adam_state(state2.opt_state).count)
