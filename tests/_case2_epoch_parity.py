"""Helper of the whole-epoch parity tests (tests/test_torch_case2_epoch*.py,
tests/test_torch_case1_epoch.py, tests/test_torch_robertson_epoch.py,
tests/test_torch_case3.py, tests/test_torch_case1_rev.py,
tests/test_torch_case2_variants.py and others): one batch-mode
training epoch, crnn_tpu_torch against crnn_tpu.

The JAX run trains one epoch (or ``n_warm``); its params, optax state
(whatever the optimizer's chain) and dataset (with its truth-solve
``success``) cross to the port through crnn_tpu_torch.convert, and both
packages run the next epoch on the same permutation and horizon masks,
which JAX drew from its key. Gradients are taken in the trainer's
``grad_mode``: reverse mode through the scan, or forward mode through the
early-exit while driver (case1 rev). The optimizer state of the compared
epoch (mu, nu, count >= 1) is not trivial. In f64 the two run the same
arithmetic up to summation order: loss, gradient, updated params, eval
losses and metrics agree at rtol 1e-6. In f32 the rounding of ~128 solver
steps accumulates: rtol 1e-3.

case2 is reduced to 4 training and 2 held-out experiments; ns=6, nr=3, 50
save points and max_steps 128 as shipped.
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


def check_epoch_vs_jax(jsetup, build_port, n_train: int, rtol: float,
                       inspect=None, n_warm: int = 1):
    """``jsetup``: the JAX case's setup; ``build_port(dataset)``: the port's
    setup of the same configuration on the CPU. JAX trains ``n_warm``
    epochs before the compared one. ``inspect(j_params, j_grad, params,
    grad)``, if given, sees both packages' params at the start of the
    compared epoch and their gradients. Returns the horizon masks both
    epochs trained under."""
    jtrainer = jsetup.trainer
    epoch = jtrainer.epoch_fn()
    state1 = jtrainer.init(jsetup.init_params, seed=0)
    for _ in range(n_warm):
        state1, _ = epoch(state1)
    state2, jm = epoch(state1)
    # the draws of the JAX epoch from its key (crnn_tpu/train/loop.py:119-123)
    _, k_perm, k_hor = jax.random.split(state1.key, 3)
    dtype = state1.params.dtype
    perm = jax.random.permutation(k_perm, n_train)
    masks = jtrainer._sample_masks(k_hor, n_train, dtype)
    if jtrainer.loss_batch is not None:      # case2: the batch-major driver
        def j_mean_loss(p):
            return jnp.mean(jtrainer.loss_batch(p, perm, masks))
    else:                                    # per-lane cases under vmap
        # forward mode differentiates the while driver's loss
        # (crnn_tpu/train/loop.py:157-166)
        j_loss_i = (jtrainer.loss_i_exp_eval if jtrainer.grad_mode == "fwd"
                    else jtrainer.loss_i_exp)

        def j_mean_loss(p):
            return jnp.mean(jax.vmap(
                lambda i, m: j_loss_i(p, i, m))(perm, masks))
    if jtrainer.grad_mode == "fwd":
        j_loss = j_mean_loss(state1.params)
        j_grad = jax.jacfwd(j_mean_loss)(state1.params)
    else:
        j_loss, j_grad = jax.value_and_grad(j_mean_loss)(state1.params)

    ds = jsetup.dataset
    dataset = convert.dataset_from_jax(
        *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean, ds.ts,
                                  ds.yscale)),
        success=np.asarray(ds.success), device="cpu")
    assert torch.equal(dataset.success,
                       torch.from_numpy(np.array(ds.success)))
    setup = build_port(dataset)
    trainer = setup.trainer
    state = TrainState(
        convert.params_from_jax(np.asarray(state1.params), device="cpu"),
        convert.adam_state_from_optax(state1.opt_state, device="cpu"),
        n_warm, torch.Generator().manual_seed(0))
    perm_t = torch.from_numpy(np.array(perm))
    masks_t = torch.from_numpy(np.array(masks))

    loss, grad = trainer.value_and_grad(state.params, perm_t, masks_t)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    np.testing.assert_allclose(grad.numpy(), np.asarray(j_grad), rtol=rtol,
                               atol=rtol * float(jnp.abs(j_grad).max()))
    if inspect is not None:
        inspect(np.asarray(state1.params), np.asarray(j_grad),
                state.params, grad)
    new_state, m = trainer.epoch(state, perm=perm_t, masks=masks_t)
    np.testing.assert_allclose(new_state.params.numpy(),
                               np.asarray(state2.params), rtol=rtol)
    np.testing.assert_allclose(m.loss_exp.numpy(), np.asarray(jm.loss_exp),
                               rtol=rtol)
    for name in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(getattr(jm, name)), rtol=rtol)
    assert new_state.epoch == int(state2.epoch) == n_warm + 1
    adam2 = convert.adam_state_from_optax(state2.opt_state, device="cpu")
    assert new_state.opt_state.count == adam2.count == n_warm + 1
    np.testing.assert_allclose(new_state.opt_state.nu.numpy(),
                               adam2.nu.numpy(), rtol=rtol)
    return masks_t


def check_case2_epoch(dtype: str, rtol: float, jac_mode: str = "lowrank",
                      inspect=None, n_warm: int = 1, **fields):
    """``fields``: further ``Case2Config`` fields, the same in both
    packages (``i_obs``, ``missing_u0``, ``p_cutoff`` for the case2_missing
    and pruning variants). Returns the JAX setup."""
    jsetup = jcase2.build(jcase2.Case2Config(
        n_exp_train=N_TRAIN, n_exp_test=N_TEST, dtype=dtype, max_steps=128,
        jac_mode=jac_mode, **fields))

    def build_port(dataset):
        return tcase2.build(tcase2.Case2Config(
            n_exp_train=N_TRAIN, n_exp_test=N_TEST, dtype=dtype,
            device="cpu", jac_mode=jac_mode, **fields), dataset=dataset)

    masks = check_epoch_vs_jax(jsetup, build_port, N_TRAIN, rtol, inspect,
                               n_warm)
    assert bool((masks == 1).all())     # case2 has no stochastic horizon
    return jsetup
