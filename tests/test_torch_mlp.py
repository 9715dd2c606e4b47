"""The hybrid cases' MLP and params tree in the port against the JAX
package: every activation (JAX's tanh GELU and its threshold-free
softplus), ``mlp_apply`` with its gradients in f64 at 1e-12, the Glorot
init's shapes and bounds, the ravel order equal to
``jax.flatten_util.ravel_pytree``'s exactly, unravel as its inverse, the
params tree and its optax moments through ``convert``, and ``p_opt.npz``
in JAX's leaf order.

``capture_build`` patches a case's config and build for its CLI test.
``check_tree_epoch_vs_jax`` is the whole-epoch parity check of a case whose
params are a tree (tests/test_torch_yeast.py, tests/test_torch_qssa.py):
the JAX run trains one epoch, its params tree and optax state cross to the
port raveled, and both packages run the second epoch on the same
permutation and horizon masks, which JAX drew from its key.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree as j_ravel

from crnn_tpu.models import mlp as jmlp
from crnn_tpu.train.optimizers import expdecay_adamw as j_expdecay_adamw
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import base
from crnn_tpu_torch.cases.base import _save_best
from crnn_tpu_torch.models import mlp as tmlp
from crnn_tpu_torch.train.loop import BestState, TrainState
from crnn_tpu_torch.train.optimizers import expdecay_adamw
from crnn_tpu_torch.transforms.ravel import ravel_pytree, tree_leaves

ACTS = ("gelu", "softplus", "exp", "tanh", "identity")


def _tree(seed=0, sizes=(7, 5, 5, 5, 5)):
    """A params dict of the hybrid cases' form, numpy f64."""
    rng = np.random.default_rng(seed)
    return {"crnn": rng.normal(size=13),
            "mlp": [{"w": rng.normal(size=(o, i)), "b": rng.normal(size=o)}
                    for i, o in zip(sizes[:-1], sizes[1:])]}


def _to(tree, fn):
    if isinstance(tree, dict):
        return {k: _to(v, fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, fn) for v in tree]
    return fn(tree)


@pytest.mark.parametrize("act", ACTS)
def test_activations_match_jax_with_gradients(act):
    """Values and derivatives at 1e-12 in f64, over |x| up to 40: softplus
    above torch's threshold of 20, the GELU's tails (where 1 + tanh
    cancels, the two tanh implementations' ulp leaves ~1e-15 absolute)."""
    x = np.concatenate([np.linspace(-40.0, 40.0, 161),
                        np.random.default_rng(1).normal(size=64) * 3.0])
    if act == "exp":
        x = x / 2.0
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmlp.ACTIVATIONS[act](xt)
    (g,) = torch.autograd.grad(got.sum(), xt)
    j_fn = jmlp._ACT[act]
    want = j_fn(jnp.asarray(x))
    j_g = jax.grad(lambda v: jnp.sum(j_fn(v)))(jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(g.numpy(), np.asarray(j_g), rtol=1e-12,
                               atol=1e-14)


def test_gelu_is_the_tanh_form_and_softplus_has_no_threshold():
    x = torch.tensor([0.7, 25.0], dtype=torch.float64)
    assert abs(float(tmlp.gelu(x)[0] - torch.nn.functional.gelu(x)[0])) > 1e-5
    sp = tmlp.softplus(x)[1]
    assert float(torch.nn.functional.softplus(x)[1]) == 25.0 < float(sp)
    np.testing.assert_allclose(float(sp), np.logaddexp(25.0, 0.0), rtol=1e-15)


@pytest.mark.parametrize("acts", [("gelu", "gelu", "gelu", "softplus"),
                                  ("gelu", "gelu", "gelu", "exp"),
                                  ("tanh", "identity", "softplus", "gelu")])
def test_mlp_apply_matches_jax_with_gradients(acts):
    """``mlp_apply`` on lanes against ``vmap`` of JAX's per-vector apply:
    values, and gradients w.r.t. every weight and the input, f64 1e-12
    (of each array's largest entry for entries near 0)."""
    tree = _tree(2)
    x = np.random.default_rng(3).uniform(0.0, 2.0, size=(6, 7))
    j_params = _to(tree["mlp"], jnp.asarray)

    def j_total(params, xx):
        out = jax.vmap(lambda v: jmlp.mlp_apply((params, acts), v))(xx)
        return jnp.sum(jnp.sin(out)), out

    (_, want), (j_gp, j_gx) = (
        j_total(j_params, jnp.asarray(x)),
        jax.grad(lambda p, v: j_total(p, v)[0], argnums=(0, 1))(
            j_params, jnp.asarray(x)))
    t_params = _to(tree["mlp"],
                   lambda a: torch.from_numpy(a).requires_grad_(True))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tmlp.mlp_apply((t_params, acts), xt)
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    leaves = tree_leaves(t_params)
    grads = torch.autograd.grad(torch.sin(got).sum(), leaves + [xt])
    j_leaves = tree_leaves(j_gp)
    for g, jg in zip(grads, j_leaves + [j_gx]):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12,
                                   atol=1e-12 * np.abs(jg).max())


def test_mlp_init_shapes_bounds_and_make_mlp():
    sizes, acts = [7, 16, 16, 16, 5], ["gelu", "gelu", "gelu", "softplus"]
    params, apply_fn = tmlp.make_mlp(torch.Generator().manual_seed(0), sizes,
                                     acts, torch.float64, "cpu")
    assert [tuple(p["w"].shape) for p in params] == [
        (16, 7), (16, 16), (16, 16), (5, 16)]
    for p, (i, o) in zip(params, zip(sizes[:-1], sizes[1:])):
        lim = (6.0 / (i + o)) ** 0.5
        assert float(p["w"].abs().max()) <= lim
        assert float(p["w"].abs().max()) > 0.5 * lim
        assert p["b"].shape == (o,) and bool((p["b"] == 0).all())
        assert p["w"].dtype == torch.float64
    assert apply_fn(params, torch.ones((3, 7), dtype=torch.float64)).shape \
        == (3, 5)
    with pytest.raises(ValueError, match="one activation per layer"):
        tmlp.mlp_init(torch.Generator(), [2, 3], ["gelu", "exp"], device="cpu")


def test_ravel_order_is_jax_ravel_pytree_and_unravel_inverts():
    """The flat vector equals ``jax.flatten_util.ravel_pytree``'s exactly
    (``crnn`` first, then each layer's ``b`` before its ``w``, C order),
    and unravel rebuilds the tree, each leaf a view that carries
    gradients."""
    tree = _tree(4)
    want, j_unravel = j_ravel(_to(tree, jnp.asarray))
    flat, unravel = ravel_pytree(_to(tree, torch.from_numpy))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(want))
    np.testing.assert_array_equal(flat[:13].numpy(), tree["crnn"])
    np.testing.assert_array_equal(flat[13:18].numpy(), tree["mlp"][0]["b"])
    np.testing.assert_array_equal(flat[18:53].numpy(),
                                  tree["mlp"][0]["w"].reshape(-1))
    back = unravel(flat)
    j_back = j_unravel(want)
    for a, b in zip(tree_leaves(back), tree_leaves(j_back)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert back["mlp"][2]["w"].shape == (5, 5)
    # the leaves are views of the flat vector: gradients reach it
    v = flat.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(unravel(v)["mlp"][1]["w"].sum(), v)
    assert float(g.sum()) == 25.0 and float(g[13 + 5 + 35:][:5].sum()) == 0.0


def test_clip_and_decay_over_the_flat_vector_equal_optax_over_leaves():
    """Three steps of the yeast optimizer (coupled decay, staircase lr) with
    a global-norm clip that engages, on the raveled tree, against optax on
    the tree; and optax's tree state through ``convert``."""
    tree = _to(_tree(5), jnp.asarray)
    grads = [_to(_tree(6 + i), lambda a: jnp.asarray(a) * 3.0)
             for i in range(3)]
    j_opt = j_expdecay_adamw(5e-3, 0.5, 2, 1e-5, weight_decay=1e-3,
                             grad_max=1.0)
    t_opt = expdecay_adamw(5e-3, 0.5, 2, 1e-5, weight_decay=1e-3,
                           grad_max=1.0)
    j_state = j_opt.init(tree)
    p = convert.params_from_jax(tree, device="cpu")
    t_state = t_opt.init(p)
    for g in grads:
        upd, j_state = j_opt.update(g, j_state, tree)
        tree = optax.apply_updates(tree, upd)
        p, t_state = t_opt.update(convert.params_from_jax(g, device="cpu"),
                                  t_state, p)
    np.testing.assert_allclose(p.numpy(), np.asarray(j_ravel(tree)[0]),
                               rtol=1e-13)
    adam = convert.adam_state_from_optax(j_state, device="cpu")
    assert adam.count == t_state.count == 3
    np.testing.assert_allclose(adam.mu.numpy(), t_state.mu.numpy(),
                               rtol=1e-13)
    np.testing.assert_allclose(adam.nu.numpy(), t_state.nu.numpy(),
                               rtol=1e-13)


def test_save_best_writes_npz_leaves_in_jax_tree_order(tmp_path):
    """A tree case's best params go to ``p_opt.npz``, ``arr_i`` the i-th
    leaf of ``jax.tree.flatten``; a flat case keeps ``p_opt.npy``."""
    tree = _tree(7)
    flat, unravel = ravel_pytree(_to(tree, torch.from_numpy))
    best = BestState(flat, np.float32(0.5), np.float32(0.4), 0)
    _save_best(str(tmp_path), "t", best, quiet=True, unravel=unravel)
    got = np.load(tmp_path / "p_opt.npz")
    j_leaves, _ = jax.tree.flatten(_to(tree, jnp.asarray))
    assert len(got.files) == len(j_leaves) == 9
    for i, leaf in enumerate(j_leaves):
        np.testing.assert_array_equal(got[f"arr_{i}"], np.asarray(leaf))
    assert not (tmp_path / "p_opt.npy").exists()
    _save_best(str(tmp_path), "t", best, quiet=True)
    np.testing.assert_array_equal(np.load(tmp_path / "p_opt.npy"),
                                  flat.numpy())


def check_tree_epoch_vs_jax(jsetup, build_port, n_train: int, rtol: float):
    """One whole epoch of a case whose params are a tree, the port against
    JAX (see the module docstring): loss, gradient, updated params, eval
    losses, metrics and the Adam state at ``rtol``. ``build_port(dataset)``
    builds the port's setup on the CPU. Returns (the port's setup, the
    horizon masks)."""
    jtrainer = jsetup.trainer
    epoch = jtrainer.epoch_fn()
    state1, _ = epoch(jtrainer.init(jsetup.init_params, seed=0))
    state2, jm = epoch(state1)
    _, k_perm, k_hor = jax.random.split(state1.key, 3)
    dtype = state1.params["crnn"].dtype
    perm = jax.random.permutation(k_perm, n_train)
    masks = jtrainer._sample_masks(k_hor, n_train, dtype)

    def j_mean_loss(p):
        return jnp.mean(jax.vmap(
            lambda i, m: jtrainer.loss_i_exp(p, i, m))(perm, masks))

    j_loss, j_grad = jax.value_and_grad(j_mean_loss)(state1.params)
    ds = jsetup.dataset
    dataset = convert.dataset_from_jax(
        *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean, ds.ts,
                                  ds.yscale)),
        success=np.asarray(ds.success), device="cpu")
    setup = build_port(dataset)
    # the port's init is the raveled tree of the same structure
    assert setup.init_params.shape == j_ravel(jsetup.init_params)[0].shape
    trainer = setup.trainer
    state = TrainState(
        convert.params_from_jax(state1.params, device="cpu"),
        convert.adam_state_from_optax(state1.opt_state, device="cpu"),
        1, torch.Generator().manual_seed(0))
    # the flat vector is JAX's ravel of the tree, leaf for leaf
    np.testing.assert_array_equal(state.params.numpy(),
                                  np.asarray(j_ravel(state1.params)[0]))
    perm_t = torch.from_numpy(np.array(perm))
    masks_t = torch.from_numpy(np.array(masks))

    loss, grad = trainer.value_and_grad(state.params, perm_t, masks_t)
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=rtol)
    j_g = np.asarray(j_ravel(j_grad)[0])
    np.testing.assert_allclose(grad.numpy(), j_g, rtol=rtol,
                               atol=rtol * float(np.abs(j_g).max()))
    new_state, m = trainer.epoch(state, perm=perm_t, masks=masks_t)
    np.testing.assert_allclose(new_state.params.numpy(),
                               np.asarray(j_ravel(state2.params)[0]),
                               rtol=rtol)
    np.testing.assert_allclose(m.loss_exp.numpy(), np.asarray(jm.loss_exp),
                               rtol=rtol)
    for name in ("loss_train", "loss_val", "grad_norm"):
        np.testing.assert_allclose(getattr(m, name).item(),
                                   float(getattr(jm, name)), rtol=rtol)
    adam2 = convert.adam_state_from_optax(state2.opt_state, device="cpu")
    assert new_state.opt_state.count == adam2.count == 2
    np.testing.assert_allclose(new_state.opt_state.nu.numpy(),
                               adam2.nu.numpy(), rtol=rtol,
                               atol=rtol * float(adam2.nu.abs().max()))
    return setup, masks_t


def capture_build(monkeypatch, mod, cls, **small):
    """Patch ``mod``'s config to ``small`` and its build to record the
    setup it returns; returns the list the setups go to."""
    seen = []
    build = mod.build
    monkeypatch.setattr(mod, cls, functools.partial(getattr(mod, cls),
                                                    **small))
    monkeypatch.setattr(mod, "build",
                        lambda *a, **k: seen.append(build(*a, **k))
                        or seen[-1])
    monkeypatch.setattr(base, "have_matplotlib", lambda: False)
    return seen
