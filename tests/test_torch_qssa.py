"""The Robertson QSSA hybrid in the port against the JAX package: the
p2vec with its ties, the hybrid RHS (the MLP in plain torch, the CRNN core
through the kernel op and its plain twin) and its gradients in f64 at
1e-12, the post-solve y2 re-prediction, and one whole training epoch in
f64 at rtol 1e-6 with the params tree raveled in JAX's order
(tests/test_torch_mlp.py:check_tree_epoch_vs_jax).

Reduced size: 2 training and 1 held-out experiments and 16 log-spaced save
points over [1e-2, 1e5]; ns=nr=3, the 2-4-4-4-1 MLP, Rosenbrock23 at rtol
1e-3 / atol 1e-5 and max_steps 256 as shipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as j_ravel
from test_torch_mlp import capture_build, check_tree_epoch_vs_jax

from crnn_tpu.cases import robertson_qssa as jq
from crnn_tpu.models.crnn import make_crnn_qssa_rhs as j_qssa_rhs
from crnn_tpu.models.mlp import make_mlp as j_make_mlp
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import robertson_qssa as tq
from crnn_tpu_torch.models.crnn import make_crnn_qssa_rhs
from crnn_tpu_torch.models.mlp import mlp_apply
from crnn_tpu_torch.transforms.ravel import ravel_pytree, tree_leaves

SMALL = dict(n_exp_train=2, n_exp_val=1, datasize=16)
ACTS = ("gelu", "gelu", "gelu", "exp")


@pytest.fixture(scope="module")
def jsetup():
    return jq.build(jq.QSSAConfig(**SMALL))


def _p(seed=0):
    p = np.random.default_rng(seed).uniform(-0.9, 0.9, size=22)
    p[3 * 4 + 2] = 0.0          # a w_in == 0 tie of the clip
    p[3 + 4] = 0.0              # a w_out_raw == 0: the |.| kink
    return p


def test_p2vec_qssa_matches_jax_with_gradients():
    p = _p()
    got = tq.p2vec_qssa(torch.from_numpy(p), 3, 3)
    want = jq.p2vec_qssa(jnp.asarray(p), 3, 3)
    for name in ("w_in", "w_b", "w_out"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))

    def j_f(p_):
        w = jq.p2vec_qssa(p_, 3, 3)
        return (jnp.sum(w.w_in ** 2) + jnp.sum(w.w_b ** 3)
                + jnp.sum(jnp.sin(w.w_out)))

    pt = torch.from_numpy(p).requires_grad_(True)
    w = tq.p2vec_qssa(pt, 3, 3)
    (g,) = torch.autograd.grad(torch.sum(w.w_in ** 2) + torch.sum(w.w_b ** 3)
                               + torch.sum(torch.sin(w.w_out)), pt)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(j_f)(jnp.asarray(p))),
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("plain", [False, True])
def test_qssa_rhs_matches_jax_with_gradients(plain):
    """The hybrid RHS on lanes against ``vmap`` of JAX's: values and the
    gradient of a scalar of it w.r.t. y, the weights and the MLP, f64
    1e-12 (of each array's largest entry near 0). ``plain=False`` is the
    kernel op, whose CPU forward is the plain version and whose backward is
    autograd of it."""
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 1.5, size=(5, 3))
    y[:, 1] = 1e-5
    y[0, 0] = 1e-9                  # below lb
    p = _p(2)
    j_mlp, j_apply = j_make_mlp(jax.random.PRNGKey(0), [2, 4, 4, 4, 1],
                                list(ACTS), jnp.float64)
    j_rhs = j_qssa_rhs(1e-5, 10.0, j_apply)

    def j_total(yy, pp, mm):
        w = jq.p2vec_qssa(pp, 3, 3)
        out = jax.vmap(lambda v: j_rhs(0.0, v, (w, mm)))(yy)
        return jnp.sum(jnp.tanh(out)), out

    _, want = j_total(jnp.asarray(y), jnp.asarray(p), j_mlp)
    j_grads = jax.grad(lambda *a: j_total(*a)[0], argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(p), j_mlp)

    _, unravel = ravel_pytree([{k: torch.from_numpy(np.array(v))
                                for k, v in d.items()} for d in j_mlp])
    m_flat = convert.params_from_jax(j_mlp, device="cpu").requires_grad_(True)
    mlp = unravel(m_flat)
    rhs = make_crnn_qssa_rhs(1e-5, 10.0,
                             lambda m, x: mlp_apply((m, ACTS), x), plain=plain)
    yt = torch.from_numpy(y).requires_grad_(True)
    pt = torch.from_numpy(p).requires_grad_(True)
    got = rhs(None, yt, (tq.p2vec_qssa(pt, 3, 3), mlp))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    grads = torch.autograd.grad(torch.tanh(got).sum(), (yt, pt, m_flat))
    for g, jg in zip(grads, (j_grads[0], j_grads[1],
                             j_ravel(j_grads[2])[0])):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12,
                                   atol=1e-12 * np.abs(jg).max())


def _port_setup(jsetup, **kw):
    ds = jsetup.dataset
    dataset = convert.dataset_from_jax(
        *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean, ds.ts,
                                  ds.yscale)),
        success=np.asarray(ds.success), device="cpu")
    return tq.build(tq.QSSAConfig(device="cpu", **SMALL, **kw),
                    dataset=dataset)


def test_solve_and_y2_post_pass_match_jax(jsetup):
    """At JAX's initial params: the early-exit solve of every experiment
    (n_steps exact, ys at rtol 1e-9) and the prediction, whose y2 column is
    the MLP re-prediction from the solved (y1, y3) (at 1e-12 of JAX's);
    the port's own y2 column is the MLP of its own y1 and y3 exactly."""
    from crnn_tpu.ode import Rosenbrock23 as JRb23
    from crnn_tpu.ode import odesolve as j_odesolve
    from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23, lane_jacfwd
    from crnn_tpu_torch.ode.solve import odesolve

    setup = _port_setup(jsetup)
    cfg = tq.QSSAConfig(**SMALL)
    jp = jsetup.init_params
    p = convert.params_from_jax(jp, device="cpu")
    ds = setup.dataset
    t1 = float(ds.ts[-1])
    j_rhs = j_qssa_rhs(cfg.lb, cfg.ub, jsetup.extras["mlp_apply"])
    w_j = jq.p2vec_qssa(jp["crnn"], 3, 3)
    jsol = jax.vmap(lambda u: j_odesolve(
        j_rhs, JRb23(), u, 0.0, t1, jnp.asarray(ds.ts.numpy()),
        args=(w_j, jp["mlp"]), rtol=cfg.rtol, atol=cfg.atol,
        max_steps=cfg.max_steps, unroll="while"))(jnp.asarray(ds.u0.numpy()))
    tree = setup.unravel(p)
    mlp_fn = setup.extras["mlp_apply"]
    rhs = make_crnn_qssa_rhs(cfg.lb, cfg.ub, mlp_fn)
    rhs_plain = make_crnn_qssa_rhs(cfg.lb, cfg.ub, mlp_fn, plain=True)
    sol = odesolve(rhs, Rosenbrock23(jac=lambda t, y, a: lane_jacfwd(
        lambda yy: rhs_plain(t, yy, a), y)), ds.u0, 0.0, t1, ds.ts,
        args=(setup.weights_fn(p), tree["mlp"]), rtol=cfg.rtol,
        atol=cfg.atol, max_steps=cfg.max_steps, unroll="while")
    np.testing.assert_array_equal(sol.n_steps.numpy(),
                                  np.asarray(jsol.n_steps))
    assert bool(sol.success.all())
    np.testing.assert_allclose(sol.ys.numpy(), np.asarray(jsol.ys),
                               rtol=1e-9, atol=1e-9 * float(ds.ys.abs().max()))
    for i in range(cfg.n_exp_train + cfg.n_exp_val):
        got = setup.predict(p, i)
        want = np.asarray(jsetup.predict(jp, i))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-12 * np.abs(want).max())
        y2 = mlp_fn(tree["mlp"], got[:, 0::2].contiguous())
        assert torch.equal(got[:, 1:2], y2)
        # y2 is not the solved (zero-rate) state: the post-pass replaced it
        assert not torch.equal(got[:, 1], sol.ys[i, :, 1])


def test_epoch_matches_jax_f64(jsetup):
    check_tree_epoch_vs_jax(jsetup, lambda ds: tq.build(
        tq.QSSAConfig(device="cpu", **SMALL), dataset=ds),
        SMALL["n_exp_train"], rtol=1e-6)


def test_cli_generates_data_and_writes_p_opt_npz(tmp_path, monkeypatch):
    """The CLI with ``--device cpu`` at the reduced size:
    the f64 truth it generates (every solve successful, the radical
    starting at lb, unit scales), the init layout, one epoch, and
    ``p_opt.npz`` with the params tree's
    leaves in JAX's order."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tq.build(tq.QSSAConfig(**SMALL))
    seen = capture_build(monkeypatch, tq, "QSSAConfig", **SMALL)
    state, hist = tq.main(["--epochs", "1", "--device", "cpu", "--out",
                           str(tmp_path)])
    (setup,) = seen
    ds = setup.dataset
    assert bool(ds.success.all()) and ds.ys.dtype == torch.float64
    assert torch.equal(ds.yscale, torch.ones(3, dtype=torch.float64))
    assert bool((ds.u0[:, 1] == 1e-5).all())
    assert state.opt_state.count == 1 and np.isfinite(hist["loss_train"][0])
    init = setup.unravel(setup.init_params)
    assert init["crnn"].shape == (22,) and float(init["crnn"][-1]) == 0.1
    leaves = tree_leaves(setup.unravel(state.params))
    assert [tuple(x.shape) for x in leaves] == [
        (22,), (4,), (4, 2), (4,), (4, 4), (4,), (4, 4), (1,), (1, 4)]
    got = np.load(tmp_path / "robertson_qssa" / "p_opt.npz")
    assert [got[f"arr_{i}"].shape for i in range(len(got.files))] == [
        tuple(x.shape) for x in leaves]
