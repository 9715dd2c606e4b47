"""yeast glycolysis in the port against the JAX package: ``p2vec_yeast``
with its ties and the init layout, ``yeast_truth`` and its constants,
``std_scale`` (ddof 0, as ``jnp.std``), the hybrid RHS (the MLP in plain
torch, the CRNN core through the kernel op and its plain twin) with its
gradients in f64 at 1e-12, the TRBDF2 solve at JAX's initial params
(n_steps exact), and one whole training epoch in f64 at rtol 1e-6 with the
params tree raveled in JAX's order
(tests/test_torch_mlp.py:check_tree_epoch_vs_jax), at the reference MLP
width (``mlp_width=16`` and the generated data:
tests/test_torch_yeast_width.py).

Reduced size, as tests/test_yeast_width.py:14 runs the JAX case: 2
training and 1 held-out experiments, 16 save points over [0, 5] (so the
horizons are 32-16, i.e. all 16) and max_steps 96; ns=7, ns_=12, nr=12,
TRBDF2 at rtol 1e-2 / atol 1e-5 as shipped, in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree as j_ravel
from test_torch_mlp import check_tree_epoch_vs_jax

from crnn_tpu.cases import yeast as jy
from crnn_tpu.data import truth as jt
from crnn_tpu.data.generate import std_scale as j_std_scale
from crnn_tpu.models.crnn import make_crnn_yeast_rhs as j_yeast_rhs
from crnn_tpu.models.mlp import make_mlp as j_make_mlp
from crnn_tpu.transforms.p2vec import p2vec_yeast as j_p2vec_yeast
from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import yeast as ty
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.data.generate import std_scale
from crnn_tpu_torch.models.crnn import make_crnn_yeast_rhs
from crnn_tpu_torch.models.mlp import mlp_apply
from crnn_tpu_torch.transforms.p2vec import init_params_yeast, p2vec_yeast
from crnn_tpu_torch.transforms.ravel import ravel_pytree

NS, NS_, NR = 7, 12, 12
NP = NR * (NS_ + 1) + NS + 1
SMALL = dict(n_exp_train=2, n_exp_val=1, ntotal=16, max_steps=96,
             dtype="float64")
ACTS = ("gelu", "gelu", "gelu", "softplus")


def _p(seed=0):
    p = np.random.default_rng(seed).uniform(-0.9, 0.9, size=NP) * 0.05
    p[-1] = 0.1
    p[NR + 5] = 0.0                 # a w_out == 0 tie of the clip
    return p


def test_p2vec_yeast_matches_jax_with_gradients():
    p = _p()
    got = p2vec_yeast(torch.from_numpy(p), NS, NS_, NR)
    want = j_p2vec_yeast(jnp.asarray(p), NS, NS_, NR)
    for name in ("w_in", "w_b", "w_out", "w_J"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    assert got.w_in.shape == (NS_, NR) and got.w_J.shape == (NS,)

    def j_f(p_):
        w = j_p2vec_yeast(p_, NS, NS_, NR)
        return (jnp.sum(w.w_in ** 2) + jnp.sum(w.w_b ** 3)
                + jnp.sum(jnp.sin(w.w_out)) + jnp.sum(w.w_J ** 2))

    pt = torch.from_numpy(p).requires_grad_(True)
    w = p2vec_yeast(pt, NS, NS_, NR)
    (g,) = torch.autograd.grad(
        torch.sum(w.w_in ** 2) + torch.sum(w.w_b ** 3)
        + torch.sum(torch.sin(w.w_out)) + torch.sum(w.w_J ** 2), pt)
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(jax.grad(j_f)(jnp.asarray(p))),
                               rtol=1e-15, atol=0)


def test_init_params_yeast_layout():
    p = init_params_yeast(torch.Generator().manual_seed(0), NS, NS_, NR,
                          device="cpu")
    assert p.shape == (NP,) and p.dtype == torch.float32
    assert p[-1].item() == pytest.approx(0.1)
    lim = (6.0 / (NS_ + NR)) ** 0.5
    assert float(p[:-1].abs().max()) <= lim
    assert float(p[:-1].abs().max()) > 0.5 * lim


def test_yeast_truth_and_constants_match_jax():
    for name in ("YEAST_K", "YEAST_IC_LB", "YEAST_IC_UB"):
        np.testing.assert_array_equal(np.asarray(getattr(tt, name)),
                                      np.asarray(getattr(jt, name)))
    rng = np.random.default_rng(1)
    y = rng.uniform(0.0, 2.5, size=(9, NS))
    k = np.broadcast_to(np.asarray(tt.YEAST_K), (9, 6)) * rng.uniform(
        0.5, 1.5, size=(9, 6))
    want = jax.vmap(lambda yy, kk: jt.yeast_truth(0.0, yy, kk))(
        jnp.asarray(y), jnp.asarray(k))
    got = tt.yeast_truth(0.0, torch.from_numpy(y), torch.from_numpy(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=1e-14 * float(np.abs(want).max()))


def test_std_scale_matches_jax():
    ys = np.random.default_rng(2).normal(size=(4, 11, NS)) * 3.0
    np.testing.assert_allclose(
        std_scale(torch.from_numpy(ys), 1e-5).numpy(),
        np.asarray(j_std_scale(jnp.asarray(ys), 1e-5)), rtol=1e-14)


def _j_mlp(width=5):
    return j_make_mlp(jax.random.PRNGKey(3), [NS, width, width, width, 5],
                      list(ACTS), jnp.float64)


@pytest.mark.parametrize("plain", [False, True])
def test_yeast_rhs_matches_jax_with_gradients(plain):
    """The hybrid RHS on lanes against ``vmap`` of JAX's: values and the
    gradient of a scalar of it w.r.t. y, the weights and the MLP, f64
    1e-12 (of each array's largest entry near 0). ``plain=False`` is the
    kernel op (its CPU forward the plain version, its backward autograd of
    it); y has an entry below lb and one above ub."""
    rng = np.random.default_rng(4)
    y = rng.uniform(0.05, 2.5, size=(6, NS))
    y[0, 0], y[1, 3] = 1e-7, 150.0
    p = _p(5)
    j_mlp, j_apply = _j_mlp()
    j_rhs = j_yeast_rhs(1e-5, 100.0, NS, j_apply)

    def j_total(yy, pp, mm):
        w = j_p2vec_yeast(pp, NS, NS_, NR)
        out = jax.vmap(lambda v: j_rhs(0.0, v, (w, mm)))(yy)
        return jnp.sum(jnp.tanh(out)), out

    _, want = j_total(jnp.asarray(y), jnp.asarray(p), j_mlp)
    j_grads = jax.grad(lambda *a: j_total(*a)[0], argnums=(0, 1, 2))(
        jnp.asarray(y), jnp.asarray(p), j_mlp)

    _, unravel = ravel_pytree([{k: torch.from_numpy(np.array(v))
                                for k, v in d.items()} for d in j_mlp])
    m_flat = convert.params_from_jax(j_mlp, device="cpu").requires_grad_(True)
    rhs = make_crnn_yeast_rhs(1e-5, 100.0, NS,
                              lambda m, x: mlp_apply((m, ACTS), x),
                              plain=plain)
    yt = torch.from_numpy(y).requires_grad_(True)
    pt = torch.from_numpy(p).requires_grad_(True)
    got = rhs(None, yt, (p2vec_yeast(pt, NS, NS_, NR), unravel(m_flat)))
    want = np.asarray(want)
    assert got.shape == (6, NS)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())
    grads = torch.autograd.grad(torch.tanh(got).sum(), (yt, pt, m_flat))
    for g, jg in zip(grads, (j_grads[0], j_grads[1],
                             j_ravel(j_grads[2])[0])):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-12,
                                   atol=1e-12 * np.abs(jg).max())


def jax_setup(width):
    cfg = jy.YeastConfig(mlp_width=width, **SMALL)
    return cfg, jy.build(cfg)


@pytest.fixture(scope="module")
def jsetup():
    return jax_setup(0)


def check_solve(jsetup):
    """The TRBDF2 solve of every experiment at JAX's initial params, early
    exit: n_steps exact, ys at rtol 1e-9 of the largest."""
    from crnn_tpu.ode import TRBDF2 as JTRBDF2
    from crnn_tpu.ode import odesolve as j_odesolve
    from crnn_tpu_torch.ode.rosenbrock import lane_jacfwd
    from crnn_tpu_torch.ode.sdirk import TRBDF2
    from crnn_tpu_torch.ode.solve import odesolve

    cfg, js = jsetup
    ds = js.dataset
    jp = js.init_params
    t1 = float(ds.ts[-1])
    j_rhs = j_yeast_rhs(cfg.lb, cfg.ub, NS, js.extras["mlp_apply"])
    w_j = j_p2vec_yeast(jp["crnn"], NS, NS_, NR)
    jsol = jax.vmap(lambda u: j_odesolve(
        j_rhs, JTRBDF2(), u, 0.0, t1, ds.ts, args=(w_j, jp["mlp"]),
        rtol=cfg.rtol, atol=cfg.atol, max_steps=cfg.max_steps,
        unroll="while"))(ds.u0)
    setup = ty.build(ty.YeastConfig(mlp_width=cfg.mlp_width, device="cpu",
                                    **SMALL),
                     dataset=convert.dataset_from_jax(
                         *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean,
                                                   ds.ts, ds.yscale)),
                         success=np.asarray(ds.success), device="cpu"))
    p = convert.params_from_jax(jp, device="cpu")
    tree = setup.unravel(p)
    mlp_fn = setup.extras["mlp_apply"]
    rhs = make_crnn_yeast_rhs(cfg.lb, cfg.ub, NS, mlp_fn)
    rhs_plain = make_crnn_yeast_rhs(cfg.lb, cfg.ub, NS, mlp_fn, plain=True)
    solver = TRBDF2(jac=lambda t, y, a: lane_jacfwd(
        lambda yy: rhs_plain(t, yy, a), y))
    sol = odesolve(rhs, solver, setup.dataset.u0, 0.0, t1, setup.dataset.ts,
                   args=(setup.weights_fn(p), tree["mlp"]), rtol=cfg.rtol,
                   atol=cfg.atol, max_steps=cfg.max_steps, unroll="while")
    np.testing.assert_array_equal(sol.n_steps.numpy(),
                                  np.asarray(jsol.n_steps))
    np.testing.assert_array_equal(sol.success.numpy(),
                                  np.asarray(jsol.success))
    want = np.asarray(jsol.ys)
    np.testing.assert_allclose(sol.ys.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())
    assert [tuple(d["w"].shape) for d in tree["mlp"]] == [
        tuple(np.shape(d["w"])) for d in jp["mlp"]]


def check_epoch(jsetup):
    cfg, js = jsetup
    setup, masks = check_tree_epoch_vs_jax(js, lambda ds: ty.build(
        ty.YeastConfig(mlp_width=cfg.mlp_width, device="cpu", **SMALL),
        dataset=ds), SMALL["n_exp_train"], rtol=1e-6)
    # the horizons are drawn in [32, 16]: every save point
    assert bool((masks == 1).all())
    assert setup.trainer.horizon_range == (32, 16)


def test_solve_matches_jax(jsetup):
    check_solve(jsetup)


def test_epoch_matches_jax_f64(jsetup):
    check_epoch(jsetup)
