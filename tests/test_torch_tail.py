"""The tail of the port against crnn_tpu on the same numpy inputs (f64):
the reaction-network language (``data/reactions.py``), the small inverses
(``ode/linsolve.py``), ``apply_w_out_cutoff``, ``TRUTH_REGISTRY``, the
mechanism export, profiling, the dtype scope, and the subpackages'
re-exports.
"""

import ast
import importlib
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.data import truth as jt
from crnn_tpu.data.reactions import ReactionNetwork as JReactionNetwork
from crnn_tpu.infra import export as jexport
from crnn_tpu.ode import linsolve as jls
from crnn_tpu.transforms.p2vec import CRNNWeights as JWeights
from crnn_tpu.transforms.pruning import apply_w_out_cutoff as j_cutoff
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.data.reactions import ReactionNetwork
from crnn_tpu_torch.infra import export
from crnn_tpu_torch.infra.profiling import Stopwatch, annotate, trace
from crnn_tpu_torch.infra.runtime import host_generation, x64_scope
from crnn_tpu_torch.ode import linsolve as tls
from crnn_tpu_torch.transforms.p2vec import CRNNWeights
from crnn_tpu_torch.transforms.pruning import apply_w_out_cutoff

ROOT = Path(__file__).resolve().parent.parent
F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


# ---- data/reactions.py: tests/test_reactions.py on the port ---------------

def test_parse_and_mass_action():
    net = ReactionNetwork(["A", "B", "C"])
    net.add("A + 2B -> C", kf=0.5)
    nu_react, nu_net = net.matrices(device="cpu")
    np.testing.assert_array_equal(nu_react[:, 0].numpy(), [1, 2, 0])
    np.testing.assert_array_equal(nu_net[:, 0].numpy(), [-1, -2, 1])
    dy = net.rhs()(0.0, _t([[2.0, 3.0, 0.1]]), net.rates(device="cpu"))
    rate = 0.5 * 2.0 * 3.0**2
    np.testing.assert_allclose(dy[0].numpy(), [-rate, -2 * rate, rate],
                               rtol=1e-6)
    # the RHS takes its dtype and device from y
    dy32 = net.rhs()(0.0, _t([[2.0, 3.0, 0.1]]).float(),
                     net.rates(torch.float32, "cpu"))
    assert dy32.dtype == torch.float32
    np.testing.assert_allclose(dy32.numpy(), dy.numpy(), rtol=1e-6)


def test_reversible_matches_handwritten_truth():
    """The language's 'case1 rev' equals the hand-written truth."""
    net = ReactionNetwork(["A", "B", "C", "D", "E"])
    for reaction in ("A <-> B", "B <-> C", "C <-> D", "2C <-> D + E"):
        net.add(reaction)
    y = _t([[0.7, 0.5, 0.3, 0.2, 0.1], [0.1, 0.9, 0.0, 0.4, 1.2]])
    dy = net.rhs()(0.0, y, net.rates(device="cpu"))
    k = _t(tt.REVERSIBLE_K).expand(2, -1)
    np.testing.assert_allclose(dy.numpy(), tt.reversible_truth(0.0, y, k).numpy(),
                               rtol=1e-12)


def test_zero_concentration_safe():
    net = ReactionNetwork(["A", "B"])
    net.add("2A -> B", kf=1.0)
    dy = net.rhs()(0.0, torch.zeros((1, 2), dtype=F64),
                   net.rates(device="cpu"))
    np.testing.assert_array_equal(dy.numpy(), [[0.0, 0.0]])


def test_parse_errors():
    net = ReactionNetwork(["A"])
    with pytest.raises(ValueError, match="unknown species"):
        net.add("A -> Z")
    with pytest.raises(ValueError, match="kb given"):
        net.add("A -> A", kf=1.0, kb=2.0)


def _network(cls):
    net = cls(["A", "B", "C", "D"])
    net.add("A + B <-> C", kf=1.5, kb=0.3)
    net.add("2C -> D", kf=0.7)
    net.add("D -> A + 3B", kf=0.2)
    return net


def test_reactions_rhs_and_y_gradient_match_jax():
    """Four lanes, some at y = 0, per-lane rates: values, and the gradient
    in y of a weighted sum of the RHS. At a zero concentration of a species
    with order 0 in some reaction, JAX's gradient is NaN (the masked
    ``clip(y)**0`` branch: its pow derivative 0 * 0**-1 times the where's
    zero cotangent); torch's pow backward is 0 at exponent 0, so the port's
    gradient is finite there. It is held against JAX's where that is
    finite, and everywhere against the same JAX RHS with the exponent of
    the masked branch replaced by 1 (the values are unchanged)."""
    rng = np.random.default_rng(0)
    y = np.abs(rng.normal(size=(4, 4)))
    y[0, 0] = y[1, 2] = y[2, 3] = 0.0
    y[3, :] = 0.0
    k = np.abs(rng.normal(size=(4, 4))) + 0.1    # 4 reactions
    weights = rng.normal(size=(4, 4))
    jnet, net = _network(JReactionNetwork), _network(ReactionNetwork)
    nu_react, nu_net = (np.asarray(m) for m in jnet.matrices())

    def j_safe(t, yi, ki):
        order = nu_react > 0
        powers = jnp.where(order, jnp.clip(yi, 0.0, jnp.inf)[:, None]
                           ** jnp.where(order, nu_react, 1.0), 1.0)
        return nu_net @ (ki * jnp.prod(powers, axis=0))

    def j_loss(y_, f):
        out = jax.vmap(lambda yi, ki: f(0.0, yi, ki))(y_, jnp.asarray(k))
        return jnp.sum(out * weights), out

    (_, j_out), j_grad = jax.value_and_grad(j_loss, has_aux=True)(
        jnp.asarray(y), jnet.rhs())
    j_grad = np.asarray(j_grad)
    safe_grad = np.asarray(jax.grad(lambda y_: j_loss(y_, j_safe)[0])(
        jnp.asarray(y)))
    yt = _t(y).requires_grad_(True)
    out = net.rhs()(0.0, yt, _t(k))
    (grad,) = torch.autograd.grad(torch.sum(out * _t(weights)), yt)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-12, atol=1e-15)
    grad = grad.numpy()
    finite = np.isfinite(j_grad)
    assert not finite.all() and np.isfinite(grad).all()
    np.testing.assert_allclose(grad[finite], j_grad[finite], rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(grad, safe_grad, rtol=1e-12, atol=1e-15)
    # the shared rates of the network broadcast over lanes too
    np.testing.assert_allclose(
        net.rhs()(0.0, _t(y), net.rates(device="cpu")).numpy(),
        np.asarray(jax.vmap(lambda yi: jnet.rhs()(0.0, yi, jnet.rates()))(
            jnp.asarray(y))), rtol=1e-12, atol=1e-15)


# ---- ode/linsolve.py: tests/test_linsolve.py's matrices --------------------

def _linsolve_matrices():
    rng = np.random.default_rng(0)
    return [np.eye(5) + 0.1 * rng.standard_normal((5, 5)),
            np.array([[0.0, 1.0], [1.0, 0.0]]),
            np.array([[1e-12, 1.0], [1.0, 1.0]]),
            np.eye(3) + 0.05 * np.ones((3, 3)),
            np.array([[1e-13, 1.0, 0.0], [1.0, 0.0, 1.0], [0.0, 1.0, 1.0]])]


@pytest.mark.parametrize("i", range(5))
def test_small_inverses_match_jax(i):
    a = _linsolve_matrices()[i]
    b = np.random.default_rng(i).standard_normal(a.shape[0])
    np.testing.assert_allclose(tls.inv_small(_t(a)).numpy(),
                               np.asarray(jls.inv_small(jnp.asarray(a))),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tls.solve_small(_t(a), _t(b)).numpy(),
                               np.asarray(jls.solve_small(jnp.asarray(a),
                                                          jnp.asarray(b))),
                               rtol=1e-12, atol=1e-12)
    ours = tls.inv_small_nopivot(_t(a)).numpy()
    ref = np.asarray(jls.inv_small_nopivot(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isfinite(ours), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(ours[fin], ref[fin], rtol=1e-12, atol=1e-12)


def test_inv_small_batched_pivots_per_matrix():
    """A batch of matrices that need different row swaps: each pivots on
    its own, as ``jax.vmap(inv_small)`` does."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 4, 4))
    a[0] = np.eye(4)[[2, 0, 3, 1]]                      # a permutation
    a[1, :, 0] = [1e-14, 3.0, -5.0, 0.5]                # pivot far below
    ours = tls.inv_small(_t(a)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.vmap(jls.inv_small)(
        jnp.asarray(a))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(ours @ a, np.broadcast_to(np.eye(4), a.shape),
                               atol=1e-10)
    b = rng.standard_normal((6, 4))
    np.testing.assert_allclose(tls.solve_small(_t(a), _t(b)).numpy(),
                               np.linalg.solve(a, b[..., None])[..., 0],
                               rtol=1e-9, atol=1e-12)


# ---- transforms/pruning.py, data/truth.py ----------------------------------

def _weights(rng, ns=5, nr=4, features=None):
    return (rng.normal(size=(features or ns, nr)), rng.normal(size=nr),
            rng.normal(size=(ns, nr)))


@pytest.mark.parametrize("cutoff", [None, 0.0, 0.3, 1.0])
def test_apply_w_out_cutoff_matches_jax(cutoff):
    w_in, w_b, w_out = _weights(np.random.default_rng(2))
    ours = apply_w_out_cutoff(CRNNWeights(_t(w_in), _t(w_b), _t(w_out)),
                              cutoff)
    ref = j_cutoff(JWeights(jnp.asarray(w_in), jnp.asarray(w_b),
                            jnp.asarray(w_out)), cutoff)
    for got, want in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_TRUTH_NS = {"case1": 5, "case2": 7, "case3": 9, "robertson": 3,
             "reversible": 5, "grn": 9, "yeast": 7}


def test_truth_registry_matches_jax():
    assert list(tt.TRUTH_REGISTRY) == list(jt.TRUTH_REGISTRY)
    rng = np.random.default_rng(3)
    for name, (j_truth, j_k) in jt.TRUTH_REGISTRY.items():
        truth, k = tt.TRUTH_REGISTRY[name]
        assert (k is None) == (j_k is None), name
        if k is None:       # case2: Arrhenius k per experiment
            k_lanes = np.abs(rng.normal(size=(4, 3)))
        else:
            np.testing.assert_array_equal(np.asarray(k), np.asarray(j_k))
            k_lanes = np.broadcast_to(np.asarray(k), (4, len(k)))
        y = np.abs(rng.normal(size=(4, _TRUTH_NS[name]))) + 0.05
        ref = jax.vmap(lambda yi, ki: j_truth(0.0, yi, ki))(
            jnp.asarray(y), jnp.asarray(k_lanes))
        np.testing.assert_allclose(tt.TRUTH_REGISTRY[name][0](
            None, _t(y), _t(k_lanes)).numpy(), np.asarray(ref), rtol=1e-12,
            atol=1e-14, err_msg=name)


# ---- infra/export.py -------------------------------------------------------

@pytest.mark.parametrize("scaled", [False, True])
def test_export_weights_csv_bytes_equal_jax(tmp_path, scaled):
    rng = np.random.default_rng(4)
    w_in, w_b, w_out = _weights(rng, ns=6, nr=3, features=7)
    scale = np.abs(rng.normal(size=6)) if scaled else None
    ours = export.export_weights_csv(
        CRNNWeights(_t(w_in), _t(w_b), _t(w_out)), str(tmp_path / "t.csv"),
        None if scale is None else _t(scale))
    ref = jexport.export_weights_csv(
        JWeights(jnp.asarray(w_in), jnp.asarray(w_b), jnp.asarray(w_out)),
        str(tmp_path / "j" / "j.csv"), scale)
    np.testing.assert_array_equal(ours, ref)
    assert (tmp_path / "t.csv").read_bytes() == \
        (tmp_path / "j" / "j.csv").read_bytes()


def test_export_gradient_blocks_equal_jax(capsys):
    ns, nr = 5, 4
    grad = np.random.default_rng(5).normal(size=nr * (2 * ns + 1) + 1)
    grad[nr * (ns + 1)] = 1e-9
    assert export.export_gradient_blocks(_t(grad), ns, nr) == \
        jexport.export_gradient_blocks(jnp.asarray(grad), ns, nr)


# ---- infra/profiling.py, infra/runtime.py ---------------------------------

def test_stopwatch_accumulates_and_dumps(tmp_path):
    sw = Stopwatch()
    for _ in range(3):
        with sw("solve", block_on={"ys": (torch.ones(3), [torch.zeros(2)])}):
            torch.ones(100).cumsum(0)
    with sw("eval"):
        pass
    summary = sw.summary()
    assert summary["solve"]["count"] == 3 and summary["eval"]["count"] == 1
    assert summary["solve"]["total_s"] >= 0.0
    sw.dump(str(tmp_path / "deep" / "timing.json"))
    assert json.loads((tmp_path / "deep" / "timing.json").read_text()) == summary


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "trace"
    with trace(str(logdir)) as prof:
        with annotate("crnn_step"):
            torch.ones(64, dtype=F64).exp().sum()
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "crnn_step" for e in events)
    assert any(e.name == "crnn_step" for e in prof.events())


def test_x64_scope_restores_default_dtype():
    before = torch.get_default_dtype()
    with x64_scope():
        assert torch.get_default_dtype() == torch.float64
        assert torch.ones(1).dtype == torch.float64
        with x64_scope(False):
            assert torch.get_default_dtype() == torch.float64
    assert torch.get_default_dtype() == before
    with pytest.raises(ZeroDivisionError):
        with x64_scope():
            1 / 0
    assert torch.get_default_dtype() == before
    with host_generation():
        assert torch.ones(1).device == torch.device("cpu")


# ---- re-exports ------------------------------------------------------------

# JAX names with no torch counterpart (ROADMAP.md says why)
_NO_COUNTERPART = {"crnn_tpu.parallel": {"make_mesh"}}


def _exported(init: Path) -> set:
    names = set()
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
    return {n for n in names if not n.startswith("_") or n == "__version__"}


def test_every_jax_init_name_importable_from_the_port():
    inits = sorted((ROOT / "crnn_tpu").glob("**/__init__.py"))
    assert len(inits) >= 10
    for init in inits:
        pkg = ".".join(init.parent.relative_to(ROOT).parts)
        port = importlib.import_module(pkg.replace("crnn_tpu", "crnn_tpu_torch",
                                                   1))
        missing = {n for n in _exported(init) - _NO_COUNTERPART.get(pkg, set())
                   if not hasattr(port, n)}
        assert not missing, (pkg, sorted(missing))
    from crnn_tpu_torch import odesolve
    from crnn_tpu_torch.train import Trainer

    assert callable(odesolve) and callable(Trainer)
