"""The Levenberg-Marquardt finisher (train/lm.py) against the JAX
package's, in f64: its conjugate-gradient solve against
``jax.scipy.sparse.linalg.cg``, the cost history on the quadratic of
tests/test_cases.py at rtol 1e-9, and on the Rosenbrock valley, where the
damping is raised after rejected steps, at rtol 1e-9. Once LM has converged
quadratically the cost is below 1e-20 and the residuals (~1e-10) carry
~1e-16 of absolute rounding each, so the history is held at rtol 1e-9 above
an absolute floor of 1e-24 of the first cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crnn_tpu.train.lm import levenberg_marquardt as j_lm
from crnn_tpu_torch.train.lm import cg, levenberg_marquardt


@pytest.mark.parametrize("maxiter", [3, 40])
def test_cg_matches_jax_cg(maxiter):
    rng = np.random.default_rng(0)
    m = rng.normal(size=(10, 10))
    a = m @ m.T + 0.1 * np.eye(10)
    b = rng.normal(size=10)
    want, _ = jax.scipy.sparse.linalg.cg(lambda x: jnp.asarray(a) @ x,
                                         jnp.asarray(b), maxiter=maxiter,
                                         tol=1e-12)
    at = torch.from_numpy(a)
    got = cg(lambda x: at @ x, torch.from_numpy(b), maxiter=maxiter,
             tol=1e-12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)


def _quadratic(lib):
    target = lib.asarray([1.0, -2.0, 0.5]) if lib is jnp else torch.tensor(
        [1.0, -2.0, 0.5], dtype=torch.float64)

    def resid(p):
        extra = p[0] * p[1] - (-2.0)
        if lib is jnp:
            return jnp.concatenate([p - target, jnp.atleast_1d(extra)])
        return torch.cat([p - target, extra[None]])

    return resid


def _rosenbrock(lib):
    def resid(p):
        r = [10.0 * (p[1] - p[0] ** 2), 1.0 - p[0]]
        return jnp.stack(r) if lib is jnp else torch.stack(r)

    return resid


@pytest.mark.parametrize("problem,p0,max_iters", [
    (_quadratic, [0.0, 0.0, 0.0], 100), (_rosenbrock, [-1.2, 1.0], 40)])
def test_lm_history_matches_jax(problem, p0, max_iters):
    jp, jinfo = j_lm(problem(jnp), jnp.asarray(p0), max_iters=max_iters)
    tp, tinfo = levenberg_marquardt(problem(torch),
                                    torch.tensor(p0, dtype=torch.float64),
                                    max_iters=max_iters)
    assert len(tinfo["history"]) == len(jinfo["history"]) > 2
    floor = 1e-24 * jinfo["history"][0]
    np.testing.assert_allclose(tinfo["history"], jinfo["history"], rtol=1e-9,
                               atol=floor)
    np.testing.assert_allclose(tinfo["cost"], jinfo["cost"], rtol=1e-9,
                               atol=floor)
    assert tinfo["converged"] == jinfo["converged"]
    assert np.all(np.diff(tinfo["history"]) < 0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-9,
                               atol=1e-12)
    if problem is _quadratic:
        np.testing.assert_allclose(tp.numpy(), [1.0, -2.0, 0.5], atol=1e-6)
        assert tinfo["converged"]
