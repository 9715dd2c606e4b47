"""AutoSwitch and the stiffness classifier against the JAX package, in f64.

A batch with a stiff and a non-stiff lane solved together (the per-lane
select's witness: each lane takes JAX's own steps, n_steps exact, ys at
rtol 1e-6), the per-lane order the controller sees, ``classify_stiffness``
and ``partition_by_stiffness``, every registry name, and a per-lane case2
epoch with ``solver='auto_tsit5_rosenbrock23'`` (AutoSwitch to the
closed-form Rosenbrock23) at rtol 1e-6.

The case2 epoch is reduced to 4 training and 2 held-out experiments and
max_steps 32 (its lanes take 6-7 steps); ns=6, nr=3 and 50 save points as
shipped.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu import ode as jode
from crnn_tpu.cases import case2 as jcase2
from crnn_tpu.ode.controller import propose_dt as j_propose_dt
from crnn_tpu.ode.stiffness import classify_stiffness as j_classify
from crnn_tpu.ode.stiffness import partition_by_stiffness as j_partition
from crnn_tpu_torch import ode as tode
from crnn_tpu_torch.cases import case2 as tcase2
from crnn_tpu_torch.ode.autoswitch import AutoSwitch, _AutoState
from crnn_tpu_torch.ode.base import autonomous
from crnn_tpu_torch.ode.controller import propose_dt
from crnn_tpu_torch.ode.solve import odesolve
from crnn_tpu_torch.ode.stiffness import (classify_stiffness,
                                          partition_by_stiffness)

STIFF = {"rosenbrock23": (jode.Rosenbrock23, tode.Rosenbrock23),
         "trbdf2": (jode.TRBDF2, tode.TRBDF2)}


def _j_robertson(t, y, k):
    r1 = k[0] * y[0]
    r2 = k[1] * y[1] * y[1]
    r3 = k[2] * y[1] * y[2]
    return jnp.array([-r1 + r3, r1 - r2 - r3, r2])


@autonomous
def _t_robertson(t, y, k):
    """Per-lane rate constants ``k (B, 3)``."""
    r1 = k[:, 0] * y[:, 0]
    r2 = k[:, 1] * y[:, 1] * y[:, 1]
    r3 = k[:, 2] * y[:, 1] * y[:, 2]
    return torch.stack([-r1 + r3, r1 - r2 - r3, r2], dim=-1)


class _Recording(AutoSwitch):
    """AutoSwitch that records every step's incoming ``is_stiff``."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.is_stiff = []

    def step(self, f, t, y, dt, args, state):
        self.is_stiff.append(state.is_stiff.clone())
        return super().step(f, t, y, dt, args, state)


@pytest.mark.parametrize("stiff", sorted(STIFF))
def test_autoswitch_mixed_stiffness_batch_matches_jax_f64(stiff):
    """Lane 0 is the stiff Robertson system, lane 1 the same network with
    slow rates: solved in one batch, each lane switches on its own."""
    j_stiff, t_stiff = STIFF[stiff]
    y0 = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    k = np.array([[4e-2, 3e7, 1e4], [4e-2, 3.0, 1.0]])
    saveat = np.concatenate([[0.0], 10 ** np.linspace(-2, 2, 13)])
    kw = dict(rtol=1e-5, atol=1e-9, max_steps=2048, unroll="while")
    j_sol = jax.vmap(lambda u, kk: jode.odesolve(
        _j_robertson, jode.AutoSwitch(jode.Tsit5(), j_stiff()), u, 0.0, 100.0,
        jnp.asarray(saveat), args=kk, **kw))(jnp.asarray(y0), jnp.asarray(k))
    solver = _Recording(tode.Tsit5(), t_stiff())
    t_sol = odesolve(_t_robertson, solver, torch.from_numpy(y0), 0.0, 100.0,
                     torch.from_numpy(saveat), args=torch.from_numpy(k), **kw)
    assert bool(np.all(np.asarray(j_sol.success)))
    np.testing.assert_array_equal(t_sol.n_steps.numpy(),
                                  np.asarray(j_sol.n_steps))
    np.testing.assert_array_equal(t_sol.n_rejected.numpy(),
                                  np.asarray(j_sol.n_rejected))
    want = np.asarray(j_sol.ys)
    np.testing.assert_allclose(t_sol.ys.numpy(), want, rtol=1e-6,
                               atol=1e-12 * np.abs(want).max())
    # the select is per lane: the stiff lane ran on the implicit branch
    # at the end, the slow lane never left the explicit one
    history = torch.stack(solver.is_stiff)
    assert int(history[-1, 0]) == 1 and int(history[:, 1].max()) == 0
    assert int(t_sol.n_steps[0]) != int(t_sol.n_steps[1])


def test_order_for_is_per_lane():
    solver = AutoSwitch(tode.Tsit5(), tode.TRBDF2())
    zero = torch.zeros(2, dtype=torch.int32)
    state = _AutoState(is_stiff=torch.tensor([0, 1], dtype=torch.int32),
                       slope=torch.zeros((2, 3), dtype=torch.float64),
                       stiff_votes=zero, nonstiff_votes=zero)
    order = solver.order_for(state)
    assert order.dtype == torch.float32 and order.tolist() == [5.0, 2.0]
    assert solver.order == 2     # the static order initial_step reads
    j_solver = jode.AutoSwitch(jode.Tsit5(), jode.TRBDF2())
    j_state = j_solver.init(lambda t, y, a: -y, 0.0, jnp.ones(3), None)
    j_states = jax.tree.map(lambda a: jnp.stack([a, a]), j_state)
    j_states = j_states._replace(is_stiff=jnp.asarray([0, 1], jnp.int32))
    j_order = jax.vmap(j_solver.order_for)(j_states)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    # the controller takes the (B,) order: each lane's own exponent
    dt = torch.tensor([0.3, 0.3], dtype=torch.float64)
    err = torch.tensor([0.25, 0.25], dtype=torch.float64)
    accept = torch.tensor([True, True])
    got = propose_dt(dt, err, accept, order)
    want = jax.vmap(j_propose_dt)(jnp.asarray(dt.numpy()),
                                  jnp.asarray(err.numpy()),
                                  jnp.asarray([True, True]), j_order)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[1]) > float(got[0])


def _j_relax(t, y, _):
    # dx/dt = -lam x, dlam/dt = 0: the lane's stiffness is its lam
    return jnp.array([-y[1] * y[0], 0.0 * y[1]])


@autonomous
def _t_relax(t, y, _):
    return torch.stack([-y[:, 1] * y[:, 0], 0.0 * y[:, 1]], dim=-1)


def test_classify_and_partition_match_jax():
    u0 = np.array([[1.0, 1.0], [1.0, 1e4], [2.0, 0.5], [1.0, 3e3]])
    mask = classify_stiffness(_t_relax, torch.from_numpy(u0), 0.0, 5.0)
    j_mask = j_classify(_j_relax, jnp.asarray(u0), 0.0, 5.0)
    assert mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), np.asarray(j_mask))
    assert mask.tolist() == [False, True, False, True]
    for got, want in zip(partition_by_stiffness(mask), j_partition(j_mask)):
        np.testing.assert_array_equal(got, want)
    nonstiff, stiff = partition_by_stiffness(mask)
    assert nonstiff.tolist() == [0, 2] and stiff.tolist() == [1, 3]


def test_get_solver_builds_every_jax_name():
    assert sorted(tode.SOLVER_REGISTRY) == sorted(jode.SOLVER_REGISTRY)
    for name in jode.SOLVER_REGISTRY:
        got, want = tode.get_solver(name), jode.get_solver(name)
        assert type(got).__name__ == type(want).__name__
        assert got.order == want.order
        if isinstance(want, jode.AutoSwitch):
            assert type(got.stiff).__name__ == type(want.stiff).__name__
            assert type(got.nonstiff).__name__ == "Tsit5"
    with pytest.raises(ValueError, match="unknown solver"):
        tode.get_solver("euler")


def test_case2_per_lane_autoswitch_epoch_matches_jax_f64():
    kw = dict(n_exp_train=4, n_exp_test=2, dtype="float64",
              batch_major=False, solver="auto_tsit5_rosenbrock23",
              max_steps=32)
    jsetup = jcase2.build(jcase2.Case2Config(**kw))
    check_epoch_vs_jax(
        jsetup, lambda ds: tcase2.build(tcase2.Case2Config(device="cpu", **kw),
                                        dataset=ds), 4, rtol=1e-6)
