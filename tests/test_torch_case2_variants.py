"""The case2_missing and case2_pruning variants against the JAX package.

``--missing`` sets ``i_obs=(0, 1, 3, 4, 5)`` and ``missing_u0=True``, and
``--p-cutoff 0.01`` prunes the raw w_out entries inside ``weights_fn``
(crnn_tpu/cases/case2.py:256-260; the reference's case2_missing.jl and
case2_pruning.jl). Each case holds the second training epoch, lowrank at 4
training and 2 held-out experiments and max_steps 128, in f64 at rtol 1e-6
through tests/_case2_epoch_parity.py: JAX's dataset, params, optax state,
perm and masks cross to the port, nothing is seeded twice. Each also shows
that it runs the variant:

- the missing u0: rows ``[:n_exp // 3]`` of species 2 start at 0.2 in
  JAX's dataset and in the port's own ``build``; the port's truth solve from
  JAX's u0 and rate constants gives JAX's clean trajectories;
- the pruning: at the params the compared epoch starts from,
  ``prune_case2_params`` zeroes the same w_out entries in both packages, at
  least one, and the gradient there is 0 in both (the mask carries none).
  So the pruning case compares the third epoch: the smallest |w_out| is
  1.28e-2 at the start and 1.26e-2 after one epoch, above the cutoff, and
  7.7e-3 after two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _case2_epoch_parity import N_TEST, N_TRAIN, check_case2_epoch
from crnn_tpu.data import truth as jtruth
from crnn_tpu.transforms.pruning import prune_case2_params as jprune
from crnn_tpu_torch.cases import case2 as tcase2
from crnn_tpu_torch.data import generate as tgen
from crnn_tpu_torch.data import truth as ttruth
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
from crnn_tpu_torch.transforms.pruning import prune_case2_params as tprune

NS, NR = 6, 3
MISSING = dict(i_obs=(0, 1, 3, 4, 5), missing_u0=True)
# (Case2Config fields, JAX epochs before the compared one)
VARIANTS = {"missing": (MISSING, 1),
            "missing_pruning": (dict(MISSING, p_cutoff=0.01), 2)}


def _check_missing_u0(jsetup, fields):
    """JAX's u0 and the port's ``build`` u0 start the first n_exp // 3
    experiments mid-cascade; the port's truth from JAX's u0 is JAX's."""
    n_exp = N_TRAIN + N_TEST
    n_mid = n_exp // 3
    ds = jsetup.dataset
    u0 = np.array(ds.u0)
    assert n_mid >= 1 and np.all(u0[:n_mid, 2] == 0.2)
    assert np.all(u0[n_mid:, 2] == 0.0)
    port = tcase2.build(tcase2.Case2Config(
        n_exp_train=N_TRAIN, n_exp_test=N_TEST, dtype="float64",
        device="cpu", **fields))
    port_u0 = port.dataset.u0.numpy()
    assert np.all(port_u0[:n_mid, 2] == 0.2)
    assert np.all(port_u0[n_mid:, 2] == 0.0)
    assert bool(port.dataset.success.all())

    # JAX's truth: the per-lane Rosenbrock23 with jacfwd's J
    # (crnn_tpu/cases/case2.py:104-115); the port's twin takes the same steps
    k = np.array(jax.vmap(lambda temp: jtruth.case2_arrhenius(
        jtruth.CASE2_LOGA, jtruth.CASE2_EA, temp))(ds.u0[:, -1]))
    ts = torch.from_numpy(np.array(ds.ts))
    t1 = float(ts[-1])
    want = np.asarray(ds.ys_clean)
    assert bool(np.asarray(ds.success).all())
    got = tgen.generate_dataset_odesolve(
        torch.Generator().manual_seed(0), ttruth.case2_truth, Rosenbrock23(),
        torch.from_numpy(u0), torch.from_numpy(k), 0.0, t1, ts, rtol=1e-6,
        atol=1e-9, noise=0.0)
    assert bool(got.success.all())
    np.testing.assert_allclose(got.ys_clean[..., :NS].numpy(), want,
                               rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # what the port's build runs: the batch-major truth (dense W-solve),
    # its own steps, so within the solvers' accuracy (tests/test_torch_data.py)
    batch = tgen.generate_dataset(
        torch.Generator().manual_seed(0), ttruth.case2_truth,
        ttruth.case2_truth_jac, torch.from_numpy(u0), torch.from_numpy(k),
        0.0, t1, ts, rtol=1e-6, atol=1e-9, noise=0.0, obs_dim=NS)
    assert bool(batch.success.all())
    err = np.abs(batch.ys_clean.numpy() - want) / np.abs(want).max(axis=(0, 1))
    assert err.max() < 1e-4, err.max()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_case2_variant_epoch_matches_jax_f64(variant):
    fields, n_warm = VARIANTS[variant]
    cutoff = fields.get("p_cutoff", 0.0)
    seen = []

    def inspect(j_params, j_grad, params, grad):
        # the raw w_out block of the case2 parameter vector
        lo, hi = NR, NR * (NS + 1)
        j_kept = np.asarray(jprune(jnp.asarray(j_params), NS, NR,
                                   cutoff))[lo:hi] != 0
        kept = tprune(params, NS, NR, cutoff)[lo:hi].numpy() != 0
        np.testing.assert_array_equal(kept, j_kept)
        pruned = ~kept & (params[lo:hi].numpy() != 0)
        assert pruned.sum() >= 1, np.abs(j_params[lo:hi]).min()
        assert np.all(j_grad[lo:hi][pruned] == 0.0)
        assert torch.all(grad[lo:hi][torch.from_numpy(pruned)] == 0.0)
        seen.append(int(pruned.sum()))

    jsetup = check_case2_epoch("float64", rtol=1e-6,
                               inspect=inspect if cutoff else None,
                               n_warm=n_warm, **fields)
    assert len(seen) == (1 if cutoff else 0)
    _check_missing_u0(jsetup, fields)
