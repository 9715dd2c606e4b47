"""yeast in the port against the JAX package at ``mlp_width=16``: the
widened MLP's shapes, the TRBDF2 solve at JAX's initial params (n_steps
exact) and one whole f64 training epoch at rtol 1e-6, as
tests/test_torch_yeast.py holds them at the reference width.
"""

import numpy as np
import pytest
from test_torch_yeast import NS, SMALL, check_epoch, check_solve, jax_setup

from crnn_tpu_torch import convert
from crnn_tpu_torch.cases import yeast as ty


@pytest.fixture(scope="module")
def jsetup():
    return jax_setup(16)


def test_wide_mlp_shapes(jsetup):
    setup = ty.build(ty.YeastConfig(mlp_width=16, device="cpu", **SMALL),
                     dataset=_dataset(jsetup))
    tree = setup.unravel(setup.init_params)
    assert [tuple(d["w"].shape) for d in tree["mlp"]] == [
        (16, NS), (16, 16), (16, 16), (5, 16)]


def _dataset(jsetup):
    ds = jsetup[1].dataset
    return convert.dataset_from_jax(
        *(np.asarray(a) for a in (ds.u0, ds.ys, ds.ys_clean, ds.ts,
                                  ds.yscale)),
        success=np.asarray(ds.success), device="cpu")


def test_solve_matches_jax(jsetup):
    check_solve(jsetup)


def test_epoch_matches_jax_f64(jsetup):
    check_epoch(jsetup)
