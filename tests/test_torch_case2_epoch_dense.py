"""One whole case2 training epoch with the dense W-solve
(``jac_mode='dense'``: every step's value and Jacobian through the fused
op) against the JAX package, in f64 at rtol 1e-6 (see
tests/_case2_epoch_parity.py)."""

from _case2_epoch_parity import check_case2_epoch


def test_case2_dense_epoch_matches_jax_f64():
    check_case2_epoch("float64", rtol=1e-6, jac_mode="dense")
