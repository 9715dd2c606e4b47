"""One whole case2 training epoch against the JAX package, in f64 at rtol
1e-6 (see tests/_case2_epoch_parity.py)."""

from _case2_epoch_parity import check_case2_epoch


def test_case2_epoch_matches_jax_f64():
    check_case2_epoch("float64", rtol=1e-6)
