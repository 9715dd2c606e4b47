"""One whole case1 training epoch against the JAX package, in f64 at rtol
1e-6, continued in the port from a JAX epoch (see tests/_case2_epoch_parity.py).

Reduced to 4 training and 2 held-out experiments and 20 save points;
ns=5, nr=4, Tsit5 at rtol 1e-2 / atol 1e-5 and max_steps 128 as shipped.
"""

from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import case1 as jcase1
from crnn_tpu_torch.cases import case1 as tcase1

N_TRAIN, N_TEST, DATASIZE = 4, 2, 20


def test_case1_epoch_matches_jax_f64():
    jsetup = jcase1.build(jcase1.Case1Config(
        n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=DATASIZE,
        dtype="float64"))

    def build_port(dataset):
        return tcase1.build(tcase1.Case1Config(
            n_exp_train=N_TRAIN, n_exp_test=N_TEST, datasize=DATASIZE,
            dtype="float64", device="cpu"), dataset=dataset)

    masks = check_epoch_vs_jax(jsetup, build_port, N_TRAIN, rtol=1e-6)
    assert bool((masks == 1).all())     # case1 has no stochastic horizon
