"""One whole robertson training epoch against the JAX package, in f64 at
rtol 1e-6, continued in the port from a JAX epoch (see
tests/_case2_epoch_parity.py): Rosenbrock23 with the closed-form scaled Jacobian,
global-norm clip 10 and stochastic prefix horizons, the masks drawn by JAX.

Reduced to 4 training and 2 validation experiments, 16 save points and
horizons in [12, 16]; ns=3, nr=6, rtol 1e-3, per-species atol and
max_steps 192 as shipped.
"""

from _case2_epoch_parity import check_epoch_vs_jax

from crnn_tpu.cases import robertson as jrob
from crnn_tpu_torch.cases import robertson as trob

N_TRAIN, N_VAL, DATASIZE, BATCHSIZE = 4, 2, 16, 12


def test_robertson_epoch_matches_jax_f64():
    kw = dict(n_exp_train=N_TRAIN, n_exp_val=N_VAL, datasize=DATASIZE,
              batchsize=BATCHSIZE)
    jsetup = jrob.build(jrob.RobertsonConfig(**kw))

    def build_port(dataset):
        return trob.build(trob.RobertsonConfig(device="cpu", **kw),
                          dataset=dataset)

    masks = check_epoch_vs_jax(jsetup, build_port, N_TRAIN, rtol=1e-6)
    lengths = masks.sum(dim=1)
    assert bool(((lengths >= BATCHSIZE) & (lengths <= DATASIZE)).all())
