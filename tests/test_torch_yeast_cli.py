"""The yeast CLI with ``--device cpu`` at the reduced size of
tests/test_yeast_width.py:14 (f32 as shipped): the data the port generates
itself (TRBDF2 truth at rtol 1e-6, u0 in the published box, std scales),
one epoch, and ``p_opt.npz`` with the params tree's leaves in JAX's order.
"""

import numpy as np
import pytest
import torch
from test_torch_mlp import capture_build
from test_torch_yeast import NP, NS, SMALL

from crnn_tpu_torch.cases import yeast as ty
from crnn_tpu_torch.data import truth as tt
from crnn_tpu_torch.data.generate import std_scale
from crnn_tpu_torch.transforms.ravel import tree_leaves


def test_cli_generates_std_scaled_data_and_writes_p_opt_npz(tmp_path,
                                                           monkeypatch):
    """The CLI with ``--device cpu`` (f32 as shipped, the reduced size):
    the data it generates (every truth solve successful, u0 in the
    published box, std scales), one epoch, and ``p_opt.npz`` holding the
    params tree's leaves in JAX's order (crnn, then each layer's b and w,
    ``--mlp-width 6``)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ty.build(ty.YeastConfig(**SMALL))
    small = {k: v for k, v in SMALL.items() if k != "dtype"}
    seen = capture_build(monkeypatch, ty, "YeastConfig", **small)
    state, hist = ty.main(["--epochs", "1", "--device", "cpu", "--out",
                           str(tmp_path), "--mlp-width", "6"])
    (setup,) = seen
    ds = setup.dataset
    assert ds.ys.dtype == torch.float32 and ds.ys.shape == (3, 16, NS)
    assert bool(ds.success.all()) and np.isfinite(hist["loss_train"][0])
    lo = torch.tensor(tt.YEAST_IC_LB)
    hi = torch.tensor(tt.YEAST_IC_UB)
    assert bool(((ds.u0 >= lo) & (ds.u0 <= hi)).all())
    np.testing.assert_allclose(ds.yscale.numpy(),
                               std_scale(ds.ys, 1e-5).numpy(), rtol=0)
    leaves = tree_leaves(setup.unravel(state.params))
    got = np.load(tmp_path / "yeast" / "p_opt.npz")
    assert len(got.files) == len(leaves) == 9
    assert [got[f"arr_{i}"].shape for i in range(9)] == [
        tuple(x.shape) for x in leaves]
    assert got["arr_0"].shape == (NP,) and got["arr_2"].shape == (6, NS)
