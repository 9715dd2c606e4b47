"""ODE solvers (port of crnn_tpu.ode): the per-lane driver with Tsit5 and
Rosenbrock23, and the batch-major Rosenbrock23."""

from crnn_tpu_torch.ode.base import Solver
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
from crnn_tpu_torch.ode.tsit5 import Tsit5

SOLVER_REGISTRY = {
    "tsit5": Tsit5,
    "rosenbrock23": Rosenbrock23,
}
# names of crnn_tpu/ode/__init__.py:SOLVER_REGISTRY whose solvers are not
# ported yet
_NOT_PORTED = ("trbdf2", "kvaerno3", "auto_tsit5_rosenbrock23",
               "auto_tsit5_trbdf2")


def get_solver(name: str) -> Solver:
    """Build a solver by registry name (config-file entry point)."""
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"solver {name!r} is not ported yet (ROADMAP.md queue 1 item 7: "
            "ode/sdirk.py, ode/autoswitch.py)")
    try:
        return SOLVER_REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(SOLVER_REGISTRY)}"
        ) from None
