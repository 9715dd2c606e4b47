"""ODE solvers (port of crnn_tpu.ode): the per-lane driver with Tsit5,
Rosenbrock23, the ESDIRK pair TRBDF2/Kvaerno3 and AutoSwitch, the
batch-major Rosenbrock23 and its compensated-f32 twin
(``ode/compensated.py``), and the continuous adjoint
(``ode/adjoint.py``)."""

from crnn_tpu_torch.ode.autoswitch import AutoSwitch
from crnn_tpu_torch.ode.base import RHS, Solver, StepResult
from crnn_tpu_torch.ode.controller import error_norm, initial_step, propose_dt
from crnn_tpu_torch.ode.rosenbrock import Rosenbrock23
from crnn_tpu_torch.ode.sdirk import ESDIRK, TRBDF2, Kvaerno3
from crnn_tpu_torch.ode.solve import ODESolution, odesolve
from crnn_tpu_torch.ode.tsit5 import Tsit5

__all__ = ["AutoSwitch", "ESDIRK", "Kvaerno3", "ODESolution", "RHS",
           "Rosenbrock23", "Solver", "SOLVER_REGISTRY", "StepResult", "TRBDF2",
           "Tsit5", "error_norm", "get_solver", "initial_step", "odesolve",
           "propose_dt"]

SOLVER_REGISTRY = {
    "tsit5": Tsit5,
    "rosenbrock23": Rosenbrock23,
    "trbdf2": TRBDF2,
    "kvaerno3": Kvaerno3,
    "auto_tsit5_rosenbrock23": lambda: AutoSwitch(Tsit5(), Rosenbrock23()),
    "auto_tsit5_trbdf2": lambda: AutoSwitch(Tsit5(), TRBDF2()),
}


def get_solver(name: str) -> Solver:
    """Build a solver by registry name (config-file entry point)."""
    try:
        return SOLVER_REGISTRY[name]()
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(SOLVER_REGISTRY)}"
        ) from None
