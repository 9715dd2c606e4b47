"""ODE solvers (port of crnn_tpu.ode): the per-lane driver with Tsit5 and
Rosenbrock23, and the batch-major Rosenbrock23."""
