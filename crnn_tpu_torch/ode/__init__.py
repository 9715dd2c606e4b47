"""Batch-major Rosenbrock23 solve and its helpers (port of crnn_tpu.ode)."""
