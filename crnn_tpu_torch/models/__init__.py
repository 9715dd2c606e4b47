"""CRNN right-hand sides and their closed-form Jacobians (port of
crnn_tpu.models)."""
