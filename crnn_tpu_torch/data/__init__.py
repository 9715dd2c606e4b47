"""Truth models and synthetic datasets (port of crnn_tpu.data)."""
