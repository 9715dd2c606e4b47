"""Case setups and the case runner (port of crnn_tpu.cases)."""
