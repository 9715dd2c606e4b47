"""Parameter-vector -> weight transforms (port of crnn_tpu.transforms)."""
