"""Losses, optimizer and training loop (port of crnn_tpu.train)."""
