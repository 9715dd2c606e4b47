"""Data parallelism over ``torch.distributed`` ranks (port of
crnn_tpu/parallel/)."""
