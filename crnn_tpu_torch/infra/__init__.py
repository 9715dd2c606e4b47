"""Run infrastructure (port of crnn_tpu.infra): metrics, checkpoints and
figures."""
