"""Structured metric logging (port of crnn_tpu/infra/metrics.py): an
appendable JSONL stream, one record per call with a ``ts`` field."""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._fh = open(path, "a")

    def log(self, **kwargs) -> None:
        self._fh.write(json.dumps({"ts": time.time(), **kwargs}) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
