"""The training log (counterpart of MetricsLogger in
gaussianavatar_tpu/engine/logging_utils.py): one JSON record per line in
`<model_path>/metrics.jsonl`, scalars by step and named run events. The
JAX package's optional TensorBoard mirror is not ported. In a data-parallel
run rank 0 alone writes (`open_logger`)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsLogger:
    def __init__(self, model_path: str):
        os.makedirs(model_path, exist_ok=True)
        self.path = os.path.join(model_path, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "t": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_event(self, name: str, value):
        """A run fact that is not a scalar, e.g. 'lpips: not ported'."""
        self._f.write(json.dumps({"event": name, "value": value, "t": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class NullLogger:
    """A MetricsLogger that writes nothing: a data-parallel run's ranks
    other than 0."""

    def log(self, step: int, scalars: Dict[str, float]):
        pass

    def log_event(self, name: str, value):
        pass

    def close(self):
        pass


def open_logger(model_path: str, write: bool):
    return MetricsLogger(model_path) if write else NullLogger()
