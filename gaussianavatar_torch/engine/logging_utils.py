"""The training log and the CLIs' stdout (counterpart of
gaussianavatar_tpu/engine/logging_utils.py):

  - `MetricsLogger`: one JSON record per line in
    `<model_path>/metrics.jsonl`, scalars by step and named run events,
    mirrored to TensorBoard as `train_loss_patches/<name>` scalars when
    `torch.utils.tensorboard` imports (off otherwise, as in JAX). In a
    data-parallel run rank 0 alone writes (`open_logger`).
  - `safe_state`: the timestamped stdout and the seeding of the training
    CLIs.
"""

from __future__ import annotations

import json
import os
import sys
import time
from datetime import datetime
from typing import Dict


class MetricsLogger:
    def __init__(self, model_path: str):
        os.makedirs(model_path, exist_ok=True)
        self.path = os.path.join(model_path, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self.tb = SummaryWriter(model_path)
        except Exception:
            pass

    def log(self, step: int, scalars: Dict[str, float]):
        rec = {"step": step, "t": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self.tb is not None:
            for k, v in scalars.items():
                self.tb.add_scalar(f"train_loss_patches/{k}", float(v), step)

    def log_event(self, name: str, value):
        """A run fact that is not a scalar, e.g. 'lpips: not ported'."""
        self._f.write(json.dumps({"event": name, "value": value, "t": time.time()}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()
        if self.tb is not None:
            self.tb.close()


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


class _TimestampedStdout:
    """Writes to `stream` with ' [dd/mm HH:MM:SS]' before every newline of
    a write that ends a line; nothing when `quiet`."""

    def __init__(self, stream, quiet: bool):
        self.stream, self.quiet = stream, quiet

    def write(self, x):
        if self.quiet:
            return
        if x.endswith("\n"):
            self.stream.write(x.replace("\n", f" [{datetime.now().strftime('%d/%m %H:%M:%S')}]\n"))
        else:
            self.stream.write(x)

    def flush(self):
        self.stream.flush()


def safe_state(quiet: bool = False, seed: int = 0):
    """The JAX package's safe_state: stdout timestamped (silent with
    `quiet`) and Python's and numpy's generators seeded, and torch's
    default generator too. Returns the stream it replaced: the port's CLIs
    put it back when they return."""
    import random

    import numpy as np
    import torch

    old = sys.stdout
    sys.stdout = _TimestampedStdout(old, quiet)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return old
