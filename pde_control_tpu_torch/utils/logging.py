"""Metrics logging: JSONL + optional TensorBoard.

Counterpart of `pde_control_tpu/utils/logging.py`: `metrics.jsonl` under
the logdir is the primary sink; tensorboardX is used only if it imports.
Values may be numbers or 0-d tensors.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any


class MetricsLogger:
    def __init__(self, logdir: str | None = None, use_tensorboard: bool = True):
        self.logdir = logdir
        self._jsonl = None
        self._tb = None
        if logdir:
            os.makedirs(logdir, exist_ok=True)
            self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
            if use_tensorboard:
                try:
                    from tensorboardX import SummaryWriter

                    self._tb = SummaryWriter(logdir)
                except Exception:
                    self._tb = None

    def log(self, step: int, metrics: dict[str, Any], prefix: str = "") -> None:
        record = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            record[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), step)
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
        if self._tb:
            self._tb.close()
