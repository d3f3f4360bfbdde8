"""Metric logging: JSONL always, TensorBoard when it is installed
(counterpart of ``batch3dmot_tpu/utils/metric_logging.py``).

``GNNTrainer.fit`` and ``fit_device`` take a :class:`MetricWriter` as
``writer=`` and log one record per epoch: ``{"step": epoch, "time": ...,
**metrics}`` on one line of ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricWriter:
    def __init__(self, log_dir: str, tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl_path = os.path.join(log_dir, "metrics.jsonl")
        self._jsonl = open(self.jsonl_path, "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception:  # tensorboard is optional
                self._tb = None

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        record = {"step": step, "time": time.time(), **metrics}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in metrics.items():
                try:
                    self._tb.add_scalar(k, float(v), step)
                except (TypeError, ValueError):
                    pass

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
