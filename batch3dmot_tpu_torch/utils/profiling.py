"""Profiling hooks and step timers (counterpart of
``batch3dmot_tpu/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace of the CPU and, when
there is one, the CUDA device, and writes it as a Chrome trace
(``chrome://tracing``, Perfetto) into a directory; ``annotate`` names a
region of it; ``StepTimer`` gives wall-clock step statistics without
waiting for the device.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write ``<log_dir>/trace_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


def annotate(name: str):
    """A named region of the profiler's timeline."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock step timing with percentile summary."""

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._times = []
        self._t0: Optional[float] = None
        self._count = 0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._count += 1
        if self._count > self.warmup:
            self._times.append(dt)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        arr = np.array(self._times)
        return {
            "steps": len(arr),
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p95_s": float(np.percentile(arr, 95)),
            "total_s": float(arr.sum()),
        }
