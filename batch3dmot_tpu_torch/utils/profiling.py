"""Profiling hooks and the training loop's spans and counters (counterpart
of ``batch3dmot_tpu/utils/profiling.py``).

``profile_trace`` records a ``torch.profiler`` trace of the CPU and, when
there is one, the CUDA device, and writes it as a Chrome trace
(``chrome://tracing``, Perfetto) into a directory, with the loop's
counters beside it.

Tracing is on exactly while a torch profiler records (``tracing()``): the
benchmark's traced window, ``--profile DIR``. Then ``GNNTrainer.fit_device``
names its stages with ``annotate`` spans, which land in the profiler's
timeline on the device records' clock:

  * ``train.sources``: the lookup or upload of the resident groups;
  * ``train.rows``: a group's permutation, index rows and their upload;
  * ``train.steps``: enqueueing a call's steps (a first call's capture
    included);
  * ``train.fetch``: the call's fetch of its metrics rows, its one wait;
  * ``train.metrics``: the epoch's metrics and its tail.

and counts into memory (``loop_stats()``, cleared by ``reset_loop()``):
training calls and steps, the valid edges of the windows stepped against
the edge slots they were padded to, and on the card two CUDA events a
call, which give the device time from a call's first index copy to its
last out copy (``step_device_s``) and from one call's end to the next
call's start (``wait_device_s``: the device waits on the loop's host
stages). With tracing off the loop records, times and counts nothing.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator, List, Optional

import numpy as np
import torch

_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a torch profiler records now."""
    return torch._C._autograd._profiler_enabled()


def annotate(name: str, on: Optional[bool] = None):
    """A named region of the profiler's timeline while it records (``on``:
    a ``tracing()`` the caller already read), else a shared null context."""
    if on is None:
        on = tracing()
    return torch.profiler.record_function(name) if on else _OFF


class _Loop:
    """The training loop's counters and its calls' device events."""

    def __init__(self):
        self.calls = self.steps = self.edges_valid = self.edge_slots = 0
        self.step_s = self.wait_s = 0.0
        self.pending: List[tuple] = []  # (start, end) events not yet resolved
        self.last_end = None  # the last resolved call's end event


_LOOP = _Loop()


def reset_loop() -> None:
    """Clear the loop's counters and events: a new traced stretch starts."""
    global _LOOP
    _LOOP = _Loop()


def count_rows(rows: np.ndarray, valid_edges: np.ndarray, edge_width: int) -> None:
    """One training call of index rows ``rows`` [steps, B] over windows of
    ``valid_edges`` each, padded to ``edge_width`` edge slots."""
    _LOOP.calls += 1
    _LOOP.steps += rows.shape[0]
    _LOOP.edges_valid += int(valid_edges[rows].sum())
    _LOOP.edge_slots += rows.size * edge_width


def device_event(device: torch.device):
    """A timing event recorded now on ``device``'s current stream (None
    off the card)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def add_call(start, device: torch.device) -> None:
    """A call's steps ended: its start event ``start`` and an end event
    recorded now (nothing off the card)."""
    if start is not None:
        _LOOP.pending.append((start, device_event(device)))


def loop_stats() -> dict:
    """The loop's counters since ``reset_loop()``: ``calls``, ``steps``,
    ``edges_valid``, ``edge_slots`` and, where a call ran on the card,
    ``step_device_s`` and ``wait_device_s`` (one synchronise resolves
    them). Empty when nothing was recorded."""
    lp = _LOOP
    if lp.pending:
        lp.pending[-1][1].synchronize()
        for start, end in lp.pending:
            if lp.last_end is not None:
                lp.wait_s += lp.last_end.elapsed_time(start) / 1e3
            lp.step_s += start.elapsed_time(end) / 1e3
            lp.last_end = end
        lp.pending = []
    out = {}
    if lp.calls:
        out.update(calls=lp.calls, steps=lp.steps, edges_valid=lp.edges_valid,
                   edge_slots=lp.edge_slots)
    if lp.last_end is not None:
        out.update(step_device_s=lp.step_s, wait_device_s=lp.wait_s)
    return out


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block and write ``<log_dir>/trace_<pid>.json``, and the
    loop's counters over it as ``<log_dir>/loop_<pid>.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_loop()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))
    with open(os.path.join(log_dir, f"loop_{os.getpid()}.json"), "w") as f:
        json.dump(loop_stats(), f, indent=1)
