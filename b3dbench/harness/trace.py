"""The traced window: torch.profiler (CPU and CUDA activity) around the
measured loop, reduced to the device's busy time, each kernel's device
time and the longest idle stretches by what the host was doing.

* busy: the union of the device's activity intervals (kernels, copies,
  sets) inside the window, so overlapping work counts once; the number of
  device records is kept beside it, because the profiler on the card's
  machines has been seen to drop records;
* kernel time: summed device durations by name inside the window; a
  source's kernels are the ``__global__`` functions its file and the
  headers it includes declare, read at run time;
* idle: the gaps between busy stretches, each named by the innermost host
  event open at its midpoint on the window's thread (a benchmark span, an
  operator or a runtime call).
"""

from __future__ import annotations

import re
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Iterable, List, Optional

WINDOW_SPAN = "b3dbench.window"
# the profiler can drop the records of a trace's first milliseconds
LEAD_S = 0.05
_KERNEL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")
_INCLUDE = re.compile(r'#include\s+"([^"]+)"')


def source_kernels(csrc: Path, source: str) -> set:
    """Kernel names declared in ``csrc/source`` and the headers it
    includes."""
    names, todo, seen = set(), [source], set()
    while todo:
        name = todo.pop()
        if name in seen or not (csrc / name).exists():
            continue
        seen.add(name)
        text = (csrc / name).read_text()
        names |= set(_KERNEL.findall(text))
        todo += _INCLUDE.findall(text)
    return names


class Window:
    """Context manager around the measured loop; with ``enabled`` False it
    only marks nothing and costs nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.summary: Optional[dict] = None

    def __enter__(self):
        if not self.enabled:
            return self
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        time.sleep(LEAD_S)
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._torch = torch
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        self._torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = reduce_events(raw_events(self._prof))
        return False


def raw_events(prof) -> list:
    """(start_ns, end_ns, name, on_device, thread, annotation) of every
    record, straight from the profiler's results (building its event tree
    costs minutes at millions of records)."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        out.append((start, start + ev.duration_ns(), ev.name(),
                    ev.device_type() == DeviceType.CUDA, ev.start_thread_id(),
                    ev.is_user_annotation()))
    return out


def _merge(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _innermost(events: List[tuple], points: List[float]) -> Dict[float, str]:
    """Name of the innermost of the nested ``events`` (start, end, name)
    open at each point."""
    events = sorted(events, key=lambda x: (x[0], -x[1]))
    out, stack, i = {}, [], 0
    for p in sorted(points):
        while i < len(events) and events[i][0] <= p:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        out[p] = stack[-1][2] if stack else "(no host event)"
    return out


def reduce_events(events: Iterable[tuple]) -> dict:
    """busy_s, window_s, records, kernel_s {name: s}, and the breakdown's
    device_ops and idle_gaps (top 10 each, seconds), from ``raw_events``'
    tuples."""
    window, host, device = None, [], []
    for start, end, name, on_device, thread, annotation in events:
        if on_device:
            if not annotation:
                device.append((start, end, name))
        elif name == WINDOW_SPAN:
            window = (start, end, thread)
        else:
            host.append((start, end, name, thread))
    if window is None:
        raise RuntimeError("the traced window's span is missing from the trace")
    w0, w1, thread = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device if e > w0 and s < w1]
    kernel_ns: Dict[str, float] = defaultdict(float)
    for s, e, n in clipped:
        kernel_ns[n] += e - s
    busy = _merge([(s, e) for s, e, _ in clipped])
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    longest = gaps[:2000]
    mids = [(a + b) / 2 for a, b in longest]
    names = _innermost([(s, e, n) for s, e, n, t in host if t == thread and e > w0 and s < w1],
                       mids)
    idle_by: Dict[str, float] = defaultdict(float)
    for (a, b), m in zip(longest, mids):
        idle_by[names[m]] += (b - a) / 1e9
    kernel_s = {k: v / 1e9 for k, v in kernel_ns.items()}
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return dict(busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(w1 - w0) / 1e9,
                records=len(clipped), kernel_s=kernel_s,
                breakdown=dict(device_ops=top(kernel_s), idle_gaps=top(idle_by)))


def seconds_of(kernel_s: Dict[str, float], names: set) -> float:
    """Device seconds of the trace's kernels whose name is one of
    ``names`` (a demangled name: ``name(`` or ``name<``)."""
    if not names:
        return 0.0
    pat = re.compile(r"(?<!\w)(?:" + "|".join(map(re.escape, sorted(names))) + r")[(<]")
    return sum(t for k, t in kernel_s.items() if pat.search(k))
