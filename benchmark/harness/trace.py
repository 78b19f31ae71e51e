"""One control step under torch.profiler, reduced in memory to a small
summary: the device kernels (count, busy seconds, the traced window's
length, seconds by kernel name) and the device's idle gaps by what the host
was doing. No trace is written.

The traced window runs from the profiler's first recorded event to its last
(the control step's host work and every kernel it launched, which the
closing synchronize waits for). Busy time is the union of the kernels'
intervals. An idle gap (no kernel on the device) is put down to the
outermost aten operation running on the host at the gap's middle, or to
`_no_host_operation_` where the host was between operations (Python).
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

TOP = 10


class Profiled:
    summary: dict = None


@contextlib.contextmanager
def profiled(device: str):
    """Profiles the body; `.summary` holds the reduction afterwards."""
    from torch.profiler import ProfilerActivity, profile

    out = Profiled()
    activities = [ProfilerActivity.CPU]
    if device.startswith("cuda"):
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    prof = profile(activities=activities)
    prof.start()
    try:
        yield out
        if device.startswith("cuda"):
            torch.cuda.synchronize()
    finally:
        prof.stop()
    out.summary = reduce_events(prof.events())


def _is_device(evt) -> bool:
    from torch.autograd import DeviceType

    return evt.device_type == DeviceType.CUDA


def reduce_events(events) -> dict:
    """The summary of a list of profiler FunctionEvents."""
    kernels: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    lo, hi = float("inf"), float("-inf")
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        lo, hi = min(lo, start), max(hi, end)
        if _is_device(e):
            kernels.append((start, end, e.name))
        elif e.name.startswith("aten::"):
            host.append((start, end, e.name))
    return summarize(kernels, host, lo, hi)


def summarize(kernels: List[Tuple[float, float, str]], host: List[Tuple[float, float, str]],
              lo: float, hi: float) -> dict:
    """Kernels and host operations as (start us, end us, name)."""
    kernels = sorted(kernels)
    by_name: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    busy = 0.0
    gaps: List[Tuple[float, float]] = []
    cursor = None
    for start, end, name in kernels:
        by_name[name][0] += 1
        by_name[name][1] += (end - start) * 1e-6
        if cursor is None:
            busy += end - start
        elif start >= cursor:
            gaps.append((cursor, start))
            busy += end - start
        elif end > cursor:
            busy += end - cursor
        cursor = end if cursor is None else max(cursor, end)
    # the outermost aten operations, in time order
    outer = []
    for start, end, name in sorted(host, key=lambda h: (h[0], -h[1])):
        if outer and start >= outer[-1][0] and end <= outer[-1][1]:
            continue
        outer.append((start, end, name))
    starts = [o[0] for o in outer]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(starts, mid) - 1
        name = outer[i][2] if i >= 0 and outer[i][1] >= mid else "_no_host_operation_"
        idle[name] += (b - a) * 1e-6
    window = max(hi - lo, 0.0) * 1e-6 if kernels or host else 0.0
    return {
        "kernels": len(kernels),
        "busy_s": busy * 1e-6,
        "window_s": window,
        "by_kernel": {k: (v[0], v[1]) for k, v in by_name.items()},
        "device_ops": sorted(([k, v[1]] for k, v in by_name.items()), key=lambda x: -x[1])[:TOP],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda x: -x[1])[:TOP],
    }
