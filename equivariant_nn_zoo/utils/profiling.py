"""Device time from a ``jax.profiler`` trace.

``jax.profiler.trace(dir)`` writes ``dir/plugins/profile/<run>/<host>.xplane.pb``.
On a GPU the trace holds one plane per card, named ``/device:GPU:<i>``; each
CUDA stream is one line of it (``Stream #<id>...``) and each event on that
line is one kernel or copy, with its start and duration on the device.  The
CPU backend writes no device plane, so a trace without device events is an
error here, never a zero.
"""

from __future__ import annotations

import collections
import glob
import os
from typing import Dict, List, NamedTuple

GPU_PLANE_PREFIX = "/device:GPU:"
STREAM_LINE_PREFIX = "Stream"


class DeviceEvent(NamedTuple):
    device: str
    name: str
    start_ns: float
    duration_ns: float


def find_xplane(trace_dir: str) -> str:
    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.xplane.pb"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no *.xplane.pb under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def device_events(trace_dir: str) -> List[DeviceEvent]:
    """Every kernel and copy that ran on a GPU in the newest trace."""
    from jax.profiler import ProfileData

    profile = ProfileData.from_file(find_xplane(trace_dir))
    events = []
    for plane in profile.planes:
        if not plane.name.startswith(GPU_PLANE_PREFIX):
            continue
        for line in plane.lines:
            if not line.name.startswith(STREAM_LINE_PREFIX):
                continue
            for ev in line.events:
                events.append(DeviceEvent(plane.name, ev.name,
                                          ev.start_ns, ev.duration_ns))
    if not events:
        planes = sorted(p.name for p in profile.planes)
        raise RuntimeError(
            f"trace in {trace_dir} holds no GPU device events "
            f"(planes: {planes})"
        )
    return events


def busy_ns(events: List[DeviceEvent]) -> float:
    """Length of the union of the events' intervals, summed per device."""
    total = 0.0
    by_device = collections.defaultdict(list)
    for ev in events:
        by_device[ev.device].append((ev.start_ns, ev.start_ns + ev.duration_ns))
    for intervals in by_device.values():
        intervals.sort()
        cur_start, cur_end = intervals[0]
        for start, end in intervals[1:]:
            if start > cur_end:
                total += cur_end - cur_start
                cur_start, cur_end = start, end
            else:
                cur_end = max(cur_end, end)
        total += cur_end - cur_start
    return total


def summarize(events: List[DeviceEvent], n_steps: int, top: int = 10,
              device: str = None) -> Dict:
    """Per-step device time of a traced window of ``n_steps`` steps on one
    device (default: the first GPU in the trace): kernel time (sum of
    durations), busy time (union), the window from the first event's start
    to the last event's end, the idle share of that window, and the ``top``
    kernels by summed duration."""
    device = device or min(ev.device for ev in events)
    events = [ev for ev in events if ev.device == device]
    start = min(ev.start_ns for ev in events)
    end = max(ev.start_ns + ev.duration_ns for ev in events)
    busy = busy_ns(events)
    by_name = collections.Counter()
    for ev in events:
        by_name[ev.name] += ev.duration_ns
    return {
        "device": device,
        "device_ms_per_step": busy / n_steps / 1e6,
        "kernel_ms_per_step": sum(by_name.values()) / n_steps / 1e6,
        "window_ms_per_step": (end - start) / n_steps / 1e6,
        "idle_share": 1.0 - busy / (end - start) if end > start else 0.0,
        "top_kernels_ms_per_step": [
            (name, d / n_steps / 1e6) for name, d in by_name.most_common(top)
        ],
    }
