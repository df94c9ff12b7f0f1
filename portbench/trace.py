"""The traced window: ``torch.profiler`` over the window's calls, read
from its raw events (no per-event Python objects are built).

``Trace.start`` opens the profiler and a ``portbench.window`` span; the
window runs its calls inside ``span`` markers; ``Trace.stop`` fences the
device, closes both and keeps the device operations (kernels, copies,
sets) clipped to the window, and the host events. The window runs from
the first timed call to the last fence, so idle time before the first
device operation and after the last counts as idle.
"""

from __future__ import annotations

import bisect
import contextlib
import re

import torch

WINDOW = "portbench.window"
SHORT_GAP_NS = 20_000      # gaps below this are named by their length only
HOST_SCAN = 400            # host events searched back from a gap


def span(name: str, on: bool):
    """A host span in the trace when ``on`` (nothing otherwise)."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def short_name(name: str) -> str:
    """A device operation's name without its return type and parameter
    list (template arguments kept: they tell a kernel's variants apart)."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()[:120]
    return name[:120]


def merged(intervals: list) -> list:
    """Sorted, non-overlapping (start, end) covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, device: torch.device):
        self.device = device
        self._prof = self._window = None
        self.window_ns = None
        self.intervals = []         # (start_ns, end_ns) of each device op
        self.by_name = {}           # device op name -> [count, seconds]
        self.host = []              # (start_ns, end_ns, name), by start

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW)
        self._window.__enter__()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        self._prof = self._window = None
        cuda = torch.autograd.DeviceType.CUDA
        ops, host = [], []
        for e in events:
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() != cuda:
                if name == WINDOW:
                    self.window_ns = (start, end)
                host.append((start, end, name))
            # the device-side copies of the host spans, and CUPTI's
            # synchronization records ("Stream Sync", ...), are no work
            elif not (e.is_user_annotation() or name.startswith("portbench.")
                      or name.endswith("Sync")):
                ops.append((name, start, end))
        a, b = self.window_ns
        for name, s, t in ops:
            s, t = max(s, a), min(t, b)
            if t <= s:
                continue
            self.intervals.append((s, t))
            entry = self.by_name.setdefault(name, [0, 0.0])
            entry[0] += 1
            entry[1] += (t - s) * 1e-9
        host.sort()
        self.host = host

    @property
    def window_s(self) -> float:
        a, b = self.window_ns
        return (b - a) * 1e-9

    def busy_intervals(self) -> list:
        return merged(self.intervals)

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    @property
    def op_total_s(self) -> float:
        """The device operations' seconds, summed."""
        return sum(sec for _, sec in self.by_name.values())

    def op_seconds(self) -> dict:
        """{short name: seconds} summed over the device operations."""
        out = {}
        for name, (_, sec) in self.by_name.items():
            key = short_name(name)
            out[key] = out.get(key, 0.0) + sec
        return out

    def seconds_matching(self, pattern: str) -> tuple:
        """(count, seconds) of the device operations whose name holds
        ``pattern`` as a whole identifier."""
        rx = re.compile(rf"(?<![A-Za-z0-9_]){pattern}(?![A-Za-z0-9_])")
        hits = [v for name, v in self.by_name.items() if rx.search(name)]
        return sum(n for n, _ in hits), sum(sec for _, sec in hits)

    def gaps(self) -> list:
        """(start_ns, end_ns) of the window's idle stretches, the leading
        and trailing ones included."""
        a, b = self.window_ns
        out, at = [], a
        for s, t in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, t)
        if b > at:
            out.append((at, b))
        return out

    def idle_by_host(self) -> dict:
        """{what the host was doing: idle seconds}: each idle stretch of
        at least ``SHORT_GAP_NS`` named by the innermost host event at its
        middle; the shorter ones together under one name."""
        out = {}
        starts = [h[0] for h in self.host]
        for s, t in self.gaps():
            if t - s < SHORT_GAP_NS:
                key = f"gaps under {SHORT_GAP_NS // 1000} us"
            else:
                mid = (s + t) // 2
                i = bisect.bisect_right(starts, mid) - 1
                key = "host outside any traced event"
                for j in range(i, max(-1, i - HOST_SCAN), -1):
                    start, end, name = self.host[j]
                    if end >= mid and name != WINDOW:
                        key = name
                        break
            out[key] = out.get(key, 0.0) + (t - s) * 1e-9
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.op_seconds().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_by_host().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in gaps]}
