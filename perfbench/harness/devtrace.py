"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the
window, recording device activity only (kernels, copies, memsets; no
host operators, which would multiply the profiler's cost), read back
from the raw Kineto events without building PyTorch's event tree.

``DeviceTrace.begin`` starts the profiler before the window and waits
out its start-up (CUPTI's first activity takes seconds to appear);
``DeviceTrace.end`` stops it and returns a ``TraceSummary``: the union
of busy intervals, device time by operation name, and the idle gaps,
each labelled by what the harness's stamps say the host was doing.
Times are mapped to the host's ``perf_counter`` seconds through the
profiler's epoch clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch


@dataclass
class TraceSummary:
    start: float                     # traced window, perf_counter seconds
    stop: float
    busy_s: float                    # union of device activity
    by_name: Dict[str, float]        # device seconds by operation name
    count_by_name: Dict[str, int]
    idle_by_phase: Dict[str, float] = field(default_factory=dict)
    first: float = 0.0               # the earliest device event's start

    @property
    def window_s(self) -> float:
        return self.stop - self.start

    def seconds(self, *parts: str) -> float:
        """Device seconds of operations whose name holds any of ``parts``."""
        return sum(v for k, v in self.by_name.items()
                   if any(p in k for p in parts))

    def top_ops(self, n: int = 10) -> List[List]:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v] for k, v in ops]

    def top_idle(self, n: int = 10) -> List[List]:
        gaps = sorted(self.idle_by_phase.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v] for k, v in gaps]


def _device_events(results, device_type) -> List[Tuple[str, int, int]]:
    out = []
    for e in results.events():
        if e.device_type() == device_type:
            out.append((e.name(), e.start_ns(), e.duration_ns()))
    return out


class DeviceTrace:
    """One profiled window. ``device`` is the run's device: on the CPU
    (tests only) the host's operators stand in for device activity."""

    def __init__(self, device: torch.device) -> None:
        from torch.profiler import ProfilerActivity, profile
        self.cuda = device.type == "cuda"
        act = ProfilerActivity.CUDA if self.cuda else ProfilerActivity.CPU
        self._dtype = (torch.autograd.DeviceType.CUDA if self.cuda
                       else torch.autograd.DeviceType.CPU)
        self._prof = profile(activities=[act])
        self._offset = 0.0

    def begin(self) -> None:
        self._prof.__enter__()
        if self.cuda:
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        # the profiler stamps in epoch nanoseconds; the harness in
        # perf_counter seconds
        self._offset = time.time_ns() * 1e-9 - time.perf_counter()

    def end(self, start: float, stop: float,
            phase_of: Callable[[float], str]) -> TraceSummary:
        """Stop, and summarise device activity in [start, stop]."""
        self._prof.__exit__(None, None, None)
        events = _device_events(self._prof.profiler.kineto_results,
                                self._dtype)
        off = self._offset
        spans = []
        by_name: Dict[str, float] = {}
        count: Dict[str, int] = {}
        first = float("inf")
        for name, t_ns, d_ns in events:
            a = t_ns * 1e-9 - off
            b = a + d_ns * 1e-9
            first = min(first, a)
            a, b = max(a, start), min(b, stop)
            if b <= a:
                continue
            spans.append((a, b))
            by_name[name] = by_name.get(name, 0.0) + (b - a)
            count[name] = count.get(name, 0) + 1
        spans.sort()
        busy = 0.0
        idle: Dict[str, float] = {}
        cursor = start
        for a, b in spans + [(stop, stop)]:
            if a > cursor:
                phase = phase_of(0.5 * (a + cursor))
                idle[phase] = idle.get(phase, 0.0) + (a - cursor)
            if b > cursor:
                busy += b - max(a, cursor)
                cursor = b
        return TraceSummary(start, stop, busy, by_name, count, idle, first)
