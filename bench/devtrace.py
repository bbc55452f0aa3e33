"""The traced steps: ``torch.profiler`` over a few more steps of the
window's own call, reduced in memory to what the per-layer metrics and
the ``breakdown`` read. Nothing is written to disk.

Each traced step runs inside a ``bench.step`` range. The window is from
the first range's start to the last one's end; ``busy_s`` is the union of
the device's kernels, copies and sets inside it; an idle gap is a stretch
of the window with nothing on the device, named by the innermost host
operation running when it began.
"""
from __future__ import annotations

import dataclasses
import re
import time

import numpy as np

STEP_RANGE = "bench.step"
# the transfer's kernels (csrc/bitpack.cu, csrc/bitunpack.cu) and the
# monitor's (csrc/l2norm.cu), by the names the profiler gives them, such
# as "void (anonymous namespace)::bitpack_vec4<2>(float4 const*, ...)"
TRANSPORT = r"\bbit(un)?pack_(vec4|scalar)\b"
MONITOR = r"\bl2norm_(partials|final)\b"
MIN_SECONDS = 2.0
MIN_STEPS = 3
# the longest gaps that are named (each name needs a scan of the host ops)
NAMED_GAPS = 500


@dataclasses.dataclass
class Trace:
    steps: int
    window_s: float
    busy_s: float
    kernel_s: dict  # kernel name -> device seconds over the traced steps
    kernel_n: dict  # kernel name -> launches (copies and sets not counted)
    gaps: list  # [(host op, idle seconds)], summed by name, longest first

    @property
    def launches(self) -> int:
        return sum(self.kernel_n.values())

    def seconds_of(self, pattern: str) -> float:
        """Device seconds of the kernels whose names match ``pattern``."""
        return sum(s for k, s in self.kernel_s.items() if re.search(pattern, k))

    def launches_of(self, pattern: str) -> int:
        """Launches of the kernels whose names match ``pattern``."""
        return sum(n for k, n in self.kernel_n.items() if re.search(pattern, k))


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def trace_steps(step, first: int, torch) -> Trace:
    """Run ``step(i)`` for ``i`` from ``first`` under the profiler: one
    step to warm it, then traced steps until ``MIN_SECONDS`` and
    ``MIN_STEPS`` are reached."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        step(first)  # the profiler's own warm-up, outside the traced window
        n, t0 = 1, time.perf_counter()
        while n <= MIN_STEPS or time.perf_counter() - t0 < MIN_SECONDS:
            with record_function(STEP_RANGE):
                step(first + n)
            n += 1
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    events = prof.events()
    ranges = [e for e in events if e.name == STEP_RANGE and e.device_type == DeviceType.CPU]
    if not ranges:
        raise RuntimeError("the profiler recorded no traced step")
    lo = min(e.time_range.start for e in ranges)
    hi = max(e.time_range.end for e in ranges)
    dev, host = [], []
    kernel_s: dict = {}
    kernel_n: dict = {}
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name == STEP_RANGE:  # the range itself, on the host and the device
            continue
        if e.device_type == DeviceType.CUDA:
            if end <= lo or start >= hi:
                continue
            dev.append((max(start, lo), min(end, hi)))
            if not _is_copy(e.name):
                kernel_s[e.name] = kernel_s.get(e.name, 0.0) + (end - start) / 1e6
                kernel_n[e.name] = kernel_n.get(e.name, 0) + 1
        else:
            host.append((start, end, e.name))
    busy, gaps = _union_and_gaps(dev, lo, hi)
    return Trace(steps=len(ranges), window_s=(hi - lo) / 1e6, busy_s=busy / 1e6,
                 kernel_s=kernel_s, kernel_n=kernel_n, gaps=_name_gaps(gaps, host))


def _union_and_gaps(intervals, lo, hi):
    """Busy microseconds of the union of ``intervals`` in ``[lo, hi]``, and
    the idle gaps ``(start, end)`` between them."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


def _name_gaps(gaps, host) -> list:
    """Idle seconds by the innermost host op running at each gap's start
    (the ``NAMED_GAPS`` longest gaps; the rest as ``other``)."""
    if not gaps:
        return []
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    starts = np.array([h[0] for h in host], dtype=np.float64)
    ends = np.array([h[1] for h in host], dtype=np.float64)
    by: dict = {}
    for i, (s, e) in enumerate(gaps):
        name = "other"
        if i < NAMED_GAPS and len(host):
            inside = np.nonzero((starts <= s) & (ends >= s))[0]
            if len(inside):
                name = host[inside[np.argmin(ends[inside] - starts[inside])]][2]
            else:
                name = "no host op"
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    return sorted(by.items(), key=lambda kv: -kv[1])
