"""What a ``torch.profiler`` window of a few steps says about the device.

The raw events are reduced here, once, to what the per-layer readers
take: the device's intervals (kernels, copies and fills) within the
window, with their names; the host's operations; the window's bounds.
Times are seconds from the window's start.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Tuple

Interval = Tuple[float, float]

WINDOW_SPAN = "saturn_bench.window"
MATMUL = re.compile(r"gemm|xmma|cutlass|cublas", re.IGNORECASE)


@dataclasses.dataclass
class Trace:
    window_s: float
    device: List[Tuple[float, float, str]]    # (start, end, kernel name)
    host: List[Tuple[float, float, str]]      # (start, end, op name)

    def busy(self, pick=None) -> List[Interval]:
        return union([(s, e) for s, e, n in self.device
                      if pick is None or pick(n)])


def union(intervals: List[Interval]) -> List[Interval]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals: List[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def subtract(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The parts of the disjoint sorted ``a`` that the disjoint sorted
    ``b`` does not cover."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def from_profiler(prof) -> Trace:
    """The trace of the profiler's window span (``WINDOW_SPAN``)."""
    from torch.autograd import DeviceType
    events = prof.profiler.kineto_results.events()
    span = [e for e in events if e.name() == WINDOW_SPAN
            and e.device_type() == DeviceType.CPU]
    if len(span) != 1:
        raise RuntimeError(f"{len(span)} '{WINDOW_SPAN}' spans in the trace")
    t0, t1 = span[0].start_ns(), span[0].end_ns()
    device, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= t0 or s >= t1 or e.name() == WINDOW_SPAN:
            continue
        item = ((max(s, t0) - t0) * 1e-9, (min(t, t1) - t0) * 1e-9, e.name())
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return Trace((t1 - t0) * 1e-9, device, host)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps of the device with the host operation running in each (the
    innermost one at the gap's middle)."""
    by_name: dict = {}
    for s, e, n in trace.device:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    busy = trace.busy()
    gaps = subtract([(0.0, trace.window_s)], busy)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for s, e in gaps:
        mid = (s + e) / 2
        around = [h for h in trace.host if h[0] <= mid <= h[1]]
        inner = min(around, key=lambda h: h[1] - h[0])[2] if around \
            else "(no host op)"
        named.append([inner[:160], e - s])
    return {"device_ops": [[n[:160], t] for n, t in ops],
            "idle_gaps": named}
