"""Reading a torch.profiler chrome trace: the device's busy intervals and
their union, the kernels by name, the idle gaps and what the host was
doing in them.

Device activity is every event of the categories "kernel", "gpu_memcpy"
and "gpu_memset". Streams can overlap (NCCL's beside the compute stream),
so busy time is the length of the union of those intervals, never their
sum. Only what lies inside the span (the harness's record_function range
SPAN) counts.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import defaultdict
from typing import List, Optional, Tuple

SPAN = "perfbench.traced"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
SHORT_GAP_US = 20.0


class Trace:
    """A parsed trace. Times are in microseconds of the trace's clock."""

    def __init__(self, events: List[dict]):
        span = [e for e in events if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e.get("name") == SPAN]
        if not span:
            raise ValueError(f"the trace holds no {SPAN!r} range")
        self.start = float(span[0]["ts"])
        self.end = self.start + float(span[0]["dur"])
        inside = lambda e: (self.start <= float(e["ts"]) < self.end)
        self.device = sorted(
            ((float(e["ts"]), float(e.get("dur", 0.0)), e.get("cat"),
              e.get("name", "")) for e in events
             if e.get("ph") == "X" and e.get("cat") in DEVICE and inside(e)),
            key=lambda t: t[0])
        self.host = sorted(
            ((float(e["ts"]), float(e.get("dur", 0.0)), e.get("name", ""))
             for e in events
             if e.get("ph") == "X" and e.get("cat") in HOST and inside(e)
             and e.get("name") != SPAN),
            key=lambda t: t[0])
        self.busy = _union([(min(t, self.end), min(t + d, self.end))
                            for t, d, _, _ in self.device])

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        events = data["traceEvents"] if isinstance(data, dict) else data
        return cls(events)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) / 1e6

    def kernels(self, pattern: Optional[str] = None) -> List[Tuple[float,
                                                                   str]]:
        """(duration us, name) of each kernel in the span whose name
        matches the regular expression `pattern` (all without one)."""
        rx = re.compile(pattern) if pattern else None
        return [(d, n) for _, d, cat, n in self.device
                if cat == "kernel" and (rx is None or rx.search(n))]

    def device_ops(self, top: int = 10) -> List[list]:
        """The device operations that took most time: [[name, seconds]]."""
        by = defaultdict(float)
        for _, d, _, n in self.device:
            by[n] += d / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """Idle time by what the host was doing: each gap in the device's
        busy union (from the span's start to its end) named after the
        innermost host event covering its midpoint, gaps shorter than
        SHORT_GAP_US pooled; [[name, seconds]] by total, largest first."""
        edges = [self.start]
        for a, b in self.busy:
            edges += [a, b]
        edges.append(self.end)
        starts = [h[0] for h in self.host]
        by = defaultdict(float)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            if b - a < SHORT_GAP_US:
                by[f"gaps under {SHORT_GAP_US:g} us"] += (b - a) / 1e6
                continue
            mid = 0.5 * (a + b)
            best = None
            i = bisect.bisect_right(starts, mid)
            for j in range(i - 1, max(-1, i - 400), -1):
                t, d, n = self.host[j]
                if t + d >= mid and (best is None or d < best[0]):
                    best = (d, n)
            by[best[1] if best else "no host event"] += (b - a) / 1e6
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out

