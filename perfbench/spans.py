"""The program's spans in a traced run (smc_tpu_torch/tracing.py: record_
function ranges, "user_annotation" events on the clock of the card's
events): the estimations, the fused recursion's replay windows, and the
card's idle time split by them. On a trace without the spans (a program
that opens none) every reading is None.

The replay window of a chunk (`smc.chunk`) runs from the end of the last
`smc.capture` or `smc.stage` span inside it (the eager first stage, then
the capture, in an estimation's first chunk), or from the chunk's start
where it has neither, to the chunk's end. Only graph replays and the
chunk's read run inside it, and the card is idle at both edges: the
capture synchronises before it starts and launches nothing while it
captures, and the read waits for every replay. So the idle time of a
traced span is the idle time in the replay windows, plus the idle time in
the `smc.estimation` spans outside them, plus the idle time between the
estimations.
"""

from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

ESTIMATION = "smc.estimation"
CHUNK = "smc.chunk"
EAGER = ("smc.stage", "smc.capture")

Interval = Tuple[float, float]


def spans(trace, name: str) -> List[Interval]:
    """(start, end) in us of each span `name` in the trace, in order."""
    return [(t, t + d) for t, d, n in trace.host if n == name]


def replay_windows(trace) -> List[Interval]:
    """The replay window of each chunk (the module's docstring)."""
    eager = sorted(s for name in EAGER for s in spans(trace, name))
    out = []
    for a, b in spans(trace, CHUNK):
        start = a
        for s, e in eager:
            if a <= s and e <= b:
                start = max(start, e)
        out.append((start, b))
    return out


def idle_us(trace, a: float, b: float) -> float:
    """The us of [a, b] in which the card's busy union is empty."""
    busy = trace.busy
    ends = [y for _, y in busy]
    covered = 0.0
    for x, y in busy[bisect.bisect_right(ends, a):]:
        if x >= b:
            break
        covered += min(y, b) - max(x, a)
    return (b - a) - covered


def total_idle_us(trace, intervals) -> float:
    return sum(idle_us(trace, a, b) for a, b in intervals)


def mean_span_ms(run, name: str) -> Optional[float]:
    """The total length of the spans `name` per traced estimation, in ms."""
    if run.trace is None:
        return None
    n = len(spans(run.trace, ESTIMATION))
    if n == 0:
        return None
    return sum(b - a for a, b in spans(run.trace, name)) / n / 1e3
