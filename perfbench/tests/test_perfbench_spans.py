"""The readers of the program's spans (perfbench/spans.py and the metrics
init_ms, finish_ms, replay_idle_share, outside_replay_idle_ms,
replay_launches_per_stage) on synthetic chrome-trace events fed to
trace.Trace: the replay windows with and without a capture span, the idle
split held to a microsecond grid, the launches over the replays, and None
on a trace without the spans."""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

from perfbench import spans, spec  # noqa: E402
from perfbench.trace import SPAN, Trace  # noqa: E402
from perfbench.traced import TracedRun  # noqa: E402

READERS = ("init_ms", "finish_ms", "replay_idle_share",
           "outside_replay_idle_ms", "replay_launches_per_stage")
END = 1000

# two estimations in a traced span [0, 1000) us: the first with one chunk
# (its eager stage, then the capture), the second with two (the first
# with its eager stage and capture, the next one with neither)
PROGRAM = [
    ("smc.estimation", 10, 400), ("smc.init", 10, 100),
    ("smc.init.round", 12, 60), ("smc.chunk", 100, 350),
    ("smc.stage", 105, 150), ("smc.capture", 160, 200),
    ("smc.read", 330, 350), ("smc.finish", 350, 400),
    ("smc.estimation", 500, 900), ("smc.init", 500, 560),
    ("smc.chunk", 560, 700), ("smc.stage", 565, 600),
    ("smc.capture", 605, 640), ("smc.chunk", 700, 850),
    ("smc.finish", 850, 900),
]
# the card's work: overlapping streams, a copy, work between estimations
# and past the traced span's end
DEVICE = [
    ("kernel", 20, 40), ("kernel", 50, 60), ("kernel", 110, 140),
    ("kernel", 205, 250), ("kernel", 240, 300), ("kernel", 310, 340),
    ("gpu_memcpy", 360, 380), ("kernel", 420, 450), ("kernel", 570, 590),
    ("kernel", 640, 660), ("kernel", 650, 690), ("kernel", 705, 720),
    ("gpu_memset", 730, 740), ("kernel", 760, 830), ("kernel", 990, 1010),
]
# each estimation's real stages and the masked replays past its end
STAGES = ((6, 0), (9, 1))


def _events(program=PROGRAM, device=DEVICE):
    ev = [{"ph": "X", "cat": "user_annotation", "name": SPAN, "ts": 0,
           "dur": END}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a,
            "dur": b - a} for n, a, b in program]
    ev += [{"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 15,
            "dur": 3}]
    ev += [{"ph": "X", "cat": c, "name": f"{c}_{a}", "ts": a, "dur": b - a}
           for c, a, b in device]
    return ev


def _run(trace, stages=STAGES):
    results = [SimpleNamespace(
        cloud=SimpleNamespace(tempering_schedule=[0.0] * (s + 1)),
        masked_stages=m) for s, m in stages]
    cell = SimpleNamespace(config=None, mix=None, reference=None)
    return TracedRun(results, [1.0] * len(results), trace, cell, None)


def _read(name, run):
    return spec.load_module(f"metrics/{name}.py", f"test_{name}").read(run)


def _idle_grid(device=DEVICE):
    """1 where the card is idle, per us of the traced span."""
    idle = np.ones(END, dtype=int)
    for _, a, b in device:
        idle[a:min(b, END)] = 0
    return idle


def _idle_in(intervals, grid):
    return sum(int(grid[int(a):int(b)].sum()) for a, b in intervals)


def test_the_replay_window_starts_after_the_capture_or_at_the_chunk():
    tr = Trace(_events())
    assert spans.replay_windows(tr) == [(200, 350), (640, 700), (700, 850)]
    # an estimation of one stage: its chunk has an eager stage and no
    # capture, and its window starts after the stage
    one = [("smc.estimation", 10, 90), ("smc.chunk", 20, 80),
           ("smc.stage", 25, 60)]
    assert spans.replay_windows(Trace(_events(one, []))) == [(60, 80)]


def test_the_idle_time_splits_into_its_parts_exactly():
    tr = Trace(_events())
    run = _run(tr)
    grid = _idle_grid()
    windows = [(200, 350), (640, 700), (700, 850)]
    est = [(10, 400), (500, 900)]
    replay_idle = _idle_in(windows, grid)
    outside = _idle_in(est, grid) - replay_idle
    between = int(grid.sum()) - _idle_in(est, grid)
    length = sum(b - a for a, b in windows)
    assert _read("replay_idle_share", run) == pytest.approx(
        100.0 * replay_idle / length, rel=1e-12)
    assert _read("outside_replay_idle_ms", run) == pytest.approx(
        outside / 2 / 1e3, rel=1e-12)
    # the span's idle time = replay idle + outside x estimations + between
    span_idle = (tr.window_s - tr.busy_s) * 1e6
    parts = (_read("replay_idle_share", run) / 100.0 * length
             + _read("outside_replay_idle_ms", run) * 1e3 * len(est)
             + between)
    assert span_idle == pytest.approx(parts, rel=1e-12)
    assert span_idle == pytest.approx(grid.sum(), rel=1e-12)


def test_the_launches_are_counted_over_the_replays():
    run = _run(Trace(_events()))
    starts = [a for c, a, _ in DEVICE if c == "kernel"]
    inside = sum(1 for t in starts if 200 <= t < 350 or 640 <= t < 850)
    assert inside == 7
    # every issued stage, masked ones included, but each estimation's eager
    # first: 6 + 9 + 1 - 2
    assert run.replays - 2 == 14
    assert _read("replay_launches_per_stage", run) == pytest.approx(7 / 14)


def test_init_and_finish_are_their_spans_per_estimation():
    run = _run(Trace(_events()))
    assert _read("init_ms", run) == pytest.approx((90 + 60) / 2 / 1e3)
    assert _read("finish_ms", run) == pytest.approx((50 + 50) / 2 / 1e3)


def test_every_reader_reads_nothing_without_the_spans():
    bare = _run(Trace(_events(program=[])))
    untraced = _run(None)
    for name in READERS:
        assert _read(name, bare) is None, name
        assert _read(name, untraced) is None, name
