"""replay_idle_share (device, smc.py FusedRecursion's graph replays): the
share of the replay windows (perfbench/spans.py) in which the card's busy
union is empty, in %: the gaps between replays that the host leaves."""

from perfbench import spans


def read(run):
    if run.trace is None:
        return None
    windows = spans.replay_windows(run.trace)
    length = sum(b - a for a, b in windows)
    if length <= 0:
        return None
    return 100.0 * spans.total_idle_us(run.trace, windows) / length
