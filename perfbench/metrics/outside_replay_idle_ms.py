"""outside_replay_idle_ms (device, smc.py smc(): init, the eager first
stage, the capture, finish): the time inside the program's
`smc.estimation` spans but outside the replay windows (perfbench/spans.py)
in which the card's busy union is empty, per traced estimation, in ms.
idle_share's idle time is the replay windows' idle time, plus this times
the estimations, plus the idle time between the estimations."""

from perfbench import spans


def read(run):
    if run.trace is None:
        return None
    est = spans.spans(run.trace, spans.ESTIMATION)
    if not est:
        return None
    outside = (spans.total_idle_us(run.trace, est)
               - spans.total_idle_us(run.trace,
                                     spans.replay_windows(run.trace)))
    return outside / len(est) / 1e3
