"""replay_launches_per_stage (stage body, smc.py make_stage_core and ops/,
as the captured graph replays them): the device kernels that start inside
the replay windows (perfbench/spans.py) over the stages replayed, every
stage the recursion issued (masked replays included) but each estimation's
eager first. The kernels of each chunk's read are counted in."""

from perfbench import spans


def read(run):
    if run.trace is None or not run.results:
        return None
    windows = spans.replay_windows(run.trace)
    replays = run.replays - len(run.results)
    if not windows or replays <= 0:
        return None
    kernels = sum(1 for t, _, cat, _ in run.trace.device if cat == "kernel"
                  and any(a <= t < b for a, b in windows))
    return kernels / replays
