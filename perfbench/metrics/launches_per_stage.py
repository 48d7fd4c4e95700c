"""launches_per_stage (stage body, smc.py make_stage_core and ops/): the
device kernels in the traced span, over the real stages of its
estimations (prior draws, redraw rounds and masked replays included in
the kernels, not in the stages)."""


def read(run):
    if run.trace is None or not run.trace.kernels():
        return None
    return len(run.trace.kernels()) / run.stages
