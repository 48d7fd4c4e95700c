"""collective_bytes_per_stage (mesh, parallel/mesh.py): the bytes rank 0
received from the other ranks, SMCResult.collective_bytes, over the stages
the recursion issued (masked replays included: each replays the
collectives); nothing on one card."""


def read(run):
    if run.world == 1 or not run.results:
        return None
    return sum(r.collective_bytes for r in run.results) / run.replays
