"""gather_ms_per_stage (mesh, parallel/mesh.py): the device time of the
NCCL kernels in rank 0's traced span, over its real stages; nothing on
one card."""


def read(run):
    if run.world == 1 or run.trace is None:
        return None
    ms = [d / 1e3 for d, _ in run.trace.kernels(r"(?i)nccl")]
    return sum(ms) / run.stages if ms else None
