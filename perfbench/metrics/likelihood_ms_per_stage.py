"""likelihood_ms_per_stage (likelihood, models/dsge.py likelihood_route ->
ops/cuda_dsge.py, ops/cuda_dsge_general.py): the device time of the
configuration's DSGE kernels in the traced span, over its real stages."""


def read(run):
    ms = [t for k in run.config.KERNELS for t in run.kernel_ms(k)]
    if not ms:
        return None
    return sum(ms) / run.stages
