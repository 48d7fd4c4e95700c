"""re_general_roofline (kernels, smc_tpu_torch csrc/dsge_general_kernels.cu): the least time
for the work the traced estimations' final clouds need
(perfbench/kernels/re_general.py at the peaks of perfbench/peaks.py) over the
median device time of a launch in the trace, in %."""


def read(run):
    return run.roofline("re_general")
