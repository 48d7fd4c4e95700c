"""expectation_rows_roofline (kernels, smc_tpu_torch csrc/dsge_expectations.cu):
the least time for the work the traced estimations' final clouds need
(perfbench/kernels/expectation_rows.py at the peaks of perfbench/peaks.py)
over the median device time of a launch in the trace, in %; None where the
trace holds no launch of the kernel (a program without it)."""


def read(run):
    return run.roofline("expectation_rows")
