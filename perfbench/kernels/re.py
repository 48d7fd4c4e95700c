"""The RE solve of the n_obs-3 DSGE kernels (smc_tpu_torch
csrc/dsge_kernels.cu re_kernel<NS,NK>): the cyclic-reduction iterations
each particle needs, the solve of X, M and the acceptance tests; it reads
A, B, C, D and writes X, M and ok."""

from perfbench.kernels import _counts as c

TRACE_NAME = "re_kernel"


def work(w: c.Workload):
    """(flop pair, bytes) of one launch on the workload's particles."""
    flop = c.summed(w.cr_iters, lambda i: c.re_flops(w.n_s, w.n_k, i))
    return flop, w.re_bytes()
