"""The RE solve of the general-shape DSGE kernels (smc_tpu_torch
csrc/dsge_general_kernels.cu re_general_kernel<N>, a block per particle):
the same work as the n_obs-3 kernel's at any shape."""

from perfbench.kernels import _counts as c

TRACE_NAME = "re_general_kernel"


def work(w: c.Workload):
    """(flop pair, bytes) of one launch on the workload's particles."""
    flop = c.summed(w.cr_iters, lambda i: c.re_flops(w.n_s, w.n_k, i))
    return flop, w.re_bytes()
