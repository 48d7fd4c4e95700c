"""The Chandrasekhar filter of the general-shape DSGE kernels (smc_tpu_torch
csrc/dsge_general_kernels.cu kalman_general_kernel<N>): for each accepted
particle its doubling steps and the filter steps up to the one that
rejects it (Cholesky solves, or the 3x3 cofactor form at n_obs 3)."""

from perfbench.kernels import _counts as c

TRACE_NAME = "kalman_general_kernel"


def work(w: c.Workload):
    """(flop pair, bytes) of one launch on the workload's particles."""
    flop = c.add(c.f(), *(c.kalman_flops(w.n_s, w.n_k, int(i), int(st),
                                         w.n_o)
                          for i, st in zip(w.lyap_iters.tolist(),
                                           w.filter_steps.tolist())))
    return flop, w.kalman_bytes()
