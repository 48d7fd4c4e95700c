"""The Kalman filter of the n_obs-3 DSGE kernels (smc_tpu_torch
csrc/dsge_kernels.cu kalman_kernel<NS,NK>): for each accepted particle the
doubling steps it needs and every one of the T Chandrasekhar steps (the
3x3 cofactor solves); it reads X, M, Q, Z, d, H, ok and the data and
writes the log-likelihood."""

from perfbench.kernels import _counts as c

TRACE_NAME = "kalman_kernel"


def work(w: c.Workload):
    """(flop pair, bytes) of one launch on the workload's particles."""
    flop = c.summed(w.lyap_iters, lambda i: c.kalman_flops(
        w.n_s, w.n_k, i, w.n_t))
    return flop, w.kalman_bytes()
