"""kalman_general_r16_roofline (kernels, smc_tpu_torch
csrc/dsge_general_kernels.cu kalman_general_kernel<N, 16>): the share of
its bound, as kalman_general_roofline reads it, in the cells whose models
have 9-16 observables, where every launch of the Kalman kernel is the
instantiation on innovation rows of 16 lanes (kalman_general_roofline
covers the Smets-Wouters cells, rows of 8)."""


def read(run):
    return run.roofline("kalman_general")
