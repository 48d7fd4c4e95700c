"""smc_tpu_torch: the SMC engine in PyTorch, with hand-written CUDA kernels
for the DSGE likelihood (a port of the JAX package smc_tpu).

Plain tensor code runs on any device; the DSGE likelihood launches the
kernels of ops/cuda_dsge.py on CUDA tensors and their plain versions on CPU
tensors. Nothing here imports jax, and importing sets no global default
device or dtype.
"""

from smc_tpu_torch.cloud import Cloud, weighted_mean, weighted_cov, weighted_std
from smc_tpu_torch.distributions import (Normal, Uniform, Gamma, Beta,
                                         InverseGamma, RootInverseGamma,
                                         TruncatedNormal, Point)
from smc_tpu_torch.params import Parameter, parameter, ParamSpace
from smc_tpu_torch.rng import TorchDraws, ReplayDraws
from smc_tpu_torch.smc import smc, SMCResult

__all__ = [
    "smc", "SMCResult", "Cloud", "weighted_mean", "weighted_cov",
    "weighted_std", "Parameter", "parameter", "ParamSpace", "TorchDraws",
    "ReplayDraws", "Normal", "Uniform", "Gamma", "Beta", "InverseGamma",
    "RootInverseGamma", "TruncatedNormal", "Point",
]
