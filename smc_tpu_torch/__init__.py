"""smc_tpu_torch: the SMC engine in PyTorch, with hand-written CUDA kernels
for the DSGE likelihood (a port of the JAX package smc_tpu).

Plain tensor code runs on any device; the DSGE likelihood launches the
kernels of ops/cuda_dsge.py, and the mutation's eigendecomposition the
kernel of ops/cuda_eigh.py, on CUDA tensors, and their plain versions on
CPU tensors. smc() runs the fused recursion by default (on a card, each
stage a replay of one captured CUDA graph). Nothing here imports jax, and
importing sets no global default device or dtype. Every name of smc_tpu's
public surface is exported under the same name; randomness comes from a
draws object (`TorchDraws`, or `ReplayDraws` for recorded draws) where the
JAX package takes a PRNG key.
"""

from smc_tpu_torch import distributions, parallel
from smc_tpu_torch.cloud import (Cloud, weighted_mean, weighted_cov,
                                 weighted_std, weighted_quantile, split_cloud,
                                 join_cloud, add_parameters_to_cloud)
from smc_tpu_torch.distributions import (Normal, Uniform, Gamma, Beta,
                                         InverseGamma, RootInverseGamma,
                                         TruncatedNormal, Point,
                                         DegenerateMvNormal, get_cov)
from smc_tpu_torch.params import (Parameter, parameter, ParamSpace,
                                  Untransformed, SquareRoot, Exponential)
from smc_tpu_torch.rng import TorchDraws, ReplayDraws
from smc_tpu_torch.ops.resample import resample
from smc_tpu_torch.ops.correction import (compute_ess, incremental_weights,
                                          log_incremental_weights)
from smc_tpu_torch.ops.mutation import (mutation, mvnormal_mixture_draw,
                                        compute_proposal_densities,
                                        generate_free_blocks,
                                        generate_all_blocks,
                                        generate_param_blocks)
from smc_tpu_torch.ops.initialization import (initial_draw,
                                              initialize_likelihoods,
                                              one_draw, draw_likelihood)
from smc_tpu_torch.io import (get_cloud, save_cloud, load_cloud,
                              split_cloud_file, join_cloud_file)
from smc_tpu_torch.settings import (GenericModel, Setting,
                                    smc_settings_kwargs, rawpath, dataroot,
                                    DATE_FORMAT)
from smc_tpu_torch.ops.schedule import solve_adaptive_phi, fixed_schedule
from smc_tpu_torch.diagnostics import VERBOSITY, check_nan_ess
from smc_tpu_torch.smc import smc, SMCResult, marginal_data_density

__all__ = [
    "smc", "SMCResult", "Cloud", "Parameter", "parameter", "ParamSpace",
    "distributions", "parallel", "resample", "mutation", "mvnormal_mixture_draw",
    "initial_draw", "initialize_likelihoods", "one_draw", "draw_likelihood",
    "DegenerateMvNormal", "get_cov", "compute_ess", "incremental_weights",
    "log_incremental_weights", "weighted_mean", "weighted_cov",
    "weighted_std", "weighted_quantile", "split_cloud", "join_cloud",
    "add_parameters_to_cloud", "get_cloud", "save_cloud", "load_cloud",
    "marginal_data_density", "Untransformed", "SquareRoot", "Exponential",
    "compute_proposal_densities", "generate_free_blocks",
    "generate_all_blocks", "generate_param_blocks", "split_cloud_file",
    "join_cloud_file", "GenericModel", "Setting", "smc_settings_kwargs",
    "rawpath", "dataroot", "DATE_FORMAT", "solve_adaptive_phi",
    "fixed_schedule", "VERBOSITY", "check_nan_ess", "TorchDraws",
    "ReplayDraws", "Normal", "Uniform", "Gamma", "Beta", "InverseGamma",
    "RootInverseGamma", "TruncatedNormal", "Point",
]
