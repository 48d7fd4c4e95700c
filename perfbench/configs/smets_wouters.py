"""Smets and Wouters (2007), "Shocks and Frictions in US Business Cycles: A
Bayesian DSGE Approach", AER 97(3): 586-606, as in Dynare's usmodel.mod, at
its published size; nothing is cut. The production model of the reference
SMC code's examples/dsge_models/dsge_model.jl.

The program builds it as smc_tpu_torch.models.sw_dsge.smets_wouters() (the
"plain" backend: on a card the general-shape CUDA kernels,
csrc/dsge_general_kernels.cu) with the priors of sw_parameters(), on the
committed observables (the JAX package's generate_sw_data(T=156,
seed=1793), simulated at the paper's posterior mode). The reference is
perfbench/reference/smets_wouters.py.
"""

SOURCE = "https://www.aeaweb.org/articles?id=10.1257/aer.97.3.586"
SIZES = {"n_params": 36, "n_state": 37, "n_shock": 7, "n_obs": 7,
         "n_t": 156}
DATA = "smc_tpu_torch/data/sw_T156_seed1793.npy"
# the kernel libraries of smc_tpu_torch/_build.py a run of this
# configuration loads, and the DSGE kernels (kernels/<name>.py) its
# likelihood launches
LIBRARIES = ("dsge_general", "eigh")
KERNELS = ("re_general", "kalman_general")


def program():
    """(loglike_batched, parameters) of the program's model."""
    from smc_tpu_torch.models import sw_dsge
    return sw_dsge.smets_wouters().loglike_batched, sw_dsge.sw_parameters()
