"""An and Schorfheide (2007), "Bayesian Analysis of DSGE Models",
Econometric Reviews 26(2-4): 113-172, the three-equation New Keynesian
model on output growth, inflation and the interest rate, at its published
size; nothing is cut.

The program builds it as smc_tpu_torch.models.as_dsge.an_schorfheide()
(the "kernel" backend: on a card the n_obs-3 CUDA kernels,
csrc/dsge_kernels.cu, the TPU kernels' counterparts) with the priors of
an_schorfheide_parameters(), on the committed observables (the JAX
package's generate_as_data(T=80, seed=1793)). The reference is
perfbench/reference/an_schorfheide.py.
"""

SOURCE = "https://doi.org/10.1080/07474930701220071"
SIZES = {"n_params": 13, "n_state": 6, "n_shock": 3, "n_obs": 3, "n_t": 80}
DATA = "smc_tpu_torch/data/as_T80_seed1793.npy"
LIBRARIES = ("dsge_ns6", "eigh")
KERNELS = ("re", "kalman")


def program():
    """(loglike_batched, parameters) of the program's model."""
    from smc_tpu_torch.models import as_dsge
    return (as_dsge.an_schorfheide().loglike_batched,
            as_dsge.an_schorfheide_parameters())
