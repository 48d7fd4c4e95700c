"""Smets and Wouters (2007) with the two expectation blocks of the FRBNY
DSGE model (Del Negro et al., "The FRBNY DSGE Model", FRBNY Staff Report
647, 2013; Del Negro, Giannoni and Schorfheide, AEJ: Macroeconomics 2015,
for the inflation target; FRBNY-DSGE/DSGE.jl, model m1002, eqcond.jl and
measurement.jl): the time-varying inflation target in the policy rule and
K = 6 anticipated policy shocks, with the expected policy rate 1-6
quarters ahead and the 10-year inflation expectation observed. Every width
is the sources' (`REDUCED` is empty): 43 parameters, 44 states, 14 shocks,
14 observables, T 156.

The program builds it as smc_tpu_torch.models.sw_pi_fg.sw_pi_fg() (the
"plain" backend: on a card the general-shape RE and Kalman kernels,
csrc/dsge_general_kernels.cu, with the expectation-rows kernel,
csrc/dsge_expectations.cu, between them) with the priors of
sw_pi_fg_parameters(), on the committed observables
(generate_sw_pi_fg_data(), simulated at the prior mode). The reference is
perfbench/reference/sw_pi_fg.py.
"""

SOURCE = ("https://github.com/FRBNY-DSGE/DSGE.jl (model m1002: eqcond.jl, "
          "measurement.jl); https://www.aeaweb.org/articles?id=10.1257/"
          "aer.97.3.586")
SIZES = {"n_params": 43, "n_state": 44, "n_shock": 14, "n_obs": 14,
         "n_t": 156}
REDUCED = []
# settings the sources' offline copies could not confirm
ASSUMED = {
    "sig_bounds": "(0.01, 3.0) for sig_pistar and sig_ant1-6, the bounds "
                  "of SW2007's shock standard deviations",
}
DEPARTURES = [
    "m1002 observes the expected rates only from 2008Q4 and the 10-year "
    "expectation only from 1991Q4, by a regime switch in the measurement; "
    "the Chandrasekhar filter holds only for a time-invariant system "
    "started at its stationary covariance, so every quarter observes all "
    "14 series and the filter stays exact",
    "m1002's financial-frictions block and its further observables (core "
    "PCE, spread, TFP, GDI) are left out: the economy is SW2007's",
    "the data is simulated at the prior mode (SW2007's posterior mode, "
    "sig_pistar 0.03, sig_ant 0.2), as SW2007's cell's is; the real series "
    "would need a download",
]
DATA = "smc_tpu_torch/data/sw_pi_fg_T156_seed1793.npy"
# the kernel libraries of smc_tpu_torch/_build.py a run of this
# configuration loads, and the kernels (kernels/<name>.py) its likelihood
# launches
LIBRARIES = ("dsge_general", "dsge_expectations", "eigh")
KERNELS = ("re_general", "kalman_general", "expectation_rows")


def program():
    """(loglike_batched, parameters) of the program's model."""
    from smc_tpu_torch.models import sw_pi_fg
    return sw_pi_fg.sw_pi_fg().loglike_batched, sw_pi_fg.sw_pi_fg_parameters()
