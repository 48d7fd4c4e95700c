"""Smets-Wouters (2007) with the FRBNY DSGE model's time-varying inflation
target and forward guidance: 43 parameters, 44 states, 14 shocks, 14
observables.

The two expectation blocks of the FRBNY DSGE model (Del Negro et al., "The
FRBNY DSGE Model", FRBNY Staff Report 647, 2013; Del Negro, Giannoni and
Schorfheide, AEJ: Macroeconomics 2015, for the inflation target; the code
FRBNY-DSGE/DSGE.jl, model m1002, eqcond.jl and measurement.jl) on SW2007's
economy (models/sw_dsge.py, whose equation builder writes equations 1-37):

- the inflation target pistar_t = 0.99 pistar_{t-1} + epistar_t (rho fixed),
  in the policy rule as m1002's eq_mp: r = crr r(-1) + (1 - crr) (crpi
  (pinf - pistar) + pistar + cry (y - yf)) + crdy D(y - yf) + ms;
- K = 6 anticipated policy shocks (m1002's n_mon_anticipated_shocks):
  ms_t = crhoms ms_{t-1} + em_t + nu1_{t-1}, nu_k,t = nu_{k+1},t-1 + eant_k,t
  for k < 6, nu6_t = eant6_t;
- seven observables more: the expected policy rate 1-6 quarters ahead,
  obs_ER_k = conster + Z_robs X^k s_t (m1002's ZZ[obs_nominalrate,:]' TTT^k),
  and the 10-year inflation expectation, obs_LRinf = constepinf + (1/40)
  sum_{h=1..40} Z_pinfobs X^h s_t (m1002's TTT10 row), in SW2007's
  quarterly-% units.

The seven expectation rows depend on the RE solution X: the measurement
gives their d and zero Z rows, and LinearDSGE fills them from X between the
solve and the filter (`EXPECTATION_ROWS`, models/dsge.py).

Departures from m1002, each forced or chosen:
- m1002 observes the expected rates only from 2008Q4 and the 10-year
  expectation only from 1991Q4, by a regime switch in the measurement. The
  Chandrasekhar filter holds only for a time-invariant system started at
  its stationary covariance, so here every quarter observes all 14 series
  and the filter stays exact.
- m1002's financial-frictions block and its further observables (core PCE,
  spread, TFP, GDI) are left out: the economy is SW2007's.
- The data is simulated at the mode, as SW2007's is (`generate_sw_pi_fg_data`,
  committed as `load_sw_pi_fg_data()`); the real series would need a
  download.
- Bounds of the new standard deviations: SW2007's own (0.01, 3.0) for its
  shocks; m1002's could not be confirmed offline.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from smc_tpu_torch.distributions import RootInverseGamma
from smc_tpu_torch.models import sw_dsge
from smc_tpu_torch.models.dsge import LinearDSGE
from smc_tpu_torch.params import Parameter, parameter

K_ANTICIPATED = 6
RHO_PISTAR = 0.99           # m1002's rho_pi_star, fixed
LR_HORIZON = 40             # quarters of the 10-year expectation

NEW_PARAMS = ["sig_pistar"] + [f"sig_ant{k}"
                               for k in range(1, K_ANTICIPATED + 1)]
PARAM_NAMES = sw_dsge.PARAM_NAMES + NEW_PARAMS          # 43
# the prior modes: SW2007's posterior mode (sw_dsge.TRUE_PARAMS), m1002's
# sig_pistar 0.03 and sig_ant 0.2; the simulation's parameters
TRUE_PARAMS = np.concatenate([sw_dsge.TRUE_PARAMS, [0.03],
                              np.full(K_ANTICIPATED, 0.2)])

NU = [f"nu{k}" for k in range(1, K_ANTICIPATED + 1)]
STATE_NAMES = sw_dsge.STATE_NAMES + ["pistar"] + NU
SHOCK_NAMES = sw_dsge.SHOCK_NAMES + ["epistar"] + [
    f"eant{k}" for k in range(1, K_ANTICIPATED + 1)]
N_STATE = len(STATE_NAMES)          # 44
N_SHOCK = len(SHOCK_NAMES)          # 14
OBS_NAMES = sw_dsge.OBS_NAMES + [f"obs_ER{k}" for k in range(
    1, K_ANTICIPATED + 1)] + ["obs_LRinf"]
N_OBS = len(OBS_NAMES)              # 14
_ROBS, _PINFOBS = 5, 4
# (obs, base, first, last): obs = mean over h = first..last of Z[base] X^h
EXPECTATION_ROWS = tuple(
    (sw_dsge.N_OBS + k - 1, _ROBS, k, k)
    for k in range(1, K_ANTICIPATED + 1)) + (
    (N_OBS - 1, _PINFOBS, 1, LR_HORIZON),)

_DATA_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                          "sw_pi_fg_T156_seed1793.npy")


def sw_pi_fg_parameters() -> List[Parameter]:
    """SW2007's 36 priors and bounds, then sig_pistar (RootInverseGamma(6,
    0.03), m1002's) and sig_ant1-6 (RootInverseGamma(4, 0.2), m1002's), with
    SW2007's shock bounds."""
    ps = sw_dsge.sw_parameters()
    ps.append(parameter("sig_pistar", 0.03, (0.01, 3.0),
                        prior=RootInverseGamma(6.0, 0.03)))
    for name in NEW_PARAMS[1:]:
        ps.append(parameter(name, 0.2, (0.01, 3.0),
                            prior=RootInverseGamma(4.0, 0.2)))
    return ps


def _system(thetas: torch.Tensor):
    """thetas [N, 43] -> (A, B, C, D) batch-last: SW2007's equations
    (sw_dsge.build_system) with the target in the policy rule and nu1 in
    the ms row, then the target's and the six nu rows."""
    th = thetas.T
    crpi, crr = th[10], th[11]
    amend = {"policy": {"b": [("pistar", (1.0 - crr) * (1.0 - crpi))]},
             "ms": {"a": [("nu1", 1.0)]}}
    rows = [dict(a=[("pistar", RHO_PISTAR)], b=[("pistar", -1.0)],
                 d=[("epistar", 1.0)])]
    for k in range(1, K_ANTICIPATED + 1):
        nxt = [(f"nu{k + 1}", 1.0)] if k < K_ANTICIPATED else []
        rows.append(dict(a=nxt, b=[(f"nu{k}", -1.0)],
                         d=[(f"eant{k}", 1.0)]))
    return sw_dsge.build_system(thetas, STATE_NAMES, SHOCK_NAMES, amend, rows)


def _measurement(thetas: torch.Tensor):
    """thetas [N, 43] -> (d [14, N], Z [14, 44, N], H [14, 14, N]): SW2007's
    seven rows, then the expectation rows' constants (conster for the
    rates, constepinf for the 10-year inflation) and zero Z rows, which
    LinearDSGE fills from X (EXPECTATION_ROWS)."""
    d_sw, Z_sw, _ = sw_dsge._measurement(thetas)
    n = thetas.shape[0]
    Z = torch.zeros((N_OBS, N_STATE, n), dtype=torch.float64,
                    device=thetas.device)
    Z[:sw_dsge.N_OBS, :sw_dsge.N_STATE] = Z_sw
    d = torch.cat([d_sw, d_sw[_ROBS].expand(K_ANTICIPATED, n),
                   d_sw[_PINFOBS][None]])
    H = (1e-10 * torch.eye(N_OBS, dtype=torch.float64, device=thetas.device)
         )[:, :, None].expand(N_OBS, N_OBS, n).contiguous()
    return d, Z, H


def _shock_cov(thetas: torch.Tensor):
    """thetas [N, 43] -> Q = diag(sig^2) [14, 14, N]: SW2007's seven, the
    target's and the six anticipated shocks'."""
    sig = thetas[:, 29:43]
    return torch.diag_embed(sig * sig, dim1=0, dim2=1).contiguous()


def sw_pi_fg() -> LinearDSGE:
    """The model on the "plain" backend: on a CUDA tensor the general-shape
    kernels with the expectation-rows kernel between them
    (ops/cuda_dsge_general.py, ops/cuda_dsge_expectations.py), on a CPU
    tensor the plain PyTorch bl_* functions."""
    return LinearDSGE(sw_pi_fg_parameters(), _system, _measurement, N_SHOCK,
                      _shock_cov, likelihood_backend="plain",
                      expectation_rows=EXPECTATION_ROWS)


def generate_sw_pi_fg_data(T: int = 156, seed: int = 1793,
                           theta: np.ndarray = TRUE_PARAMS,
                           device="cpu") -> np.ndarray:
    """The 14 observables [14, T] simulated at `theta`, shocks from
    TorchDraws(seed, device): `load_sw_pi_fg_data()` is the default call's
    output on the CPU."""
    from smc_tpu_torch.rng import TorchDraws
    obs = sw_pi_fg().simulate(theta, T, TorchDraws(seed, device))
    return obs.cpu().numpy()


def load_sw_pi_fg_data() -> np.ndarray:
    """The observables [14, 156]: generate_sw_pi_fg_data(), committed as an
    array."""
    return np.load(_DATA_FILE)
