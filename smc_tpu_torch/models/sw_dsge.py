"""Smets-Wouters (2007) medium-scale DSGE (port of
smc_tpu/models/sw_dsge.py): the production model of the reference's
examples/dsge_models/dsge_model.jl (36 estimated parameters, up to 12,000
particles, 3 blocks, alpha = 0.9).

The log-linearized equations of "Shocks and Frictions in US Business
Cycles" (AER 2007): the sticky price-wage economy, its flexible-price
counterpart (for the output gap of the policy rule), seven structural shocks
(two with MA(1) terms) and seven observables (output, consumption,
investment and wage growth, inflation, the policy rate, hours). 37 states,
7 shocks, 5 fixed parameters.

The system matrices are built batch-last [r, c, N] from thetas [N, P]: the
(row, column, coefficient [N]) triples of each matrix are stacked and
scattered into zeros in one accumulating index_put, as the JAX version's
`.at[].add` accumulates. The likelihood runs on the "plain" backend: on a
card the general-shape CUDA kernels (ops/cuda_dsge_general.py), on the CPU
the plain PyTorch bl_* functions.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List

import numpy as np
import torch

from smc_tpu_torch.distributions import Normal, Beta, Gamma, RootInverseGamma
from smc_tpu_torch.params import Parameter, parameter
from smc_tpu_torch.models.dsge import LinearDSGE

# parameter order (36 estimated; SW2007 Table 1 notation in comments)
PARAM_NAMES = [
    "csadjcost",   # phi: investment adjustment cost
    "csigma",      # sigma_c: risk aversion / IES inverse
    "chabb",       # lambda: habit
    "cprobw",      # xi_w: Calvo wages
    "csigl",       # sigma_l: labor supply elasticity inverse
    "cprobp",      # xi_p: Calvo prices
    "cindw",       # iota_w: wage indexation
    "cindp",       # iota_p: price indexation
    "czcap",       # psi: capacity utilization cost
    "cfc",         # Phi: fixed cost share (= 1 + price markup)
    "crpi",        # r_pi: Taylor inflation response
    "crr",         # rho: policy smoothing
    "cry",         # r_y: output gap response
    "crdy",        # r_dy: output gap growth response
    "constepinf",  # pi_bar: SS inflation (quarterly %)
    "constebeta",  # 100(beta^-1 - 1)
    "constelab",   # l_bar: SS hours (normalization)
    "ctrend",      # gamma_bar: trend growth (quarterly %)
    "cgy",         # rho_ga: spending response to TFP shock
    "calfa",       # alpha: capital share
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap",        # mu_p: price markup MA
    "cmaw",        # mu_w: wage markup MA
    "sig_a", "sig_b", "sig_g", "sig_qs", "sig_m", "sig_pinf", "sig_w",
]

# SW2007 posterior-mode values (Table 1), the simulation DGP
TRUE_PARAMS = np.array([
    5.74, 1.38, 0.71, 0.70, 1.83, 0.66, 0.58, 0.24, 0.54, 1.60,
    2.04, 0.81, 0.08, 0.22, 0.78, 0.16, 0.53, 0.43, 0.52, 0.19,
    0.95, 0.22, 0.97, 0.71, 0.15, 0.89, 0.96,
    0.69, 0.84,
    0.45, 0.23, 0.53, 0.45, 0.24, 0.14, 0.24,
])

# fixed parameters (SW2007; Dynare usmodel.mod fixed block)
CTOU = 0.025     # depreciation
CLANDAW = 1.5    # SS wage markup
CG = 0.18        # exogenous spending share
CURVP = 10.0     # Kimball curvature, goods
CURVW = 10.0     # Kimball curvature, labor

_DATA_FILE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                          "sw_T156_seed1793.npy")


def _beta_ms(mean, std):
    nu = mean * (1 - mean) / (std * std) - 1.0
    return Beta(mean * nu, (1 - mean) * nu)


def _gamma_ms(mean, std):
    return Gamma((mean / std) ** 2, std * std / mean)


def sw_parameters() -> List[Parameter]:
    """SW2007 priors and bounds (Dynare usmodel.mod estimated_params)."""
    P = parameter
    ps = [
        P("csadjcost", 5.74, (2.0, 15.0), prior=Normal(4.0, 1.5)),
        P("csigma", 1.38, (0.25, 3.0), prior=Normal(1.5, 0.375)),
        P("chabb", 0.71, (0.001, 0.99), prior=_beta_ms(0.7, 0.1)),
        P("cprobw", 0.70, (0.3, 0.95), prior=_beta_ms(0.5, 0.1)),
        P("csigl", 1.83, (0.25, 10.0), prior=Normal(2.0, 0.75)),
        P("cprobp", 0.66, (0.5, 0.95), prior=_beta_ms(0.5, 0.10)),
        P("cindw", 0.58, (0.01, 0.99), prior=_beta_ms(0.5, 0.15)),
        P("cindp", 0.24, (0.01, 0.99), prior=_beta_ms(0.5, 0.15)),
        P("czcap", 0.54, (0.01, 1.0), prior=_beta_ms(0.5, 0.15)),
        P("cfc", 1.60, (1.0, 3.0), prior=Normal(1.25, 0.125)),
        P("crpi", 2.04, (1.0, 3.0), prior=Normal(1.5, 0.25)),
        P("crr", 0.81, (0.5, 0.975), prior=_beta_ms(0.75, 0.10)),
        P("cry", 0.08, (0.001, 0.5), prior=Normal(0.125, 0.05)),
        P("crdy", 0.22, (0.001, 0.5), prior=Normal(0.125, 0.05)),
        P("constepinf", 0.78, (0.1, 2.0), prior=_gamma_ms(0.625, 0.1)),
        P("constebeta", 0.16, (0.01, 2.0), prior=_gamma_ms(0.25, 0.1)),
        P("constelab", 0.53, (-10.0, 10.0), prior=Normal(0.0, 2.0)),
        P("ctrend", 0.43, (0.1, 0.8), prior=Normal(0.4, 0.10)),
        P("cgy", 0.52, (0.01, 2.0), prior=Normal(0.5, 0.25)),
        P("calfa", 0.19, (0.01, 1.0), prior=Normal(0.3, 0.05)),
    ]
    for name, mode in [("crhoa", 0.95), ("crhob", 0.22), ("crhog", 0.97),
                       ("crhoqs", 0.71), ("crhoms", 0.15), ("crhopinf", 0.89),
                       ("crhow", 0.96)]:
        ps.append(P(name, mode, (0.001, 0.9999), prior=_beta_ms(0.5, 0.2)))
    ps.append(P("cmap", 0.69, (0.001, 0.9999), prior=_beta_ms(0.5, 0.2)))
    ps.append(P("cmaw", 0.84, (0.001, 0.9999), prior=_beta_ms(0.5, 0.2)))
    for name, mode in [("sig_a", 0.45), ("sig_b", 0.23), ("sig_g", 0.53),
                       ("sig_qs", 0.45), ("sig_m", 0.24), ("sig_pinf", 0.14),
                       ("sig_w", 0.24)]:
        ps.append(P(name, mode, (0.01, 3.0), prior=RootInverseGamma(2.0, 0.1)))
    return ps


# sticky economy (13) + flexible economy (11) + shocks (7) + MA terms (2)
# + observation lags (4) = 37 states
_STICKY = ["y", "c", "inve", "pk", "k", "kp", "zcap", "rk", "mc", "pinf",
           "w", "r", "lab"]
_FLEX = ["yf", "cf", "invef", "pkf", "kf", "kpf", "zcapf", "rkf", "wf",
         "labf", "rrf"]
_SHOCKS = ["a", "b", "g", "qs", "ms", "spinf", "sw"]
_MA_AUX = ["epinfma", "ewma"]
_LAGS = ["ylag", "clag", "ivlag", "wlag"]

STATE_NAMES = _STICKY + _FLEX + _SHOCKS + _MA_AUX + _LAGS
_IDX: Dict[str, int] = {n: i for i, n in enumerate(STATE_NAMES)}
N_STATE = len(STATE_NAMES)          # 37
SHOCK_NAMES = ["ea", "eb", "eg", "eqs", "em", "epinf", "ew"]
N_SHOCK = len(SHOCK_NAMES)          # 7

OBS_NAMES = ["dy", "dc", "dinve", "dw", "pinfobs", "robs", "labobs"]
N_OBS = 7


@functools.lru_cache(maxsize=None)
def _const(values: tuple, dtype, device) -> torch.Tensor:
    """A constant index or coefficient tensor, made once per device, so a
    likelihood call copies nothing from the host."""
    return torch.tensor(values, dtype=dtype, device=device)


def _scatter(terms, n_rows, n_cols, like):
    """Sum the (flat index, coefficient) terms into a batch-last
    [n_rows, n_cols, N] matrix: coefficients are [N] tensors or floats."""
    t_idx = [i for i, c in terms if torch.is_tensor(c)]
    f_idx = [i for i, c in terms if not torch.is_tensor(c)]
    n = like.shape[0]
    vals = torch.cat([
        torch.stack([c for _, c in terms if torch.is_tensor(c)]),
        _const(tuple(float(c) for _, c in terms if not torch.is_tensor(c)),
               like.dtype, like.device)[:, None].expand(len(f_idx), n)])
    idx = _const(tuple(t_idx + f_idx), torch.int64, like.device)
    out = torch.zeros((n_rows * n_cols, n), dtype=like.dtype,
                      device=like.device)
    return out.index_put((idx,), vals, accumulate=True).view(n_rows, n_cols,
                                                              n)


def _system(thetas: torch.Tensor):
    """thetas [N, P] -> (A, B, C, D) batch-last, the SW2007 equations in
    A x_{t-1} + B x_t + C E x_{t+1} + D eps = 0 form, one row per
    equation, with the steady-state ratios computed from theta."""
    return build_system(thetas, STATE_NAMES, SHOCK_NAMES)


@functools.lru_cache(maxsize=None)
def _index(names: tuple) -> Dict[str, int]:
    return {n: i for i, n in enumerate(names)}


def build_system(thetas: torch.Tensor, states, shocks, amend=None, rows=()):
    """(A, B, C, D) batch-last of SW2007's equations over the state and
    shock names `states` and `shocks` (SW2007's first, in their order), for
    a model that extends SW2007 (models/sw_pi_fg.py): `amend` maps the
    label of a row ("policy", "ms") to a dict of extra a=, b=, c=, d= terms
    for it, and `rows` holds one such dict per further equation, written
    after SW2007's 37. thetas' first 36 columns are SW2007's parameters."""
    amend = amend or {}
    sidx, eidx = _index(tuple(states)), _index(tuple(shocks))
    n_state, n_shock = len(states), len(shocks)
    th = thetas.T                                         # [P, N]
    (csadjcost, csigma, chabb, cprobw, csigl, cprobp, cindw, cindp, czcap,
     cfc, crpi, crr, cry, crdy, constepinf, constebeta, constelab, ctrend,
     cgy, calfa) = [th[i] for i in range(20)]
    crhoa, crhob, crhog, crhoqs, crhoms, crhopinf, crhow = \
        [th[20 + i] for i in range(7)]
    cmap, cmaw = th[27], th[28]

    # steady-state relationships (usmodel.mod steady-state block)
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    clandap = cfc
    cbetabar = cbeta * cgamma ** (-csigma)
    crk = (1.0 / cbeta) * cgamma ** csigma - (1.0 - CTOU)
    cw = (calfa ** calfa * (1 - calfa) ** (1 - calfa)
          / (clandap * crk ** calfa)) ** (1.0 / (1 - calfa))
    cikbar = 1.0 - (1.0 - CTOU) / cgamma
    cik = cikbar * cgamma
    clk = ((1 - calfa) / calfa) * (crk / cw)
    cky = cfc * clk ** (calfa - 1.0)
    ciy = cik * cky
    ccy = 1.0 - CG - ciy
    crkky = crk * cky
    cwhlc = (1.0 / CLANDAW) * (1 - calfa) / calfa * crk * cky / ccy

    terms = {"A": [], "B": [], "C": [], "D": []}
    row = [0]

    def eq(a=(), b=(), c=(), d=(), label=None):
        r, more = row[0], amend.get(label, {})
        for mat, lst, index, width in (("A", a, sidx, n_state),
                                       ("B", b, sidx, n_state),
                                       ("C", c, sidx, n_state),
                                       ("D", d, eidx, n_shock)):
            for name, coef in (*lst, *more.get(mat.lower(), ())):
                terms[mat].append((r * width + index[name], coef))
        row[0] += 1

    hg = chabb / cgamma
    c1 = hg / (1 + hg)                     # consumption lag coef
    c2 = 1.0 / (1 + hg)                    # consumption lead coef
    c3 = (csigma - 1.0) * cwhlc / (csigma * (1 + hg))
    c4 = (1 - hg) / (csigma * (1 + hg))
    i1 = 1.0 / (1 + cbetabar * cgamma)     # investment lag coef
    i2 = i1 / (cgamma * cgamma * csadjcost)
    pk1 = crk / (crk + 1 - CTOU)
    pk2 = (1 - CTOU) / (crk + 1 - CTOU)
    zc = (1 - czcap) / czcap               # zcap response to rk
    kb = cfc                               # production fixed-cost multiplier
    # NKPC slope and wage rigidity terms
    pinf_den = 1.0 + cbetabar * cgamma * cindp
    kappa_p = ((1 - cprobp) * (1 - cbetabar * cgamma * cprobp) / cprobp
               / ((cfc - 1.0) * CURVP + 1.0))
    w_den = 1.0 + cbetabar * cgamma
    kappa_w = ((1 - cprobw) * (1 - cbetabar * cgamma * cprobw)
               / (w_den * cprobw) / ((CLANDAW - 1.0) * CURVW + 1.0))

    # ---------------- flexible economy (no markup shocks; the real rate rrf
    # replaces r - E pinf) ----------------
    # 1. marginal cost = 0: calfa*rkf + (1-calfa)*wf - a = 0
    eq(b=[("rkf", calfa), ("wf", 1 - calfa), ("a", -1.0)])
    # 2. zcapf = zc * rkf
    eq(b=[("zcapf", -1.0), ("rkf", zc)])
    # 3. rkf = wf + labf - kf
    eq(b=[("rkf", -1.0), ("wf", 1.0), ("labf", 1.0), ("kf", -1.0)])
    # 4. kf = kpf(-1) + zcapf
    eq(a=[("kpf", 1.0)], b=[("kf", -1.0), ("zcapf", 1.0)])
    # 5. invef = i1*invef(-1) + i1*cbetabar*cgamma*invef(+1) + i2*pkf + qs
    eq(a=[("invef", i1)], b=[("invef", -1.0), ("pkf", i2), ("qs", 1.0)],
       c=[("invef", i1 * cbetabar * cgamma)])
    # 6. pkf = -rrf + (1/c4)*b + pk1*rkf(+1) + pk2*pkf(+1)
    eq(b=[("pkf", -1.0), ("rrf", -1.0), ("b", 1.0 / c4)],
       c=[("rkf", pk1), ("pkf", pk2)])
    # 7. cf = c1*cf(-1) + c2*cf(+1) + c3*(labf - labf(+1)) - c4*rrf + b
    eq(a=[("cf", c1)],
       b=[("cf", -1.0), ("labf", c3), ("rrf", -c4), ("b", 1.0)],
       c=[("cf", c2), ("labf", -c3)])
    # 8. yf = ccy*cf + ciy*invef + g + crkky*zcapf
    eq(b=[("yf", -1.0), ("cf", ccy), ("invef", ciy), ("g", 1.0),
          ("zcapf", crkky)])
    # 9. yf = cfc*(calfa*kf + (1-calfa)*labf + a)
    eq(b=[("yf", -1.0), ("kf", kb * calfa), ("labf", kb * (1 - calfa)),
          ("a", kb)])
    # 10. wf = csigl*labf + (1/(1-hg))*cf - (hg/(1-hg))*cf(-1)
    eq(a=[("cf", -hg / (1 - hg))],
       b=[("wf", -1.0), ("labf", csigl), ("cf", 1.0 / (1 - hg))])
    # 11. kpf = (1-cikbar)*kpf(-1) + cikbar*invef + cikbar*cgamma^2*csadjcost*qs
    eq(a=[("kpf", 1 - cikbar)],
       b=[("kpf", -1.0), ("invef", cikbar),
          ("qs", cikbar * cgamma * cgamma * csadjcost)])

    # ---------------- sticky economy ----------------
    # 12. mc = calfa*rk + (1-calfa)*w - a
    eq(b=[("mc", -1.0), ("rk", calfa), ("w", 1 - calfa), ("a", -1.0)])
    # 13. zcap = zc*rk
    eq(b=[("zcap", -1.0), ("rk", zc)])
    # 14. rk = w + lab - k
    eq(b=[("rk", -1.0), ("w", 1.0), ("lab", 1.0), ("k", -1.0)])
    # 15. k = kp(-1) + zcap
    eq(a=[("kp", 1.0)], b=[("k", -1.0), ("zcap", 1.0)])
    # 16. inve = i1*inve(-1) + i1*cbetabar*cgamma*inve(+1) + i2*pk + qs
    eq(a=[("inve", i1)], b=[("inve", -1.0), ("pk", i2), ("qs", 1.0)],
       c=[("inve", i1 * cbetabar * cgamma)])
    # 17. pk = -r + pinf(+1) + (1/c4)*b + pk1*rk(+1) + pk2*pk(+1)
    eq(b=[("pk", -1.0), ("r", -1.0), ("b", 1.0 / c4)],
       c=[("pinf", 1.0), ("rk", pk1), ("pk", pk2)])
    # 18. c = c1*c(-1) + c2*c(+1) + c3*(lab - lab(+1)) - c4*(r - pinf(+1)) + b
    eq(a=[("c", c1)],
       b=[("c", -1.0), ("lab", c3), ("r", -c4), ("b", 1.0)],
       c=[("c", c2), ("lab", -c3), ("pinf", c4)])
    # 19. y = ccy*c + ciy*inve + g + crkky*zcap
    eq(b=[("y", -1.0), ("c", ccy), ("inve", ciy), ("g", 1.0),
          ("zcap", crkky)])
    # 20. y = cfc*(calfa*k + (1-calfa)*lab + a)
    eq(b=[("y", -1.0), ("k", kb * calfa), ("lab", kb * (1 - calfa)),
          ("a", kb)])
    # 21. NKPC: pinf = (1/pinf_den)*(cbetabar*cgamma*pinf(+1)
    #      + cindp*pinf(-1) + kappa_p*mc) + spinf
    eq(a=[("pinf", cindp / pinf_den)],
       b=[("pinf", -1.0), ("mc", kappa_p / pinf_den), ("spinf", 1.0)],
       c=[("pinf", cbetabar * cgamma / pinf_den)])
    # 22. wage Phillips curve:
    # w = (1/w_den)*w(-1) + (cbetabar*cgamma/w_den)*w(+1)
    #     + (cindw/w_den)*pinf(-1) - ((1+cbetabar*cgamma*cindw)/w_den)*pinf
    #     + (cbetabar*cgamma/w_den)*pinf(+1)
    #     + kappa_w*(csigl*lab + (1/(1-hg))*c - (hg/(1-hg))*c(-1) - w) + sw
    eq(a=[("w", 1.0 / w_den), ("pinf", cindw / w_den),
          ("c", -kappa_w * hg / (1 - hg))],
       b=[("w", -1.0 - kappa_w),
          ("pinf", -(1 + cbetabar * cgamma * cindw) / w_den),
          ("lab", kappa_w * csigl), ("c", kappa_w / (1 - hg)),
          ("sw", 1.0)],
       c=[("w", cbetabar * cgamma / w_den),
          ("pinf", cbetabar * cgamma / w_den)])
    # 23. policy rule: r = crpi*(1-crr)*pinf + cry*(1-crr)*(y-yf)
    #      + crdy*(y - yf - y(-1) + yf(-1)) + crr*r(-1) + ms
    eq(a=[("r", crr), ("y", -crdy), ("yf", crdy)],
       b=[("r", -1.0), ("pinf", crpi * (1 - crr)),
          ("y", cry * (1 - crr) + crdy), ("yf", -cry * (1 - crr) - crdy),
          ("ms", 1.0)], label="policy")
    # 24. kp = (1-cikbar)*kp(-1) + cikbar*inve + cikbar*cgamma^2*csadjcost*qs
    eq(a=[("kp", 1 - cikbar)],
       b=[("kp", -1.0), ("inve", cikbar),
          ("qs", cikbar * cgamma * cgamma * csadjcost)])

    # ---------------- shock processes ----------------
    # 25. a = crhoa*a(-1) + ea
    eq(a=[("a", crhoa)], b=[("a", -1.0)], d=[("ea", 1.0)])
    # 26. b = crhob*b(-1) + eb
    eq(a=[("b", crhob)], b=[("b", -1.0)], d=[("eb", 1.0)])
    # 27. g = crhog*g(-1) + eg + cgy*ea
    eq(a=[("g", crhog)], b=[("g", -1.0)], d=[("eg", 1.0), ("ea", cgy)])
    # 28. qs = crhoqs*qs(-1) + eqs
    eq(a=[("qs", crhoqs)], b=[("qs", -1.0)], d=[("eqs", 1.0)])
    # 29. ms = crhoms*ms(-1) + em
    eq(a=[("ms", crhoms)], b=[("ms", -1.0)], d=[("em", 1.0)], label="ms")
    # 30. spinf = crhopinf*spinf(-1) + epinf - cmap*epinfma(-1)
    eq(a=[("spinf", crhopinf), ("epinfma", -cmap)], b=[("spinf", -1.0)],
       d=[("epinf", 1.0)])
    # 31. epinfma = epinf (MA bookkeeping)
    eq(b=[("epinfma", -1.0)], d=[("epinf", 1.0)])
    # 32. sw = crhow*sw(-1) + ew - cmaw*ewma(-1)
    eq(a=[("sw", crhow), ("ewma", -cmaw)], b=[("sw", -1.0)],
       d=[("ew", 1.0)])
    # 33. ewma = ew
    eq(b=[("ewma", -1.0)], d=[("ew", 1.0)])

    # ---------------- observation lags ----------------
    for lag, cur in [("ylag", "y"), ("clag", "c"), ("ivlag", "inve"),
                     ("wlag", "w")]:
        eq(a=[(cur, 1.0)], b=[(lag, -1.0)])
    for extra in rows:
        eq(**extra)

    if row[0] != n_state:
        raise ValueError(f"wrote {row[0]} equations for {n_state} states")
    return tuple(_scatter(terms[m], n_state,
                          n_shock if m == "D" else n_state, thetas)
                 for m in "ABCD")


def _measurement(thetas: torch.Tensor):
    """thetas [N, P] -> (d [7, N], Z [7, 37, N], H [7, 7, N])."""
    th = thetas.T
    constepinf, constebeta = th[14], th[15]
    constelab, ctrend, csigma = th[16], th[17], th[1]
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    cpie = 1.0 + constepinf / 100.0
    cr = cpie / (cbeta * cgamma ** (-csigma))
    conster = (cr - 1.0) * 100.0

    n, I = thetas.shape[0], _IDX
    Z = torch.zeros((N_OBS, N_STATE, n), dtype=torch.float64,
                    device=thetas.device)
    for r, (cur, lag) in enumerate([("y", "ylag"), ("c", "clag"),
                                    ("inve", "ivlag"), ("w", "wlag")]):
        Z[r, I[cur]], Z[r, I[lag]] = 1.0, -1.0
    Z[4, I["pinf"]] = 1.0
    Z[5, I["r"]] = 1.0
    Z[6, I["lab"]] = 1.0
    d = torch.stack([ctrend, ctrend, ctrend, ctrend,
                     constepinf, conster, constelab])
    H = (1e-10 * torch.eye(N_OBS, dtype=torch.float64, device=thetas.device)
         )[:, :, None].expand(N_OBS, N_OBS, n).contiguous()
    return d, Z, H


def _shock_cov(thetas: torch.Tensor):
    """thetas [N, P] -> Q = diag(sig^2) [7, 7, N]."""
    sig = thetas[:, 29:36]
    return torch.diag_embed(sig * sig, dim1=0, dim2=1).contiguous()


def smets_wouters() -> LinearDSGE:
    """SW2007 on the "plain" backend (the JAX package's "xla"): on a CUDA
    tensor the general-shape CUDA kernels (ops/cuda_dsge_general.py), on a
    CPU tensor the plain PyTorch bl_* functions."""
    return LinearDSGE(sw_parameters(), _system, _measurement, N_SHOCK,
                      _shock_cov, likelihood_backend="plain")


def generate_sw_data(T: int = 156, seed: int = 1793,
                     theta: np.ndarray = TRUE_PARAMS,
                     device="cuda") -> np.ndarray:
    """The 7 observables [7, T] simulated at `theta`, shocks from
    TorchDraws(seed, device). This is torch's stream, not the JAX
    package's: its generate_sw_data(T=156, seed=1793) is `load_sw_data()`."""
    from smc_tpu_torch.rng import TorchDraws
    obs = smets_wouters().simulate(theta, T, TorchDraws(seed, device))
    return obs.cpu().numpy()


def load_sw_data() -> np.ndarray:
    """The SW observables [7, 156]: the JAX package's
    generate_sw_data(T=156, seed=1793), committed as an array."""
    return np.load(_DATA_FILE)


def load_reference_sw_data(path: str, demean_hours: bool = True
                           ) -> np.ndarray:
    """The reference's US dataset for the Smets-Wouters example (its
    examples/data/sw_orig_smc.h5, read by examples/dsge_models/
    dsge_model.jl): 7 observables x 197 quarters, [7, T] in OBS_NAMES order.

    The file's columns are (dy, dc, dinve, dw, labobs, pinfobs, robs),
    identified by their magnitudes (growth rates near 0.4% a quarter, hours
    a raw log level near -46, inflation and the rate small and positive);
    a file that does not look so raises ValueError instead of being
    mis-mapped. labobs = constelab + lab_t expects demeaned hours, as the
    published usmodel dataset has them, so demean_hours=True demeans the
    level."""
    import h5py
    with h5py.File(path, "r") as f:
        d = f["data"][()]            # stored (197, 7) -> Julia (7, 197)
    d = np.ascontiguousarray(d.T)    # file order: dy dc dinve dw lab pinf r
    means = d.mean(axis=1)
    if not (np.all(np.abs(means[:4]) < 2.0)
            and np.all(d[:4].std(axis=1) < 5.0)):
        raise ValueError(
            f"columns 0-3 of {path} do not look like quarterly growth rates "
            f"(means {means[:4]}); observable order differs from the "
            "expected (dy, dc, dinve, dw, labobs, pinfobs, robs)")
    if not means[4] < -10.0:
        raise ValueError(
            f"column 4 of {path} (mean {means[4]:.2f}) is not a raw "
            "log-hours level; observable order differs from expectation")
    if not (0.0 < means[5] < 5.0 and 0.0 < means[6] < 5.0
            and d[6].min() > -1.0):
        raise ValueError(
            f"columns 5-6 of {path} (means {means[5]:.2f}, {means[6]:.2f}) "
            "do not look like inflation / policy-rate observables")
    out = d[[0, 1, 2, 3, 5, 6, 4]]   # -> dy dc dinve dw pinfobs robs labobs
    if demean_hours:
        out[6] = out[6] - out[6].mean()
    return out
