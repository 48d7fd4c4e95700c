"""The plain Smets-Wouters likelihood: Smets and Wouters (2007), "Shocks and
Frictions in US Business Cycles: A Bayesian DSGE Approach", AER 97(3), as
in Dynare's usmodel.mod.

The sticky-price-and-wage economy, its flexible-price counterpart (for the
output gap of the policy rule), seven structural shocks (price and wage
markups with MA(1) terms) and seven observables (output, consumption,
investment and wage growth, inflation, the policy rate, hours): 37 states,
7 shocks, 36 estimated parameters in the order (csadjcost, csigma, chabb,
cprobw, csigl, cprobp, cindw, cindp, czcap, cfc, crpi, crr, cry, crdy,
constepinf, constebeta, constelab, ctrend, cgy, calfa, crhoa, crhob, crhog,
crhoqs, crhoms, crhopinf, crhow, cmap, cmaw, sig_a, sig_b, sig_g, sig_qs,
sig_m, sig_pinf, sig_w). The equations are written out again here, one row
each in A x_{t-1} + B x_t + C E x_{t+1} + D eps = 0; every matrix is made
in the dtype of theta, batch-last [r, c, N]. Imports nothing of the
program.
"""

from __future__ import annotations

import torch

from perfbench.reference import _linear_re

# fixed parameters (usmodel.mod)
CTOU, CLANDAW, CG, CURVP, CURVW = 0.025, 1.5, 0.18, 10.0, 10.0

STATES = ["y", "c", "inve", "pk", "k", "kp", "zcap", "rk", "mc", "pinf",
          "w", "r", "lab",
          "yf", "cf", "invef", "pkf", "kf", "kpf", "zcapf", "rkf", "wf",
          "labf", "rrf",
          "a", "b", "g", "qs", "ms", "spinf", "sw",
          "epinfma", "ewma",
          "ylag", "clag", "ivlag", "wlag"]
SHOCKS = ["ea", "eb", "eg", "eqs", "em", "epinf", "ew"]
N_STATE, N_SHOCK, N_OBS = len(STATES), len(SHOCKS), 7
_S = {n: i for i, n in enumerate(STATES)}

# the priors of Smets and Wouters (2007), Table 1A-B, with the bounds of
# usmodel.mod's estimated_params, as (name, family, p1, p2, lo, hi) of
# reference/prior.py
PRIORS = [
    ("csadjcost", "normal", 4.0, 1.5, 2.0, 15.0),
    ("csigma", "normal", 1.5, 0.375, 0.25, 3.0),
    ("chabb", "beta", 0.7, 0.1, 0.001, 0.99),
    ("cprobw", "beta", 0.5, 0.1, 0.3, 0.95),
    ("csigl", "normal", 2.0, 0.75, 0.25, 10.0),
    ("cprobp", "beta", 0.5, 0.1, 0.5, 0.95),
    ("cindw", "beta", 0.5, 0.15, 0.01, 0.99),
    ("cindp", "beta", 0.5, 0.15, 0.01, 0.99),
    ("czcap", "beta", 0.5, 0.15, 0.01, 1.0),
    ("cfc", "normal", 1.25, 0.125, 1.0, 3.0),
    ("crpi", "normal", 1.5, 0.25, 1.0, 3.0),
    ("crr", "beta", 0.75, 0.1, 0.5, 0.975),
    ("cry", "normal", 0.125, 0.05, 0.001, 0.5),
    ("crdy", "normal", 0.125, 0.05, 0.001, 0.5),
    ("constepinf", "gamma", 0.625, 0.1, 0.1, 2.0),
    ("constebeta", "gamma", 0.25, 0.1, 0.01, 2.0),
    ("constelab", "normal", 0.0, 2.0, -10.0, 10.0),
    ("ctrend", "normal", 0.4, 0.1, 0.1, 0.8),
    ("cgy", "normal", 0.5, 0.25, 0.01, 2.0),
    ("calfa", "normal", 0.3, 0.05, 0.01, 1.0),
] + [(name, "beta", 0.5, 0.2, 0.001, 0.9999) for name in (
    "crhoa", "crhob", "crhog", "crhoqs", "crhoms", "crhopinf", "crhow",
    "cmap", "cmaw")] + [(name, "root_inv_gamma", 2.0, 0.1, 0.01, 3.0)
                        for name in ("sig_a", "sig_b", "sig_g", "sig_qs",
                                     "sig_m", "sig_pinf", "sig_w")]
_E = {n: i for i, n in enumerate(SHOCKS)}


def _system(thetas):
    th = thetas.T
    (csadjcost, csigma, chabb, cprobw, csigl, cprobp, cindw, cindp, czcap,
     cfc, crpi, crr, cry, crdy, constepinf, constebeta, constelab, ctrend,
     cgy, calfa) = th[:20]
    crhoa, crhob, crhog, crhoqs, crhoms, crhopinf, crhow = th[20:27]
    cmap, cmaw = th[27], th[28]

    # steady state
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    cbetabar = cbeta * cgamma ** (-csigma)
    crk = (1.0 / cbeta) * cgamma ** csigma - (1.0 - CTOU)
    cw = (calfa ** calfa * (1 - calfa) ** (1 - calfa)
          / (cfc * crk ** calfa)) ** (1.0 / (1 - calfa))
    cikbar = 1.0 - (1.0 - CTOU) / cgamma
    cik = cikbar * cgamma
    clk = ((1 - calfa) / calfa) * (crk / cw)
    cky = cfc * clk ** (calfa - 1.0)
    ciy = cik * cky
    ccy = 1.0 - CG - ciy
    crkky = crk * cky
    cwhlc = (1.0 / CLANDAW) * (1 - calfa) / calfa * crk * cky / ccy

    hg = chabb / cgamma
    c1, c2 = hg / (1 + hg), 1.0 / (1 + hg)
    c3 = (csigma - 1.0) * cwhlc / (csigma * (1 + hg))
    c4 = (1 - hg) / (csigma * (1 + hg))
    i1 = 1.0 / (1 + cbetabar * cgamma)
    i2 = i1 / (cgamma * cgamma * csadjcost)
    pk1 = crk / (crk + 1 - CTOU)
    pk2 = (1 - CTOU) / (crk + 1 - CTOU)
    zc = (1 - czcap) / czcap
    pinf_den = 1.0 + cbetabar * cgamma * cindp
    kappa_p = ((1 - cprobp) * (1 - cbetabar * cgamma * cprobp) / cprobp
               / ((cfc - 1.0) * CURVP + 1.0))
    w_den = 1.0 + cbetabar * cgamma
    kappa_w = ((1 - cprobw) * (1 - cbetabar * cgamma * cprobw)
               / (w_den * cprobw) / ((CLANDAW - 1.0) * CURVW + 1.0))
    qs_k = cikbar * cgamma * cgamma * csadjcost
    bg = cbetabar * cgamma

    rows = []     # one (a, b, c, d) of (name, coefficient) lists per row

    def eq(a=(), b=(), c=(), d=()):
        rows.append((a, b, c, d))

    # flexible economy
    eq(b=[("rkf", calfa), ("wf", 1 - calfa), ("a", -1.0)])
    eq(b=[("zcapf", -1.0), ("rkf", zc)])
    eq(b=[("rkf", -1.0), ("wf", 1.0), ("labf", 1.0), ("kf", -1.0)])
    eq(a=[("kpf", 1.0)], b=[("kf", -1.0), ("zcapf", 1.0)])
    eq(a=[("invef", i1)], b=[("invef", -1.0), ("pkf", i2), ("qs", 1.0)],
       c=[("invef", i1 * bg)])
    eq(b=[("pkf", -1.0), ("rrf", -1.0), ("b", 1.0 / c4)],
       c=[("rkf", pk1), ("pkf", pk2)])
    eq(a=[("cf", c1)], b=[("cf", -1.0), ("labf", c3), ("rrf", -c4),
                          ("b", 1.0)],
       c=[("cf", c2), ("labf", -c3)])
    eq(b=[("yf", -1.0), ("cf", ccy), ("invef", ciy), ("g", 1.0),
          ("zcapf", crkky)])
    eq(b=[("yf", -1.0), ("kf", cfc * calfa), ("labf", cfc * (1 - calfa)),
          ("a", cfc)])
    eq(a=[("cf", -hg / (1 - hg))],
       b=[("wf", -1.0), ("labf", csigl), ("cf", 1.0 / (1 - hg))])
    eq(a=[("kpf", 1 - cikbar)],
       b=[("kpf", -1.0), ("invef", cikbar), ("qs", qs_k)])
    # sticky economy
    eq(b=[("mc", -1.0), ("rk", calfa), ("w", 1 - calfa), ("a", -1.0)])
    eq(b=[("zcap", -1.0), ("rk", zc)])
    eq(b=[("rk", -1.0), ("w", 1.0), ("lab", 1.0), ("k", -1.0)])
    eq(a=[("kp", 1.0)], b=[("k", -1.0), ("zcap", 1.0)])
    eq(a=[("inve", i1)], b=[("inve", -1.0), ("pk", i2), ("qs", 1.0)],
       c=[("inve", i1 * bg)])
    eq(b=[("pk", -1.0), ("r", -1.0), ("b", 1.0 / c4)],
       c=[("pinf", 1.0), ("rk", pk1), ("pk", pk2)])
    eq(a=[("c", c1)], b=[("c", -1.0), ("lab", c3), ("r", -c4), ("b", 1.0)],
       c=[("c", c2), ("lab", -c3), ("pinf", c4)])
    eq(b=[("y", -1.0), ("c", ccy), ("inve", ciy), ("g", 1.0),
          ("zcap", crkky)])
    eq(b=[("y", -1.0), ("k", cfc * calfa), ("lab", cfc * (1 - calfa)),
          ("a", cfc)])
    eq(a=[("pinf", cindp / pinf_den)],
       b=[("pinf", -1.0), ("mc", kappa_p / pinf_den), ("spinf", 1.0)],
       c=[("pinf", bg / pinf_den)])
    eq(a=[("w", 1.0 / w_den), ("pinf", cindw / w_den),
          ("c", -kappa_w * hg / (1 - hg))],
       b=[("w", -1.0 - kappa_w), ("pinf", -(1 + bg * cindw) / w_den),
          ("lab", kappa_w * csigl), ("c", kappa_w / (1 - hg)),
          ("sw", 1.0)],
       c=[("w", bg / w_den), ("pinf", bg / w_den)])
    eq(a=[("r", crr), ("y", -crdy), ("yf", crdy)],
       b=[("r", -1.0), ("pinf", crpi * (1 - crr)),
          ("y", cry * (1 - crr) + crdy), ("yf", -cry * (1 - crr) - crdy),
          ("ms", 1.0)])
    eq(a=[("kp", 1 - cikbar)],
       b=[("kp", -1.0), ("inve", cikbar), ("qs", qs_k)])
    # shock processes
    eq(a=[("a", crhoa)], b=[("a", -1.0)], d=[("ea", 1.0)])
    eq(a=[("b", crhob)], b=[("b", -1.0)], d=[("eb", 1.0)])
    eq(a=[("g", crhog)], b=[("g", -1.0)], d=[("eg", 1.0), ("ea", cgy)])
    eq(a=[("qs", crhoqs)], b=[("qs", -1.0)], d=[("eqs", 1.0)])
    eq(a=[("ms", crhoms)], b=[("ms", -1.0)], d=[("em", 1.0)])
    eq(a=[("spinf", crhopinf), ("epinfma", -cmap)], b=[("spinf", -1.0)],
       d=[("epinf", 1.0)])
    eq(b=[("epinfma", -1.0)], d=[("epinf", 1.0)])
    eq(a=[("sw", crhow), ("ewma", -cmaw)], b=[("sw", -1.0)],
       d=[("ew", 1.0)])
    eq(b=[("ewma", -1.0)], d=[("ew", 1.0)])
    # observation lags
    for lag, cur in [("ylag", "y"), ("clag", "c"), ("ivlag", "inve"),
                     ("wlag", "w")]:
        eq(a=[(cur, 1.0)], b=[(lag, -1.0)])
    if len(rows) != N_STATE:
        raise AssertionError(f"{len(rows)} equations for {N_STATE} states")

    mats = [torch.zeros((N_STATE, n, th.shape[1]), dtype=th.dtype,
                        device=th.device)
            for n in (N_STATE, N_STATE, N_STATE, N_SHOCK)]
    for r, terms in enumerate(rows):
        for mat, lst, index in zip(mats, terms, (_S, _S, _S, _E)):
            for name, coef in lst:
                mat[r, index[name]] += coef
    return mats


def inputs(thetas: torch.Tensor):
    """thetas [N, 36] -> (A, B, C, D, Q, Z, d, H), batch-last."""
    A, B, C, D = _system(thetas)
    th = thetas.T
    sig = th[29:36]
    Q = torch.diag_embed((sig * sig).T, dim1=0, dim2=1)
    constepinf, constebeta, constelab, ctrend, csigma = (
        th[14], th[15], th[16], th[17], th[1])
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    cr = (1.0 + constepinf / 100.0) / (cbeta * cgamma ** (-csigma))
    n = thetas.shape[0]
    Z = torch.zeros((N_OBS, N_STATE, n), dtype=th.dtype, device=th.device)
    for r, (cur, lag) in enumerate([("y", "ylag"), ("c", "clag"),
                                    ("inve", "ivlag"), ("w", "wlag")]):
        Z[r, _S[cur]], Z[r, _S[lag]] = 1.0, -1.0
    Z[4, _S["pinf"]] = 1.0
    Z[5, _S["r"]] = 1.0
    Z[6, _S["lab"]] = 1.0
    d = torch.stack([ctrend, ctrend, ctrend, ctrend, constepinf,
                     (cr - 1.0) * 100.0, constelab])
    H = (1e-10 * torch.eye(N_OBS, dtype=th.dtype, device=th.device)
         )[:, :, None].expand(N_OBS, N_OBS, n).contiguous()
    return A, B, C, D, Q, Z, d, H


def loglike(thetas: torch.Tensor, data) -> torch.Tensor:
    """log p(data | theta) per row of thetas [N, 36] -> [N]; -inf where the
    model has no unique stable solution or the filter diverges."""
    return _linear_re.loglike(*inputs(thetas), data)
