"""The plain likelihood of Smets-Wouters (2007) with the FRBNY DSGE model's
inflation-target and forward-guidance blocks (DSGE.jl m1002's eq_mp, its
six anticipated policy shocks, its expected-rate rows ZZ_r TTT^k and its
10-year inflation row TTT10): 43 parameters, 44 states, 14 shocks, 14
observables.

Written again from the papers, independently of smc_tpu_torch (it imports
neither the port nor JAX): the 44 equations one row each in
A x_{t-1} + B x_t + C E x_{t+1} + D eps = 0, a cyclic-reduction RE solve
by torch.linalg.solve_ex, the seven expectation rows by
torch.linalg.matrix_power (the port runs a chain v <- v X), and the
Chandrasekhar filter from the stationary covariance (Lyapunov doubling)
with Cholesky solves. The acceptance tests and the filter's divergence
guards are the model's definition and are the port's: residual below 1e-8
(1e-4 in float32) relative to max|A|, the 12-squaring spectral bounds of X
and of -(B + C X)^-1 C below 1, finite X and M; quad < 0, diag(F) <= 0 or
trace(F) growing past trace(F_1) reject a draw. Everything is computed in
the dtype of theta; matrices batch-last [r, c, N] at the interface.

perfbench/reference/sw_pi_fg.py is the benchmark's copy of this file.
"""

from __future__ import annotations

import torch

LOG_2PI = 1.8378770664093453
CTOU, CLANDAW, CG, CURVP, CURVW = 0.025, 1.5, 0.18, 10.0, 10.0
RHO_PISTAR, K_ANT, LR_HORIZON = 0.99, 6, 40

STATES = ["y", "c", "inve", "pk", "k", "kp", "zcap", "rk", "mc", "pinf",
          "w", "r", "lab",
          "yf", "cf", "invef", "pkf", "kf", "kpf", "zcapf", "rkf", "wf",
          "labf", "rrf",
          "a", "b", "g", "qs", "ms", "spinf", "sw",
          "epinfma", "ewma",
          "ylag", "clag", "ivlag", "wlag",
          "pistar", "nu1", "nu2", "nu3", "nu4", "nu5", "nu6"]
SHOCKS = ["ea", "eb", "eg", "eqs", "em", "epinf", "ew",
          "epistar", "eant1", "eant2", "eant3", "eant4", "eant5", "eant6"]
N_STATE, N_SHOCK, N_OBS = len(STATES), len(SHOCKS), 14
_S = {n: i for i, n in enumerate(STATES)}
_E = {n: i for i, n in enumerate(SHOCKS)}
# (obs, base, first, last): row obs = mean_{h=first..last} Z[base] X^h;
# rows 7-12 the expected policy rate 1-6 quarters ahead (base robs, 5),
# row 13 the 10-year inflation expectation (base pinfobs, 4)
EXPECTATION_ROWS = tuple((6 + k, 5, k, k) for k in range(1, K_ANT + 1)) + (
    (13, 4, 1, LR_HORIZON),)

# (name, family, p1, p2, lo, hi): Smets and Wouters (2007) Table 1A-B with
# usmodel.mod's bounds, then m1002's RootInverseGamma(6, 0.03) and (4, 0.2)
# priors of the new standard deviations, with SW2007's shock bounds
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
                                     "sig_m", "sig_pinf", "sig_w")] + [
    ("sig_pistar", "root_inv_gamma", 6.0, 0.03, 0.01, 3.0)] + [
    (f"sig_ant{k}", "root_inv_gamma", 4.0, 0.2, 0.01, 3.0)
    for k in range(1, K_ANT + 1)]


def system(thetas):
    """thetas [N, 43] -> (A, B, C, D) batch-last."""
    th = thetas.T
    (csadjcost, csigma, chabb, cprobw, csigl, cprobp, cindw, cindp, czcap,
     cfc, crpi, crr, cry, crdy, constepinf, constebeta, constelab, ctrend,
     cgy, calfa) = th[:20]
    crhoa, crhob, crhog, crhoqs, crhoms, crhopinf, crhow = th[20:27]
    cmap, cmaw = th[27], th[28]

    # steady state (usmodel.mod)
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
    # m1002's eq_mp: r = crr r(-1) + (1 - crr)(crpi (pinf - pistar) + pistar
    #   + cry (y - yf)) + crdy (y - yf - y(-1) + yf(-1)) + ms
    eq(a=[("r", crr), ("y", -crdy), ("yf", crdy)],
       b=[("r", -1.0), ("pinf", crpi * (1 - crr)),
          ("pistar", (1 - crr) * (1 - crpi)),
          ("y", cry * (1 - crr) + crdy), ("yf", -cry * (1 - crr) - crdy),
          ("ms", 1.0)])
    eq(a=[("kp", 1 - cikbar)],
       b=[("kp", -1.0), ("inve", cikbar), ("qs", qs_k)])
    # shock processes; ms takes last quarter's first anticipated shock
    eq(a=[("a", crhoa)], b=[("a", -1.0)], d=[("ea", 1.0)])
    eq(a=[("b", crhob)], b=[("b", -1.0)], d=[("eb", 1.0)])
    eq(a=[("g", crhog)], b=[("g", -1.0)], d=[("eg", 1.0), ("ea", cgy)])
    eq(a=[("qs", crhoqs)], b=[("qs", -1.0)], d=[("eqs", 1.0)])
    eq(a=[("ms", crhoms), ("nu1", 1.0)], b=[("ms", -1.0)], d=[("em", 1.0)])
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
    # the inflation target and the anticipated policy shocks
    eq(a=[("pistar", RHO_PISTAR)], b=[("pistar", -1.0)],
       d=[("epistar", 1.0)])
    for k in range(1, K_ANT + 1):
        eq(a=[(f"nu{k + 1}", 1.0)] if k < K_ANT else [],
           b=[(f"nu{k}", -1.0)], d=[(f"eant{k}", 1.0)])
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


def measurement(thetas):
    """thetas [N, 43] -> (d [14, N], Z [14, 44, N] with the expectation
    rows zero, H [14, 14, N])."""
    th = thetas.T
    constepinf, constebeta, constelab, ctrend, csigma = (
        th[14], th[15], th[16], th[17], th[1])
    cgamma = 1.0 + ctrend / 100.0
    cbeta = 1.0 / (1.0 + constebeta / 100.0)
    conster = ((1.0 + constepinf / 100.0) / (cbeta * cgamma ** (-csigma))
               - 1.0) * 100.0
    n = thetas.shape[0]
    Z = torch.zeros((N_OBS, N_STATE, n), dtype=th.dtype, device=th.device)
    for r, (cur, lag) in enumerate([("y", "ylag"), ("c", "clag"),
                                    ("inve", "ivlag"), ("w", "wlag")]):
        Z[r, _S[cur]], Z[r, _S[lag]] = 1.0, -1.0
    Z[4, _S["pinf"]] = 1.0
    Z[5, _S["r"]] = 1.0
    Z[6, _S["lab"]] = 1.0
    d = torch.stack([ctrend, ctrend, ctrend, ctrend, constepinf, conster,
                     constelab] + [conster] * K_ANT + [constepinf])
    H = (1e-10 * torch.eye(N_OBS, dtype=th.dtype, device=th.device)
         )[:, :, None].expand(N_OBS, N_OBS, n).contiguous()
    return d, Z, H


def shock_cov(thetas):
    """Q = diag(sig^2) [14, 14, N]."""
    sig = thetas.T[29:43]
    return torch.diag_embed((sig * sig).T, dim1=0, dim2=1)


def _bf(x):
    """batch-last [r, c, N] -> batch-first [N, r, c] and back."""
    return x.permute(2, 0, 1)


def _solve(A, B):
    """A^-1 B, batch-first; a singular A gives non-finite entries."""
    return torch.linalg.solve_ex(A, B)[0]


def _max_abs(A):
    return torch.amax(A.abs(), dim=(1, 2))


def _radius_bound(M, n_squarings: int = 12):
    """rho(M) <= ||M^(2^k)||_F^(1/2^k) by renormalized squaring -> [N]."""
    log_scale = torch.zeros(M.shape[0], dtype=M.dtype, device=M.device)
    for _ in range(n_squarings):
        nrm = torch.sqrt(torch.sum(M * M, dim=(1, 2))) + 1e-300
        M = (M / nrm[:, None, None]) @ (M / nrm[:, None, None])
        log_scale = 2.0 * (log_scale + torch.log(nrm))
    nrm = torch.sqrt(torch.sum(M * M, dim=(1, 2))) + 1e-300
    return torch.exp((log_scale + torch.log(nrm)) / (2.0 ** n_squarings))


RESIDUAL_TOL = {torch.float64: 1e-8, torch.float32: 1e-4}


def solve_re(A, B, C, D, n_iter: int = 16):
    """Cyclic reduction for A + B X + C X^2 = 0 (batch-last in and out):
    (X, M, ok), X and M zero where not ok."""
    A, B, C, D = (_bf(m) for m in (A, B, C, D))
    n = A.shape[-1]
    A0, A1, A2, Ah = A, B, C, B
    for _ in range(n_iter):
        SA = _solve(A1, torch.cat([A0, A2], dim=-1))
        SA0, SA2 = SA[..., :n], SA[..., n:]
        Ah = Ah - A2 @ SA0
        A1 = A1 - A0 @ SA2 - A2 @ SA0
        A0, A2 = -A0 @ SA0, -A2 @ SA2
    X = -_solve(Ah, A)
    lhs = B + C @ X
    M = -_solve(lhs, D)
    resid = A + B @ X + C @ (X @ X)
    converged = (_max_abs(resid) < RESIDUAL_TOL[A.dtype]
                 * torch.clamp(_max_abs(A), min=1.0))
    ok = (converged & (_radius_bound(X) < 1.0)
          & (_radius_bound(-_solve(lhs, C)) < 1.0)
          & torch.isfinite(X).all(-1).all(-1)
          & torch.isfinite(M).all(-1).all(-1))
    X = torch.where(ok[:, None, None], X, 0.0)
    M = torch.where(ok[:, None, None], M, 0.0)
    return X.permute(1, 2, 0), M.permute(1, 2, 0), ok


def expectation_rows(Z, X, rows=EXPECTATION_ROWS):
    """Z [o, n, N] with row obs = mean_{h=first..last} Z[base] X^h, by
    matrix powers."""
    Zb, Xb = _bf(Z).clone(), _bf(X)
    for obs, base, first, last in rows:
        Zb[:, obs] = sum(Zb[:, base, None, :] @ torch.linalg.matrix_power(
            Xb, h) for h in range(first, last + 1))[:, 0] / (last - first + 1)
    return Zb.permute(1, 2, 0)


def chandrasekhar(T, R, Q, Z, d, H, data, n_doubling: int = 30):
    """The Chandrasekhar (Morf-Sidhu-Kailath) log-likelihood from the
    stationary covariance, batch-last inputs, data [n_o, T] -> [N]."""
    T, R, Q, Z, H = (_bf(m) for m in (T, R, Q, Z, H))
    d = d.T
    sym = lambda m: 0.5 * (m + m.transpose(1, 2))
    RQR = R @ Q @ R.transpose(1, 2)
    Ak, P0 = T, RQR
    for _ in range(n_doubling):
        Ak, P0 = Ak @ Ak, P0 + Ak @ P0 @ Ak.transpose(1, 2)
    Zt = Z.transpose(1, 2)

    def factor(F):
        L, info = torch.linalg.cholesky_ex(F)
        bad = info != 0
        return L, bad

    def solve(L, bad, B):
        X = torch.cholesky_solve(B, L)
        return torch.where(bad[:, None, None], float("nan"), X)

    F = sym(Z @ P0 @ Zt + H)
    K = T @ P0 @ Zt
    n_o = Z.shape[1]
    eye = torch.eye(n_o, dtype=F.dtype, device=F.device).expand_as(F)
    M = sym(-solve(*factor(F), eye))
    W = K
    s = torch.zeros(T.shape[:2], dtype=F.dtype, device=F.device)
    tr_cap = torch.diagonal(F, dim1=1, dim2=2).sum(-1) * (1.0 + 1e-6) + 1e-12
    bad = torch.zeros(T.shape[0], dtype=torch.bool, device=F.device)
    total = torch.zeros(T.shape[0], dtype=F.dtype, device=F.device)
    ys = torch.as_tensor(data, dtype=F.dtype, device=F.device)
    for t in range(ys.shape[1]):
        v = ys[:, t] - d - (Z @ s[..., None])[..., 0]
        ZW = Z @ W
        L, failed = factor(F)
        logdet = 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(-1)
        logdet = torch.where(failed, float("nan"), logdet)
        sol = solve(L, failed, torch.cat([v[..., None], ZW], dim=-1))
        quad = (v * sol[..., 0]).sum(-1)
        total = total - 0.5 * (n_o * LOG_2PI + logdet + quad)
        s = (T @ s[..., None] + K @ sol[..., :1])[..., 0]
        MWtZt = M @ ZW.transpose(1, 2)
        WMWtZt = W @ MWtZt
        F_new = sym(F + Z @ WMWtZt)
        K_new = K + T @ WMWtZt
        W = T @ W - K @ sol[..., 1:]
        M = sym(M - MWtZt @ solve(*factor(F_new), ZW) @ M)
        diag_F = torch.diagonal(F_new, dim1=1, dim2=2)
        bad = (bad | (quad < 0.0) | (diag_F <= 0.0).any(-1)
               | (diag_F.sum(-1) > tr_cap))
        F, K = F_new, K_new
    return torch.where(torch.isfinite(total) & ~bad, total, float("-inf"))


def _solved(thetas):
    A, B, C, D = system(thetas)
    d, Z, H = measurement(thetas)
    X, M, ok = solve_re(A, B, C, D)
    return (A, B, C, D, shock_cov(thetas), expectation_rows(Z, X), d, H,
            X, M, ok)


def inputs(thetas):
    """thetas [N, 43] -> (A, B, C, D, Q, Z, d, H) batch-last, Z with the
    expectation rows filled from the solved X (zero where the solve
    failed)."""
    return _solved(thetas)[:8]


def loglike(thetas, data):
    """log p(data | theta) per row of thetas [N, 43] -> [N]; -inf where the
    model has no unique stable solution or the filter diverges."""
    A, B, C, D, Q, Z, d, H, X, M, ok = _solved(thetas)
    ll = chandrasekhar(X, M, Q, Z, d, H, data)
    return torch.where(ok, ll, float("-inf"))
