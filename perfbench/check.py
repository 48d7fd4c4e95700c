"""The comparison that decides `correct`: what the timed estimations
returned, against the plain reference.

For each checked estimation the reference works out again, in float64:

  * the likelihood of every particle of the final cloud, from its
    parameters and the data (reference/<config>.py);
  * the selection bookkeeping, stage by stage from the program's own
    incremental weights w_n and the weights W_{n-1} it carried into the
    stage: u = W_{n-1} w_n, the ESS N^2 / sum (N u / sum u)^2, the
    resampling decision ESS < threshold, the weights W_n it leaves (1 after
    a resample, N u / sum u otherwise) and the log marginal data density
    sum_n log(sum u / N);
  * the fixed tempering schedule ((n - 1)/(n_phi - 1))^lambda;
  * the posterior mean of the final cloud under its weights.

Each number compared is the widest gap over the checked estimations:

  loglh_gap      max over particles of |l - l_ref| / max(|l_ref|, 1); 1
                 where exactly one of the two is finite (the answer wholly
                 wrong), 0 where both are -inf
  weights_gap    max |W - W_ref| / max(|W_ref|, 1) over stages and
                 particles, the final cloud's weights included
  ess_gap        max |ESS - ESS_ref| / N over stages
  mdd_gap        |log-MDD - log-MDD_ref| in nats
  schedule_gap   max |phi - phi_ref| over stages; 1 for a schedule of
                 another length
  posterior_gap  max over parameters of |mean - mean_ref| / sd_ref

and three compare the posterior the estimation returned (its posterior
mean and sd, its log-MDD) with the reference's own posterior: the average
of plain SMC estimations of the configuration (reference/smc.py), kept in
posteriors/<config>.json. They are what a mutation that leaves the
particles where they are, or a correction with the wrong tempering
increment, fails, since the bookkeeping above agrees with itself there:

  post_mean_gap  max over parameters of |mean - mean_table| / sd_table
  post_sd_gap    max over parameters of |log(sd / sd_table)|
  mdd_table_gap  |log-MDD - log-MDD_table| in nats

A mesh cell also compares ranks_gap (run.py): the largest difference
between what rank 0 and another rank got back, which the mesh makes the
same whole result on every rank (an exact comparison).

A gap that is NaN reads as infinite. The control (control.py) is this
same reference computed in float32 and put in the program's place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np
import torch

NUMBERS = ("loglh_gap", "weights_gap", "ess_gap", "mdd_gap", "schedule_gap",
           "posterior_gap", "post_mean_gap", "post_sd_gap", "mdd_table_gap")


@dataclasses.dataclass
class Record:
    """What one estimation returned, as the check reads it."""

    params: torch.Tensor        # [N, P], the final cloud
    loglh: torch.Tensor         # [N]
    weights: torch.Tensor       # [N]
    w: np.ndarray               # [N, S + 1] incremental weights
    W: np.ndarray               # [N, S + 1] weights after each stage
    ess: List[float]            # [S + 1]
    schedule: List[float]       # [S + 1]
    log_mdd: float
    post_mean: np.ndarray       # [P]
    post_sd: np.ndarray         # [P]

    @classmethod
    def of(cls, res):
        """From an SMCResult (duck-typed: the check imports nothing of the
        program)."""
        c = res.cloud
        return cls(params=c.params, loglh=c.loglh, weights=c.weights,
                   w=res.w, W=res.W, ess=list(c.ESS),
                   schedule=list(c.tempering_schedule),
                   log_mdd=float(res.log_mdd),
                   post_mean=np.asarray(res.posterior_mean()),
                   post_sd=np.asarray(res.posterior_std()))


def reference_outputs(rec: Record, reference, data, smc: dict,
                      dtype=torch.float64, block: int = 4096) -> dict:
    """The reference's outputs for one estimation, computed in `dtype` on
    the device of rec.params (the likelihood in blocks of `block` rows)."""
    dev = rec.params.device
    th = rec.params.to(dtype)
    y = torch.as_tensor(np.asarray(data), dtype=dtype, device=dev)
    loglh = torch.cat([reference.loglike(th[i:i + block], y)
                       for i in range(0, th.shape[0], block)])
    n = th.shape[0]
    w = torch.as_tensor(rec.w, dtype=dtype)
    W = torch.as_tensor(rec.W, dtype=dtype)
    u = W[:, :-1] * w[:, 1:]
    total = u.sum(0)
    norm = n * u / total
    ess = n * n / (norm * norm).sum(0)
    resampled = ess < smc.get("threshold_ratio", 0.5) * n
    W_ref = torch.where(resampled, torch.ones_like(norm), norm)
    log_mdd = torch.log(total / n).sum()
    n_phi = int(smc["n_phi"])
    schedule = (torch.arange(n_phi, dtype=dtype) / (n_phi - 1)) ** float(
        smc["lam"])
    final = W_ref[:, -1].to(dev)
    mean = (final @ th) / final.sum()
    sd = torch.sqrt((final @ (th - mean) ** 2) / final.sum())
    return dict(loglh=loglh, W=W_ref, ess=ess, log_mdd=log_mdd,
                schedule=schedule, post_mean=mean, post_sd=sd)


def program_outputs(rec: Record) -> dict:
    """The program's answers, in the form of reference_outputs'."""
    f64 = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
    return dict(loglh=rec.loglh, W=f64(rec.W[:, 1:]),
                final_weights=rec.weights, ess=f64(rec.ess[1:]),
                log_mdd=rec.log_mdd, schedule=f64(rec.schedule),
                post_mean=f64(rec.post_mean), post_sd=f64(rec.post_sd))


def _f64(x):
    return torch.as_tensor(x).detach().to("cpu", torch.float64)


def _max(t) -> float:
    t = _f64(t)
    if t.numel() == 0:
        return 0.0
    v = float(t.max())
    return math.inf if math.isnan(v) or bool(torch.isnan(t).any()) else v


def gaps(judged: dict, ref: dict, table: dict) -> Dict[str, float]:
    """The numbers compared, one estimation: `judged` (the program's
    outputs, or the control's) against the float64 reference's `ref` and
    the reference posterior `table` (posteriors/<config>.json)."""
    lj, lr = _f64(judged["loglh"]), _f64(ref["loglh"])
    fj, fr = torch.isfinite(lj), torch.isfinite(lr)
    rel = (lj - lr).abs() / lr.abs().clamp(min=1.0)
    per = torch.where(fj & fr, rel, torch.where(fj == fr, 0.0, 1.0))
    per = torch.where(torch.isnan(lj), 1.0, per)
    n = lr.numel()
    Wj, Wr = _f64(judged["W"]), _f64(ref["W"])
    wgap = (Wj - Wr).abs() / Wr.abs().clamp(min=1.0) if Wj.shape == Wr.shape \
        else torch.tensor([math.inf])
    if "final_weights" in judged:
        fw = _f64(judged["final_weights"])
        wgap = torch.cat([wgap.flatten(),
                          ((fw - Wr[:, -1]).abs()
                           / Wr[:, -1].abs().clamp(min=1.0))])
    ej, er = _f64(judged["ess"]), _f64(ref["ess"])
    sj, sr = _f64(judged["schedule"]), _f64(ref["schedule"])
    mj, mr = _f64(judged["post_mean"]), _f64(ref["post_mean"])
    sd = _f64(ref["post_sd"]).clamp(min=1e-12)
    mdd = abs(float(judged["log_mdd"]) - float(ref["log_mdd"]))
    if table is None:            # no posteriors/<config>.json yet
        table = dict(mean=mj * math.nan, sd=mj, log_mdd=math.nan)
    tm, ts = _f64(table["mean"]), _f64(table["sd"])
    sdj = _f64(judged["post_sd"]).clamp(min=1e-300)
    mdd_t = abs(float(judged["log_mdd"]) - float(table["log_mdd"]))
    return {
        "loglh_gap": _max(per),
        "weights_gap": _max(wgap),
        "ess_gap": (_max((ej - er).abs() / n) if ej.shape == er.shape
                    else math.inf),
        "mdd_gap": math.inf if math.isnan(mdd) else mdd,
        "schedule_gap": (_max((sj - sr).abs()) if sj.shape == sr.shape
                         else 1.0),
        "posterior_gap": _max((mj - mr).abs() / sd),
        "post_mean_gap": _max((mj - tm).abs() / ts),
        "post_sd_gap": _max(torch.log(sdj / ts).abs()),
        "mdd_table_gap": math.inf if math.isnan(mdd_t) else mdd_t,
    }


def loglh_finite_gap(judged: dict, ref: dict) -> float:
    """loglh_gap over the particles where both sides are finite: the
    control's arithmetic error apart from the draws it rejects."""
    lj, lr = _f64(judged["loglh"]), _f64(ref["loglh"])
    both = torch.isfinite(lj) & torch.isfinite(lr)
    return _max(((lj - lr).abs() / lr.abs().clamp(min=1.0))[both])


def widest(per_estimation: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number's widest gap over the estimations."""
    return {k: max(g[k] for g in per_estimation) for k in NUMBERS}


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          failed: int, checked: int) -> bool:
    """True where every number is within its limit, no estimation failed
    and at least one was checked."""
    return (failed == 0 and checked > 0
            and all(numbers[k] <= limits[k] for k in limits))


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    """'check name number limit limit' lines for standard error."""
    return [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in limits]


def as_json(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """{name: {"value": number, "limit": limit}}; a non-finite number is
    written as a string."""
    def num(v):
        return v if math.isfinite(v) else str(v)
    return {k: {"value": num(numbers[k]), "limit": limits[k]}
            for k in limits}
