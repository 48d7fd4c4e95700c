"""Correction step: incremental weights, normalized weights, ESS and the
log-MDD increment (port of smc_tpu/ops/correction.py).

The chain-facing quantities are computed in log space relative to the cloud
maximum, so a coarse schedule meeting |loglh| in the thousands cannot
underflow every weight to 0. Only the reported incremental-weight column is
the raw exponential (it may underflow cosmetically).
"""

from __future__ import annotations

import math

import torch


def log_incremental_weights(loglh, old_loglh, phi_n, phi_n1,
                            tempered_update_prior_weight: float = 0.0,
                            log_prob_old_data: float = 0.0):
    """log w_tilde per particle, three variants on the bridge weight omega:
      omega == 0: (phi_{n-1}-phi_n) old_loglh + (phi_n-phi_{n-1}) loglh
      omega == 1: (phi_n-phi_{n-1}) loglh
      0<omega<1:  the convex bridge, the old-posterior term mixed with prior
                  mass omega and normalized by the old data's log-MDD."""
    d = phi_n - phi_n1
    w = tempered_update_prior_weight
    if w == 0.0:
        return -d * old_loglh + d * loglh
    if w == 1.0:
        return d * loglh
    mix = torch.logaddexp(old_loglh - log_prob_old_data + math.log1p(-w),
                          torch.full_like(old_loglh, math.log(w)))
    return -d * mix + d * loglh


def incremental_weights(loglh, old_loglh, phi_n, phi_n1,
                        tempered_update_prior_weight: float = 0.0,
                        log_prob_old_data: float = 0.0):
    """w_tilde per particle: the raw exponential of log_incremental_weights
    (may under- or overflow; `correct` gives the stable quantities)."""
    return torch.exp(log_incremental_weights(
        loglh, old_loglh, phi_n, phi_n1, tempered_update_prior_weight,
        log_prob_old_data))


def correct(loglh, old_loglh, weights, phi_n, phi_n1,
            tempered_update_prior_weight: float = 0.0,
            log_prob_old_data: float = 0.0):
    """Returns (inc_w, norm_w, ess, mdd_inc), all on the cloud's device:
    raw incremental weights, new weights normalized to sum to N, the ESS
    N^2 / sum(norm_w^2), and log((1/N) sum_i weight_i w_tilde_i)."""
    n = loglh.shape[0]
    log_inc = log_incremental_weights(loglh, old_loglh, phi_n, phi_n1,
                                      tempered_update_prior_weight,
                                      log_prob_old_data)
    lw = torch.log(weights) + log_inc
    m = torch.max(lw)
    shifted = torch.exp(lw - m)
    total = torch.sum(shifted)
    norm_w = n * shifted / total
    ess = n * n / torch.sum(norm_w * norm_w)
    mdd_inc = m + torch.log(total / n)
    return torch.exp(log_inc), norm_w, ess, mdd_inc


def compute_ess(loglh, current_weights, phi_n, phi_n1, old_loglh=None):
    """ESS after a hypothetical tempering step phi_n1 -> phi_n, max-shifted
    in log space."""
    if old_loglh is None:
        old_loglh = torch.zeros_like(loglh)
    n = loglh.shape[0]
    log_inc = (phi_n1 - phi_n) * old_loglh + (phi_n - phi_n1) * loglh
    lw = torch.log(current_weights) + log_inc
    shifted = torch.exp(lw - torch.max(lw))
    norm_w = n * shifted / torch.sum(shifted)
    return n * n / torch.sum(norm_w * norm_w)
