"""Particle cloud (port of smc_tpu/cloud.py): f64 tensors for the particle
arrays plus host-side scalar state, the weighted cloud statistics, and the
split/join and model-extension helpers."""

from __future__ import annotations

import dataclasses
from typing import List, Mapping

import numpy as np
import torch

# the array fields, in the order and under the names the JAX package saves
ARRAY_FIELDS = ("params", "loglh", "logprior", "old_loglh", "accept",
                "weights")


@dataclasses.dataclass
class Cloud:
    """params [N, P], loglh, logprior, old_loglh, accept, weights [N] (f64,
    one device; weights normalized to sum to N), and the scalar state of the
    recursion."""

    params: torch.Tensor
    loglh: torch.Tensor
    logprior: torch.Tensor
    old_loglh: torch.Tensor
    accept: torch.Tensor
    weights: torch.Tensor

    tempering_schedule: List[float] = dataclasses.field(
        default_factory=lambda: [0.0])
    ESS: List[float] = dataclasses.field(default_factory=lambda: [0.0])
    stage_index: int = 1
    n_phi: int = 1
    resamples: int = 0
    c: float = 0.5
    accept_rate: float = 0.25
    total_sampling_time: float = 0.0

    @classmethod
    def create(cls, n_para: int, n_parts: int, device="cuda") -> "Cloud":
        z = lambda *s: torch.zeros(s, dtype=torch.float64, device=device)
        return cls(params=z(n_parts, n_para), loglh=z(n_parts),
                   logprior=z(n_parts), old_loglh=z(n_parts),
                   accept=z(n_parts),
                   weights=torch.ones(n_parts, dtype=torch.float64,
                                      device=device))

    @classmethod
    def from_numpy(cls, fields: Mapping, device="cuda") -> "Cloud":
        """A cloud from the saved particle arrays (the ARRAY_FIELDS of e.g.
        np.load of a cloud written by either package's save_cloud); the
        scalar state starts fresh."""
        return cls(**{k: torch.as_tensor(np.array(fields[k], np.float64),
                                         device=device)
                      for k in ARRAY_FIELDS})

    @property
    def n_parts(self) -> int:
        return int(self.params.shape[0])

    @property
    def n_para(self) -> int:
        return int(self.params.shape[1])

    @property
    def device(self) -> torch.device:
        return self.params.device

    def __len__(self) -> int:
        return self.n_parts

    def is_empty(self) -> bool:
        return self.n_parts == 0

    @property
    def logpost(self) -> torch.Tensor:
        """Log posterior kernel loglh + logprior."""
        return self.loglh + self.logprior

    def likeliest_particle_value(self) -> torch.Tensor:
        """The particle with the largest loglh."""
        return self.params[torch.argmax(self.loglh)]

    def highest_posterior_particle_value(self) -> torch.Tensor:
        """The particle with the largest loglh + logprior."""
        return self.params[torch.argmax(self.loglh + self.logprior)]

    # -- weights --------------------------------------------------------------

    def normalize_weights(self) -> torch.Tensor:
        """Normalize the weights to sum to N (not 1) in place; returns them."""
        self.weights = self.n_parts * self.weights / torch.sum(self.weights)
        return self.weights

    def reset_weights(self) -> None:
        """All weights to 1 (after a resample)."""
        self.weights = torch.ones_like(self.weights)

    def update_weights(self, incremental) -> None:
        """Multiply the weights by the incremental weights."""
        self.weights = self.weights * self._f64(incremental)

    def zero_bad_loglh_weights(self) -> None:
        """Weight 0 where loglh is -inf or nan (bridge clean-up)."""
        self.weights = torch.where(torch.isfinite(self.loglh), self.weights,
                                   0.0)

    def update_acceptance_rate(self) -> None:
        """accept_rate <- mean per-particle acceptance (a host read)."""
        self.accept_rate = float(torch.mean(self.accept))

    # -- accessors; setters take (N, P) or (P, N) and keep the cloud's device

    def _f64(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def get_vals(self, transpose: bool = True) -> torch.Tensor:
        """Parameter draws, (P, N) by default."""
        return self.params.T if transpose else self.params

    def _oriented(self, draws) -> torch.Tensor:
        draws = self._f64(draws)
        if tuple(draws.shape) == (self.n_parts, self.n_para):
            return draws
        if tuple(draws.shape) == (self.n_para, self.n_parts):
            return draws.T
        raise ValueError(f"draws shape {tuple(draws.shape)} matches neither "
                         f"(N={self.n_parts}, P={self.n_para}) orientation")

    def update_draws(self, draws) -> None:
        self.params = self._oriented(draws)

    def update_loglh(self, loglh) -> None:
        self.loglh = self._f64(loglh)

    def update_logprior(self, logprior) -> None:
        self.logprior = self._f64(logprior)

    def update_old_loglh(self, old_loglh) -> None:
        self.old_loglh = self._f64(old_loglh)

    def set_weights(self, weights) -> None:
        """Assign (update_weights multiplies)."""
        self.weights = self._f64(weights)

    def update_cloud(self, params, loglh, logprior, old_loglh,
                     accept) -> None:
        """Write back a whole mutation result."""
        self.params = self._oriented(params)
        self.loglh = self._f64(loglh)
        self.logprior = self._f64(logprior)
        self.old_loglh = self._f64(old_loglh)
        self.accept = self._f64(accept)

    def update_mutation(self, i: int, para, loglh, logprior, old_loglh,
                        accept) -> None:
        """Write one particle's state after its mutation."""
        self.update_val(i, para)
        for name, v in (("loglh", loglh), ("logprior", logprior),
                        ("old_loglh", old_loglh), ("accept", accept)):
            t = getattr(self, name).clone()
            t[i] = self._f64(v)
            setattr(self, name, t)

    def update_val(self, i: int, para) -> None:
        params = self.params.clone()
        params[i] = self._f64(para)
        self.params = params

    def update_weight(self, i: int, weight) -> None:
        weights = self.weights.clone()
        weights[i] = self._f64(weight)
        self.weights = weights

    def reindexed(self, idx) -> "Cloud":
        """Particle rows gathered by `idx` (resampling); a new Cloud sharing
        the scalar state."""
        idx = torch.as_tensor(idx, device=self.device)
        return dataclasses.replace(
            self, **{k: getattr(self, k)[idx] for k in ARRAY_FIELDS})


def _vals_weights(cloud_or_vals, weights):
    if isinstance(cloud_or_vals, Cloud):
        return cloud_or_vals.params, cloud_or_vals.weights
    return cloud_or_vals, weights


def weighted_mean(cloud_or_vals, weights=None) -> torch.Tensor:
    """vals' W / sum(W) -> [P]."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    return (w @ vals) / torch.sum(w)


def weighted_cov(cloud_or_vals, weights=None) -> torch.Tensor:
    """Weighted, uncorrected covariance [P, P]."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    wsum = torch.sum(w)
    dev = vals - (w @ vals) / wsum
    return (dev.T * w) @ dev / wsum


def weighted_std(cloud_or_vals, weights=None) -> torch.Tensor:
    return torch.sqrt(torch.diagonal(weighted_cov(cloud_or_vals, weights)))


def weighted_quantile(cloud_or_vals, weights=None, qs=(0.05, 0.95)
                      ) -> torch.Tensor:
    """Weighted quantiles per parameter [len(qs), P]: per column, the first
    sorted value whose cumulative normalized weight reaches q."""
    vals, w = _vals_weights(cloud_or_vals, weights)
    vals = torch.as_tensor(vals, dtype=torch.float64)
    w = torch.as_tensor(w, dtype=torch.float64, device=vals.device)
    qs_t = torch.as_tensor(qs, dtype=torch.float64, device=vals.device)
    sv, order = torch.sort(vals, dim=0, stable=True)
    cw = torch.cumsum((w / torch.sum(w))[order], dim=0)          # [N, P]
    q = qs_t[None, :].expand(cw.shape[1], -1).contiguous()        # [P, Q]
    pos = torch.searchsorted(cw.T.contiguous(), q)                # [P, Q]
    pos = pos.clamp_(max=vals.shape[0] - 1)
    return torch.gather(sv, 0, pos.T)


def split_cloud(cloud: Cloud, n_pieces: int) -> List[Cloud]:
    """Equal row slices; the scalar state is copied to every piece."""
    n = cloud.n_parts
    if n % n_pieces != 0:
        raise ValueError(f"n_parts={n} not divisible by n_pieces={n_pieces}")
    k = n // n_pieces
    return [dataclasses.replace(
        cloud, tempering_schedule=list(cloud.tempering_schedule),
        ESS=list(cloud.ESS),
        **{f: getattr(cloud, f)[i * k:(i + 1) * k] for f in ARRAY_FIELDS})
        for i in range(n_pieces)]


def join_cloud(pieces: List[Cloud]) -> Cloud:
    """Row slices concatenated back into one cloud; the scalar state is the
    first piece's."""
    return dataclasses.replace(
        pieces[0], **{f: torch.cat([getattr(p, f) for p in pieces])
                      for f in ARRAY_FIELDS})


def add_parameters_to_cloud(cloud_or_file, new_space, old_para_inds, draws,
                            regime_switching: bool = False,
                            device="cuda") -> Cloud:
    """A cloud over an extended parameter vector: the old posterior draws
    for the old parameters, prior draws (from `draws`) for the new ones.

    Valid when the old likelihood does not depend on the new parameters and
    the priors of old and new parameters are independent. loglh, accept and
    weights are kept; logprior is recomputed under the extended prior;
    old_loglh is zeroed and the scalar state reset (stage 1, c = 0,
    accept_rate = 0.25).

    cloud_or_file: the old cloud (P_old columns) or the path of a saved one.
    new_space: ParamSpace of the extended model; for regime switching, built
      with regime_switching=True (the flag must agree with this one's).
    old_para_inds: boolean mask over the new space's flat columns, or their
      integer indices, marking the old parameters in old column order.
    The result lies on `device`."""
    if isinstance(cloud_or_file, (str, bytes)):
        from smc_tpu_torch import io as smc_io
        cloud = smc_io.get_cloud(cloud_or_file, device=device)
    else:
        cloud = cloud_or_file
    if regime_switching != new_space.regime_switching:
        raise ValueError(
            f"regime_switching={regime_switching} disagrees with new_space "
            f"(built with regime_switching={new_space.regime_switching}); "
            "the flat-column layout the cloud is extended into comes from "
            "the space, so the flags must agree")
    expected = new_space.n_para
    old_para_inds = np.asarray(old_para_inds)
    if old_para_inds.dtype == bool:
        if old_para_inds.shape[0] != expected:
            raise ValueError(
                f"old_para_inds has {old_para_inds.shape[0]} entries but the "
                f"new space has {expected} flat columns")
        old_cols = np.nonzero(old_para_inds)[0]
    else:
        old_cols = old_para_inds
    if len(old_cols) != cloud.params.shape[1]:
        raise ValueError(
            f"old_para_inds marks {len(old_cols)} columns but the old cloud "
            f"has {cloud.params.shape[1]} parameters")
    arrays = {f: getattr(cloud, f).to(device) for f in ARRAY_FIELDS}
    params = new_space.sample_prior(draws, cloud.n_parts, device=device)
    params[:, torch.as_tensor(old_cols, device=params.device)] = \
        arrays["params"]
    arrays.update(params=params, logprior=new_space.log_prior(params),
                  old_loglh=torch.zeros_like(arrays["old_loglh"]))
    out = dataclasses.replace(cloud, **arrays, tempering_schedule=[0.0],
                              ESS=list(cloud.ESS))
    out.stage_index = 1
    out.resamples = 0
    out.c = 0.0
    out.accept_rate = 0.25
    out.total_sampling_time = 0.0
    return out
