"""Parameter-vector layer (port of smc_tpu/params.py).

A model's parameters are a list of `Parameter`, compiled into a `ParamSpace`:
one column per parameter plus one per non-first regime value (named
"<key>_reg<i>"), with stacked prior codes so `log_prior` and `sample_prior`
are a few masked tensor ops. Bounds violations give -inf, never an exception.

The metadata lives in numpy arrays; `ParamSpace.from_numpy` rebuilds a space
from those arrays alone, so a test can build the port's space from the JAX
package's numbers.

The sampler works in the model (untransformed) space. The transform tags
(`Untransformed`, `SquareRoot`, `Exponential`) are carried for API parity and
for users who want an unconstrained space (`ParamSpace.to_real`/`from_real`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from smc_tpu_torch.distributions import (Distribution, Point, FAMILY_CODES,
                                         logpdf_family, sample_family)

ARRAY_FIELDS = ("names", "values", "lo", "hi", "fixed", "prior_family",
                "prior_a", "prior_b", "_tn_logz")


class Untransformed:
    """Identity map between model space and unconstrained space."""

    def to_real(self, x, lo, hi):
        return x

    def from_real(self, y, lo, hi):
        return y


class SquareRoot:
    """For interval-bounded parameters: real = z / sqrt(1 - z^2) with
    z = (x - (a+b)/2) / ((b-a)/2)."""

    def to_real(self, x, lo, hi):
        z = (x - (lo + hi) / 2.0) / ((hi - lo) / 2.0)
        return z / torch.sqrt(1.0 - z * z)

    def from_real(self, y, lo, hi):
        z = y / torch.sqrt(1.0 + y * y)
        return (lo + hi) / 2.0 + (hi - lo) / 2.0 * z


class Exponential:
    """For lower-bounded parameters: real = log(x - lo), model = lo + exp(real)."""

    def to_real(self, x, lo, hi):
        return torch.log(x - lo)

    def from_real(self, y, lo, hi):
        return lo + torch.exp(y)


@dataclasses.dataclass
class Parameter:
    """One model parameter. `regimes` maps an attribute ("value",
    "valuebounds", "fixed", "prior") to {regime: override}; regime 1 lives in
    the parameter's own column, regimes 2..R in appended columns."""

    name: str
    value: float
    valuebounds: Tuple[float, float] = (-np.inf, np.inf)
    transform_bounds: Tuple[float, float] = (-np.inf, np.inf)
    transform: object = dataclasses.field(default_factory=Untransformed)
    prior: Optional[Distribution] = None
    fixed: bool = False
    regimes: Optional[Dict[str, Dict[int, object]]] = None

    def n_regimes(self) -> int:
        if not self.regimes or "value" not in self.regimes:
            return 1
        return max(self.regimes["value"].keys())

    def regime_attr(self, attr: str, regime: int, default):
        if self.regimes and attr in self.regimes and regime in self.regimes[attr]:
            return self.regimes[attr][regime]
        return default


def parameter(name, value, valuebounds=(-np.inf, np.inf),
              transform_bounds=None, transform=None, prior=None,
              fixed=False, regimes=None) -> Parameter:
    """A Parameter; transform_bounds default to valuebounds and transform to
    Untransformed()."""
    return Parameter(
        name=name, value=float(value), valuebounds=tuple(valuebounds),
        transform_bounds=(tuple(transform_bounds) if transform_bounds
                          else tuple(valuebounds)),
        transform=transform if transform is not None else Untransformed(),
        prior=prior, fixed=fixed, regimes=regimes)


class ParamSpace:
    """Flat, vectorized sampling space for a list of Parameters."""

    def __init__(self, params: Sequence[Parameter] = (),
                 regime_switching: bool = False):
        self.parameters: List[Parameter] = list(params)
        self.regime_switching = bool(regime_switching)
        rows = []

        def push(name, value, bounds, fx, pr):
            d = Point() if (fx or pr is None) else pr
            rows.append((name, float(value), float(bounds[0]),
                         float(bounds[1]), bool(fx), d.code, d.a, d.b))

        for p in self.parameters:
            push(p.name, p.regime_attr("value", 1, p.value),
                 p.regime_attr("valuebounds", 1, p.valuebounds),
                 p.regime_attr("fixed", 1, p.fixed),
                 p.regime_attr("prior", 1, p.prior))
        if regime_switching:
            for p in self.parameters:
                for r in range(2, p.n_regimes() + 1):
                    push(f"{p.name}_reg{r}",
                         p.regime_attr("value", r, p.value),
                         p.regime_attr("valuebounds", r, p.valuebounds),
                         p.regime_attr("fixed", r, p.fixed),
                         p.regime_attr("prior", r, p.prior))
        cols = list(zip(*rows)) if rows else [()] * 8
        self._set_arrays(
            names=list(cols[0]), values=cols[1], lo=cols[2], hi=cols[3],
            fixed=cols[4], prior_family=cols[5], prior_a=cols[6],
            prior_b=cols[7], _tn_logz=None)

    @classmethod
    def from_numpy(cls, fields: Mapping) -> "ParamSpace":
        """A space from the stacked arrays alone (the JAX ParamSpace's
        `names`, `values`, `lo`, `hi`, `fixed`, `prior_family`, `prior_a`,
        `prior_b` and `_tn_logz`)."""
        space = cls.__new__(cls)
        space.parameters = []
        space.regime_switching = False
        space._set_arrays(**{k: fields[k] for k in ARRAY_FIELDS})
        return space

    def _set_arrays(self, names, values, lo, hi, fixed, prior_family,
                    prior_a, prior_b, _tn_logz):
        self.names = [str(n) for n in names]
        self.values = np.asarray(values, np.float64)
        self.lo = np.asarray(lo, np.float64)
        self.hi = np.asarray(hi, np.float64)
        self.fixed = np.asarray(fixed, bool)
        self.prior_family = np.asarray(prior_family, np.int32)
        self.prior_a = np.asarray(prior_a, np.float64)
        self.prior_b = np.asarray(prior_b, np.float64)
        self.n_para = len(self.names)
        self.free_inds = np.nonzero(~self.fixed)[0]
        self.fixed_inds = np.nonzero(self.fixed)[0]
        self.n_free = len(self.free_inds)
        if _tn_logz is None:
            # log(Phi((hi-mu)/sig) - Phi((lo-mu)/sig)) per truncated-normal
            # column, zero elsewhere: a host-side constant
            logz = np.zeros(self.n_para)
            tn = self.prior_family == FAMILY_CODES["truncated_normal"]
            if tn.any():
                from scipy.stats import norm
                mu, sig = self.prior_a[tn], self.prior_b[tn]
                zhi = norm.cdf((self.hi[tn] - mu) / sig)
                zlo = norm.cdf((self.lo[tn] - mu) / sig)
                logz[tn] = np.log(np.maximum(zhi - zlo, 1e-300))
            _tn_logz = logz
        self._tn_logz = np.asarray(_tn_logz, np.float64)
        self._dev = {}

    def tensors(self, device) -> Dict[str, torch.Tensor]:
        """The stacked metadata as tensors on `device` (cached)."""
        device = torch.device(device)
        if device not in self._dev:
            f64 = lambda v: torch.as_tensor(v, dtype=torch.float64,
                                            device=device)
            self._dev[device] = dict(
                values=f64(self.values), lo=f64(self.lo), hi=f64(self.hi),
                free=torch.as_tensor(~self.fixed, device=device),
                fixed=torch.as_tensor(self.fixed, device=device),
                code=torch.as_tensor(self.prior_family.astype(np.int64),
                                     device=device),
                a=f64(self.prior_a), b=f64(self.prior_b),
                tn_logz=f64(self._tn_logz),
                free_inds=torch.as_tensor(self.free_inds.astype(np.int64),
                                          device=device))
        return self._dev[device]

    def log_prior(self, theta: torch.Tensor) -> torch.Tensor:
        """Sum of free-parameter prior log-densities at theta [..., P];
        -inf when a free coordinate is outside its bounds."""
        t = self.tensors(theta.device)
        lp = logpdf_family(t["code"], t["a"], t["b"], theta) - t["tn_logz"]
        free = t["free"]
        in_bounds = (theta >= t["lo"]) & (theta <= t["hi"])
        ok = torch.all(in_bounds | ~free, dim=-1)
        total = torch.sum(torch.where(free, lp, 0.0), dim=-1)
        return torch.where(ok & torch.isfinite(total), total, float("-inf"))

    def sample_prior(self, draws, n: int, device="cuda") -> torch.Tensor:
        """n prior draws [n, P]; fixed columns at their value. Truncated
        normals by inverse CDF inside their bounds (one uniform block after
        the family draws)."""
        t = self.tensors(device)
        out = sample_family(self.prior_family, self.prior_a, self.prior_b,
                            draws, n, device=device)
        tn_cols = np.nonzero(
            self.prior_family == FAMILY_CODES["truncated_normal"])[0]
        if tn_cols.size:
            idx = torch.as_tensor(tn_cols, device=out.device)
            mu, sig = t["a"][idx], t["b"][idx]
            sig = torch.clamp(sig, min=1e-300)
            zlo = torch.special.ndtr((t["lo"][idx] - mu) / sig)
            zhi = torch.special.ndtr((t["hi"][idx] - mu) / sig)
            u = draws.uniform((n, tn_cols.size))
            q = torch.clamp(zlo + u * (zhi - zlo), 1e-15, 1.0 - 1e-15)
            out.index_copy_(1, idx, mu + sig * torch.special.ndtri(q))
        return torch.where(t["fixed"], t["values"], out)

    # -- transforms (unused by the sampler itself) ---------------------------

    def to_real(self, theta: torch.Tensor) -> torch.Tensor:
        return torch.stack([tr.to_real(theta[..., j], lo, hi) for j, (tr, lo, hi)
                            in enumerate(self._column_specs())], dim=-1)

    def from_real(self, y: torch.Tensor) -> torch.Tensor:
        return torch.stack([tr.from_real(y[..., j], lo, hi) for j, (tr, lo, hi)
                            in enumerate(self._column_specs())], dim=-1)

    def _column_specs(self):
        """(transform, lo, hi) per flat column: the parameters, then one per
        appended regime column."""
        spec = lambda p: (p.transform, p.transform_bounds[0],
                          p.transform_bounds[1])
        specs = [spec(p) for p in self.parameters]
        if self.regime_switching:
            specs += [spec(p) for p in self.parameters
                      for _ in range(2, p.n_regimes() + 1)]
        return specs

    def regime_matrix(self) -> np.ndarray:
        """[n_base_params, max_regimes] column-index map: entry (i, r-1) is
        the flat column holding parameter i's regime-r value (regime 1 -> i),
        so a likelihood picks per-regime values with one gather."""
        n_base = len(self.parameters)
        max_r = max(p.n_regimes() for p in self.parameters)
        out = np.zeros((n_base, max_r), np.int32)
        col = n_base
        for i, p in enumerate(self.parameters):
            out[i, :] = i
            for r in range(2, p.n_regimes() + 1):
                if self.regime_switching:
                    out[i, r - 1] = col
                    col += 1
        return out

    def __len__(self) -> int:
        return self.n_para

    def __repr__(self) -> str:
        return (f"ParamSpace(n_para={self.n_para}, n_free={self.n_free}, "
                f"regime_switching={self.regime_switching})")
