"""The draws interface: every random number the port consumes goes through it.

Stage functions never touch a generator directly; they ask a draws object for
`uniform`, `normal`, `integers`, `categorical`, `permutation` or
`standard_gamma`. Two implementations:

* `TorchDraws` wraps one explicit `torch.Generator` on the tensors' device
  (a CUDA generator for CUDA tensors), so a run is reproducible from its seed;
  `get_state`/`set_state` carry the generator across a checkpoint.
* `ReplayDraws` serves recorded numpy arrays in FIFO order. Tests record the
  draws the JAX package made (its PRNG differs from torch's) and replay them
  here, which makes one stage of the port comparable to one stage of the
  reference to rounding. A request whose kind or shape differs from the next
  recorded entry raises, so a change in draw order cannot pass silently.

Under a particle mesh every rank holds the same draws object with the same
seed; `ParticleDraws` serves one rank's rows of the per-particle draws the
mutation makes (drawn at the global size), and everything else (the prior
draws of the initialization, the resampling draws, the block permutation)
is drawn whole on every rank.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Tuple

import numpy as np
import torch

_F64 = torch.float64


def _shape(shape) -> Tuple[int, ...]:
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


class TorchDraws:
    """Draws from one `torch.Generator` seeded with `seed` on `device`."""

    def __init__(self, seed: int, device="cuda"):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._cdfs = {}

    def uniform(self, shape) -> torch.Tensor:
        """U[0, 1) f64 of `shape`."""
        return torch.rand(_shape(shape), generator=self.generator, dtype=_F64,
                          device=self.device)

    def normal(self, shape) -> torch.Tensor:
        """Standard normal f64 of `shape`."""
        return torch.randn(_shape(shape), generator=self.generator, dtype=_F64,
                           device=self.device)

    def integers(self, low: int, high: int, shape) -> torch.Tensor:
        """Uniform integers in [low, high), int64 of `shape`."""
        return torch.randint(int(low), int(high), _shape(shape),
                             generator=self.generator, device=self.device)

    def categorical(self, probs, n: int) -> torch.Tensor:
        """n iid indices into `probs` (need not be normalized), int64 [n],
        by inverse CDF: first index whose cumulative probability exceeds u.
        The CDF of host probabilities (a list or tuple) is made on the device
        once per distinct tuple, so a call copies nothing from the host (as
        a CUDA graph capture requires)."""
        if torch.is_tensor(probs):
            cdf = self._cdf(probs)
        else:
            key = tuple(float(x) for x in probs)
            if key not in self._cdfs:
                self._cdfs[key] = self._cdf(torch.tensor(
                    key, dtype=_F64, device=self.device))
            cdf = self._cdfs[key]
        u = self.uniform((n,))
        return torch.searchsorted(cdf, u, right=True).clamp_(0,
                                                             cdf.numel() - 1)

    def _cdf(self, p) -> torch.Tensor:
        p = torch.as_tensor(p, dtype=_F64, device=self.device)
        return torch.cumsum(p / p.sum(), 0)

    def permutation(self, n: int) -> torch.Tensor:
        """A uniformly random permutation of 0..n-1, int64 [n]."""
        return torch.randperm(int(n), generator=self.generator,
                              device=self.device)

    def standard_gamma(self, alpha: torch.Tensor) -> torch.Tensor:
        """Gamma(alpha, 1) draws, one per entry of `alpha` (f64)."""
        a = torch.as_tensor(alpha, dtype=_F64, device=self.device).contiguous()
        return torch._standard_gamma(a, generator=self.generator)

    def get_state(self) -> np.ndarray:
        """The generator's state as a uint8 array (what a checkpoint keeps)."""
        return self.generator.get_state().numpy().copy()

    def set_state(self, state) -> None:
        self.generator.set_state(torch.as_tensor(np.asarray(state, np.uint8)))


class ParticleDraws:
    """One rank's view of a shared draws object for per-particle draws
    under a particle mesh: each request for the rank's `rows` (a slice of
    `n_parts`) is drawn at the global size and the rank keeps its rows. So
    every rank's generator advances as the one-device run's does, and the
    ranks' particles get the one-device run's numbers, not copies of one
    another's. Only per-particle draws (leading dimension the rank's row
    count) are served; anything else raises."""

    def __init__(self, draws, rows: slice, n_parts: int):
        self.draws = draws
        self.rows = rows
        self.n_parts = int(n_parts)
        self.n_local = rows.stop - rows.start
        self.device = draws.device

    def _global(self, shape) -> Tuple[int, ...]:
        shape = _shape(shape)
        if not shape or shape[0] != self.n_local:
            raise ValueError(f"ParticleDraws serves per-particle draws "
                             f"(leading dimension {self.n_local}), not "
                             f"{shape}")
        return (self.n_parts,) + shape[1:]

    def uniform(self, shape) -> torch.Tensor:
        return self.draws.uniform(self._global(shape))[self.rows]

    def normal(self, shape) -> torch.Tensor:
        return self.draws.normal(self._global(shape))[self.rows]

    def categorical(self, probs, n: int) -> torch.Tensor:
        return self.draws.categorical(probs, self._global(n)[0])[self.rows]


class ReplayDraws:
    """Serves recorded draws in order. `entries` is an iterable of
    (kind, array) with kind one of the TorchDraws method names."""

    def __init__(self, entries: Iterable, device="cpu"):
        self.device = torch.device(device)
        self._queue = deque((str(k), np.asarray(v)) for k, v in entries)

    def remaining(self) -> int:
        return len(self._queue)

    def _next(self, kind: str, shape) -> np.ndarray:
        if not self._queue:
            raise RuntimeError(f"ReplayDraws exhausted: asked for {kind}"
                               f"{tuple(shape)}")
        k, v = self._queue.popleft()
        if k != kind or tuple(v.shape) != tuple(shape):
            raise RuntimeError(
                f"ReplayDraws mismatch: asked for {kind}{tuple(shape)}, next "
                f"recorded entry is {k}{tuple(v.shape)}")
        return v

    def _f64(self, v):
        return torch.as_tensor(np.array(v, np.float64), device=self.device)

    def uniform(self, shape) -> torch.Tensor:
        return self._f64(self._next("uniform", _shape(shape)))

    def normal(self, shape) -> torch.Tensor:
        return self._f64(self._next("normal", _shape(shape)))

    def integers(self, low: int, high: int, shape) -> torch.Tensor:
        v = self._next("integers", _shape(shape))
        return torch.as_tensor(v.astype(np.int64), device=self.device)

    def categorical(self, probs, n: int) -> torch.Tensor:
        v = self._next("categorical", (int(n),))
        return torch.as_tensor(v.astype(np.int64), device=self.device)

    def permutation(self, n: int) -> torch.Tensor:
        v = self._next("permutation", (int(n),))
        return torch.as_tensor(v.astype(np.int64), device=self.device)

    def standard_gamma(self, alpha) -> torch.Tensor:
        return self._f64(self._next("standard_gamma", tuple(alpha.shape)))
