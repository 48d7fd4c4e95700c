"""A hand-written CUDA kernel for the expectation rows of a DSGE
measurement, and its dispatch.

With X the solved transition, row obs of Z becomes the mean over h =
first..last of Z[base] X^h (models/dsge.py `bl_expectation_rows`, which a
CPU tensor runs). It runs between the RE solve and the Kalman filter of
ops/cuda_dsge_general.py `dsge_loglike`, as a kernel of its own so that a
profiler names and times the step inside the fused recursion's graph
replays; the JAX package has no such rows and no such kernel.

Domain (`in_domain`): 1 <= n_state <= MAX_STATE, 1 <= n_obs <= MAX_OBS and
1 to n_obs - 1 rows, those of models/dsge.py `check_expectation_rows`.
Dispatch, as the other wrappers: a CPU tensor runs the plain version; a
CUDA tensor launches the kernel, or raises; shapes or rows outside the
domain raise ValueError on every device. There is no fallback. Its
library, `dsge_expectations`, is built apart from the general kernels', so
a model without expectation rows neither builds nor loads it. The kernel
launches through ops/kernels.py, which counts it under
"expectation_rows". The wrapper reads nothing back from the card and sets
no attribute (the tile fits a block's default shared memory), so the fused
recursion captures it: the rows go to the kernel by value.

The kernel (csrc/dsge_expectations.cu, body in csrc/dsge_expectations.cuh)
runs one block of 64 threads per particle, thread j owning column j: each
base row's chain v <- v X runs once, to the last horizon of the rows it
feeds, with X in shared memory. Particles whose RE solve failed keep their
rows as given. PERF.md holds the measured times.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from smc_tpu_torch import _build
from smc_tpu_torch.models.dsge import (bl_expectation_rows,
                                       check_expectation_rows)
from smc_tpu_torch.ops.kernels import check, cuda_device, launch, load

_LIB = "dsge_expectations"

# csrc/dsge_expectations.cuh: a thread per column, n_obs as the general
# kernels take it
MAX_STATE = 64
MAX_OBS = _build.GENERAL_MAX_OBS


def smem_bytes(n_s: int, n_rows: int) -> int:
    """The kernel's tile (csrc/dsge_expectations.cuh tile_doubles): X, the
    chain's two vectors and the rows' sums."""
    return 8 * (n_s * n_s + 2 * n_s + n_rows * n_s)


def in_domain(n_s: int, n_o: int) -> bool:
    """Whether the kernel takes a model of these shapes."""
    return 1 <= n_s <= MAX_STATE and 2 <= n_o <= MAX_OBS


@functools.lru_cache(maxsize=None)
def _spec(rows: tuple):
    """The rows as the launcher's int array [n_rows][4], made once."""
    flat = [x for r in rows for x in r]
    return (ctypes.c_int * len(flat))(*flat)


def expectation_rows(Z, X, ok, rows):
    """Z [o,n,N] f64 with each expectation row (obs, base, first, last) of
    `rows` set to the mean over h = first..last of Z[base] X^h, X [n,n,N],
    where ok (bool [N]); elsewhere Z as given. A new tensor."""
    n_o, n_s, n = Z.shape
    rows = check_expectation_rows(rows, n_o)
    if not rows or not in_domain(n_s, n_o):
        raise ValueError(
            f"no expectation-rows kernel for n_state={n_s}, n_obs={n_o} "
            f"with {len(rows)} rows: it takes n_state <= {MAX_STATE}, "
            f"n_obs <= {MAX_OBS} and at least one row")
    if Z.device.type == "cpu":
        return bl_expectation_rows(Z, X, rows, ok)
    dev = cuda_device(Z)
    check("Z", Z, (n_o, n_s, n), dev)
    check("X", X, (n_s, n_s, n), dev)
    check("ok", ok, (n,), dev, torch.bool)
    out = torch.empty_like(Z)
    if n == 0:
        return out
    if load(_LIB, dev).smc_expectation_smem(n_s, len(rows)) != smem_bytes(
            n_s, len(rows)):
        raise RuntimeError("expectation rows: the library's tile is not the "
                           "wrapper's")
    launch(_LIB, "smc_expectation_rows", dev, n_s, n_o, len(rows),
           _spec(rows), Z.data_ptr(), X.data_ptr(), ok.data_ptr(),
           out.data_ptr(), n)
    return out
