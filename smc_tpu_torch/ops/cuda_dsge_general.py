"""Hand-written CUDA kernels for the DSGE likelihood at general shapes, and
their dispatch.

They stand where the JAX package's default likelihood ("xla") stands:
`solve_linear_re` for smc_tpu/models/dsge.py `bl_solve_linear_re`,
`kalman_chandrasekhar` for `bl_kalman_loglike_chandrasekhar` (with
smc_tpu/ops/linalg.py `bl_psd_fast_solve`: the cofactor form at n_obs 3,
Cholesky otherwise), and `dsge_loglike` composes the two. XLA compiles
those into a few fused device loops; the port's plain versions
(models/dsge.py `bl_*`) issue ~22,000 launches per Smets-Wouters call.

Domain (`in_domain`): 1 <= n_state <= GENERAL_MAX_STATE, 1 <= n_shock <=
GENERAL_MAX_SHOCK, 1 <= n_obs <= GENERAL_MAX_OBS (_build sets them, the
compiler checks the largest tiles), and both tiles within a block's shared
memory (_build.SMEM_LIMIT, also passed to the compiler), any number of
observations: the Kalman kernel reads them from global memory. Dispatch,
as ops/cuda_dsge.py: a CPU tensor runs the plain PyTorch version; a CUDA
tensor launches the kernel, or raises. Shapes outside the domain raise
ValueError on every device. There is no fallback. The kernels launch
through ops/kernels.py, which counts them under "re_general" and
"kalman_general". The wrappers read nothing back from the card and set no
attribute after the first call on a device, so the fused recursion
captures them.

The kernels (csrc/dsge_general_kernels.cu, bodies in
csrc/dsge_general.cuh) run one block per particle with the particle's
matrices in shared memory (the RE tile 78 kB at Smets-Wouters' n_state 37),
a block of 64 threads up to n_state 16 and 256 beyond; the Kalman kernel
holds three such blocks an SM up to n_obs 8 and two beyond
(`kalman_blocks_per_sm` asks the card). In the Kalman
filter's recursion warp 0 does the n_obs-sized algebra (the Cholesky
factor, log det, solves, M-update and guards) with the rows in its lanes'
registers, exchanged by shuffles, and the other warps the n_state-sized
products; the two hand results over at named barriers. A particle's chain
of small dependent steps, not the card's f64 rate, sets the kernels' time.
PERF.md holds the measured times.
"""

from __future__ import annotations

import functools

import torch

from smc_tpu_torch import _build
from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                       bl_kalman_loglike_chandrasekhar)
from smc_tpu_torch.ops import cuda_dsge_expectations
from smc_tpu_torch.ops.kernels import check, cuda_device, launch, load
from smc_tpu_torch.tracing import span

_LIB = "dsge_general"

MAX_STATE = _build.GENERAL_MAX_STATE
MAX_SHOCK = _build.GENERAL_MAX_SHOCK
MAX_OBS = _build.GENERAL_MAX_OBS
SMEM_LIMIT = _build.SMEM_LIMIT
# csrc/dsge_general.cuh: the block size by n_state, and its reduction slots
_SMALL_MAX, _SMALL_TEAM, _LARGE_TEAM = 16, 64, 256


def _red(n):
    return 4 * ((_SMALL_TEAM if n <= _SMALL_MAX else _LARGE_TEAM) // 32)


def re_smem_bytes(n_s: int, n_k: int) -> int:
    """The RE kernel's tile (csrc/dsge_general.cuh re_doubles): the
    Gauss-Jordan tile [n_s, max(3 n_s, 2 n_s + n_k)], the four carried
    matrices, a column and a row buffer and the reduction slots."""
    w = max(3 * n_s, 2 * n_s + n_k)
    return 8 * (n_s * w + 4 * n_s * n_s + n_s + w + _red(n_s))


def kalman_smem_bytes(n_s: int, n_k: int, n_o: int) -> int:
    """The Kalman kernel's tile (kalman_doubles): T, P, Z, d and v, ten
    n_obs-square matrices, the innovation solve and 4 scalars, the
    doubling's buffers or the filter's [n_s, n_o] ones (K and [W | s] twice,
    T W). Not the observations: they stay in global memory."""
    fixed = (2 * n_s * n_s + n_o * n_s + 2 * n_o + 10 * n_o * n_o
             + n_o * (n_o + 1) + 4 + _red(n_s))
    union = max(2 * n_s * n_s + max(n_s * n_s, n_k * n_s),
                5 * n_s * n_o + 2 * n_s)
    return 8 * (fixed + union)


def in_domain(n_s: int, n_k: int, n_o: int, n_t: int) -> bool:
    """Whether the general kernels take a model of these shapes with n_t
    observations: every size within its maximum and both tiles within a
    block's shared memory."""
    return (1 <= n_s <= MAX_STATE and 1 <= n_k <= MAX_SHOCK
            and 1 <= n_o <= MAX_OBS and n_t >= 0
            and re_smem_bytes(n_s, n_k) <= SMEM_LIMIT
            and kalman_smem_bytes(n_s, n_k, n_o) <= SMEM_LIMIT)


def _domain(n_s, n_k, n_o=1, n_t=0):
    """Raise ValueError, whatever the device, for shapes without a kernel."""
    if not in_domain(n_s, n_k, n_o, n_t):
        raise ValueError(
            f"no general kernel for n_state={n_s}, n_shock={n_k}, "
            f"n_obs={n_o} with {n_t} observations: the kernels take n_state "
            f"<= {MAX_STATE}, n_shock <= {MAX_SHOCK}, n_obs <= {MAX_OBS} "
            f"and tiles within {SMEM_LIMIT} bytes of shared memory")


def _same_bytes(got, want, what):
    """The library's tile size must be the one the route was decided on."""
    if got != want:
        raise RuntimeError(f"{what}: the library's tile is {got} bytes, the "
                           f"wrapper's {want}")


def solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """A/B/C [n,n,N], D [n,k,N] f64 -> (X [n,n,N], M [n,k,N], ok bool [N]);
    X and M are zero where not ok. The kernel leaves cyclic reduction per
    particle at convergence; the plain version runs all n_iter iterations
    (they agree to f64 rounding, since the iteration is quadratic)."""
    n_s, n_k, n = A.shape[0], D.shape[1], A.shape[-1]
    _domain(n_s, n_k)
    if A.device.type == "cpu":
        return bl_solve_linear_re(A, B, C, D, n_iter=n_iter, tol=tol)
    dev = cuda_device(A)
    for name, t in (("A", A), ("B", B), ("C", C)):
        check(name, t, (n_s, n_s, n), dev)
    check("D", D, (n_s, n_k, n), dev)
    X = torch.empty((n_s, n_s, n), dtype=torch.float64, device=dev)
    M = torch.empty((n_s, n_k, n), dtype=torch.float64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return X, M, ok
    _same_bytes(load(_LIB, dev).smc_general_re_smem(n_s, n_k),
                re_smem_bytes(n_s, n_k), "RE solve")
    launch(_LIB, "smc_general_re", dev, n_s, n_k, A.data_ptr(), B.data_ptr(),
           C.data_ptr(), D.data_ptr(), X.data_ptr(), M.data_ptr(),
           ok.data_ptr(), n, int(n_iter), float(tol))
    return X, M, ok


def kalman_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H, data, ok=None,
                         lyap_iter: int = 30):
    """Chandrasekhar Kalman log-likelihood: T [n,n,N], R [n,k,N], Q [k,k,N],
    Z [o,n,N], d_obs [o,N], H [o,o,N], data [o,T] -> loglh [N]. Particles
    with ok == False (optional bool [N]) get -inf. The kernel leaves the
    Lyapunov doubling per particle once it has converged, and the
    recursion once the particle is rejected."""
    n_s, n_k, n_o, n = (T_mat.shape[0], R_mat.shape[1], Z.shape[0],
                        T_mat.shape[-1])
    n_t = data.shape[-1]
    _domain(n_s, n_k, n_o, n_t)
    if T_mat.device.type == "cpu":
        ll = bl_kalman_loglike_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H,
                                             data)
        return ll if ok is None else torch.where(ok, ll, float("-inf"))
    dev = cuda_device(T_mat)
    check("T", T_mat, (n_s, n_s, n), dev)
    check("R", R_mat, (n_s, n_k, n), dev)
    check("Q", Q, (n_k, n_k, n), dev)
    check("Z", Z, (n_o, n_s, n), dev)
    check("d_obs", d_obs, (n_o, n), dev)
    check("H", H, (n_o, n_o, n), dev)
    check("data", data, (n_o, n_t), dev)
    if ok is not None:
        check("ok", ok, (n,), dev, torch.bool)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    _same_bytes(load(_LIB, dev).smc_general_kalman_smem(n_s, n_k, n_o, n_t),
                kalman_smem_bytes(n_s, n_k, n_o), "Kalman")
    launch(_LIB, "smc_general_kalman", dev, n_s, n_k, n_o, T_mat.data_ptr(),
           R_mat.data_ptr(), Q.data_ptr(), Z.data_ptr(), d_obs.data_ptr(),
           H.data_ptr(), data.data_ptr(), n_t,
           None if ok is None else ok.data_ptr(), n, int(lyap_iter),
           out.data_ptr())
    return out


@functools.cache
def _blocks_per_sm(device_index: int, n_s: int, n_k: int, n_o: int) -> int:
    dev = torch.device("cuda", device_index)
    lib = load(_LIB, dev)
    with torch.cuda.device(dev):
        blocks = lib.smc_general_kalman_blocks_per_sm(n_s, n_k, n_o)
    if blocks < 1:
        raise RuntimeError(f"the Kalman kernel fits no block an SM at "
                           f"({n_s}, {n_k}, {n_o}) ({blocks})")
    return blocks


def kalman_blocks_per_sm(n_s: int, n_k: int, n_o: int,
                         device="cuda") -> int:
    """How many blocks of the Kalman kernel an SM of `device` (a CUDA
    device) holds at once at this shape: the occupancy calculator's answer
    for the instantiation and tile the launch takes (its registers and
    tile), asked once per device and shape. Particles in flight are this
    times the SMs: the kernel is latency-bound, so this sets its rate."""
    _domain(n_s, n_k, n_o)
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for {dev}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return _blocks_per_sm(index, n_s, n_k, n_o)


def dsge_loglike(A, B, C, D, Q, Z, d_obs, H, data, expectation_rows=()):
    """Full DSGE likelihood: RE solve, the expectation rows of Z (if any;
    ops/cuda_dsge_expectations.py, models/dsge.py LinearDSGE), then the
    Kalman filter on the particles whose solve succeeded; rejected draws ->
    -inf. Without expectation rows: two launches, the RE and Kalman
    kernels."""
    _domain(A.shape[0], D.shape[1], Z.shape[0], data.shape[-1])
    X, M, ok = solve_linear_re(A, B, C, D)
    if expectation_rows:
        with span("smc.likelihood.expectations"):
            Z = cuda_dsge_expectations.expectation_rows(Z, X, ok,
                                                        expectation_rows)
    return kalman_chandrasekhar(X, M, Q, Z, d_obs, H, data, ok=ok)
