"""Hand-written CUDA kernels for the DSGE likelihood, and their dispatch.

Replaces smc_tpu/ops/pallas_dsge.py: `solve_linear_re` stands where
`pallas_solve_linear_re` (kernel `_re_kernel`) stood, `kalman_chandrasekhar`
where `pallas_kalman_chandrasekhar` (kernel `_kalman_kernel`) stood, and
`dsge_loglike` composes the two as `pallas_dsge_loglike` did.

The kernels' domain is the TPU kernels': n_obs == 3, 1 <= n_state <= 8,
1 <= n_shock <= 8 (`SIZES`). Dispatch: a CPU tensor runs the plain PyTorch
version (models/dsge.py `bl_*`); a CUDA tensor launches the kernel, or
raises. Shapes outside the domain raise ValueError on every device. There
is no fallback. The card's kernels come in one library per n_state
(csrc/dsge_sizes.cuh), built by nvcc at its first use.
`LAUNCHES` counts kernel launches, one per call that reaches the GPU. A
call inside a CUDA graph capture launches nothing; smc()'s fused recursion
adds the captured launches to `LAUNCHES` once per replay.

The kernels (csrc/dsge_kernels.cu, bodies in csrc/dsge_particle.cuh) run
in native f64 with a group of G lanes per particle: G = 8 for the RE solve,
G = 2 for the Kalman filter up to n_state 6 and 4 from 7 (smc::kReLanes,
smc::kalman_lanes). Lane r of a
group keeps rows r, r + G, ... of every matrix of its particle; a product
reads the other rows from the group's tile in shared memory after a
__syncwarp. Pivot choice,
exit tests and norms are read back from the tile in row order by every lane,
so a group branches as one, and the serial pivot rule (first maximal |entry|
in the current row order) holds exactly: a row swap only exchanges two
positions. A warp iterates until every particle in it has left; a particle
that has left keeps its values, so its result, and a NaN particle's
neighbours, are those of a per-particle exit.

Their bound on the card is set by f64 arithmetic: at 16,384 AS prior draws
the RE solve needs ~40k flop per particle (8.6 cyclic-reduction iterations
on average, each a 6x18 Gauss-Jordan and four 6x6 products, then two solves,
the residual and two 12-squaring spectral bounds), ~20 us at 33.5 TFLOP/s,
against 23.6 MB (7 us at 3.35 TB/s); the Kalman filter ~127k flop per ok
particle (8 doubling steps, 80 Chandrasekhar steps), ~61 us, against
12.4 MB. One thread per particle left the card with fewer than one warp per
scheduler and the RE carry spilling; G lanes per particle give G times the
warps and a carry of RPL = ceil(n/G) rows per lane. The Kalman filter's 3x3
work (F, M, the innovation solves) is done by every lane of a group, so it
takes two lanes, the fewest that double the warps (four from n_state 7,
where two would hold four rows each); F's adjugate and 1/det
are made once per F and serve both of the solves that use it. PERF.md holds
the measured times.
"""

from __future__ import annotations

import ctypes

import torch

from smc_tpu_torch import _build
from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                       bl_kalman_loglike_chandrasekhar)

LAUNCHES = {"re": 0, "kalman": 0}

# (n_state, n_shock) pairs the kernels are instantiated for: the domain of
# the TPU kernels they replace (smc_tpu/ops/pallas_dsge.py), n_obs 3, as
# the build sets it
MAX_STATE = MAX_SHOCK = _build.DSGE_MAX_DIM
SIZES = tuple((s, k) for s in range(1, MAX_STATE + 1)
              for k in range(1, MAX_SHOCK + 1))
N_OBS = 3
# dynamic shared memory a block may use on Hopper (the launcher raises the
# kernel's limit above the default 48 KB when it needs to)
_MAX_SMEM = 227 * 1024

_libs = {}          # n_state -> library
_prepared = set()   # (n_state, device index)


def _library(device: torch.device, n_s: int):
    """The kernel library of n_state n_s, built and loaded at its first use;
    every kernel's shared-memory limit raised to _MAX_SMEM once per device,
    before its first launch (so no launch, and none inside a CUDA graph
    capture, sets an attribute)."""
    lib = _libs.get(n_s)
    if lib is None:
        lib = ctypes.CDLL(str(_build.build_cuda_library(f"dsge_ns{n_s}")))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.smc_re_solve.argtypes = [I, I, P, P, P, P, P, P, P, L, I,
                                     ctypes.c_double, P]
        lib.smc_re_solve.restype = I
        lib.smc_kalman.argtypes = [I, I, P, P, P, P, P, P, P, I, P, L, I, P,
                                   P]
        lib.smc_kalman.restype = I
        lib.smc_kalman_smem_bytes.argtypes = [I, I]
        lib.smc_kalman_smem_bytes.restype = L
        lib.smc_dsge_prepare.argtypes = [I]
        lib.smc_dsge_prepare.restype = I
        _libs[n_s] = lib
    if (n_s, device.index) not in _prepared:
        with torch.cuda.device(device):
            rc = lib.smc_dsge_prepare(_MAX_SMEM)
        if rc != 0:
            raise RuntimeError(f"DSGE kernel set-up failed (CUDA error {rc})")
        _prepared.add((n_s, device.index))
    return lib


def _check(name, t, shape, device, dtype=torch.float64):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _cuda_device(t: torch.Tensor) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return t.device


def _sizes(n_s, n_k, n_o=N_OBS):
    """Raise ValueError, whatever the device, for shapes without a kernel:
    the CPU's plain path serves only what the card's kernels serve."""
    if (n_s, n_k) not in SIZES:
        raise ValueError(f"no kernel instantiated for n_state={n_s}, "
                         f"n_shock={n_k}; the kernels take 1 <= n_state <= "
                         f"{MAX_STATE} and 1 <= n_shock <= {MAX_SHOCK}")
    if n_o != N_OBS:
        raise ValueError(f"the Kalman kernel needs n_obs == {N_OBS}, not "
                         f"{n_o}")


def _raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed (CUDA error {rc})")


def solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """A/B/C [n,n,N], D [n,k,N] f64 -> (X [n,n,N], M [n,k,N], ok bool [N]).
    The kernel exits cyclic reduction per particle at convergence; the plain
    version runs all n_iter iterations (they agree to f64 rounding, since
    the iteration is quadratic)."""
    n_s, n_k, n = A.shape[0], D.shape[1], A.shape[-1]
    _sizes(n_s, n_k)
    if A.device.type == "cpu":
        return bl_solve_linear_re(A, B, C, D, n_iter=n_iter, tol=tol)
    dev = _cuda_device(A)
    for name, t in (("A", A), ("B", B), ("C", C)):
        _check(name, t, (n_s, n_s, n), dev)
    _check("D", D, (n_s, n_k, n), dev)
    X = torch.empty((n_s, n_s, n), dtype=torch.float64, device=dev)
    M = torch.empty((n_s, n_k, n), dtype=torch.float64, device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return X, M, ok
    lib = _library(dev, n_s)
    with torch.cuda.device(dev):
        rc = lib.smc_re_solve(
            n_s, n_k, A.data_ptr(), B.data_ptr(), C.data_ptr(), D.data_ptr(),
            X.data_ptr(), M.data_ptr(), ok.data_ptr(), n, int(n_iter),
            float(tol), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "RE solve")
    LAUNCHES["re"] += 1
    return X, M, ok


def kalman_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H, data, ok=None,
                         lyap_iter: int = 30):
    """Chandrasekhar Kalman log-likelihood: T [n,n,N], R [n,k,N], Q [k,k,N],
    Z [3,n,N], d_obs [3,N], H [3,3,N], data [3,T] -> loglh [N]. Particles
    with ok == False (optional bool [N]) get -inf. The kernel exits the
    Lyapunov doubling per particle once it has converged."""
    n_s, n_k, n = T_mat.shape[0], R_mat.shape[1], T_mat.shape[-1]
    _sizes(n_s, n_k, Z.shape[0])
    if T_mat.device.type == "cpu":
        ll = bl_kalman_loglike_chandrasekhar(T_mat, R_mat, Q, Z, d_obs, H,
                                             data)
        return ll if ok is None else torch.where(ok, ll, float("-inf"))
    dev = _cuda_device(T_mat)
    n_t = data.shape[-1]
    _check("T", T_mat, (n_s, n_s, n), dev)
    _check("R", R_mat, (n_s, n_k, n), dev)
    _check("Q", Q, (n_k, n_k, n), dev)
    _check("Z", Z, (N_OBS, n_s, n), dev)
    _check("d_obs", d_obs, (N_OBS, n), dev)
    _check("H", H, (N_OBS, N_OBS, n), dev)
    _check("data", data, (N_OBS, n_t), dev)
    if ok is not None:
        _check("ok", ok, (n,), dev, torch.bool)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    lib = _library(dev, n_s)
    if lib.smc_kalman_smem_bytes(n_s, n_t) > _MAX_SMEM:
        raise ValueError(f"T={n_t} observations and the group tiles do not "
                         "fit the kernel's shared memory")
    with torch.cuda.device(dev):
        rc = lib.smc_kalman(
            n_s, n_k, T_mat.data_ptr(), R_mat.data_ptr(), Q.data_ptr(),
            Z.data_ptr(), d_obs.data_ptr(), H.data_ptr(), data.data_ptr(),
            n_t, None if ok is None else ok.data_ptr(), n, int(lyap_iter),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "Kalman")
    LAUNCHES["kalman"] += 1
    return out


def dsge_loglike(A, B, C, D, Q, Z, d_obs, H, data):
    """Full DSGE likelihood: RE solve, then the Kalman filter on the
    particles whose solve succeeded; rejected draws -> -inf."""
    _sizes(A.shape[0], D.shape[1], Z.shape[0])
    X, M, ok = solve_linear_re(A, B, C, D)
    return kalman_chandrasekhar(X, M, Q, Z, d_obs, H, data, ok=ok)
