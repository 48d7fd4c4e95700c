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
(csrc/dsge_sizes.cuh), built by nvcc at its first use and launched through
ops/kernels.py, which counts them under "re" and "kalman".

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

import torch

from smc_tpu_torch import _build
from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                       bl_kalman_loglike_chandrasekhar)
from smc_tpu_torch.ops.kernels import check, cuda_device, launch, load

# (n_state, n_shock) pairs the kernels are instantiated for: the domain of
# the TPU kernels they replace (smc_tpu/ops/pallas_dsge.py), n_obs 3, as
# the build sets it
MAX_STATE = MAX_SHOCK = _build.DSGE_MAX_DIM
SIZES = tuple((s, k) for s in range(1, MAX_STATE + 1)
              for k in range(1, MAX_SHOCK + 1))
N_OBS = 3
# dynamic shared memory a block may use on Hopper (the library's prepare
# call raises the kernels' limit to it, above the default 48 KB)
_MAX_SMEM = _build.SMEM_LIMIT
# csrc/dsge_kernels.cu: warps per block; csrc/dsge_particle.cuh: the Kalman
# filter's lanes per particle
_WARPS = 4


def kalman_smem_bytes(n_s: int, n_t: int) -> int:
    """The Kalman kernel's shared memory at n_state n_s with n_t
    observations (csrc/dsge_kernels.cu kalman_smem: the observations and
    each warp's KalmanTile)."""
    lanes = 2 if n_s <= 6 else 4
    stride = (n_s * max(2 * n_s, 8) + n_s + 13) // 16 * 16 + 2
    return 8 * (N_OBS * n_t + _WARPS * stride * (32 // lanes))


def in_domain(n_s: int, n_k: int, n_o: int, n_t: int) -> bool:
    """Whether the kernels take a model of these shapes with n_t
    observations: (n_s, n_k) in SIZES, n_obs 3 and the observations within
    the Kalman kernel's shared memory. Decided without a build."""
    return ((n_s, n_k) in SIZES and n_o == N_OBS and n_t >= 0
            and kalman_smem_bytes(n_s, n_t) <= _MAX_SMEM)


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


def solve_linear_re(A, B, C, D, n_iter: int = 16, tol: float = 1e-8):
    """A/B/C [n,n,N], D [n,k,N] f64 -> (X [n,n,N], M [n,k,N], ok bool [N]).
    The kernel exits cyclic reduction per particle at convergence; the plain
    version runs all n_iter iterations (they agree to f64 rounding, since
    the iteration is quadratic)."""
    n_s, n_k, n = A.shape[0], D.shape[1], A.shape[-1]
    _sizes(n_s, n_k)
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
    launch(f"dsge_ns{n_s}", "smc_re_solve", dev, n_s, n_k, A.data_ptr(),
           B.data_ptr(), C.data_ptr(), D.data_ptr(), X.data_ptr(),
           M.data_ptr(), ok.data_ptr(), n, int(n_iter), float(tol))
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
    dev = cuda_device(T_mat)
    n_t = data.shape[-1]
    check("T", T_mat, (n_s, n_s, n), dev)
    check("R", R_mat, (n_s, n_k, n), dev)
    check("Q", Q, (n_k, n_k, n), dev)
    check("Z", Z, (N_OBS, n_s, n), dev)
    check("d_obs", d_obs, (N_OBS, n), dev)
    check("H", H, (N_OBS, N_OBS, n), dev)
    check("data", data, (N_OBS, n_t), dev)
    if ok is not None:
        check("ok", ok, (n,), dev, torch.bool)
    out = torch.empty(n, dtype=torch.float64, device=dev)
    if n == 0:
        return out
    name = f"dsge_ns{n_s}"
    if load(name, dev).smc_kalman_smem_bytes(n_s, n_t) > _MAX_SMEM:
        raise ValueError(f"T={n_t} observations and the group tiles do not "
                         "fit the kernel's shared memory")
    launch(name, "smc_kalman", dev, n_s, n_k, T_mat.data_ptr(),
           R_mat.data_ptr(), Q.data_ptr(), Z.data_ptr(), d_obs.data_ptr(),
           H.data_ptr(), data.data_ptr(), n_t,
           None if ok is None else ok.data_ptr(), n, int(lyap_iter),
           out.data_ptr())
    return out


def dsge_loglike(A, B, C, D, Q, Z, d_obs, H, data):
    """Full DSGE likelihood: RE solve, then the Kalman filter on the
    particles whose solve succeeded; rejected draws -> -inf."""
    _sizes(A.shape[0], D.shape[1], Z.shape[0])
    X, M, ok = solve_linear_re(A, B, C, D)
    return kalman_chandrasekhar(X, M, Q, Z, d_obs, H, data, ok=ok)
