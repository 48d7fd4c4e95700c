"""The CUDA kernels' warp bodies (csrc/dsge_particle.cuh), compiled for the
host with g++ through csrc/dsge_cpu.cpp (one library per (n_state,
n_shock), built at its first use), against the plain PyTorch versions.
The host build runs the same group layout as the card (8 lanes per particle
in the RE solve, 2 in the Kalman filter up to n_state 6 and 4 from 7, 32
lanes per warp, the tile exchanges phase by phase), so this is
the CPU's view of the kernels' arithmetic, pivoting and warp-wide exits; the
kernels themselves run only on the card (chip_smoke.py). The Jacobi eigh
body (csrc/eigh_jacobi.cuh, through csrc/eigh_cpu.cpp, each matrix's warp
or block of threads phase by phase) is held against numpy.linalg.eigh the
same way."""

import ctypes
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from smc_tpu_torch import _build
from smc_tpu_torch.ops import kernels
from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                       bl_kalman_loglike_chandrasekhar)

from torch_parity import (as_prior_draws, assert_loglh_close, normwise_rel,
                          synthetic_system, tiny_system)


class _BodyLibraries:
    """The host builds of the kernel bodies, one library per (n_state,
    n_shock), each built and loaded once at its first call; a call goes to
    the library of its shape."""

    def __init__(self):
        self._libs = {}

    def _get(self, n_s, n_k):
        if (n_s, n_k) not in self._libs:
            name = f"dsge_ns{n_s}"
            self._libs[n_s, n_k] = kernels.typed(
                _build.build_cpu_library(name, n_k), name, host=True)
        return self._libs[n_s, n_k]

    def smc_re_solve_cpu(self, n_s, n_k, *args):
        return self._get(n_s, n_k).smc_re_solve_cpu(n_s, n_k, *args)

    def smc_kalman_cpu(self, n_s, n_k, *args):
        return self._get(n_s, n_k).smc_kalman_cpu(n_s, n_k, *args)


@pytest.fixture(scope="module")
def lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the kernel bodies")
    return _BodyLibraries()


def _re(lib, A, B, C, D):
    n_s, n_k, n = A.shape[0], D.shape[1], A.shape[-1]
    X = torch.empty((n_s, n_s, n), dtype=torch.float64)
    M = torch.empty((n_s, n_k, n), dtype=torch.float64)
    ok = torch.empty(n, dtype=torch.bool)
    rc = lib.smc_re_solve_cpu(n_s, n_k, A.data_ptr(), B.data_ptr(),
                              C.data_ptr(), D.data_ptr(), X.data_ptr(),
                              M.data_ptr(), ok.data_ptr(), n, 16, 1e-8)
    assert rc == 0
    return X, M, ok


def _kalman(lib, X, M, Q, Z, d, H, data, ok):
    n = X.shape[-1]
    out = torch.empty(n, dtype=torch.float64)
    rc = lib.smc_kalman_cpu(X.shape[0], M.shape[1], X.data_ptr(),
                            M.data_ptr(), Q.data_ptr(), Z.data_ptr(),
                            d.data_ptr(), H.data_ptr(), data.data_ptr(),
                            data.shape[1], ok.data_ptr(), n, 30,
                            out.data_ptr())
    assert rc == 0
    return out


@pytest.fixture(scope="module")
def case():
    th = torch.as_tensor(as_prior_draws(256, seed=3))
    d, Z, H = tas._measurement(th)
    data = torch.as_tensor(tas.load_as_data()).contiguous()
    return tas._system(th), (tas._shock_cov(th), Z, d, H, data)


def test_re_body_matches_plain(lib, case):
    sys_t, _ = case
    X, M, ok = _re(lib, *sys_t)
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    assert torch.equal(ok, okp)
    assert 0 < int(ok.sum()) < 256
    np.testing.assert_allclose(X.numpy(), Xp.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.numpy(), Mp.numpy(), rtol=1e-10, atol=1e-12)


def test_kalman_body_matches_plain(lib, case):
    sys_t, (Q, Z, d, H, data) = case
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    got = _kalman(lib, Xp, Mp, Q, Z, d, H, data, okp)
    want = torch.where(okp, bl_kalman_loglike_chandrasekhar(
        Xp, Mp, Q, Z, d, H, data), float("-inf"))
    assert_loglh_close(got.numpy(), want.numpy())


def test_nan_lane_is_isolated(lib, case):
    sys_t, (Q, Z, d, H, data) = case
    X, M, ok = _re(lib, *sys_t)
    ll = _kalman(lib, X, M, Q, Z, d, H, data, ok)
    A_nan = sys_t[0].clone()
    j = 17
    A_nan[:, :, j] = float("nan")
    X2, M2, ok2 = _re(lib, A_nan, *sys_t[1:])
    ll2 = _kalman(lib, X2, M2, Q, Z, d, H, data, ok2)
    keep = torch.arange(256) != j
    assert not bool(ok2[j]) and ll2[j].item() == float("-inf")
    assert torch.equal(X2[..., keep], X[..., keep])
    assert torch.equal(M2[..., keep], M[..., keep])
    assert torch.equal(ok2[keep], ok[keep])
    assert torch.equal(ll2[keep], ll[keep])
    # without the ok mask the body itself rejects the NaN particle
    nan_sys = [torch.full_like(t[..., :1], float("nan")).contiguous()
               for t in (Q, Z, d, H)]
    Xn = torch.full((6, 6, 1), float("nan"), dtype=torch.float64)
    Mn = torch.full((6, 3, 1), float("nan"), dtype=torch.float64)
    out = _kalman(lib, Xn, Mn, *nan_sys, data,
                  torch.ones(1, dtype=torch.bool))
    assert out.item() == float("-inf")


def test_tiny_system_body_matches_plain(lib):
    A, B, C, D, Q, Z, d, H, data = (torch.as_tensor(a).contiguous()
                                    for a in tiny_system())
    X, M, ok = _re(lib, A, B, C, D)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    assert bool(ok.all()) and bool(okp.all())
    np.testing.assert_allclose(X.numpy(), Xp.numpy(), rtol=1e-12, atol=1e-14)
    got = _kalman(lib, X, M, Q, Z, d, H, data, ok)
    want = bl_kalman_loglike_chandrasekhar(Xp, Mp, Q, Z, d, H, data)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def _as_case(n, seed):
    th = torch.as_tensor(as_prior_draws(n, seed=seed))
    d, Z, H = tas._measurement(th)
    data = torch.as_tensor(tas.load_as_data()).contiguous()
    return tas._system(th), (tas._shock_cov(th), Z, d, H, data)


@pytest.mark.parametrize("part", ["re", "kalman"])
@pytest.mark.parametrize("n", [1, 3, 5, 257])
def test_ragged_n_matches_plain(lib, n, part):
    """Particle counts that leave a warp part empty: the missing particles'
    lanes run every exchange on zeros and write nothing."""
    sys_t, rest = _as_case(n, seed=10 + n)
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    if part == "re":
        X, M, ok = _re(lib, *sys_t)
        assert torch.equal(ok, okp)
        np.testing.assert_allclose(X.numpy(), Xp.numpy(), rtol=1e-10,
                                   atol=1e-12)
        np.testing.assert_allclose(M.numpy(), Mp.numpy(), rtol=1e-10,
                                   atol=1e-12)
    else:
        got = _kalman(lib, Xp, Mp, *rest, okp)
        want = torch.where(okp, bl_kalman_loglike_chandrasekhar(Xp, Mp, *rest),
                           float("-inf"))
        assert_loglh_close(got.numpy(), want.numpy())


@pytest.mark.parametrize("j_nan", [0, 1, 7, 19])
def test_nan_particle_shares_a_warp_with_converging_ones(lib, j_nan):
    """A NaN particle keeps its warp iterating to n_iter (an RE warp holds 4
    particles, 8 lanes each; a Kalman warp 16); the other particles must
    come out bitwise as when each runs alone (its own exit, no neighbour),
    and the NaN particle is rejected."""
    n, per_warp = 20, 4
    (A, B, C, D), (Q, Z, d, H, data) = _as_case(n, seed=21)
    A_nan = A.clone()
    A_nan[:, :, j_nan] = float("nan")
    X, M, ok = _re(lib, A_nan, B, C, D)
    ll = _kalman(lib, X, M, Q, Z, d, H, data, ok)
    assert not bool(ok[j_nan]) and ll[j_nan].item() == float("-inf")
    w0 = j_nan // per_warp * per_warp
    assert int(ok[w0:w0 + per_warp].sum()) >= 3
    for j in range(n):
        if j == j_nan:
            continue
        one = [t[..., j:j + 1].contiguous() for t in (A, B, C, D)]
        Xj, Mj, okj = _re(lib, *one)
        assert torch.equal(X[..., j:j + 1], Xj)
        assert torch.equal(M[..., j:j + 1], Mj)
        assert torch.equal(ok[j:j + 1], okj)
        rest = [t[..., j:j + 1].contiguous() for t in (Q, Z, d, H)]
        llj = _kalman(lib, Xj, Mj, *rest, data, okj)
        assert torch.equal(ll[j:j + 1], llj)


def test_tied_pivot_magnitudes_follow_the_serial_rule(lib):
    """Columns with tied maximal |entries|: the pivot is the first of them
    in the current row order (each row sits on another lane of the group).
    ok and X must match bl_solve_linear_re."""
    rng = np.random.default_rng(1793)
    (A, B, C, D), _ = _as_case(64, seed=4)
    B = B.clone()
    for j in range(B.shape[-1]):
        rows = rng.choice(6, size=3, replace=False)
        top = B[:, 0, j].abs().max() * (1.0 + rng.uniform())
        signs = torch.as_tensor(rng.choice([-1.0, 1.0], size=3))
        B[rows, 0, j] = top * signs
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    assert int(okp.sum()) > 10
    X, M, ok = _re(lib, A, B, C, D)
    assert torch.equal(ok, okp)
    np.testing.assert_allclose(X.numpy(), Xp.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.numpy(), Mp.numpy(), rtol=1e-10, atol=1e-12)


# shapes where the group geometry changes: n_shock below n_state, the
# Kalman filter's 4 lanes of 2 rows from n_state 7, the widest RE tile
@pytest.mark.parametrize("shape", [(4, 2), (7, 3), (8, 8)])
def test_bodies_across_the_domain_match_plain(lib, shape):
    """Both bodies at a shape of the domain on synthetic systems (41
    particles: ragged RE and Kalman warps) against the plain versions, and
    a NaN lane that leaves its neighbours bitwise alone."""
    n_s, n_k = shape
    sys_np, data = synthetic_system(n_s, n_k, 41, n_t=12)
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x) for x in sys_np)
    data = torch.as_tensor(data)
    X, M, ok = _re(lib, A, B, C, D)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    assert torch.equal(ok, okp) and bool(ok.all())
    np.testing.assert_allclose(X.numpy(), Xp.numpy(), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(M.numpy(), Mp.numpy(), rtol=1e-10, atol=1e-12)
    assert normwise_rel(X, Xp).max().item() <= 1e-10
    ll = _kalman(lib, X, M, Q, Z, d, H, data, ok)
    want = bl_kalman_loglike_chandrasekhar(Xp, Mp, Q, Z, d, H, data)
    assert_loglh_close(ll.numpy(), want.numpy())
    j = 18
    A_nan = A.clone()
    A_nan[:, :, j] = float("nan")
    X2, M2, ok2 = _re(lib, A_nan, B, C, D)
    ll2 = _kalman(lib, X2, M2, Q, Z, d, H, data, ok2)
    keep = torch.arange(41) != j
    assert not bool(ok2[j]) and ll2[j].item() == float("-inf")
    assert torch.equal(X2[..., keep], X[..., keep])
    assert torch.equal(M2[..., keep], M[..., keep])
    assert torch.equal(ll2[keep], ll[keep])
    Q_nan = Q.clone()
    Q_nan[:, :, j] = float("nan")
    ll3 = _kalman(lib, X, M, Q_nan, Z, d, H, data, ok)
    assert ll3[j].item() == float("-inf")
    assert torch.equal(ll3[keep], ll[keep])


@pytest.mark.parametrize("gap", [-1e-6, -1e-11, 1e-11, 1e-6])
def test_spectral_bound_decision_near_one(lib, gap):
    """The kernel scales by 1/||m|| where the plain version divides by ||m||
    (the two differ by a rounding): the determinacy decision must still
    agree with bl_solve_linear_re for solutions whose spectral radius is
    1 + gap. A + B X + C X^2 = 0 is built from X = V diag(x) V' with V
    orthogonal (so the bound ||X^4096||_F^(1/4096) is 1 + gap up to
    rounding), one root x_0 = 1 + gap, the others well inside, and the
    second roots y = 2.5 (C = I, B = -(x + y), A = x y in that basis)."""
    rng = np.random.default_rng(2029)
    n, ns = 8, 6
    A, B, C, D = (np.empty((ns, ns, n)), np.empty((ns, ns, n)),
                  np.empty((ns, ns, n)), np.empty((ns, 3, n)))
    for j in range(n):
        x = np.concatenate([[1.0 + gap], rng.uniform(-0.6, 0.6, ns - 1)])
        y = np.full(ns, 2.5)
        V, _ = np.linalg.qr(rng.standard_normal((ns, ns)))
        Vi = V.T
        A[..., j] = V @ np.diag(x * y) @ Vi
        B[..., j] = V @ np.diag(-(x + y)) @ Vi
        C[..., j] = np.eye(ns)
        D[..., j] = rng.standard_normal((ns, 3))
    A, B, C, D = (torch.as_tensor(t).contiguous() for t in (A, B, C, D))
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    X, M, ok = _re(lib, A, B, C, D)
    assert torch.equal(ok, okp)
    assert bool(okp.all()) == (gap < 0) and bool((~okp).all()) == (gap > 0)
    np.testing.assert_allclose(X.numpy(), Xp.numpy(), rtol=1e-10, atol=1e-12)


# --- the table of kernel libraries -------------------------------------------

@pytest.mark.parametrize("name", sorted(_build.CUDA_LIBRARIES))
def test_host_build_holds_every_declared_entry(name):
    """Each library's host build, made through build_cpu_library, exports
    every entry point _build.CUDA_LIBRARIES declares for it (each kernel's
    <entry>_cpu and the host-only probes), and the layer types each as
    declared; a kernel's card entry ends with the stream."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the kernel bodies")
    spec = _build.CUDA_LIBRARIES[name]
    path = _build.build_cpu_library(
        name, 1 if name.startswith("dsge_ns") else None)
    raw = ctypes.CDLL(str(path))
    lib = kernels.typed(path, name, host=True)
    entries = spec.entries(host=True)
    assert {f"{k}_cpu" for k in spec.kernels} <= set(entries)
    for symbol, (restype, argtypes) in entries.items():
        assert hasattr(raw, symbol), symbol
        fn = getattr(lib, symbol)
        assert fn.restype is restype and fn.argtypes == list(argtypes)
    for symbol, (restype, argtypes) in spec.entries().items():
        if symbol in spec.kernels:
            assert argtypes[-1] is ctypes.c_void_p and restype is ctypes.c_int
    assert {key for key, _ in spec.kernels.values()} <= set(kernels.LAUNCHES)


def test_typed_leaves_out_what_an_older_build_lacks():
    """Another tree's build may predate entries declared since: typed
    raises on a missing entry, and with missing_ok types the entries the
    build has and leaves the rest out."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the kernel bodies")
    path = _build.build_cpu_library("dsge_general")
    with pytest.raises(AttributeError, match="smc_metropolis_cpu"):
        kernels.typed(path, "metropolis", host=True)
    lib = kernels.typed(path, "metropolis", host=True, missing_ok=True)
    assert not hasattr(lib, "smc_metropolis_cpu")
    assert kernels.typed(path, "dsge_general", host=True,
                         missing_ok=True).smc_general_kalman_cpu.argtypes


# --- the Jacobi eigh body ----------------------------------------------------

EIGH_TOL = 1e-12


@pytest.fixture(scope="module")
def eigh_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the eigh body")
    return kernels.typed(_build.build_cpu_library("eigh"), "eigh", host=True)


def _eigh_body(lib, a):
    """(lam, u) of the stack a [..., k, k] through the host build."""
    return _eigh_body_parts(lib, [a])[0]


def _eigh_body_parts(lib, stacks):
    """[(lam, u)] of one or two stacks of matrices in one call of the host
    build (the kernel's launch of two parts)."""
    stacks = [np.ascontiguousarray(a, np.float64) for a in stacks]
    ks = [a.shape[-1] for a in stacks]
    ns = [a.size // (k * k) for a, k in zip(stacks, ks)]
    flat = np.concatenate([a.reshape(-1) for a in stacks])
    lam, u = np.empty(sum(n * k for n, k in zip(ns, ks))), np.empty(flat.size)
    assert lib.smc_eigh_cpu(ks[0], ns[0], ks[-1], ns[1] if len(ns) > 1 else 0,
                            flat.ctypes.data, lam.ctypes.data,
                            u.ctypes.data) == 0
    out, lo, uo = [], 0, 0
    for a, n, k in zip(stacks, ns, ks):
        out.append((lam[lo:lo + n * k].reshape(a.shape[:-1]),
                    u[uo:uo + n * k * k].reshape(a.shape)))
        lo, uo = lo + n * k, uo + n * k * k
    return out


def _symmetric(kind, k, rng):
    """A symmetric k x k test matrix: SPD, rank-deficient PSD, diagonal,
    or with each eigenvalue repeated (1, 2 and 5 over a random basis)."""
    if kind == "spd":
        x = rng.standard_normal((k, k + 3))
        return x @ x.T
    if kind == "rank_deficient":
        x = rng.standard_normal((k, max(1, k // 2)))
        return x @ x.T
    if kind == "diagonal":
        return np.diag(rng.standard_normal(k))
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    a = (q * np.resize([1.0, 2.0, 5.0], k)) @ q.T
    return 0.5 * (a + a.T)


def _keep(lam, tol=1e-12):
    """_deg_factor's mask of the eigenvalues it keeps."""
    return lam > tol * max(lam.max(), 1e-300)


@pytest.mark.parametrize("kind", ["spd", "rank_deficient", "diagonal",
                                  "repeated"])
@pytest.mark.parametrize("k", [1, 2, 3, 12, 13, 31, 32, 33, 36, 64, 65,
                               100, 118, 119, 128])
def test_eigh_body_matches_numpy(eigh_lib, k, kind):
    """Eigenvalues ascending within 1e-12 max|lam| of numpy's; U diag(lam) U'
    within 1e-12 of A normwise; U'U within 1e-12 of I; the same kept
    eigenvalues in _deg_factor; each column's largest entry positive. Each
    path at its edges: two warps per matrix up to k = 32, a block with the
    matrix in shared memory up to 118, past it in the workspace."""
    rng = np.random.default_rng(100 * k + len(kind))
    a = _symmetric(kind, k, rng)
    lam, u = _eigh_body(eigh_lib, a)
    want = np.linalg.eigh(a)[0]
    scale = max(np.abs(want).max(), 1e-300)
    assert np.all(np.diff(lam) >= 0)
    assert np.abs(lam - want).max() <= EIGH_TOL * scale
    assert (np.linalg.norm(u @ np.diag(lam) @ u.T - a)
            <= EIGH_TOL * max(np.linalg.norm(a), 1e-300))
    assert np.abs(u.T @ u - np.eye(k)).max() <= EIGH_TOL
    np.testing.assert_array_equal(_keep(lam), _keep(want))
    lead = u[np.argmax(np.abs(u), axis=0), np.arange(k)]
    assert np.all(lead > 0)


def test_eigh_body_batches_and_nan(eigh_lib):
    """A batch gives each matrix's own decomposition bit for bit; a NaN
    entry makes its matrix's results NaN and leaves the others alone."""
    rng = np.random.default_rng(7)
    a = np.stack([_symmetric("spd", 5, rng) for _ in range(3)])
    a[1, 3, 2] = np.nan
    lam, u = _eigh_body(eigh_lib, a)
    assert np.isnan(lam[1]).all() and np.isnan(u[1]).all()
    for b in (0, 2):
        lb, ub = _eigh_body(eigh_lib, a[b])
        np.testing.assert_array_equal(lam[b], lb)
        np.testing.assert_array_equal(u[b], ub)


# the mutation's block splits (block_sizes): AS-sized blocks of 12, 12, 11;
# 65 free parameters in two blocks (the small-team path and the block path
# in one launch); the workspace path beside the shared-memory one
TWO_SIZES = [(12, 12, 11), (33, 32), (119, 118)]


@pytest.mark.parametrize("sizes", TWO_SIZES)
def test_eigh_body_two_sizes_match_each_alone(eigh_lib, sizes):
    """One call on a batch of two sizes (equal blocks, then a smaller last
    one, as the mutation sends them) gives each matrix the bits of a call on
    it alone."""
    rng = np.random.default_rng(sum(sizes))
    mats = [_symmetric("spd", k, rng) for k in sizes]
    stacks = [np.stack(mats[:-1]), mats[-1][None]]
    got = _eigh_body_parts(eigh_lib, stacks)
    alone = [_eigh_body(eigh_lib, a) for a in mats]
    got = [(lam[i], u[i]) for lam, u in got for i in range(lam.shape[0])]
    for (lam, u), (lam1, u1) in zip(got, alone):
        np.testing.assert_array_equal(lam, lam1)
        np.testing.assert_array_equal(u, u1)


@pytest.mark.parametrize("sizes", TWO_SIZES)
def test_eigh_body_nan_leaves_its_neighbours(eigh_lib, sizes):
    """A NaN matrix among converging ones of both sizes (neighbours in one
    block of warps on the card, or in the next block) gives NaN and leaves
    every other matrix bitwise as a call on it alone gives it."""
    rng = np.random.default_rng(3 + sum(sizes))
    k0, k1 = sizes[0], sizes[-1]
    first = np.stack([_symmetric("spd", k0, rng) for _ in range(3)])
    last = np.stack([_symmetric("spd", k1, rng) for _ in range(2)])
    first[1, k0 - 1, 0] = np.nan
    (lam0, u0), (lam1, u1) = _eigh_body_parts(eigh_lib, [first, last])
    assert np.isnan(lam0[1]).all() and np.isnan(u0[1]).all()
    for lam, u, a in ((lam0[0], u0[0], first[0]), (lam0[2], u0[2], first[2]),
                      (lam1[0], u1[0], last[0]), (lam1[1], u1[1], last[1])):
        want_lam, want_u = _eigh_body(eigh_lib, a)
        np.testing.assert_array_equal(lam, want_lam)
        np.testing.assert_array_equal(u, want_u)


def test_eigh_plain_has_the_kernel_form():
    """The CPU path of ops/cuda_eigh.eigh (torch.linalg.eigh): ascending,
    each column's largest entry positive, NaN for a non-finite matrix
    without raising, the same factor as the body to 1e-12, and any k (the
    kernel's limit, 1,024, binds only on a card)."""
    from smc_tpu_torch.ops import cuda_eigh
    rng = np.random.default_rng(9)
    a = np.stack([_symmetric("spd", 13, rng), _symmetric("spd", 13, rng)])
    a[1, 0, 0] = np.inf
    lam, u = cuda_eigh.eigh(torch.as_tensor(a))
    assert torch.isnan(lam[1]).all() and torch.isnan(u[1]).all()
    lam0, u0 = lam[0].numpy(), u[0].numpy()
    assert np.all(np.diff(lam0) > 0)
    lead = u0[np.argmax(np.abs(u0), axis=0), np.arange(13)]
    assert np.all(lead > 0)
    np.testing.assert_allclose(u0 @ np.diag(lam0) @ u0.T, a[0],
                               rtol=0, atol=EIGH_TOL * np.abs(a[0]).max())
    big = _symmetric("spd", cuda_eigh.MAX_K + 1, rng)
    lam_b, u_b = cuda_eigh.eigh(torch.as_tensor(big))
    np.testing.assert_allclose(lam_b.numpy(), np.linalg.eigh(big)[0],
                               rtol=0, atol=EIGH_TOL * np.abs(big).max()
                               * cuda_eigh.MAX_K)
    with pytest.raises(ValueError, match="k <= 1024"):
        cuda_eigh.check_block(cuda_eigh.MAX_K + 1)


# --- the Metropolis chain ---------------------------------------------------

@pytest.fixture(scope="module")
def metropolis_lib():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the chain")
    return kernels.typed(_build.build_cpu_library("metropolis"),
                         "metropolis", host=True)


def _chain_body(lib, w, key, steps, flag, n_out):
    """The ancestors of the host build for the weights w (f64 tensor)."""
    idx = torch.empty(n_out, dtype=torch.int64)
    f = torch.tensor(bool(flag))
    rc = lib.smc_metropolis_cpu(w.data_ptr(), w.shape[0], n_out,
                                key.data_ptr(), f.data_ptr(),
                                steps.data_ptr(), idx.data_ptr())
    assert rc == 0
    return idx


@pytest.mark.parametrize("vector", range(3))
def test_philox_body_known_answers(metropolis_lib, vector):
    """The header's Philox4x32-10 built with g++ gives Random123's
    known-answer outputs."""
    from torch_metropolis import PHILOX_KAT
    ctr, key, want = PHILOX_KAT[vector]
    c, k = np.array(ctr, np.uint32), np.array(key, np.uint32)
    out = np.zeros(4, np.uint32)
    metropolis_lib.smc_philox_cpu(c.ctypes.data, k.ctypes.data,
                                  out.ctypes.data)
    assert tuple(int(x) for x in out) == want


@pytest.mark.parametrize("case", ["n1", "n7", "n4096", "n_out_less",
                                  "n_out_more", "zero", "nan", "nan_inside",
                                  "spike", "capped", "no_resample"])
def test_metropolis_body_matches_plain(metropolis_lib, case):
    """The chain built with g++ equals ops/cuda_metropolis.py's plain
    version bit for bit. Zero weights, NaN weights (a non-finite kappa
    gives 0 steps) and a stage that does not resample give the identity; a
    single non-zero weight draws the slots that reached it; a chain past
    its cap runs the cap's steps."""
    from torch_metropolis import chain_case
    from smc_tpu_torch.ops.cuda_metropolis import metropolis_chain_plain
    from smc_tpu_torch.ops.resample import chain_steps
    w, n_out, steps, cap, flag, key = chain_case(case)
    wt = torch.as_tensor(w)
    steps_t = (chain_steps(wt, 0.01, cap)[0] if steps is None
               else torch.tensor(steps))
    want = metropolis_chain_plain(wt, key, steps_t, torch.tensor(flag), n_out)
    got = _chain_body(metropolis_lib, wt, key, steps_t, flag, n_out)
    assert torch.equal(got, want)
    start = torch.arange(n_out) % w.shape[0]
    if case in ("zero", "nan", "no_resample"):
        assert torch.equal(got, start)
    if case == "nan":
        assert int(steps_t) == 0
    if case == "spike":
        assert int(steps_t) == int(np.ceil(64 * np.log(100.0)))
        assert (got == 17).float().mean() > 0.98
    if case == "capped":
        assert int(steps_t) == cap
    if case not in ("zero", "nan", "no_resample", "n1"):
        assert not torch.equal(got, start)


def test_metropolis_body_counts_follow_the_weights(metropolis_lib):
    """The host build's ancestors over 40 weights at a 1e-6 bias bound:
    the counts pass a chi-square test against N w / sum(w) at 0.1%."""
    from scipy import stats
    from smc_tpu_torch.ops.resample import chain_steps
    rng = np.random.default_rng(8)
    w = np.exp(rng.standard_normal(40))
    wt = torch.as_tensor(w)
    steps, _ = chain_steps(wt, 1e-6)
    idx = _chain_body(metropolis_lib, wt, torch.tensor([12345, 678]), steps,
                      True, 20_000)
    counts = np.bincount(idx.numpy(), minlength=40)
    assert stats.chisquare(counts, 20_000 * w / w.sum()).pvalue > 1e-3
