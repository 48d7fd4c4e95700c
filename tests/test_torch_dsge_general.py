"""The general-shape DSGE kernels' block bodies (csrc/dsge_general.cuh),
compiled for the host with g++ through csrc/dsge_general_cpu.cpp, against
the JAX package's batch-last likelihood (smc_tpu/models/dsge.py
bl_solve_linear_re, bl_kalman_loglike_chandrasekhar) at Smets-Wouters' and
AS-2obs's shapes, and against the port's plain versions (models/dsge.py
bl_*) at synthetic shapes. The host build runs each particle's block of
threads phase by phase (lanes.cuh), so this is the CPU's view of the card's
arithmetic, pivoting and exits; the kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py). Also here: the likelihood route
of LinearDSGE as a function of shapes and flags, the tile sizes the route
is decided on, and the wrappers' CPU path."""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax
import jax.numpy as jnp

from smc_tpu.models import as_dsge as jas
from smc_tpu.models import sw_dsge as jsw
from smc_tpu.models.dsge import (bl_solve_linear_re as jax_solve,
                                 bl_kalman_loglike_chandrasekhar as jax_chand)
from smc_tpu.ops.linalg import bl_psd_fast_solve as jax_psd_solve
from smc_tpu.params import ParamSpace as JParamSpace

from smc_tpu_torch.models import as_dsge as tas
from smc_tpu_torch.models import sw_dsge as tsw
from smc_tpu_torch.models.dsge import (bl_dsge_loglike, bl_solve_linear_re,
                                       bl_kalman_loglike_chandrasekhar,
                                       likelihood_route)
from smc_tpu_torch.ops import cuda_dsge_general
from smc_tpu_torch.ops.kernels import LAUNCHES
from smc_tpu_torch.ops.linalg import bl_psd_fast_solve

from test_torch_cuda import assert_sw_loglh_close
from torch_parity import (GeneralHostBuild, as_prior_draws,
                          assert_loglh_close, launches_since, normwise_rel,
                          synthetic_system)

XM_RTOL = 1e-10     # X and M, normwise per particle


@pytest.fixture(scope="module")
def body():
    if shutil.which("g++") is None:
        pytest.skip("no g++ to build the host version of the block bodies")
    return GeneralHostBuild()


def _t(*xs):
    return [torch.as_tensor(np.array(x)).contiguous() for x in xs]


@pytest.fixture(scope="module")
def sw_case():
    """tests/test_torch_sw.py's 21 draws (TRUE_PARAMS, 16 prior draws of
    the JAX package's sampler, 4 within 1e-4 of TRUE_PARAMS), their system
    through the JAX package, and its batch-last RE solve and Chandrasekhar
    likelihood on the committed data."""
    draws = np.asarray(JParamSpace(jsw.sw_parameters()).sample_prior(
        jax.random.PRNGKey(0), 16))
    near = jsw.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                              .standard_normal((4, 36)))
    th = jnp.asarray(np.vstack([jsw.TRUE_PARAMS[None], draws, near]))
    bl = lambda x: jnp.moveaxis(x, 0, -1)
    A, B, C, D = (bl(m) for m in jax.vmap(jsw._system)(th))
    d, Z, H = (bl(m) for m in jax.vmap(jsw._measurement)(th))
    Q = bl(jax.vmap(jsw._shock_cov)(th))
    data = tsw.load_sw_data()
    X, M, ok = jax.jit(jax_solve)(A, B, C, D)
    ll = jax.jit(jax_chand)(X, M, Q, Z, d, H, jnp.asarray(data))
    ll = jnp.where(ok, ll, -jnp.inf)
    return dict(sys=_t(A, B, C, D), rest=_t(Q, Z, d, H, data),
                X=np.asarray(X), M=np.asarray(M), ok=np.asarray(ok),
                ll=np.asarray(ll))


def test_sw_solve_matches_jax(body, sw_case):
    X, M, ok = body.re(*sw_case["sys"])
    np.testing.assert_array_equal(ok.numpy(), sw_case["ok"])
    assert 10 < int(ok.sum()) <= 21
    for got, key in ((X, "X"), (M, "M")):
        want = torch.as_tensor(sw_case[key])
        assert normwise_rel(got[..., ok], want[..., ok]).max() <= XM_RTOL
        assert not got[..., ~ok].any()


def test_sw_likelihood_matches_jax(body, sw_case):
    *_, ll = body.loglike(*sw_case["sys"], *sw_case["rest"])
    assert_sw_loglh_close(ll.numpy(), sw_case["ll"])
    assert np.isfinite(ll[0].item()) and ll[0].item() > -1e3


def test_sw_passive_policy_is_rejected(body):
    theta = tsw.TRUE_PARAMS.copy()
    theta[10], theta[12], theta[13] = 0.5, 0.001, 0.001
    th = torch.as_tensor(np.stack([tsw.TRUE_PARAMS, theta]))
    sys_t = tsw._system(th)
    d, Z, H = tsw._measurement(th)
    rest = (tsw._shock_cov(th), Z, d, H,
            torch.as_tensor(tsw.load_sw_data()))
    X, M, ok, ll = body.loglike(*sys_t, *rest)
    assert ok.tolist() == [True, False]
    assert ll[1].item() == float("-inf") and np.isfinite(ll[0].item())
    assert not X[..., 1].any() and not M[..., 1].any()
    assert not bool(bl_solve_linear_re(*sys_t)[2][1])


def _as2_case(n, seed):
    th = as_prior_draws(n, seed=seed)
    tt = torch.as_tensor(th)
    d, Z, H = tas._measurement_2obs(tt)
    data = torch.as_tensor(tas.load_as_data()[:2]).contiguous()
    return th, tas._system(tt), (tas._shock_cov(tt), Z, d, H, data)


def test_as2obs_likelihood_matches_jax(body):
    th, sys_t, rest = _as2_case(96, seed=7)
    *_, ll = body.loglike(*sys_t, *rest)
    model = jas.an_schorfheide_2obs()
    want = jax.jit(lambda t: model.loglike_batched(
        t, jnp.asarray(tas.load_as_data()[:2])))(jnp.asarray(th))
    assert_loglh_close(ll.numpy(), np.asarray(want))
    assert int(torch.isfinite(ll).sum()) > 48


@pytest.mark.parametrize("n_o", [1, 2, 3, 5, 7, 16])
@pytest.mark.parametrize("n_s", [1, 6, 9, 17, 37])
def test_synthetic_shapes_match_plain(body, n_s, n_o):
    """Both innovation solves (the cofactor form at n_obs 3, Cholesky
    otherwise, up to the largest n_obs), both block sizes (n_state <= 16:
    one product warp; beyond: seven). At n_obs 1, 5 and 16 (each width of
    the innovation warp's rows) and n_state 9 and 37 (each block size)
    also against the JAX package's filter on the same RE solution."""
    n = 6 if n_s >= 17 else 24
    sys_np, data_np = synthetic_system(n_s, 3, n, n_t=30, n_o=n_o)
    A, B, C, D, Q, Z, d, H = _t(*sys_np)
    data = torch.as_tensor(data_np)
    X, M, ok, ll = body.loglike(A, B, C, D, Q, Z, d, H, data)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    assert bool(ok.all()) and bool(okp.all())
    assert normwise_rel(X, Xp).max() <= XM_RTOL
    assert normwise_rel(M, Mp).max() <= XM_RTOL
    want = bl_kalman_loglike_chandrasekhar(Xp, Mp, Q, Z, d, H, data)
    assert_loglh_close(ll.numpy(), want.numpy())
    if n_o in (1, 5, 16) and n_s in (9, 37):
        j = lambda t: jnp.asarray(t.numpy())
        want_jax = jax.jit(jax_chand)(*map(j, (Xp, Mp, Q, Z, d, H, data)))
        assert_loglh_close(ll.numpy(), np.asarray(want_jax))


@pytest.mark.parametrize("n", [1, 3, 257])
def test_ragged_n_matches_plain(body, n):
    """One block per particle: any particle count, each particle alone."""
    _, sys_t, rest = _as2_case(n, seed=30 + n)
    X, M, ok, ll = body.loglike(*sys_t, *rest)
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    assert torch.equal(ok, okp)
    if ok.any():
        assert normwise_rel(X[..., ok], Xp[..., ok]).max() <= XM_RTOL
    want = bl_dsge_loglike(*sys_t, *rest)
    if torch.isfinite(want).any():
        assert_loglh_close(ll.numpy(), want.numpy())
    else:
        assert not torch.isfinite(ll).any()


@pytest.mark.parametrize("n_s,n_o", [
    pytest.param(n_s, n_o, id=str(n_o) if n_s == 5 else f"{n_s}-{n_o}")
    for n_s in (5, 20) for n_o in (1, 2, 3, 7, 16)])
def test_nan_and_non_pd_particles_are_isolated(body, n_s, n_o):
    """A NaN particle (RE solve) and a particle whose innovation covariance
    is negative definite (H = -10 I: the Cholesky factorization fails, or
    at n_obs 3 det F < 0) give -inf; their neighbours are bitwise those of
    the run without them. Both block sizes."""
    sys_np, data_np = synthetic_system(n_s, 2, 12, n_t=20, n_o=n_o)
    A, B, C, D, Q, Z, d, H = _t(*sys_np)
    data = torch.as_tensor(data_np)
    *_, ll = body.loglike(A, B, C, D, Q, Z, d, H, data)
    j_nan, j_pd = 4, 7
    A2, H2 = A.clone(), H.clone()
    A2[:, :, j_nan] = float("nan")
    H2[:, :, j_pd] = -10.0 * torch.eye(n_o, dtype=torch.float64)
    X2, M2, ok2, ll2 = body.loglike(A2, B, C, D, Q, Z, d, H2, data)
    keep = torch.ones(12, dtype=torch.bool)
    keep[[j_nan, j_pd]] = False
    assert not bool(ok2[j_nan]) and bool(ok2[j_pd])
    assert ll2[j_nan].item() == ll2[j_pd].item() == float("-inf")
    assert torch.equal(ll2[keep], ll[keep])
    assert bool(torch.isfinite(ll[keep]).all())
    want = bl_dsge_loglike(A2, B, C, D, Q, Z, d, H2, data)
    assert want[j_nan].item() == want[j_pd].item() == float("-inf")


@pytest.mark.parametrize("n_s,n_o", [(5, 2), (5, 3), (20, 7), (20, 16)])
def test_no_observations_give_zero(body, n_s, n_o):
    """With no observations (n_t = 0) the filter adds no term: 0 for every
    particle whose RE solve succeeded, as the plain version gives, with
    nothing read from the empty observations. Both block sizes, both
    innovation solves."""
    sys_np, _ = synthetic_system(n_s, 2, 5, n_t=1, n_o=n_o)
    A, B, C, D, Q, Z, d, H = _t(*sys_np)
    data = torch.zeros((n_o, 0), dtype=torch.float64)
    X, M, ok, ll = body.loglike(A, B, C, D, Q, Z, d, H, data)
    assert bool(ok.all())
    assert torch.equal(ll, torch.zeros(5, dtype=torch.float64))
    assert torch.equal(bl_dsge_loglike(A, B, C, D, Q, Z, d, H, data), ll)


@pytest.mark.parametrize("n_o", range(1, 17))
def test_innovation_solve_matches_plain(body, n_o):
    """The innovation warp's factor and solves (Cholesky across the lanes by
    shuffles; the cofactor form at n_obs 3) against bl_psd_fast_solve, the
    port's and the JAX package's, with the filter's n_obs + 1 right-hand
    sides. A particle whose F is negative definite gets a NaN log det (the
    filter's -inf; the Cholesky solves are NaN too) and leaves its
    neighbours' bits unchanged."""
    rng = np.random.default_rng(n_o)
    n, j_neg = 9, 4
    A = rng.standard_normal((n, n_o, n_o))
    F = A @ A.transpose(0, 2, 1) + n_o * np.eye(n_o)
    B = rng.standard_normal((n, n_o, n_o + 1))
    X, logdet = body.psd(F, B)
    bl = lambda x: torch.as_tensor(np.ascontiguousarray(np.moveaxis(x, 0, -1)))
    Xp, ldp = bl_psd_fast_solve(bl(F), bl(B))
    assert normwise_rel(bl(X), Xp).max().item() <= 1e-12
    np.testing.assert_allclose(logdet, ldp.numpy(), rtol=1e-13, atol=1e-13)
    Xj, ldj = jax.jit(jax_psd_solve)(*(jnp.asarray(bl(x).numpy())
                                       for x in (F, B)))
    assert normwise_rel(bl(X), torch.as_tensor(np.array(Xj))).max().item() \
        <= 1e-12
    np.testing.assert_allclose(logdet, np.asarray(ldj), rtol=1e-13,
                               atol=1e-13)
    F2 = F.copy()
    F2[j_neg] = -F2[j_neg]
    X2, ld2 = body.psd(F2, B)
    keep = np.arange(n) != j_neg
    assert np.array_equal(X2[keep], X[keep])
    assert np.array_equal(ld2[keep], logdet[keep])
    assert np.isnan(ld2[j_neg])
    assert np.isnan(X2[j_neg]).all() == (n_o != 3)
    assert np.isnan(bl_psd_fast_solve(bl(F2), bl(B))[1][j_neg].item())


def _gj_serial(W, n):
    """Gauss-Jordan with the serial pivot rule (the first maximal |entry|
    at or below the diagonal, as bl_gj_solve's argmax), in the kernel's
    operation order: (pivot rows, the solution columns)."""
    W = W.copy()
    pivots = []
    for k in range(n):
        p = k + int(np.argmax(np.abs(W[k:, k])))
        pivots.append(p)
        piv = W[p, k]
        row = W[p, k + 1:].copy()
        if p != k:
            W[p, k + 1:] = W[k, k + 1:]
        col = W[:, k].copy()
        col[p] = W[k, k]
        fac = col / piv
        for i in range(W.shape[0]):
            if i != k:
                W[i, k + 1:] = W[i, k + 1:] - fac[i] * row
        W[k, k + 1:] = row / piv
    return pivots, W[:, n:]


def _gj_host(body, W, n):
    """(pivot rows, the solution columns) of the host build's Gauss-Jordan
    on W [n, w]: the block that n_state n takes."""
    got = np.ascontiguousarray(W)
    piv = np.zeros(n, dtype=np.int32)
    assert body.lib.smc_general_gj_cpu(
        n, W.shape[1], got.ctypes.data, piv.ctypes.data) == 0
    return piv.tolist(), got[:, n:]


@pytest.mark.parametrize("n,w,seed", [(5, 10, 0), (16, 48, 1), (37, 111, 2),
                                      (64, 192, 3)])
def test_tied_pivots_follow_the_serial_rule(body, n, w, seed):
    """Entries in {-2, ..., 2} tie in magnitude at most pivot steps; a tie
    at rows 10 and 40 of the first column (lanes 10 and 8 of the warp) and
    at rows 3 and 35 (lane 3 twice) must pick the smaller row. Pivot rows
    and solution are the serial rule's, bit for bit."""
    rng = np.random.default_rng(seed)
    W = rng.integers(-2, 3, size=(n, w)).astype(np.float64)
    if n == 64:
        W[:, 0] = 1.0
        W[10, 0], W[40, 0] = -9.0, 9.0
        W[:, 1] = 1.0
        W[3, 1], W[35, 1] = 9.0, -9.0
    want_piv, want = _gj_serial(W, n)
    if n == 64:
        assert want_piv[:2] == [10, 3]
    piv, got = _gj_host(body, W, n)
    assert piv == want_piv
    assert sum(p != k for k, p in enumerate(want_piv)) > 0
    assert np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)


# (n, k, width, case): the large team's panels are 4 columns wide, so 17, 37
# and 63 end inside a panel and 44 on a panel's edge; k for the width
# 2n + k; the features need a second row in every lane (n > 40)
_PANEL_CASES = [
    (n, k, width, case)
    for n, k in [(17, 8), (37, 7), (44, 14), (63, 7)]
    for width in ["2n", "2n+k", "3n"]
    for case in ["plain", "high_row", "lane_edge", "nan"]
    if n > 40 or case in ("plain", "nan")]


@pytest.mark.parametrize("n,k,width,case", _PANEL_CASES)
def test_panel_pivots_follow_the_serial_rule(body, n, k, width, case):
    """The large team's panels against the serial rule, bit for bit, pivot
    rows included, at n 17, 37, 44 and 63 and the RE solve's widths. On entries in {-2, ..., 2}
    ("plain"), and with one feature each: "high_row", step 0's pivot in
    row 40 (lane 8's second row), then at step 1 a tie within lane 0
    between row 32 and the row-0 item that step 0 moved to row 40 (row 32
    wins, though it is the lane's second); "lane_edge", a tie at rows 31 and
    32 (lane 31's first row, lane 0's second), then between the row-0
    item now in row 31 and row 33; "nan", an all-NaN column inside the
    last panel (that step and every later one keep p = k)."""
    w = {"2n": 2 * n, "2n+k": 2 * n + k, "3n": 3 * n}[width]
    rng = np.random.default_rng(1000 * n + w)
    W = rng.integers(-2, 3, size=(n, w)).astype(np.float64)
    if case == "high_row":
        W[:, 0] = 1.0
        W[40, 0], W[40, 1] = 9.0, 0.0  # column 1 untouched by step 0
        W[0, 1], W[32, 1] = 9.0, -9.0
        first = [40, 32]
    elif case == "lane_edge":
        W[:, 0] = 1.0
        W[31, 0], W[32, 0], W[31, 1] = -9.0, 9.0, 0.0
        W[0, 1], W[33, 1] = -9.0, 9.0
        first = [31, 31]
    elif case == "nan":
        W[:, n - 3] = np.nan
        first = None
    else:
        first = None
    want_piv, want = _gj_serial(W, n)
    if first is not None:
        assert want_piv[:2] == first
    piv, got = _gj_host(body, W, n)
    assert piv == want_piv
    assert sum(p != i for i, p in enumerate(want_piv)) > 0
    if case == "nan":
        assert want_piv[n - 3:] == [n - 3, n - 2, n - 1]
        assert np.isnan(want).all()
    else:
        assert np.isfinite(want).all()
    np.testing.assert_array_equal(got, want)


def _quot_pairs(kind, rng, m=200_000):
    """(a, b) pairs of one kind for test_kernel_division_is_ieee."""
    def doubles(lo, hi):
        return np.ldexp(rng.uniform(1.0, 2.0, m) * rng.choice([-1.0, 1.0], m),
                        rng.integers(lo, hi, m))
    if kind == "ordinary":      # the exponents of the RE solve's entries
        return doubles(-60, 60), doubles(-60, 60)
    if kind == "any_exponent":  # under- and overflow, subnormals
        return doubles(-1100, 1024), doubles(-1100, 1024)
    if kind == "integers":      # exact quotients and ties in |a|
        return (rng.integers(-40, 41, m).astype(np.float64),
                rng.integers(-9, 10, m).astype(np.float64))
    if kind == "near_one":      # quotients at and around powers of 2
        b = doubles(-3, 3)
        k = rng.integers(-3, 4, m).astype(np.float64)
        return np.ldexp(b, rng.integers(-2, 3, m)) * (1.0 + k * 2.0 ** -52), b
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1.0, -1.0,
                         5e-324, -5e-324, 2.2250738585072014e-308,
                         1.7976931348623157e308, 2.0 ** -480, 2.0 ** 480,
                         1.0 - 2.0 ** -53, 1.0 + 2.0 ** -52, 3.0, 0.1])
    a, b = np.meshgrid(specials, specials)
    return a.ravel(), b.ravel()


@pytest.mark.parametrize("kind", ["ordinary", "any_exponent", "integers",
                                  "near_one", "specials"])
def test_kernel_division_is_ieee(body, kind):
    """The kernels' division (quot: a zero dividend by the signs, else the
    division) gives IEEE's quotient, bit for bit, NaN included."""
    a, b = _quot_pairs(kind, np.random.default_rng(7))
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    q = np.empty_like(a)
    assert body.lib.smc_general_quot_cpu(a.ctypes.data, b.ctypes.data,
                                         q.ctypes.data, a.size) == 0
    with np.errstate(all="ignore"):
        want = a / b
    np.testing.assert_array_equal(q.view(np.uint64), want.view(np.uint64))


@pytest.mark.parametrize("n_s,n_k,n_o,n_t", [
    (1, 1, 1, 0), (6, 3, 2, 80), (17, 8, 3, 40), (37, 7, 7, 156),
    (37, 7, 7, 197), (64, 64, 16, 300), (64, 64, 16, 400), (64, 65, 1, 1),
    (65, 7, 7, 10), (8, 2, 17, 10), (44, 14, 14, 5_000),
    (6, 3, 3, 100_000)])
def test_tile_sizes_are_the_kernels(body, n_s, n_k, n_o, n_t):
    """The wrapper decides a shape's route from its own copy of the tiles'
    sizes: equal to the library's, and the domain is where they fit, for
    data of any length (the Kalman tile holds no observations)."""
    in_max = n_s <= 64 and n_k <= 64 and n_o <= 16
    re = body.lib.smc_general_re_smem_cpu(n_s, n_k)
    kal = body.lib.smc_general_kalman_smem_cpu(n_s, n_k, n_o, n_t)
    if in_max:
        assert re == cuda_dsge_general.re_smem_bytes(n_s, n_k)
        assert kal == cuda_dsge_general.kalman_smem_bytes(n_s, n_k, n_o)
    else:
        assert kal == -1
    assert cuda_dsge_general.in_domain(n_s, n_k, n_o, n_t) == (
        in_max and kal <= cuda_dsge_general.SMEM_LIMIT
        and re <= cuda_dsge_general.SMEM_LIMIT)


def test_domain_covers_the_models():
    assert cuda_dsge_general.in_domain(37, 7, 7, 156)      # SW
    assert cuda_dsge_general.in_domain(37, 7, 7, 197)      # SW, real data
    assert cuda_dsge_general.in_domain(6, 3, 2, 80)        # AS-2obs
    assert cuda_dsge_general.in_domain(44, 14, 14, 156)    # sw_pi_fg
    # the largest shape over long data: the observations are not in a tile
    assert cuda_dsge_general.in_domain(64, 64, 16, 400)
    assert not cuda_dsge_general.in_domain(64, 65, 16, 10)  # the RE tile
    assert not cuda_dsge_general.in_domain(65, 3, 3, 10)


@pytest.mark.parametrize("backend,chand,device,shape,want", [
    ("plain", True, "cuda", (37, 7, 7, 156), "general"),      # SW
    ("xla", True, "cuda", (37, 7, 7, 156), "general"),
    ("plain", True, "cuda", (6, 3, 2, 80), "general"),        # AS-2obs
    ("plain", True, "cuda", (6, 3, 3, 80), "kernel"),         # AS on plain
    ("plain", True, "cuda", (8, 8, 3, 80), "kernel"),
    ("plain", True, "cuda", (6, 3, 3, 7936), "kernel"),       # longest data
    ("plain", True, "cuda", (6, 3, 3, 7937), "general"),
    ("plain", True, "cuda", (6, 3, 3, 9580), "general"),
    ("plain", True, "cuda", (9, 3, 3, 80), "general"),        # n_state 9
    ("plain", True, "cuda", (6, 9, 3, 80), "general"),        # n_shock 9
    ("plain", False, "cuda", (6, 3, 3, 80), "plain"),         # Riccati
    ("plain", True, "cpu", (6, 3, 3, 80), "plain"),
    ("plain", False, "cuda", (37, 7, 7, 156), "plain"),       # Riccati
    ("plain", True, "cuda", (65, 7, 7, 156), "plain"),        # n_state
    ("plain", True, "cuda", (37, 7, 17, 156), "plain"),       # n_obs
    ("plain", True, "cuda", (37, 7, 7, 100_000), "general"),  # long data
    ("plain", True, "cpu", (37, 7, 7, 156), "plain"),
    ("plain", True, "cpu", (6, 3, 2, 80), "plain"),
    ("kernel", True, "cuda", (6, 3, 3, 80), "kernel"),
    ("pallas", True, "cuda", (6, 3, 3, 80), "kernel"),
    ("kernel", True, "cpu", (6, 3, 3, 80), "kernel"),
])
def test_likelihood_route(backend, chand, device, shape, want):
    assert likelihood_route(backend, chand, device, *shape) == want


def test_long_data_matches_plain(body):
    """Data longer than the Kalman tile once held (its observations now
    stay in global memory): sw_pi_fg's shape (44, 14, 14) over 400
    quarters simulated at the mode, on the mode, 8 prior and 4 near-mode
    draws, the host build of the kernel bodies against the plain route,
    in SW's bands; the card takes the shape ("general")."""
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.models.dsge import bl_expectation_rows
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    assert likelihood_route("plain", True, "cuda", 44, 14, 14, 400,
                            expectations=True) == "general"
    prior = ParamSpace(fg.sw_pi_fg_parameters()).sample_prior(
        TorchDraws(6, "cpu"), 8, device="cpu")
    mode = torch.as_tensor(fg.TRUE_PARAMS)[None]
    near = mode * (1.0 + 1e-4 * torch.as_tensor(
        np.random.default_rng(2).standard_normal((4, 43))))
    th = torch.cat([mode, prior, near])
    data = torch.as_tensor(fg.generate_sw_pi_fg_data(T=400))
    A, B, C, D = fg._system(th)
    d, Z, H = fg._measurement(th)
    Q = fg._shock_cov(th)
    X, M, ok = body.re(A, B, C, D)
    ll = body.kalman(X, M, Q, bl_expectation_rows(
        Z, X, fg.EXPECTATION_ROWS, ok), d, H, data, ok)
    want = bl_dsge_loglike(A, B, C, D, Q, Z, d, H, data,
                           expectation_rows=fg.EXPECTATION_ROWS)
    assert bool(torch.isfinite(ll[[0, -4, -3, -2, -1]]).all())
    assert_sw_loglh_close(ll.numpy(), want.numpy())


def test_models_on_cpu_launch_no_kernel():
    before = dict(LAUNCHES)
    th = torch.as_tensor(np.stack([tsw.TRUE_PARAMS] * 2))
    tsw.smets_wouters().loglike_batched(th, tsw.load_sw_data())
    tas.an_schorfheide_2obs().loglike_batched(
        torch.as_tensor(as_prior_draws(4, seed=2)), tas.load_as_data()[:2])
    assert launches_since(before) == {}


def test_wrappers_on_cpu_are_the_plain_versions():
    _, sys_t, rest = _as2_case(16, seed=5)
    X, M, ok = cuda_dsge_general.solve_linear_re(*sys_t)
    Xp, Mp, okp = bl_solve_linear_re(*sys_t)
    assert torch.equal(X, Xp) and torch.equal(M, Mp) and torch.equal(ok, okp)
    assert torch.equal(cuda_dsge_general.dsge_loglike(*sys_t, *rest),
                       bl_dsge_loglike(*sys_t, *rest))


def test_wrappers_refuse_other_devices_and_shapes():
    A = torch.zeros((6, 6, 4), device="meta", dtype=torch.float64)
    D = torch.zeros((6, 3, 4), device="meta", dtype=torch.float64)
    with pytest.raises(ValueError, match="no kernel for tensors on meta"):
        cuda_dsge_general.solve_linear_re(A, A, A, D)
    big = torch.zeros((65, 65, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="no general kernel"):
        cuda_dsge_general.solve_linear_re(big, big, big, big[:, :3])
