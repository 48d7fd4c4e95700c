"""Shared inputs and tolerances for the smc_tpu_torch parity tests
(tests/test_torch_*.py) and chip_smoke.py. Imports numpy alone at the top
(never jax). Not a test module itself."""

import numpy as np

# Tolerance bands for log-likelihoods computed by two implementations of the
# Chandrasekhar recursion (JAX vs PyTorch, or a kernel body vs its plain
# version). The recursion is not self-correcting: on draws far from the data
# (innovations orders of magnitude off, F nearly singular with H = 1e-10) a
# rounding difference in the first steps is amplified. Measured on prior
# draws: within 50 nats of the best lane (the posterior band of bench.py's
# gate) two implementations agree to ~1e-14 relative; within 1e6 nats to
# ~1e-8; beyond that, only the -inf pattern is stable. Such lanes carry no
# posterior weight.
BAND_NATS = 50.0
BAND_RTOL = 1e-10
TAIL_NATS = 1e6
TAIL_RTOL = 1e-7


def assert_loglh_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.any()
    best = want[fin].max()
    band = fin & (want > best - BAND_NATS)
    tail = fin & (want > best - TAIL_NATS)
    np.testing.assert_allclose(got[band], want[band], rtol=BAND_RTOL, atol=0)
    np.testing.assert_allclose(got[tail], want[tail], rtol=TAIL_RTOL, atol=0)


def as_prior_draws(n, seed):
    """n draws [n, 13] from the An-Schorfheide prior, made with numpy."""
    rng = np.random.default_rng(seed)

    def gamma_ms(mean, std):
        return rng.gamma((mean / std) ** 2, std * std / mean, n)

    def rig(nu, tau):
        return tau * np.sqrt(nu / rng.chisquare(nu, n))

    return np.stack([
        gamma_ms(2.0, 0.5), rng.uniform(0, 1, n), gamma_ms(1.5, 0.25),
        gamma_ms(0.5, 0.25), gamma_ms(0.5, 0.5), gamma_ms(7.0, 2.0),
        rng.normal(0.4, 0.2, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n),
        rng.uniform(0, 1, n), rig(4.0, 0.4), rig(4.0, 1.0), rig(4.0, 0.5),
    ], axis=1)


def as_posterior_draws(n, seed, scale=0.02):
    """n draws near the An-Schorfheide DGP values (relative jitter `scale`):
    particles where every likelihood is well inside the posterior band."""
    from smc_tpu_torch.models.as_dsge import TRUE_PARAMS
    rng = np.random.default_rng(seed)
    th = TRUE_PARAMS * (1.0 + scale * rng.standard_normal((n, 13)))
    th[:, 7:10] = np.clip(th[:, 7:10], 0.01, 0.99)
    return th


def tiny_system(N=64, seed=5):
    """The 3-state backward-looking system of test_pallas_dsge.py."""
    rng = np.random.default_rng(seed)
    n_s = 3
    A = np.zeros((n_s, n_s, N))
    B = np.zeros((n_s, n_s, N))
    C = np.zeros((n_s, n_s, N))
    D = np.zeros((n_s, 3, N))
    for k in range(N):
        rho = rng.uniform(0.2, 0.8, n_s)
        B[..., k] = np.eye(n_s)
        A[..., k] = -np.diag(rho)
        D[..., k] = -np.eye(n_s)
    Q = np.tile(np.eye(3)[:, :, None], (1, 1, N))
    Z = np.tile(np.eye(3)[:, :, None], (1, 1, N)) * 1.5
    d = np.zeros((3, N))
    H = np.tile((0.1 * np.eye(3))[:, :, None], (1, 1, N))
    data = rng.standard_normal((3, 5))
    return A, B, C, D, Q, Z, d, H, data


class StubMesh:
    """What smc() reads of a particle mesh of `size` ranks (a DeviceMesh
    needs a process group): with `group` (a process group of this process)
    it stands for a mesh over that group, else it serves only until the
    first collective."""
    mesh_dim_names = ("parts",)

    def __init__(self, size, group=None):
        self._size = size
        self._group = group

    def size(self):
        return self._size

    def get_local_rank(self, dim):
        return 0

    def get_group(self, dim):
        return self._group


# the length of the observed series synthetic_system draws from
SYNTHETIC_T = 80


def synthetic_system(n_s, n_k, n, seed=5, n_t=SYNTHETIC_T):
    """n stable linear-RE systems at (n_s, n_k) with three observables,
    drawn with numpy from `seed` (the 3-state system of the kernel tests,
    widened): X = diag(rho) + E, rho ~ U(0.2, 0.7), and B = I + E', a
    forward-looking C, A = -(B X + C X^2), so that X solves the system;
    D = -(I + 0.3 G), Q = S S'/n_k + I/2, Z = 1.5 I + 0.3 G, H = 0.1 I, E, E'
    and C of scale 0.1/sqrt(n_s). Returns the batch-last float64 arrays
    (A, B, C, D, Q, Z, d, H) and data [3, n_t], the first n_t observations
    of a standard normal series drawn from `seed`."""
    rng = np.random.default_rng([seed, n_s, n_k])
    s = 0.1 / np.sqrt(n_s)
    g = lambda *shape: rng.standard_normal((n, *shape))
    eye = np.eye(n_s)
    X = rng.uniform(0.2, 0.7, (n, n_s, 1)) * eye + s * g(n_s, n_s)
    B = eye + s * g(n_s, n_s)
    C = s * g(n_s, n_s)
    A = -(B @ X + C @ X @ X)
    D = -(np.eye(n_s, n_k) + 0.3 * g(n_s, n_k))
    S = g(n_k, n_k)
    Q = S @ S.transpose(0, 2, 1) / n_k + 0.5 * np.eye(n_k)
    Z = 1.5 * np.eye(3, n_s) + 0.3 * g(3, n_s)
    d = 0.1 * g(3)
    H = np.broadcast_to(0.1 * np.eye(3), (n, 3, 3))
    last = lambda x: np.ascontiguousarray(np.moveaxis(x, 0, -1))
    data = np.random.default_rng(seed).standard_normal((3, SYNTHETIC_T))
    return ((last(A), last(B), last(C), last(D), last(Q), last(Z), last(d),
             last(H)), np.ascontiguousarray(data[:, :n_t]))


def synthetic_model(sys_np, device, likelihood_backend="kernel"):
    """A LinearDSGE (on the "kernel" backend unless told otherwise) whose
    particle j (theta [N, 1] holding j) is system j of sys_np: a user's own
    small model, through the entry point a user calls."""
    import torch
    from smc_tpu_torch.distributions import Uniform
    from smc_tpu_torch.models.dsge import LinearDSGE
    from smc_tpu_torch.params import parameter
    A, B, C, D, Q, Z, d, H = (torch.as_tensor(x, device=device)
                              for x in sys_np)
    pick = lambda x, th: x[..., th[:, 0].long()].contiguous()
    return LinearDSGE(
        [parameter("j", 0.0, prior=Uniform(0.0, float(A.shape[-1])))],
        lambda th: tuple(pick(x, th) for x in (A, B, C, D)),
        lambda th: (pick(d, th), pick(Z, th), pick(H, th)), D.shape[1],
        lambda th: pick(Q, th), likelihood_backend=likelihood_backend)


def normwise_rel(a, b):
    """Per particle max|a-b| / max|b| over a batch-last [r, c, N] pair."""
    import torch
    num = (a - b).abs().amax(dim=(0, 1))
    den = b.abs().amax(dim=(0, 1)).clamp(min=1e-300)
    return num / den
