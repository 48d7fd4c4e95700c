"""JAX draws recorded for replay through smc_tpu_torch.rng.ReplayDraws, for
the parity tests (tests/test_torch_*.py). Not a test module itself.

The port's eigh (ops/cuda_eigh.py: each eigenvector's largest-magnitude entry
positive) and jnp.linalg.eigh may return eigenvectors of opposite sign. The
full-covariance step is c * (eps * sqrt_lam) @ U.T, so a column flipped by
s_i is undone by replaying eps_i * s_i; the diagonal component (comp == 1)
uses eps directly and gets it unflipped."""

import numpy as np
import torch
import jax
import jax.numpy as jnp

from smc_tpu_torch.cloud import weighted_cov
from smc_tpu_torch.ops.correction import correct
from smc_tpu_torch.ops.cuda_eigh import eigh
from smc_tpu_torch.ops.resample import resample
from smc_tpu_torch.rng import ReplayDraws


def _eigh_signs(cov_b):
    Uj = np.asarray(jnp.linalg.eigh(jnp.asarray(cov_b))[1])
    Ut = eigh(torch.as_tensor(cov_b))[1].numpy()
    s = np.sign(np.sum(Uj * Ut, axis=0))
    assert np.all(np.abs(np.abs(np.sum(Uj * Ut, axis=0)) - 1) < 1e-8)
    return s


def replay_mutation(key, n, cov_free, perm, sizes, alpha):
    """The draws JAX's mutation_step makes from `key`, in the port's order,
    with eps sign-matched to torch's eigenvectors."""
    entries = []
    off = 0
    for k in sizes:
        key, kcomp, keps, ku = jax.random.split(key, 4)
        eps = np.asarray(jax.random.normal(keps, (n, k), dtype=jnp.float64))
        idx = perm[off:off + k]
        off += k
        s = _eigh_signs(cov_free[np.ix_(idx, idx)])
        if alpha < 1.0:
            comp = np.asarray(jax.random.choice(
                kcomp, 3, (n,),
                p=jnp.array([alpha, (1 - alpha) / 2, (1 - alpha) / 2])))
            eps = np.where((comp != 1)[:, None], eps * s, eps)
            entries += [("normal", eps), ("categorical", comp)]
        else:
            entries += [("normal", eps * s)]
        entries.append(("uniform", np.asarray(jax.random.uniform(
            ku, (n,), dtype=jnp.float64))))
    return entries


def stage_replay(skey, tspace, state, phi_n, phi_n1, threshold, resampled,
                 alpha=0.9, method="systematic"):
    """Replay entries for one port stage (one block) from the JAX stage
    key: the resampling uniforms of `method` (drawn on every stage, as JAX
    splits kr on every stage; one for systematic, one per particle for
    stratified and multinomial), the permutation, the mutation draws
    (sign-matched to the port's own block covariance)."""
    kr, kp, km = jax.random.split(skey, 3)
    params, loglh, logprior, old, weights = state
    _, norm_w, ess, _ = correct(loglh, old, weights, phi_n, phi_n1)
    assert bool(ess < threshold) == resampled
    shape = () if method == "systematic" else (params.shape[0],)
    u = np.asarray(jax.random.uniform(kr, shape, dtype=jnp.float64))
    entries = [("uniform", u)]
    w = norm_w
    if resampled:
        params = params[resample(ReplayDraws([("uniform", u)]), norm_w,
                                 method=method)]
        w = torch.ones_like(norm_w)
    perm = np.asarray(jax.random.permutation(kp, tspace.n_free))
    entries.append(("permutation", perm))
    cov = weighted_cov(params[:, torch.as_tensor(tspace.free_inds)], w)
    cov = (0.5 * (cov + cov.T)).numpy()
    entries += replay_mutation(km, params.shape[0], cov, perm,
                               [tspace.n_free], alpha)
    return entries
