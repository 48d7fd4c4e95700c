"""Estimate the 9-parameter linear regression model with smc_tpu_torch, the
PyTorch and CUDA port (the JAX package's script is
examples/estimate_linear.py; the shared test fixture of reference
test/modelsetup.jl). Writes its checkpoint (smc_cloud.npz) and particle
store (smcsave.npy) to the working directory.

Run: python examples/torch/estimate_linear.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import smc_tpu_torch
from smc_tpu_torch.models.linear import (linear_parameters,
                                         make_linear_loglike,
                                         generate_linear_data)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--seed", type=int, default=42,
                    help="the run's seed (default: 42, the JAX script's)")
    args = ap.parse_args(argv)

    data, X = generate_linear_data(seed=1793)
    loglike = make_linear_loglike(X)

    kw = dict(n_parts=400, n_phi=120, lam=2.0,
              resampling_method="systematic", verbose="low",
              seed=args.seed, savepath="smc_cloud.npz",
              particle_store_path="smcsave.npy")
    if os.environ.get("SMC_TPU_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none",
                  savepath=None, particle_store_path=None)
    result = smc_tpu_torch.smc(loglike, linear_parameters(), data,
                               device=args.device, **kw)

    true = np.array([1, 1, 1, 2, 2, 1, 3, 3, 1], dtype=float)
    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\n{'param':>8s} {'true':>6s} {'mean':>8s} {'std':>8s}")
    for name, t, m, s in zip(result.para_names, true, mu, sd):
        print(f"{name:>8s} {t:6.2f} {m:8.3f} {s:8.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")
    print(f"max |posterior mean - truth| = {np.max(np.abs(mu - true)):.3f}")
    return result


if __name__ == "__main__":
    main()
