"""Estimate the 2-parameter regression with smc_tpu_torch, the PyTorch and
CUDA port (the JAX package's script is examples/estimate_regression.py;
reference examples/regression_model/estimate_regression.jl: 100 particles,
all-default schedule).

Run: python examples/torch/estimate_regression.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import smc_tpu_torch
from smc_tpu_torch.models.regression import (regression_parameters,
                                             make_regression_loglike,
                                             generate_regression_data)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the run's seed (default: 0, the JAX script's)")
    args = ap.parse_args(argv)

    y, x = generate_regression_data(n=100, seed=1793)
    loglike = make_regression_loglike(x)

    kw = dict(n_parts=100, verbose="low", seed=args.seed)
    if os.environ.get("SMC_TPU_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none")
    result = smc_tpu_torch.smc(loglike, regression_parameters(), y,
                               device=args.device, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\nalpha: mean={mu[0]:.3f} std={sd[0]:.3f} (true 1.0)")
    print(f"beta : mean={mu[1]:.3f} std={sd[1]:.3f} (true 1.0)")
    print(f"log marginal data density: {result.log_mdd:.3f}")
    return result


if __name__ == "__main__":
    main()
