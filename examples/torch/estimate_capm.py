"""Estimate the single-factor CAPM with smc_tpu_torch, the PyTorch and CUDA
port (the JAX package's script is examples/estimate_capm.py; reference
examples/capm_model/estimate_capm.jl): R_it = alpha_i + beta_i R_Mt +
eps_it for 3 assets.

Without --data it estimates on data simulated from the true parameters (T =
200, seed 1793), as the JAX script does where the reference's dataset is not
mounted; with --data PATH, on the reference's shipped capm.jld2.

Run: python examples/torch/estimate_capm.py [--device cpu] [--data PATH]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

import smc_tpu_torch
from smc_tpu_torch.models.capm import (capm_parameters, make_capm_loglike,
                                       generate_capm_data,
                                       load_reference_capm_data)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the run's seed (default: 0, the JAX script's)")
    ap.add_argument("--data", default=None,
                    help="the reference's capm.jld2 (default: simulated "
                         "data)")
    args = ap.parse_args(argv)

    # the reference's shipped dataset (examples/data/capm.jld2, as
    # estimate_capm.jl:40-42 loads) when given; else simulate
    true = None
    if args.data:
        lik_data, market_data = load_reference_capm_data(args.data)
        print(f"data: the reference's shipped capm.jld2 ({args.data})")
    else:
        lik_data, market_data = generate_capm_data(T=200, seed=1793)
        true = np.array([0.1, 0.8, 0.5, 0.2, 1.0, 0.5, 0.3, 1.2, 0.5])
        print("data: simulated (T = 200, seed 1793)")
    loglike = make_capm_loglike(market_data)

    # All-default settings, as the reference example runs it
    # (estimate_capm.jl:74), with a shrunk particle count for a quick demo.
    kw = dict(n_parts=1000, n_phi=100, lam=2.0, verbose="low",
              seed=args.seed)
    if os.environ.get("SMC_TPU_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none")
    result = smc_tpu_torch.smc(loglike, capm_parameters(), lik_data,
                               device=args.device, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    if true is None:
        print(f"\n{'param':>8s} {'mean':>8s} {'std':>8s}")
        for name, m, s in zip(result.para_names, mu, sd):
            print(f"{name:>8s} {m:8.3f} {s:8.3f}")
    else:
        print(f"\n{'param':>8s} {'true':>6s} {'mean':>8s} {'std':>8s}")
        for name, t, m, s in zip(result.para_names, true, mu, sd):
            print(f"{name:>8s} {t:6.2f} {m:8.3f} {s:8.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")
    return result


if __name__ == "__main__":
    main()
