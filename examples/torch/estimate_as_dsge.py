"""Estimate the An-Schorfheide 3-equation New Keynesian DSGE with
smc_tpu_torch, the PyTorch and CUDA port (the JAX package's script is
examples/estimate_as_dsge.py; reference
examples/dsge_models/small_dsge_model.jl: 400 particles, n_phi=100,
lambda=2.0, systematic resampling).

The likelihood runs batched over the particles through the hand-written
CUDA kernels (an_schorfheide(), likelihood_backend "kernel": the
cyclic-reduction RE solve and the Chandrasekhar Kalman filter; on the CPU
their plain PyTorch versions). The data are the JAX package's
generate_as_data(T=80, seed=1793), simulated at the Herbst-Schorfheide DGP
values and committed as an array.

Run: python examples/torch/estimate_as_dsge.py [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import smc_tpu_torch
from smc_tpu_torch.models.as_dsge import (an_schorfheide,
                                          an_schorfheide_parameters,
                                          load_as_data, TRUE_PARAMS,
                                          PARAM_NAMES)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--seed", type=int, default=42,
                    help="the run's seed (default: 42, the JAX script's)")
    args = ap.parse_args(argv)

    model = an_schorfheide()
    data = load_as_data()

    kw = dict(n_parts=400, n_phi=100, lam=2.0,
              resampling_method="systematic", verbose="low",
              seed=args.seed)
    if os.environ.get("SMC_TPU_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=10, verbose="none")
    result = smc_tpu_torch.smc(model.loglike_batched,
                               an_schorfheide_parameters(), data,
                               batched=True, device=args.device, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\n{'param':>8s} {'true':>7s} {'mean':>8s} {'std':>8s}")
    for name, t, m, s in zip(PARAM_NAMES, TRUE_PARAMS, mu, sd):
        print(f"{name:>8s} {t:7.3f} {m:8.3f} {s:8.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")
    return result


if __name__ == "__main__":
    main()
