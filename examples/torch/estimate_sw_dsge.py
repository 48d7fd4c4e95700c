"""Estimate the Smets-Wouters (2007) medium-scale DSGE with smc_tpu_torch,
the PyTorch and CUDA port (the JAX package's script is
examples/estimate_sw_dsge.py): the reference's production-scale
configuration (examples/dsge_models/dsge_model.jl: n_parts=1000+, 3 blocks,
alpha=0.9, multinomial resampling) on one card, batched likelihoods (on
the card the general-shape CUDA kernels, ops/cuda_dsge_general.py; on the
CPU their plain PyTorch versions). The data are the JAX
package's generate_sw_data(T=156, seed=1793), committed as an array.

Run: python examples/torch/estimate_sw_dsge.py [--device cpu]
     (heavy on a CPU; sized for a card)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import smc_tpu_torch
from smc_tpu_torch.models.sw_dsge import (smets_wouters, sw_parameters,
                                          load_sw_data, TRUE_PARAMS,
                                          PARAM_NAMES)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--seed", type=int, default=42,
                    help="the run's seed (default: 42, the JAX script's)")
    args = ap.parse_args(argv)

    model = smets_wouters()
    data = load_sw_data()

    kw = dict(n_parts=1000, n_phi=100, lam=2.1, n_blocks=3, alpha=0.9,
              resampling_method="multinomial", verbose="low",
              seed=args.seed)
    if os.environ.get("SMC_TPU_SMOKE"):  # CI smoke: tiny but same code path
        kw.update(n_parts=64, n_phi=8, verbose="none")
    result = smc_tpu_torch.smc(model.loglike_batched, sw_parameters(), data,
                               batched=True, device=args.device, **kw)

    mu, sd = result.posterior_mean(), result.posterior_std()
    print(f"\n{'param':>11s} {'mode':>7s} {'mean':>8s} {'std':>7s}")
    for name, t, m, s in zip(PARAM_NAMES, TRUE_PARAMS, mu, sd):
        print(f"{name:>11s} {t:7.3f} {m:8.3f} {s:7.3f}")
    print(f"\nlog marginal data density: {result.log_mdd:.3f}")
    return result


if __name__ == "__main__":
    main()
