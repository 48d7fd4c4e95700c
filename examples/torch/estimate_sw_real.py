"""Estimate the Smets-Wouters (2007) model on the reference's shipped US
dataset (its examples/data/sw_orig_smc.h5) with smc_tpu_torch, the PyTorch
and CUDA port (the JAX package's script is examples/estimate_sw_real.py),
at the reference's production configuration (reference
examples/dsge_models/dsge_model.jl:27-35,60-66: n_parts >= 1000, n_phi =
100, 3 blocks, multinomial resampling, c = 0.4, alpha = 0.9), and compare
the posterior with the published SW2007 posterior: a per-parameter z-score
of the published mean under this posterior.

The dataset spans 197 quarters (SW2007's 1966-2004 sample is 156).
SW_SAMPLE=matched estimates on the first 156 quarters, SW2007's own
sample, with hours demeaned over it. The dataset is not part of this
repository: it reads --data, else $SW_REAL_DATA, and without either (or
where the file is missing) says so and stops.

Checkpoints every 10 stages to examples/torch/sw_{real,matched}_cloud_torch
.npz (SW_REAL_CONTINUE=1 resumes) and writes its results to
examples/torch/results_sw_{real,matched}_torch.json, never to the JAX
package's benchmarks/results_sw_*.json.

Usage: python examples/torch/estimate_sw_real.py [n_parts] [n_phi]
           [--device cpu] [--data PATH]
       SW_SAMPLE=matched python examples/torch/estimate_sw_real.py
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, REPO)

import numpy as np

from smc_tpu_torch import smc
from smc_tpu_torch.models.sw_dsge import (smets_wouters,
                                          load_reference_sw_data,
                                          PARAM_NAMES)

# SW2007 AER Table 1A/1B posterior means (PARAM_NAMES order).
SW2007_POSTERIOR_MEAN = np.array([
    5.74, 1.38, 0.71, 0.70, 1.83, 0.66, 0.58, 0.24, 0.54, 1.60,
    2.04, 0.81, 0.08, 0.22, 0.78, 0.16, 0.53, 0.43, 0.52, 0.19,
    0.95, 0.22, 0.97, 0.71, 0.15, 0.89, 0.96, 0.69, 0.84,
    0.45, 0.23, 0.53, 0.45, 0.24, 0.14, 0.24,
])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_parts", nargs="?", type=int, default=2048)
    ap.add_argument("n_phi", nargs="?", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--data", default=os.environ.get("SW_REAL_DATA"),
                    help="the reference's sw_orig_smc.h5 (default: "
                         "$SW_REAL_DATA)")
    args = ap.parse_args(argv)
    n_parts, n_phi = args.n_parts, args.n_phi
    smoke = bool(os.environ.get("SMC_TPU_SMOKE"))
    if smoke:
        n_parts, n_phi = 64, 8

    if not args.data or not os.path.exists(args.data):
        print("data: reference US dataset not mounted; nothing to estimate")
        print("log marginal data density: n/a")
        return None

    model = smets_wouters()
    data = load_reference_sw_data(args.data)
    print(f"data: the reference's sw_orig_smc.h5 ({args.data})")
    matched = os.environ.get("SW_SAMPLE", "") == "matched"
    if matched:
        data = np.array(data[:, :156])   # SW2007's 1966-2004 sample
        # labobs (row 6 in OBS_NAMES order) is demeaned hours: demean it
        # over the subsample, as the published 1966-2004 dataset is built
        data[6] = data[6] - data[6].mean()
    print(f"US data: {data.shape[0]} observables x {data.shape[1]} quarters"
          + (" (matched 1966-2004 subsample)" if matched else ""),
          flush=True)

    tag = "matched" if matched else "real"
    ckpt = os.path.join(HERE, f"sw_{tag}_cloud_torch.npz")
    resume = bool(os.environ.get("SW_REAL_CONTINUE"))
    t0 = time.time()
    res = smc(model.loglike_batched, model.parameters, data, batched=True,
              n_parts=n_parts, n_phi=n_phi, n_blocks=3, n_mh_steps=1,
              lam=2.1, c=0.4, alpha=0.9, resampling_method="multinomial",
              verbose="low", seed=0, store_weight_matrices=False,
              savepath=None if smoke else ckpt,
              save_intermediate=not smoke,
              intermediate_stage_increment=10,
              continue_intermediate=resume,
              loadpath=ckpt if resume else "", device=args.device)
    wall = time.time() - t0

    mu = res.posterior_mean()
    sd = res.posterior_std()
    z = (mu - SW2007_POSTERIOR_MEAN) / np.maximum(sd, 1e-12)

    print(f"\n{'param':11s} {'post.mean':>9s} {'post.sd':>8s} "
          f"{'SW2007':>7s} {'z':>6s}", flush=True)
    for i, name in enumerate(PARAM_NAMES):
        print(f"{name:11s} {mu[i]:9.3f} {sd[i]:8.3f} "
              f"{SW2007_POSTERIOR_MEAN[i]:7.2f} {z[i]:6.1f}", flush=True)
    print(f"\nwall {wall:.0f}s  stages {len(res.cloud.ESS) - 1}  "
          f"resamples {res.cloud.resamples}", flush=True)
    print(f"log marginal data density: {res.log_mdd:.3f}", flush=True)

    n_within = int(np.sum(np.abs(z) < 2.0))
    print(f"parameters within |z|<2 of SW2007: {n_within}/36", flush=True)
    if smoke:
        return res  # never overwrite real results with smoke-config output
    out = {
        "metric": f"sw_{tag}_estimation",
        "sample_quarters": int(data.shape[1]),
        "n_within_2sd_of_sw2007": n_within,
        "n_parts": n_parts, "n_phi": n_phi,
        "wall_s": round(wall, 1),
        "log_mdd": round(float(res.log_mdd), 2),
        "device": str(args.device),
        "posterior_mean": {n: round(float(m), 4)
                           for n, m in zip(PARAM_NAMES, mu)},
        "posterior_sd": {n: round(float(s), 4)
                         for n, s in zip(PARAM_NAMES, sd)},
        "z_vs_sw2007": {n: round(float(v), 2)
                        for n, v in zip(PARAM_NAMES, z)},
        "median_abs_z": round(float(np.median(np.abs(z))), 2),
    }
    path = os.path.join(HERE, f"results_sw_{tag}_torch.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", flush=True)
    return res


if __name__ == "__main__":
    main()
