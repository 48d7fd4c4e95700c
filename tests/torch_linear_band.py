"""The JAX package's log-MDD band on the linear fixture at the configuration
of its bench.py (32,768 particles, n_phi=120, lam=2.1, 3 blocks, 1 MH step,
alpha=0.9, systematic resampling), over seeds 0-4 on the CPU. chip_smoke.py
gates the port's log-MDD on this band widened by 5 nats each side; the
numbers it prints are recorded in PERF.md. Not a test module:

    JAX_PLATFORMS=cpu python tests/torch_linear_band.py
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from smc_tpu import smc  # noqa: E402
from smc_tpu.models.linear import (linear_parameters, make_linear_loglike,  # noqa: E402
                                   generate_linear_data,
                                   exact_linear_posterior)


def main():
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    exact = exact_linear_posterior(data, X)
    rows = []
    for seed in range(5):
        t0 = time.perf_counter()
        res = smc(ll, linear_parameters(), data, n_parts=32_768, n_phi=120,
                  lam=2.1, n_blocks=3, n_mh_steps=1, alpha=0.9,
                  resampling_method="systematic", verbose="none", seed=seed)
        err = float(np.max(np.abs(res.posterior_mean() - exact["mean"])))
        rows.append(dict(seed=seed, log_mdd=res.log_mdd, max_mean_err=err,
                         seconds=time.perf_counter() - t0))
        print(json.dumps(rows[-1]), flush=True)
    mdds = [r["log_mdd"] for r in rows]
    print(json.dumps({"min": min(mdds), "max": max(mdds),
                      "exact_log_evidence": exact["log_evidence"]}))


if __name__ == "__main__":
    main()
