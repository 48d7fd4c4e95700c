"""CAPM estimation at the JAX package's tests/test_capm.py configuration
(5,000 particles, n_phi=100, lam=2.1, alpha=0.9, systematic) on the CPU,
one line per seed: each parameter's |z| against the data-generating values,
and log-MDD. A seed "collapses" when some |z| is far above 5 (one
parameter's cloud settles away from the truth); how often that happens is
what tests/test_torch_capm.py's median-over-seeds gate must absorb. Runs
the port by default, the JAX package with --jax, so the two collapse counts
can be set side by side. Not a test module:

    python tests/torch_capm_seeds.py [--jax] [SEED,SEED,...]
                                     (default seeds 42,0,1,...,7)

Run it from another checkout's root to measure that tree's package.
"""

import os
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402

TRUE = np.array([0.1, 0.8, 0.5, 0.2, 1.0, 0.5, 0.3, 1.2, 0.5])
CONFIG = dict(n_parts=5000, n_phi=100, lam=2.1, alpha=0.9,
              resampling_method="systematic", verbose="none")


def run_port(seed):
    import torch
    import smc_tpu_torch
    from smc_tpu_torch.models import capm
    torch.set_num_threads(1)
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    return smc_tpu_torch.smc(capm.make_capm_loglike(market),
                             capm.capm_parameters(), lik, seed=seed,
                             device="cpu", **CONFIG)


def run_jax(seed):
    """As the JAX package's tests run it: the CPU with 8 virtual devices."""
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import smc_tpu
    from smc_tpu.models import capm
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    return smc_tpu.smc(capm.make_capm_loglike(market), capm.capm_parameters(),
                       lik, seed=seed, **CONFIG)


def main(run, seeds):
    for seed in seeds:
        res = run(seed)
        z = np.abs(np.asarray(res.posterior_mean()) - TRUE) / np.maximum(
            np.asarray(res.posterior_std()), 1e-9)
        print(f"seed {seed}: max |z| {z.max():.2f}, |z| "
              f"{np.array2string(z, precision=2)}, log-MDD "
              f"{float(res.log_mdd):.3f}", flush=True)


if __name__ == "__main__":
    args = sys.argv[1:]
    use_jax = "--jax" in args
    args = [a for a in args if a != "--jax"]
    main(run_jax if use_jax else run_port,
         [int(s) for s in args[0].split(",")] if args
         else [42, 0, 1, 2, 3, 4, 5, 6, 7])
