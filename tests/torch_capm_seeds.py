"""CAPM estimation over seeds, one line per seed: each parameter's |z|
against the data-generating values, the largest distance of a posterior
mean from the exact posterior mean in exact posterior sds, the largest
ratio of a posterior sd to the exact one, log-MDD and the exact log
evidence (CAPM is the linear fixture's model with the market return as
every equation's regressor, so `exact_linear_posterior` gives both).

By default at the JAX package's tests/test_capm.py configuration (5,000
particles, n_phi=100, lam=2.1, alpha=0.9, systematic); with --example at
examples/estimate_capm.py's (1,000 particles, n_phi=100, lam=2.0, smc()'s
other defaults). A seed "collapses" when some |z| is far above 5 (one
parameter's cloud settles away from the truth); how often that happens is
what tests/test_torch_capm.py's median-over-seeds gate must absorb. Runs
the port on the CPU by default, the JAX package with --jax, so the two
collapse counts can be set side by side. --device cuda runs the port on a
card (fused); with --host-eigh as well, the host loop with the mutation's
eigh done by torch.linalg.eigh on the CPU (the CPU run's eigh) instead of
the Jacobi kernel, to tell the kernel's rounding from the card's other
arithmetic. Not a test module:

    python tests/torch_capm_seeds.py [--jax] [--example] [--device cuda]
                                     [--host-eigh] [SEED,SEED,... | A-B]
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
EXAMPLE_CONFIG = dict(n_parts=1000, n_phi=100, lam=2.0, verbose="none")


def exact_posterior():
    """The exact posterior moments and log evidence of the simulated CAPM
    data (T = 200, seed 1793)."""
    from smc_tpu_torch.models import capm
    from smc_tpu_torch.models.linear import exact_linear_posterior
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    return exact_linear_posterior(lik, np.tile(market, (3, 1)))


def _host_eigh():
    """Route the mutation's eigh through torch.linalg.eigh on the CPU."""
    from smc_tpu_torch.ops import cuda_eigh, mutation

    def eigh(A):
        return tuple(t.to(A.device) for t in cuda_eigh.eigh_plain(A.cpu()))

    mutation.eigh = eigh
    mutation.eigh_batched = lambda stacks: [eigh(A) for A in stacks]


def run_port(seed, config, device="cpu", host_eigh=False):
    import torch
    import smc_tpu_torch
    from smc_tpu_torch.models import capm
    torch.set_num_threads(1)
    if host_eigh:
        _host_eigh()
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    return smc_tpu_torch.smc(capm.make_capm_loglike(market),
                             capm.capm_parameters(), lik, seed=seed,
                             device=device, fused=not host_eigh, **config)


def run_jax(seed, config, device=None, host_eigh=False):
    """As the JAX package's tests run it: the CPU with 8 virtual devices."""
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import smc_tpu
    from smc_tpu.models import capm
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    return smc_tpu.smc(capm.make_capm_loglike(market), capm.capm_parameters(),
                       lik, seed=seed, **config)


def main(run, seeds, **kw):
    exact = exact_posterior()
    print(f"exact log evidence {exact['log_evidence']:.3f}", flush=True)
    for seed in seeds:
        res = run(seed, **kw)
        mu = np.asarray(res.posterior_mean())
        sd = np.asarray(res.posterior_std())
        z = np.abs(mu - TRUE) / np.maximum(sd, 1e-9)
        off = np.abs(mu - exact["mean"]) / exact["sd"]
        print(f"seed {seed}: max |z| {z.max():.2f}, |z| "
              f"{np.array2string(z, precision=2)}, max |mean - exact| / "
              f"exact sd {off.max():.2f}, max sd / exact sd "
              f"{np.max(sd / exact['sd']):.2f}, log-MDD "
              f"{float(res.log_mdd):.3f}", flush=True)


def _seeds(arg):
    if "-" in arg:
        lo, hi = arg.split("-")
        return list(range(int(lo), int(hi) + 1))
    return [int(s) for s in arg.split(",")]


if __name__ == "__main__":
    args = sys.argv[1:]
    flags = {a for a in args if a in ("--jax", "--example", "--host-eigh")}
    device = "cpu"
    if "--device" in args:
        device = args[args.index("--device") + 1]
        args.remove("--device")
        args.remove(device)
    args = [a for a in args if a not in flags]
    kw = dict(config=EXAMPLE_CONFIG if "--example" in flags else CONFIG)
    if "--jax" not in flags:
        kw.update(device=device, host_eigh="--host-eigh" in flags)
    main(run_jax if "--jax" in flags else run_port,
         _seeds(args[0]) if args else [42, 0, 1, 2, 3, 4, 5, 6, 7], **kw)
