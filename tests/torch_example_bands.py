"""The log-MDD bands of chip_smoke.py's phase (k): each examples/torch/
script run by the port on this machine's CPU over seeds 0-9 (the script's
own configuration, --device cpu --seed S), and the band half-width: four
standard deviations of the difference of two independent runs, each with
that spread (4 sqrt(2) times the sample standard deviation), rounded up to
a whole nat.
With --jax, the JAX package's examples/ scripts instead, each at its own
seed (the values the bands are centred on). Not a test module itself.

    python tests/torch_example_bands.py [--jax] [SCRIPT ...]
"""

import math
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ["estimate_regression.py", "estimate_linear.py",
           "estimate_capm.py", "estimate_as_dsge.py"]
SEEDS = range(10)
_JAX_PRELUDE = ("import jax, runpy, sys;"
                "jax.config.update('jax_platforms', 'cpu');"
                "runpy.run_path(sys.argv[1], run_name='__main__')")


def log_mdd(cmd, cwd) -> float:
    out = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                         check=True, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    line = [ln for ln in out.stdout.splitlines()
            if ln.startswith("log marginal data density")][-1]
    return float(line.split()[-1])


def report(script, jax, cwd):
    """Print one script's JAX log-MDD, or the port's over SEEDS and its
    band."""
    if jax:
        v = log_mdd([sys.executable, "-c", _JAX_PRELUDE,
                     os.path.join(REPO, "examples", script)], cwd)
        print(f"{script}: JAX log-MDD {v:.3f}", flush=True)
        return
    path = os.path.join(REPO, "examples", "torch", script)
    vals = [log_mdd([sys.executable, path, "--device", "cpu", "--seed",
                     str(s)], cwd) for s in SEEDS]
    sd = float(np.std(vals, ddof=1))
    print(f"{script}: seeds {list(SEEDS)} log-MDD "
          f"{[round(v, 3) for v in vals]}; mean {np.mean(vals):.3f}, "
          f"sd {sd:.3f}, band {math.ceil(4 * math.sqrt(2) * sd):.1f}",
          flush=True)


def main(argv):
    jax = "--jax" in argv
    scripts = [a for a in argv if a != "--jax"] or SCRIPTS
    # the linear script writes its checkpoint to the working directory
    with tempfile.TemporaryDirectory() as cwd:
        for script in scripts:
            report(script, jax, cwd)


if __name__ == "__main__":
    main(sys.argv[1:])
