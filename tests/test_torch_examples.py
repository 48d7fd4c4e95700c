"""Every smc_tpu_torch example script must run, as tests/test_examples.py
holds the JAX package's: each examples/torch/ script runs end to end in a
subprocess under SMC_TPU_SMOKE=1 (tiny particle counts, same code path)
with --device cpu, and the subprocess checks at the end that neither jax
nor the JAX package was imported. The six subprocesses start together
(one thread each) and each test waits for its own, with a timeout."""

import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["estimate_regression.py", "estimate_linear.py",
            "estimate_capm.py", "estimate_as_dsge.py",
            "estimate_sw_dsge.py", "estimate_sw_real.py"]
TIMEOUT = 600   # seconds, each

# runs the script as __main__ with --device cpu, then fails if anything it
# imported is jax or the JAX package (modules loaded before it are not its)
_PRELUDE = (
    "import runpy, sys\n"
    "before = set(sys.modules)\n"
    "path = sys.argv[1]\n"
    "sys.argv = [path, '--device', 'cpu']\n"
    "runpy.run_path(path, run_name='__main__')\n"
    "bad = sorted(m for m in set(sys.modules) - before\n"
    "             if m.split('.')[0] in ('jax', 'jaxlib', 'smc_tpu'))\n"
    "assert not bad, f'the example imported {bad[:5]}'\n"
    "print('no jax imported')\n"
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # no $SW_REAL_DATA: the real-data script stops at its "not mounted" exit
    env = {k: v for k, v in os.environ.items() if k != "SW_REAL_DATA"}
    env.update(SMC_TPU_SMOKE="1", OMP_NUM_THREADS="1")
    procs = {}
    for script in EXAMPLES:
        cwd = tmp_path_factory.mktemp(script.split(".")[0])
        procs[script] = subprocess.Popen(
            [sys.executable, "-c", _PRELUDE,
             os.path.join(REPO, "examples", "torch", script)],
            env=env, cwd=str(cwd), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("script", EXAMPLES)
def test_example_runs(runs, script):
    proc = runs[script]
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{script} ran past {TIMEOUT} s:\n{err[-2000:]}")
    assert proc.returncode == 0, (
        f"{script} crashed:\nSTDOUT:\n{out[-2000:]}\nSTDERR:\n{err[-2000:]}")
    assert "log marginal data density" in out
    assert out.rstrip().endswith("no jax imported")
    # the data source each script reports: nothing read from outside the
    # repository unless asked for
    if script == "estimate_capm.py":
        assert "data: simulated (T = 200, seed 1793)" in out
    if script == "estimate_sw_real.py":
        assert "data: reference US dataset not mounted" in out
