"""A mesh mix's run on the CPU: two gloo ranks in their own processes drive
run.run as the card's NCCL ranks do (the look for cards skipped), at a
small size and on An-Schorfheide's likelihood. A sound run is correct;
where a rank other than rank 0 holds jax once the window has closed, rank
0 prints no result; with the exchange between the ranks left out (each
rank's gather returns its own rows, repeated), the ranks get different
results back and the check refuses the run."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)

WORKER = r"""
import json, sys
sys.path.insert(0, __ROOT__)
from perfbench import run, spec
rank, world, store, out, fault = (int(sys.argv[1]), int(sys.argv[2]),
                                  sys.argv[3], sys.argv[4], sys.argv[5])
if fault == "jax" and rank == 1:
    import types
    sys.modules["jax"] = types.ModuleType("jax")
if fault == "exchange":
    from smc_tpu_torch.parallel import mesh
    def alone(self, *xs):
        self.counts["collectives"] += 1
        reps = [x.repeat((self.world,) + (1,) * (x.dim() - 1)) for x in xs]
        return reps[0] if len(reps) == 1 else tuple(reps)
    mesh.ParticleSharding.gather = alone
from perfbench.tests._small import small_cell
# the mesh mix's path with An-Schorfheide's likelihood, which the CPU
# runs in seconds (the mesh's code does not depend on the model)
cell = small_cell("as-16k-fixed", "12k-3blocks-multinomial-mesh4",
                  ranks=world)
cell.limits = dict(cell.limits, ranks_gap=0.0)
r = run.Rank("cpu", rank, world)
r.join(store)
res = run.run(cell, 123456789012, 0.1, False, r)
if res is not None:
    held = res["_held"]
    emitted = run.emit(dict(res))
    res.pop("_lines")
    json.dump(dict(res, held=held, emitted=emitted), open(out, "w"))
"""


def _mesh_run(fault: str = ""):
    with tempfile.TemporaryDirectory() as tmp:
        code = WORKER.replace("__ROOT__", repr(ROOT))
        out = os.path.join(tmp, "out.json")
        env = dict(os.environ, OMP_NUM_THREADS="1")
        procs = [subprocess.Popen(
            [sys.executable, "-c", code, str(r), "2",
             os.path.join(tmp, "store"), out, fault],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(2)]
        try:
            errs = [p.communicate(timeout=600)[1] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        assert all(p.returncode == 0 for p in procs), errs[0][-3000:]
        with open(out) as f:
            return json.load(f)


def test_a_sound_mesh_run_is_correct():
    res = _mesh_run()
    assert res["correct"], res["checks"]
    assert res["checks"]["ranks_gap"]["value"] == 0.0
    assert res["held"] == 0 and res["emitted"] == 0


def test_a_rank_that_holds_jax_leaves_no_result():
    res = _mesh_run("jax")
    assert res["held"] == 1 and res["emitted"] == 3


def test_the_exchange_left_out_is_caught():
    res = _mesh_run("exchange")
    assert not res["correct"]
    assert res["checks"]["ranks_gap"]["value"] > 0.0
