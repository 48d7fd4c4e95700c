"""The check that decides `correct`, on the CPU at a small size (_small.py):
a sound run passes it, the float32 control fails it, and so does a run
whose timed path is broken underneath (a stage that returns its state
unchanged, half of the batch left out of the correction's mean, a
likelihood answer altered where it is produced, a mutation that rejects
every proposal, a correction with the wrong tempering increment). The look
for a card is skipped; the rest of a run (run.run) is driven as on a card.
The card test reads the control at each cell's own size."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)

from perfbench import check, control, faults, run, spec  # noqa: E402
from perfbench.tests._small import small_cell  # noqa: E402

SEED = 3_000_000_019
# the numbers the float32 control moves; it runs on the program's own
# cloud, so the posterior's comparison with the reference's reads as the
# program's does
CONTROLLED = ("loglh_gap", "weights_gap", "ess_gap", "mdd_gap",
              "schedule_gap", "posterior_gap")


def _cell():
    return small_cell()


def _run(cell, trace=False):
    return run.run(cell, SEED, 0.2, trace, run.Rank("cpu"))


def test_a_sound_run_is_correct():
    out = _run(_cell())
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "stage_ms", "estimation_s"}
    assert list(out["checks"]) == list(check.NUMBERS)
    assert out["_held"] == 0


def test_a_traced_run_on_the_cpu_writes_no_device_metric():
    out = _run(_cell(), trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"capture_s"}
    assert "busy_s" not in out["device"]


def _program():
    return sys.modules["smc_tpu_torch.smc"]


def test_a_stage_that_returns_its_state_unchanged_is_caught(monkeypatch):
    mod = _program()
    real = mod.make_recursion_step

    def frozen(*a, **k):
        step = real(*a, **k)
        return lambda draws, st: (st, step(draws, st)[1])

    monkeypatch.setattr(mod, "make_recursion_step", frozen)
    out = _run(_cell())
    assert not out["correct"]
    assert out["checks"]["schedule_gap"]["value"] == 1.0


def test_half_the_batch_left_out_of_the_mean_is_caught(monkeypatch):
    mod = _program()

    def half(loglh, old_loglh, weights, phi_n, phi_n1, *rest):
        from smc_tpu_torch.ops.correction import log_incremental_weights
        n, h = loglh.shape[0], loglh.shape[0] // 2
        log_inc = log_incremental_weights(loglh, old_loglh, phi_n, phi_n1,
                                          *rest)
        lw = torch.log(weights) + log_inc
        m = torch.max(lw[:h])
        shifted = torch.exp(lw - m)
        total = torch.sum(shifted[:h]) * (n / h)
        norm_w = n * shifted / total
        ess = n * n / torch.sum(norm_w * norm_w)
        return torch.exp(log_inc), norm_w, ess, m + torch.log(total / n)

    monkeypatch.setattr(mod, "correct", half)
    out = _run(_cell())
    assert not out["correct"]
    assert out["checks"]["mdd_gap"]["value"] > \
        out["checks"]["mdd_gap"]["limit"]


def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch):
    cell = _cell()
    program = cell.config.program

    def altered():
        loglike, params = program()

        def wrong(th, data):
            out = loglike(th, data).clone()
            out[::8] += 1e-3 * out[::8].abs()
            return out
        return wrong, params

    monkeypatch.setattr(cell.config, "program", altered)
    out = _run(cell)
    assert not out["correct"]
    assert out["checks"]["loglh_gap"]["value"] > \
        out["checks"]["loglh_gap"]["limit"]


@pytest.mark.parametrize("fault,number", [
    ("frozen_mutation", "post_sd_gap"), ("wrong_phi", "mdd_table_gap")])
def test_a_fault_that_the_bookkeeping_agrees_with_is_caught(fault, number):
    cell = _cell()
    with faults.FAULTS[fault]():
        out = _run(cell)
    assert not out["correct"]
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]


def test_the_float32_control_fails_and_the_program_passes():
    cell = _cell()
    for r in control.readings(cell, [SEED, 11, 2 ** 33 + 1],
                              run.Rank("cpu")):
        assert check.judge(r["program"], cell.limits, 0, 1), r
        assert not check.judge(r["control"], cell.limits, 0, 1), r
        # each number the control moves reads above its limit, its
        # likelihood's among the draws both keep finite included
        for k in CONTROLLED:
            assert r["control"][k] > cell.limits[k], (k, r)
        assert r["control_loglh_finite"] > cell.limits["loglh_gap"], r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["as-16k-fixed", "sw-4k-fixed"])
def test_the_control_fails_at_the_cells_own_size(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "control.py"),
         "--workload", workload, "--seeds", "101,202,303"],
        capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    cell = spec.load_cell(workload)
    for line in proc.stdout.strip().splitlines():
        r = json.loads(line)
        assert check.judge(r["program"], cell.limits, 0, 1), r
        assert not check.judge(r["control"], cell.limits, 0, 1), r
