"""A cell at a size the CPU runs in seconds, for the tests.

An estimation of 256 particles over 40 stages lies farther from the
reference posterior (posteriors/<config>.json, made at the cell's size)
than the cell's own estimations do, so the three numbers that compare with
it get limits of this size: sound runs here read up to about 1, 1.3 and 5,
a mutation that rejects every proposal 9, 7 and 24 or more, a correction
with the wrong tempering increment an mdd_table_gap of thousands. Every
other limit is the cell's own; the cell's limits for these three are read
at the cell's size on a card (control.py)."""

from __future__ import annotations

import json
import os

from perfbench import spec

N_PARTS, N_PHI = 256, 40
SMALL_LIMITS = {"post_mean_gap": 3.0, "post_sd_gap": 3.0,
                "mdd_table_gap": 15.0}
MIXES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "mixes")


def small_cell(name="as-16k-fixed", traffic=None, **mix_keys):
    """The cell `name` of BENCHMARK.json with its mix (or the mix
    `traffic`, updated by mix_keys) cut to N_PARTS particles over N_PHI
    schedule entries and one traced estimation, and the limits above."""
    bench = spec.read_benchmark()
    traffic = traffic or {w["name"]: w["traffic"]
                          for w in bench["workloads"]}[name]
    with open(os.path.join(MIXES, f"{traffic}.json")) as f:
        mix = json.load(f)
    mix["smc"].update(n_parts=N_PARTS, n_phi=N_PHI)
    mix.update(traced_estimations=1, **mix_keys)
    cell = spec.load_cell(name, bench, mix=mix)
    cell.limits = dict(cell.limits, **SMALL_LIMITS)
    return cell
