#!/usr/bin/env python3
"""The two readings each limit of limits/<cell>.json is set between.

    python3 perfbench/control.py --workload CELL --seeds 1,2,3 [--fault F]

One process: the cell's set-up once, then for each seed one estimation at
the cell's own size through the timed entry (smc_tpu_torch.smc with the
cell's mix), and two readings of every number of check.py:

  program  the estimation's answers against the float64 reference: the
           lower reading, the largest of which over a dozen seeds or more
           sets the floor of the limit;
  control  the same reference computed in float32 and put in the
           program's place (its likelihood of the final cloud, its
           bookkeeping from the estimation's weights cast to float32, its
           schedule and posterior mean): the upper reading, the smallest
           of which over three seeds or more sets the ceiling; with
           control_loglh_finite, its likelihood's largest relative gap
           over the draws that both keep finite.

With --fault F (faults.py) the estimations run with that fault planted
in the timed path, and the program's readings are the fault's: the upper
reading of the numbers that compare the posterior with the reference's
(post_mean_gap, post_sd_gap, mdd_table_gap), which the float32 control,
run on the program's own cloud, does not move.

The port computes in float64 throughout and its kernels take only
float64, so it has no lower-precision path of its own; the control is made
from the benchmark's own reference. Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def readings(cell, seeds, rank, fault=None):
    """[{seed, program: {number: gap}, control: {number: gap},
    control_loglh_finite}] for one estimation per seed on `rank` (a
    run.Rank), with faults.FAULTS[fault] planted where given."""
    import contextlib
    import numpy as np
    import torch
    import smc_tpu_torch
    from perfbench import check, faults, run
    if rank.cuda:
        run.build_libraries(cell.config.LIBRARIES)
    loglike, parameters = cell.config.program()
    data = np.load(os.path.join(ROOT, cell.config.DATA))
    kw = dict(cell.mix["smc"], batched=True, verbose="none", testing=True,
              device=rank.device)
    out = []
    planted = faults.FAULTS[fault] if fault else contextlib.nullcontext
    for seed in seeds:
        with planted():
            res = smc_tpu_torch.smc(loglike, parameters, data,
                                    **dict(kw,
                                           seed=run.estimation_seed(seed, 0)))
        rec = check.Record.of(res)
        del res
        ref = check.reference_outputs(rec, cell.reference, data,
                                      cell.mix["smc"])
        ctl = check.reference_outputs(rec, cell.reference, data,
                                      cell.mix["smc"], dtype=torch.float32)
        out.append({"seed": seed, "fault": fault,
                    "program": check.gaps(check.program_outputs(rec), ref,
                                          cell.posterior),
                    "control": check.gaps(ctl, ref, cell.posterior),
                    "control_loglh_finite": check.loglh_finite_gap(ctl,
                                                                   ref)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    ap.add_argument("--fault", default=None,
                    help="plant this fault of faults.py")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import run, spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("control.py runs on a CUDA card", file=sys.stderr)
        return run.NO_RESULT
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(cell, seeds, run.Rank("cuda:0"), args.fault):
        print(json.dumps({"workload": args.workload, **r}, default=str),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
