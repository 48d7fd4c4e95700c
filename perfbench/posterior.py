#!/usr/bin/env python3
"""The reference posterior of a configuration, posteriors/<config>.json:
plain SMC estimations (reference/smc.py) at a cell's mix, one per seed,
averaged.

    python3 perfbench/posterior.py --workload CELL --seeds 1,2,3,4

Runs on a CUDA card where there is one (else on the CPU), in float64.
Prints one JSON line per seed as it ends, then the table, the file's
contents, as the last line: the mean over the seeds of each parameter's
posterior mean and sd and of the log-MDD, with every seed's values and
the settings it was made with.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated whole numbers")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    from perfbench import run, spec
    from perfbench.reference import smc
    cell = spec.load_cell(args.workload)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    data = np.load(os.path.join(ROOT, cell.config.DATA))
    runs = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = smc.estimate(cell.reference, data, cell.mix["smc"], seed,
                         device=device)
        r.update(seed=seed, seconds=time.perf_counter() - t)
        runs.append(r)
        print(json.dumps(r), flush=True)
    mean = lambda key: np.mean([r[key] for r in runs], axis=0).tolist()
    table = {"mean": mean("mean"), "sd": mean("sd"),
             "log_mdd": float(np.mean([r["log_mdd"] for r in runs])),
             "names": [p[0] for p in cell.reference.PRIORS],
             "made_with": {"workload": args.workload,
                           "smc": cell.mix["smc"], "device": (
                               torch.cuda.get_device_name(0)
                               if device != "cpu" else "cpu"),
                           "card": run._smi() if device != "cpu" else None},
             "runs": runs}
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
