"""capture_s (driver, smc.py FusedRecursion): the seconds a fused
estimation spends capturing its stage as a CUDA graph, the mean of
SMCResult.capture_seconds over the traced estimations."""

import statistics


def read(run):
    if not run.results:
        return None
    return statistics.mean(r.capture_seconds for r in run.results)
