"""stage_mfu (the whole stage): the f64 operations a stage's likelihood
calls need (n_blocks calls of the configuration's kernels on the final
clouds' particles, counted as for the rooflines), at the card's f64 peaks,
over the traced time per stage, in %."""


def read(run):
    return run.stage_mfu()
