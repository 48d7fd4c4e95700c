"""idle_share (device): the share of the traced span in which no
operation ran on the card, 1 - (union of the device's busy intervals) /
(the span's length), in %."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
