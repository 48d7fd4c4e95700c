"""init_ms (smc.py smc() and ops/initialization.py initial_draw):
the length of the program's `smc.init` span, from the first prior draw
(or a tempered update's or a resume's first step) to the recursion's
initial state, redraw rounds and their host reads included, per traced
estimation, in ms."""

from perfbench import spans


def read(run):
    return spans.mean_span_ms(run, "smc.init")
