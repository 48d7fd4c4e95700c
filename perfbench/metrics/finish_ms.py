"""finish_ms (smc.py smc()): the length of the program's
`smc.finish` span, from the end of the recursion's last chunk through the
final scalar read, the whole cloud and the weight matrices copied to the
host, per traced estimation, in ms."""

from perfbench import spans


def read(run):
    return spans.mean_span_ms(run, "smc.finish")
