"""Models ported so far: the linear DSGE container, An-Schorfheide and the
two-parameter regression."""
