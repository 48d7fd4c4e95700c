"""SMC stage operations and the hand-written DSGE likelihood kernels."""
