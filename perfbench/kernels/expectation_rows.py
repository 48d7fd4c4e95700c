"""The expectation rows of a DSGE measurement (smc_tpu_torch
csrc/dsge_expectations.cu expectation_rows_kernel<N>, a block per
particle): for each accepted particle each base row's chain v <- v X to
the last horizon of the rows it feeds (a vector-matrix product a step, on
the FMA pipes), the sums and the means; it reads X of the accepted
particles, the rows of Z it does not fill (all of them for a rejected
particle) and ok, and writes Z whole.

The rows, (obs, base, first, last) with row obs the mean over h =
first..last of Z[base] X^h, are the workload's own: a configuration's
reference whose inputs() fills such rows records them on the Z it returns
(`Z.expectation_rows`), since a workload carries nothing else of its
configuration."""

from perfbench.kernels import _counts as c

TRACE_NAME = "expectation_rows_kernel"


def rows_of(w: c.Workload) -> tuple:
    """The expectation rows the workload's Z was filled with; ValueError
    where its reference recorded none."""
    rows = getattr(w.Z, "expectation_rows", ())
    if not rows:
        raise ValueError("the workload's Z records no expectation rows: its "
                         "reference's inputs() fills none")
    return tuple(rows)


def flops(n_s, rows):
    """flop of one accepted particle: 2 n_s^2 a chain step, an addition
    per entry a horizon a row holds, and a division per entry a row."""
    h_max = {}
    for _, base, _, last in rows:
        h_max[base] = max(h_max.get(base, 0), last)
    chain = sum(h_max.values()) * 2 * n_s * n_s
    sums = sum(last - first + 1 for _, _, first, last in rows) * n_s
    return c.f(other=chain + sums + len(rows) * n_s)


def work(w: c.Workload):
    """(flop pair, bytes) of one launch on the workload's particles."""
    rows = rows_of(w)
    n_ok = int(w.solution[2].sum())
    n_s, n_o, r = w.n_s, w.n_o, len(rows)
    nbytes = (n_ok * 8 * (n_s * n_s + (n_o - r) * n_s)
              + (w.n - n_ok) * 8 * n_o * n_s + w.n * (1 + 8 * n_o * n_s))
    return c.mul(n_ok, flops(n_s, rows)), nbytes
