"""The table of peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the 700 W limit), and the least time for a piece of work.

f64 runs on the FMA pipes at 33.5 TFLOP/s, and f64 products of two
matrices can run on the tensor cores (DMMA) at 67 TFLOP/s; the two units
run at once. HBM3 moves 3.35 TB/s. A share of these is a share of the
published peak: a card set below 700 W (nvidia-smi's power.limit, printed
beside every run) reaches less.
"""

PEAK_F64 = 33.5e12          # flop/s, FMA pipes
PEAK_F64_MMA = 67e12        # flop/s, tensor cores, matrix products
PEAK_BYTES = 3.35e12        # bytes/s, HBM3


def ops_ms(flop) -> float:
    """ms the operations need at the peaks: flop is a pair (matrix-product
    flop, other flop), the longer of the two units' times."""
    return max(flop[0] / PEAK_F64_MMA, flop[1] / PEAK_F64) * 1e3


def bound_ms(flop, nbytes):
    """(ms, "operations" | "bytes"): the least time for the work, the
    larger of the operations' time and the bytes over the memory rate."""
    t_ops, t_bytes = ops_ms(flop), nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
