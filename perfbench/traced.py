"""What a per-layer metric's reader (metrics/<name>.py) is given: the
traced estimations, their trace, and the work their final clouds need.

A reader is a module with `read(run) -> float | None`; it returns None
where it finds nothing to read (a kernel the trace does not hold, a
counter of a mesh on one card), and the metric is then left out of the
result's line.
"""

from __future__ import annotations

import statistics
from typing import List, Optional

import torch

from perfbench import peaks, spec
from perfbench.kernels import _counts


class TracedRun:
    """The traced span of one run: `results` (the SMCResults of the
    estimations run inside it, in order), `walls` (their host-clock
    seconds), `trace` (trace.Trace, or None where no device was traced),
    the cell (`config`, `mix`, `reference`), the observations `data`, and
    `world` and `rank` (the particle mesh; 1 and 0 on one card)."""

    def __init__(self, results, walls, trace, cell, data, world=1, rank=0):
        self.results, self.walls, self.trace = results, walls, trace
        self.config, self.mix = cell.config, cell.mix
        self.reference, self.data = cell.reference, data
        self.world, self.rank = world, rank
        self._workloads = None

    @property
    def stages(self) -> int:
        """Real stages over the traced estimations (masked replays past
        the end not counted)."""
        return sum(len(r.cloud.tempering_schedule) - 1 for r in self.results)

    @property
    def replays(self) -> int:
        """Stages the recursion issued, masked ones included."""
        return self.stages + sum(r.masked_stages for r in self.results)

    @property
    def stage_ms(self) -> float:
        return 1e3 * sum(self.walls) / self.stages

    @property
    def workloads(self) -> List[_counts.Workload]:
        """The likelihood inputs of each traced estimation's final cloud,
        this rank's rows of it under a mesh (what its kernels see), built
        by the reference in float64."""
        if self._workloads is None:
            self._workloads = []
            for r in self.results:
                th = r.cloud.params.to(torch.float64)
                k = th.shape[0] // self.world
                th = th[self.rank * k:(self.rank + 1) * k]
                self._workloads.append(_counts.Workload(
                    *self.reference.inputs(th), self.data))
        return self._workloads

    def kernel_ms(self, kernel: str) -> List[float]:
        """Device ms of each launch of kernels/<kernel>.py's kernel in the
        trace."""
        if self.trace is None:
            return []
        name = spec.kernel_counts(kernel).TRACE_NAME
        return [d / 1e3 for d, _ in self.trace.kernels(rf"\b{name}<")]

    def roofline(self, kernel: str) -> Optional[float]:
        """% of its bound: the least time for the work the final clouds
        need (kernels/<kernel>.py at the peaks) over the median device
        time of the kernel's launches; None where the trace has none."""
        times = self.kernel_ms(kernel)
        if not times:
            return None
        counts = spec.kernel_counts(kernel)
        bound = statistics.mean(peaks.bound_ms(*counts.work(w))[0]
                                for w in self.workloads)
        return 100.0 * bound / statistics.median(times)

    def stage_mfu(self) -> Optional[float]:
        """% of the card's f64 peaks: the operations the stage's likelihood
        calls need (n_blocks calls of the configuration's kernels on the
        final cloud's particles, counted as for the rooflines) at the
        peaks, over the traced time per stage."""
        if self.trace is None or not self.trace.kernels():
            return None
        per_call = _counts.add(*(
            _counts.add(*(spec.kernel_counts(k).work(w)[0]
                          for k in self.config.KERNELS))
            for w in self.workloads))
        per_call = _counts.mul(1.0 / len(self.workloads), per_call)
        n_blocks = int(self.mix["smc"].get("n_blocks", 1))
        return 100.0 * peaks.ops_ms(_counts.mul(n_blocks, per_call)) \
            / self.stage_ms
