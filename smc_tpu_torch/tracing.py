"""Spans at the layer boundaries of smc(), for a torch profiler's trace.

`span(name)` is a `torch.profiler.record_function` range while a torch
profiler records (`torch.profiler.profile`, `smc(profile_dir=...)`): the
range lands in the profiler's trace as a "user_annotation" event on the
clock of the card's events, so each idle gap on the card can be put down to
what the program was doing. While no profiler records it is one shared
no-op context: a flag read, no allocation and no op dispatched (entering
and leaving a record_function costs ~13 us even with no profiler). The
profiler keeps the spans; nothing here stores them.

The spans, nested as they run (the nesting is the parent link; the spans
of one call share its `smc.estimation`):

  smc.estimation   the whole smc() call
    smc.init         fresh draw, tempered update / bridge, or resume
      smc.init.round   initial_draw's first evaluation, each redraw round
    smc.chunk        a chunk of the fused loop: its stages issued, its read
      smc.stage        a stage whose host code runs: the eager first stage
                       (each stage on the CPU), each host-loop stage
      smc.capture      the capture of the stage as a CUDA graph
      smc.read         the chunk's read; the final scalar read (in finish)
    smc.finish       final reads, the whole cloud, the weight matrices to
                     the host, the writes
  inside a stage or the capture: smc.correction, smc.selection,
  smc.mutation; inside a round, stage or capture: smc.likelihood (each
  batched likelihood call), and inside it, for a LinearDSGE with
  expectation rows, smc.likelihood.expectations (the rows filled from the
  solved transition, models/dsge.py, ops/cuda_dsge_general.py); wherever a
  mesh gathers on the host: smc.gather.

No span opens around a graph replay: no host code runs inside one.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A record_function range `name` while a torch profiler records, else
    a no-op context."""
    if profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
