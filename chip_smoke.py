#!/usr/bin/env python3
"""GPU smoke run of smc_tpu_torch: build the CUDA kernels, hold them against
their plain PyTorch versions, run the An-Schorfheide estimation through
smc_tpu_torch.smc on the card, then the rest of smc()'s paths:

  (a) the linear fixture at the JAX package's bench.py configuration;
  (b) AS with the adaptive schedule;
  (c) the linear fixture with Metropolis resampling, and the Metropolis
      chain kernel against its plain version;
  (d) checkpoint and resume of the linear fixture, bitwise;
  (e) tempered update and bridge distribution from half the linear data;
  (f) Smets-Wouters at 4,096 particles (the reference's production model)
      on the general-shape DSGE kernels;
  (g) An-Schorfheide on two observables at 16,384 particles, on the same
      kernels;
  (h) CAPM at five seeds;
  (i) the particle mesh: AS-16k under smc(mesh=particle_mesh()) on one
      NCCL rank (fused, and once on the host loop), on two gloo ranks
      sharing the card (the host loop), and on one NCCL rank per card
      where there are two or more (fused);
  (j) the fused recursion against the host loop: AS-16k, adaptive AS-16k,
      the linear fixture and (c)'s Metropolis run again with fused=False at
      the same seeds (bit for bit), SW and AS-2obs timed both ways, and the
      Jacobi eigh kernel against torch.linalg.eigh at the mutation's block
      shapes;
  (k) the example scripts of examples/torch/ at their own configurations,
      each log-MDD gated against the JAX script's;
  (l) Smets-Wouters with FRBNY m1002's inflation target and forward
      guidance (models/sw_pi_fg.py: 44 states, 14 observables) at (f)'s
      configuration, through the general kernels with the expectation-rows
      kernel between them: that kernel against its plain version, the
      whole likelihood against the plain route, and the Kalman kernel on
      rows of 16 timed on the model's prior and posterior draws and on
      synthetic draws (with --other, in turns against another tree's
      build, outputs compared bit for bit).

Before the main path, the shape phase holds both DSGE kernels at every
(n_state, n_shock) of their domain (1..8 each, n_obs 3) against their plain
versions on synthetic systems, each shape's likelihood first called once
through a LinearDSGE (its launches are the kernels line's). The general
phase then holds the general-shape DSGE kernels (the "plain" backend's on
the card: Smets-Wouters, AS-2obs) against their plain versions at SW's and
AS-2obs's shapes and at synthetic shapes with 1, 2, 3 and 7 observables,
and times one SW likelihood call at 12,000 draws; their launches in the
kernels line are phase (f)'s.

The main path and phases (a)-(c), (e)-(h), (l) and the NCCL mesh run the fused
recursion, smc()'s automatic choice at verbose="none": each stage a replay
of one captured CUDA graph (under the mesh with its collectives). The gloo
mesh on the card runs the host loop, by the same choice; (d) checkpoints,
so it runs the host loop too.

    python3 chip_smoke.py                 # all phases
    python3 chip_smoke.py --other DIR     # all phases; (l) also times DIR's
                                          # Kalman kernel (another csrc/)
    python3 chip_smoke.py --mesh-only     # the build, the AS main path and
                                          # phase (i) alone (i.3 on every
                                          # card: --chips 4)

Needs one CUDA card and nvcc (the kernels are built from csrc/ at first
use, one nvcc per library, all at once: the DSGE kernels in one library per
n_state). Every phase raises on failure and the script exits nonzero; it
never falls back to the CPU. The line before the last is a JSON object with
each kernel's launches on the main path (an entry of the shape phase,
named with its <n_state,n_shock>: in its model's likelihood call), error
against its plain version, time (the mean of 20 back-to-back calls),
its plain version's time, its bound (the least time for the work these
inputs need, from the f64 peak and the memory rate) and the library call's
time where one PyTorch call computes the same function; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# the inputs and tolerances shared with the tests (tests/torch_parity.py)
sys.path.insert(0, os.path.join(HERE, "tests"))

AS_N_PARTS = 16_384
AS_N_PHI = 100
REF_LOG_MDD = -1416.22     # JAX package, same data and configuration
REF_LOG_MDD_ADAPTIVE = -1416.05   # JAX package, adaptive schedule (0.97)
MDD_TOL = 3.0              # nats
# the linear fixture at bench.py's configuration; the JAX package's log-MDD
# over seeds 0-4 on a CPU (tests/torch_linear_band.py) spans
# [-626.4052, -599.0195]; the gate widens that by 5 nats each side
LIN_N_PARTS = 32_768
LIN_CONFIG = dict(n_parts=LIN_N_PARTS, n_phi=120, lam=2.1, n_blocks=3,
                  n_mh_steps=1, alpha=0.9, resampling_method="systematic",
                  verbose="none")
LIN_BAND = (-626.4052078903568 - 5.0, -599.0194509045155 + 5.0)
LIN_MEAN_TOL = 0.5         # of the exact posterior mean
AS_CONFIG = dict(batched=True, n_parts=AS_N_PARTS, n_phi=AS_N_PHI, lam=2.0,
                 n_blocks=1, alpha=0.9, resampling_method="systematic",
                 verbose="none")
OK_AGREE_MIN = 0.9999
XM_RTOL = 1e-10
LL_RTOL = 1e-9             # over the posterior band (50 nats of the best)
# Smets-Wouters at the reference dsge_model.jl's configuration
SW_N_PARTS = 4_096
SW_CONFIG = dict(batched=True, n_parts=SW_N_PARTS, n_phi=100, lam=2.1,
                 n_blocks=3, alpha=0.9, resampling_method="multinomial",
                 verbose="none")
SW_CMP_DRAWS = 1_024      # prior draws, card against CPU
SW_CMP_POSTERIOR = 256    # and particles of (f)'s final cloud
# AS-2obs: the JAX package's log-MDD at AS_CONFIG on load_as_data()[:2],
# seed 0 (seeds 1 and 2: -946.9598, -946.9346), printed by
# `JAX_PLATFORMS=cpu python tests/test_torch_as2obs.py`
REF_LOG_MDD_AS2 = -946.9788833516116
# CAPM at the JAX package's tests/test_capm.py configuration
CAPM_CONFIG = dict(n_parts=5_000, n_phi=100, lam=2.1, alpha=0.9,
                   resampling_method="systematic", verbose="none")
CAPM_SEEDS = (42, 0, 1, 2, 3)
CAPM_TRUE = (0.1, 0.8, 0.5, 0.2, 1.0, 0.5, 0.3, 1.2, 0.5)
# the wider tail of SW's Chandrasekhar recursion (tests/test_torch_sw.py);
# the other likelihood bands (card against CPU) are tests/torch_parity.py's
SW_TAIL_RTOL = 1e-3
# (i) the particle mesh: several ranks against one rank, and how long the
# spawned ranks may take in all
MESH_RTOL = 1e-9
MESH_TIMEOUT = 600         # seconds
MESH_PG_TIMEOUT = 300      # seconds a collective waits for the other ranks


def smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: command not found"
    p = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return (p.stdout.strip().splitlines() or [p.stderr.strip()])[0]


def ptxas_lines(log: str):
    """One line per kernel instantiation from nvcc -Xptxas -v output:
    registers, stack, spill stores and loads."""
    import re
    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(re_kernel|kalman_kernel)ILi(\d+)ELi(\d+)E",
                          m.group(1))
            gen = re.search(r"(re_general_kernel|kalman_general_kernel|"
                            r"expectation_rows_kernel)ILi(\d+)E(?:Li(\d+)E)?",
                            m.group(1))
            name = (f"{k.group(1)}<{k.group(2)},{k.group(3)}>" if k else
                    f"{gen.group(1)}<{gen.group(2)}>" if gen and
                    gen.group(3) is None else
                    f"{gen.group(1)}<{gen.group(2)},{gen.group(3)}>" if gen
                    else
                    "eigh_kernel" if "eigh_kernel" in m.group(1) else
                    "metropolis_kernel" if "metropolis_kernel" in m.group(1)
                    else m.group(1))
        elif "spill stores" in line:
            frame = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            used = line.split(":", 1)[-1].strip()
            out.append(f"{name}: {used}; {frame}")
            name = None
    return out


def ptxas_table(libs) -> dict:
    """{instantiation: "registers; stack and spills"} over the libraries'
    build logs (ptxas_lines' lines, keyed by name)."""
    out = {}
    for lib in libs.values():
        for line in ptxas_lines(lib.with_suffix(".log").read_text()):
            name, rest = line.split(": ", 1)
            out[name] = rest
    return out


def cuda_ms(fn, reps: int, batches: int = 5) -> float:
    """Median over `batches` of the mean ms per call of `reps` back-to-back
    calls of fn between two CUDA events, after one warm-up call: the device
    runs the launches back to back, so the host's time per call is hidden
    behind the kernels' (syncing after each call would add it in)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int, batches: int = 5) -> float:
    """Device time per call of fn: `reps` calls captured in one CUDA graph
    after a warm-up call, the median over `batches` replays between two
    CUDA events, divided by `reps`. A replay issues no host work per call,
    so a kernel that takes less time than its wrapper's host code (where
    cuda_ms measures the host) shows its own time."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def once_ms(fn) -> float:
    """ms of one call of fn between two CUDA events, after the queue has
    drained (for the plain versions, whose single call lasts long enough
    that its launches, not the events, set the time)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): f64 on the
# FMA pipes, f64 matrix products on the tensor cores (DMMA), HBM3 bandwidth
PEAK_F64 = 33.5e12          # flop/s
PEAK_F64_MMA = 67e12        # flop/s
PEAK_BYTES = 3.35e12        # bytes/s
# instructions issued: 4 schedulers per SM, one warp instruction (32
# threads) each per clock, x 132 SMs x 1.98 GHz boost; the peak of a stream
# of integer and f64 instructions that no one pipe limits
PEAK_ISSUE = 132 * 4 * 32 * 1.98e9  # thread-instructions/s


# flop counts are pairs (matrix-product flop, other flop): the products of
# two matrices can run on the tensor cores (PEAK_F64_MMA); the rest
# (elimination, factors, matrix-vector products, elementwise work) on the
# FMA pipes (PEAK_F64)


def _f(prod=0, other=0):
    return (prod, other)


def _add(*fs):
    return tuple(map(sum, zip(*fs)))


def _mul(c, f):
    return (c * f[0], c * f[1])


def gj_flops(n, w):
    """Gauss-Jordan on n x w: per pivot, w-1-k normalizing multiplies and
    (n-1)(w-1-k) eliminating FMAs (2 flop each); none a matrix product."""
    return _f(other=sum((w - 1 - k) * (1 + 2 * (n - 1)) for k in range(n)))


def re_flops(ns, nk, cr_iters):
    """flop of the RE solve of one particle that runs `cr_iters` cyclic-
    reduction iterations (the work of dsge_particle.cuh re_solve_warp)."""
    prod = _f(prod=2 * ns ** 3)
    sq = lambda c: _f(other=c * ns * ns)
    per_iter = _add(gj_flops(ns, 3 * ns), _mul(4, prod), sq(4))
    spectral = _add(_mul(12, _add(prod, sq(3))), sq(2))
    tail = _add(gj_flops(ns, 2 * ns), prod, sq(1),       # X, then B + C X
                gj_flops(ns, 2 * ns + nk),                # M and Fwd
                _mul(3, prod), sq(2),                     # residual
                _mul(2, spectral))
    return _add(_mul(cr_iters, per_iter), tail)


def psd_solve_flops(no, m):
    """flop of one PSD innovation solve with m right-hand sides: the 3x3
    cofactor form (kalman_warp's), or Cholesky and two triangular solves."""
    if no == 3:
        return 2 * 6 + 5 + 1 + m * (3 * 5 + 1)
    return 2 * no ** 3 // 3 + 2 * no * no * m


def kalman_flops(ns, nk, lyap_iters, n_t, no=3):
    """flop of the Kalman filter of one ok particle (kalman_warp, or the
    plain Chandrasekhar filter at any n_obs): R Q R', the doubling steps,
    the set-up of F, K, M and n_t Chandrasekhar steps."""
    setup = _f(prod=2 * ns * nk * nk + 2 * ns * ns * nk)
    per_doubling = _f(prod=3 * 2 * ns ** 3, other=ns * ns)
    first = _f(prod=2 * ns * ns * no * 2 + 2 * no * no * ns,
               other=60 if no == 3 else psd_solve_flops(no, no))
    per_step = _f(
        prod=(2 * no * no * ns                                # Z W
              + 2 * no ** 3 + 2 * ns * no * no                # M W'Z', W M W'Z'
              + 2 * ns * ns * no + 2 * ns * no * no           # new W
              + 2 * ns * ns * no                              # new K
              + 2 * no * no * ns                              # new F
              + 2 * 2 * no ** 3),                             # new M
        other=(2 * no * ns + 2 * no                           # Z s, v
               + psd_solve_flops(no, 1 + no) + 10             # solve, quad
               + 2 * ns * ns + 2 * ns * no + ns               # s
               + ns * no                                      # new K
               + no * no + 6                                  # new F
               + psd_solve_flops(no, no) + no * no + 6
               + 8))                                          # new M, guards
    return _add(setup, _mul(lyap_iters, per_doubling), first,
                _mul(n_t, per_step))


def kalman_general_flops(ns, nk, lyap_iters, n_t, no):
    """flop of kalman_block's filter of one ok particle (the general-shape
    kernel): kalman_flops' set-up and doubling, and steps regrouped as the
    kernel forms them: Z U = (Z W)(M W'Z') and K' = K + (T W)(M W'Z'), so
    neither U = W M W'Z' nor the n_state-long T U is formed, and one factor
    a step (F''s, which serves the next step's solve too)."""
    setup = _f(prod=2 * ns * nk * nk + 2 * ns * ns * nk)
    per_doubling = _f(prod=3 * 2 * ns ** 3, other=ns * ns)
    first = _f(prod=2 * ns * ns * no * 2 + 2 * no * no * ns,
               other=60 if no == 3 else psd_solve_flops(no, no))
    rhs = lambda m: psd_solve_flops(no, m) - psd_solve_flops(no, 0)
    per_step = _f(
        prod=(2 * no * no * ns                                # Z W
              + 2 * no ** 3 + 2 * no ** 3                     # M W'Z', Z U
              + 2 * ns * ns * no + 2 * ns * no * no           # new W
              + 2 * ns * no * no                              # new K
              + 2 * 2 * no ** 3),                             # new M
        other=(2 * no * ns + 2 * no                           # Z s, v
               + rhs(1 + no) + 10                             # solve, quad
               + 2 * ns * ns + 2 * ns * no + ns               # s
               + ns * no                                      # new K
               + no * no + 6                                  # new F
               + psd_solve_flops(no, 0) + rhs(no) + no * no + 6
               + 8))                                          # new M, guards
    return _add(setup, _mul(lyap_iters, per_doubling), first,
                _mul(n_t, per_step))


def cr_iterations(A, B, C, n_iter=16):
    """Per particle, the cyclic-reduction iterations the kernels run on
    these inputs (the exit rule of re_solve_warp), with the plain steps."""
    import torch
    from smc_tpu_torch.ops.linalg import bl_gj_solve, bl_matmul
    n = A.shape[0]
    amax = lambda t: t.abs().amax(dim=(0, 1))
    finite = lambda t: torch.isfinite(t).all(dim=0).all(dim=0)
    fin = finite(A) & finite(B) & finite(C)
    scale = torch.where(fin, torch.maximum(torch.maximum(amax(A), amax(B)),
                                           amax(C)), 0.0)
    tol_exit = scale.clamp(min=1.0) * 2.0 ** -27
    iters = torch.full((A.shape[-1],), n_iter, device=A.device)
    running = torch.ones(A.shape[-1], dtype=torch.bool, device=A.device)
    A0, A1, A2 = A, B, C
    for it in range(n_iter):
        nan = torch.isnan(A0).any(0).any(0) | torch.isnan(A2).any(0).any(0)
        stop = running & ~nan & (torch.maximum(amax(A0), amax(A2))
                                 <= tol_exit)
        iters[stop] = it
        running &= ~stop
        SA = bl_gj_solve(A1, torch.cat([A0, A2], dim=1))
        SA0, SA2 = SA[:, :n], SA[:, n:]
        A2SA0 = bl_matmul(A2, SA0)
        A1 = A1 - bl_matmul(A0, SA2) - A2SA0
        A0, A2 = -bl_matmul(A0, SA0), -bl_matmul(A2, SA2)
    return iters


def lyapunov_iterations(T, n_iter=30):
    """Per particle, the doubling steps the Kalman kernel runs (exit once
    max|A_k| <= 1e-20, never on a NaN)."""
    import torch
    from smc_tpu_torch.ops.linalg import bl_matmul
    iters = torch.full((T.shape[-1],), n_iter, device=T.device)
    running = torch.ones(T.shape[-1], dtype=torch.bool, device=T.device)
    Ak = T
    for it in range(n_iter):
        nan = torch.isnan(Ak).any(0).any(0)
        stop = running & ~nan & (Ak.abs().amax(dim=(0, 1)) <= 1e-20)
        iters[stop] = it
        running &= ~stop
        Ak = bl_matmul(Ak, Ak)
    return iters


def bound_ms(flop, nbytes):
    """The least time for the work: the larger of the operations' time and
    bytes over the memory rate, and which of the two sets it. flop is a
    pair (matrix-product flop, other flop): the products at the tensor
    cores' f64 peak, the rest at the FMA pipes', the two units running at
    once (so the longer of the two times)."""
    t_ops = max(flop[0] / PEAK_F64_MMA, flop[1] / PEAK_F64) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_phase(dev):
    import torch
    from torch_parity import normwise_rel
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    from smc_tpu_torch.models import as_dsge
    from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                           bl_kalman_loglike_chandrasekhar)
    from smc_tpu_torch.ops import cuda_dsge

    space = ParamSpace(as_dsge.an_schorfheide_parameters())
    th = space.sample_prior(TorchDraws(1, dev), AS_N_PARTS, device=dev)
    A, B, C, D = as_dsge._system(th)
    Q = as_dsge._shock_cov(th)
    d, Z, H = as_dsge._measurement(th)
    data = torch.as_tensor(as_dsge.load_as_data(), device=dev).contiguous()

    # --- B1: RE solve against its plain version on the card ---------------
    X, M, ok = cuda_dsge.solve_linear_re(A, B, C, D)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    torch.cuda.synchronize()
    agree = (ok == okp).double().mean().item()
    bad_lanes = torch.nonzero(ok != okp).flatten().tolist()
    for j in bad_lanes:
        print(f"# re ok disagrees on lane {j}: kernel={bool(ok[j])} "
              f"plain={bool(okp[j])} theta={th[j].tolist()}")
    both = ok & okp
    x_rel = normwise_rel(X[..., both], Xp[..., both]).max().item()
    m_rel = normwise_rel(M[..., both], Mp[..., both]).max().item()
    re_abs = max((X[..., both] - Xp[..., both]).abs().max().item(),
                 (M[..., both] - Mp[..., both]).abs().max().item())
    print(f"# re: ok {int(ok.sum())}/{AS_N_PARTS} (plain {int(okp.sum())}), "
          f"agreement {agree:.6f}, max rel err X {x_rel:.3e} M {m_rel:.3e}")
    if not (agree >= OK_AGREE_MIN and x_rel <= XM_RTOL and m_rel <= XM_RTOL):
        raise RuntimeError("RE kernel disagrees with its plain version")

    # --- B2 + composition: full likelihood against the plain path ----------
    ll = cuda_dsge.dsge_loglike(A, B, C, D, Q, Z, d, H, data)
    llp = torch.where(okp, bl_kalman_loglike_chandrasekhar(
        Xp, Mp, Q, Z, d, H, data), float("-inf"))
    fin = torch.isfinite(ll) & torch.isfinite(llp)
    band = fin & (llp > llp[fin].max() - 50.0)
    ll_rel = ((ll[band] - llp[band]).abs() / llp[band].abs()).max().item()
    ll_abs = (ll[band] - llp[band]).abs().max().item()
    n_pattern = int((torch.isfinite(ll) != torch.isfinite(llp)).sum())
    print(f"# loglike: {int(band.sum())} posterior-band lanes, max rel err "
          f"{ll_rel:.3e} (gate {LL_RTOL:g}); finite-pattern disagreements "
          f"{n_pattern}")
    if not (int(band.sum()) > 10 and ll_rel <= LL_RTOL):
        raise RuntimeError("likelihood kernels disagree with the plain path")

    # --- the 3-state system of the kernel tests ----------------------------
    n_t = 64
    g = torch.Generator(device=dev).manual_seed(5)
    rho = 0.2 + 0.6 * torch.rand((3, n_t), generator=g, dtype=torch.float64,
                                 device=dev)
    eye = torch.eye(3, dtype=torch.float64, device=dev)[:, :, None]
    At = torch.zeros((3, 3, n_t), dtype=torch.float64, device=dev)
    for i in range(3):
        At[i, i] = -rho[i]
    Bt = eye.expand(3, 3, n_t).contiguous()
    Ct = torch.zeros_like(At)
    Dt = -Bt.clone()
    Qt = Bt.clone()
    Zt = 1.5 * Bt
    dt = torch.zeros((3, n_t), dtype=torch.float64, device=dev)
    Ht = 0.1 * Bt
    yt = torch.randn((3, 5), generator=g, dtype=torch.float64, device=dev)
    llt = cuda_dsge.dsge_loglike(At, Bt, Ct, Dt, Qt, Zt, dt, Ht, yt)
    Xs, Ms, oks = bl_solve_linear_re(At, Bt, Ct, Dt)
    llts = bl_kalman_loglike_chandrasekhar(Xs, Ms, Qt, Zt, dt, Ht, yt)
    tiny_rel = ((llt - llts).abs() / llts.abs()).max().item()
    print(f"# 3-state system: max rel err {tiny_rel:.3e}")
    if not (bool(oks.all()) and tiny_rel <= 1e-12):
        raise RuntimeError("3-state system disagrees")

    # --- a NaN particle leaves its neighbours bitwise unchanged ------------
    j = AS_N_PARTS // 2 + 3
    A_nan = A.clone()
    A_nan[:, :, j] = float("nan")
    X2, M2, ok2 = cuda_dsge.solve_linear_re(A_nan, B, C, D)
    ll2 = cuda_dsge.dsge_loglike(A_nan, B, C, D, Q, Z, d, H, data)
    keep = torch.ones(AS_N_PARTS, dtype=torch.bool, device=dev)
    keep[j] = False
    same = (torch.equal(X2[..., keep], X[..., keep])
            and torch.equal(M2[..., keep], M[..., keep])
            and torch.equal(ok2[keep], ok[keep])
            and torch.equal(ll2[keep], ll[keep]))
    print(f"# NaN particle {j}: ok={bool(ok2[j])} loglh={ll2[j].item()}, "
          f"neighbours bitwise unchanged: {same}")
    if not (same and not bool(ok2[j]) and ll2[j].item() == float("-inf")):
        raise RuntimeError("a NaN particle changed other particles")

    # --- ragged particle counts against the plain versions -----------------
    first_finite = int(torch.nonzero(torch.isfinite(llp))[0])
    for j0, n_r in ((0, AS_N_PARTS - 1), (first_finite, 1)):
        cut = slice(j0, j0 + n_r)
        sl = [t[..., cut].contiguous() for t in (A, B, C, D, Q, Z, d, H)]
        Xr, Mr, okr = cuda_dsge.solve_linear_re(*sl[:4])
        llr = cuda_dsge.kalman_chandrasekhar(Xr, Mr, *sl[4:], data, ok=okr)
        Xq, Mq, okq = Xp[..., cut], Mp[..., cut], okp[cut]
        llq = llp[cut]
        both_r = okr & okq
        agree_r = (okr == okq).double().mean().item()
        err_r = max(normwise_rel(Xr[..., both_r], Xq[..., both_r]).max().item(),
                    normwise_rel(Mr[..., both_r], Mq[..., both_r]).max().item())
        fin_r = torch.isfinite(llr) & torch.isfinite(llq)
        band_r = fin_r & (llq > llq[fin_r].max() - 50.0)
        ll_err_r = ((llr[band_r] - llq[band_r]).abs()
                    / llq[band_r].abs()).max().item()
        print(f"# ragged N={n_r}: ok agreement {agree_r:.6f}, X/M max rel err "
              f"{err_r:.3e}, loglike max rel err {ll_err_r:.3e} over "
              f"{int(band_r.sum())} band lanes")
        if not (agree_r >= OK_AGREE_MIN and err_r <= XM_RTOL
                and ll_err_r <= LL_RTOL and bool(band_r.any())):
            raise RuntimeError(f"ragged N={n_r} disagrees with the plain "
                               "versions")

    # --- the work these inputs need, and its bound --------------------------
    n_s, n_k = A.shape[0], D.shape[1]
    cr_it = cr_iterations(A, B, C)
    ly_it = lyapunov_iterations(X[..., ok])
    re_flop = _work_flop(cr_it, lambda i: re_flops(n_s, n_k, i))
    kal_flop = _work_flop(ly_it, lambda i: kalman_flops(n_s, n_k, i,
                                                        data.shape[1]))
    re_bytes = AS_N_PARTS * (8 * (3 * n_s * n_s + n_s * n_k)
                             + 8 * (n_s * n_s + n_s * n_k) + 1)
    kal_bytes = (AS_N_PARTS * (8 * (n_s * n_s + n_s * n_k + n_k * n_k
                                    + 3 * n_s + 3 + 9) + 1 + 8)
                 + 8 * data.numel())
    re_bound, re_by = bound_ms(re_flop, re_bytes)
    kal_bound, kal_by = bound_ms(kal_flop, kal_bytes)
    print(f"# work: cyclic reduction {cr_it.double().mean().item():.4f} "
          f"iterations per particle (max {int(cr_it.max())}), doubling "
          f"{ly_it.double().mean().item():.4f} (max {int(ly_it.max())}) over "
          f"{int(ok.sum())} ok particles; re {_flop_str(re_flop)} "
          f"{re_bytes} B, bound {re_bound:.4f} ms ({re_by}); kalman "
          f"{_flop_str(kal_flop)} {kal_bytes} B, bound {kal_bound:.4f} ms "
          f"({kal_by})")

    # --- times at the main path's shapes -----------------------------------
    re_ms = cuda_ms(lambda: cuda_dsge.solve_linear_re(A, B, C, D), 20)
    kal_ms = cuda_ms(lambda: cuda_dsge.kalman_chandrasekhar(
        X, M, Q, Z, d, H, data, ok=ok), 20)
    re_plain_ms = cuda_ms(lambda: bl_solve_linear_re(A, B, C, D), 2, 3)
    kal_plain_ms = cuda_ms(lambda: torch.where(okp, bl_kalman_loglike_chandrasekhar(
        Xp, Mp, Q, Z, d, H, data), float("-inf")), 2, 3)
    print(f"# times at N={AS_N_PARTS} (median ms): re kernel {re_ms:.4f} "
          f"({100 * re_bound / re_ms:.1f}% of bound) plain {re_plain_ms:.4f}; "
          f"kalman kernel {kal_ms:.4f} ({100 * kal_bound / kal_ms:.1f}% of "
          f"bound) plain {kal_plain_ms:.4f}")
    return [
        dict(name="re_solve", route="cuda",
             source="smc_tpu_torch/csrc/dsge_kernels.cu",
             replaces="smc_tpu/ops/pallas_dsge.py:259",
             max_abs_err=re_abs, ms=re_ms, plain_ms=re_plain_ms,
             bound_ms=re_bound, bound_by=re_by, library_ms=None),
        dict(name="kalman_chandrasekhar", route="cuda",
             source="smc_tpu_torch/csrc/dsge_kernels.cu",
             replaces="smc_tpu/ops/pallas_dsge.py:379",
             max_abs_err=ll_abs, ms=kal_ms, plain_ms=kal_plain_ms,
             bound_ms=kal_bound, bound_by=kal_by, library_ms=None),
    ]


# --- every shape of the kernels' domain ------------------------------------
# the synthetic systems of the shape phase (tests/torch_parity.py's
# synthetic_system): N draws at each (n_state, n_shock) and the 80
# observations of one 3-row series
SHAPES_N = 16_384
# every finite lane of a synthetic system (all lie within a few hundred nats
# of the best): the tail band of tests/torch_parity.py
SHAPE_TAIL_RTOL = 1e-7


def _work_flop(counts, per):
    """sum over particles of per(iterations), from the iteration counts."""
    import torch
    vals, reps = torch.unique(counts, return_counts=True)
    return _add(_f(), *(_mul(int(r), per(int(v)))
                        for v, r in zip(vals.tolist(), reps.tolist())))


def _flop_str(flop):
    return f"{flop[0]:.4e} product + {flop[1]:.4e} other flop"


def shape_phase(dev, ptxas):
    """Both DSGE kernels at every (n_state, n_shock) of their domain, on
    SHAPES_N synthetic systems each: one likelihood call of a LinearDSGE
    through the kernels (launches counted: one of each), then the kernels
    against their plain versions with the AS gates, the work's bound, the
    kernels' and the plain versions' times, registers and spills. Returns
    the kernels-line entries."""
    import torch
    from torch_parity import normwise_rel, synthetic_model, synthetic_system
    from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                           bl_kalman_loglike_chandrasekhar)
    from smc_tpu_torch.ops import cuda_dsge, kernels

    entries = []
    worst = dict(agree=1.0, xm=0.0, ll=0.0, tail=0.0)
    for n_s, n_k in cuda_dsge.SIZES:
        sys_np, data_np = synthetic_system(n_s, n_k, SHAPES_N)
        model = synthetic_model(sys_np, dev)
        th = torch.arange(SHAPES_N, dtype=torch.float64,
                          device=dev)[:, None]
        _reset_launches()
        ll_model = model.loglike_batched(th, data_np)
        torch.cuda.synchronize()
        launches = _launches("re", "kalman")
        if launches != {"re": 1, "kalman": 1}:
            raise RuntimeError(f"({n_s}, {n_k}): the model's likelihood "
                               f"made launches {launches}, not one of each")
        A, B, C, D, Q, Z, d, H = (torch.as_tensor(x, device=dev)
                                  for x in sys_np)
        data = torch.as_tensor(data_np, device=dev)
        X, M, ok = cuda_dsge.solve_linear_re(A, B, C, D)
        Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
        ll = cuda_dsge.kalman_chandrasekhar(X, M, Q, Z, d, H, data, ok=ok)
        llp = torch.where(okp, bl_kalman_loglike_chandrasekhar(
            Xp, Mp, Q, Z, d, H, data), float("-inf"))
        agree = (ok == okp).double().mean().item()
        both = ok & okp
        xm_rel = max(normwise_rel(X[..., both], Xp[..., both]).max().item(),
                     normwise_rel(M[..., both], Mp[..., both]).max().item())
        re_abs = max((X[..., both] - Xp[..., both]).abs().max().item(),
                     (M[..., both] - Mp[..., both]).abs().max().item())
        fin = torch.isfinite(ll) & torch.isfinite(llp)
        band = fin & (llp > llp[fin].max() - 50.0)
        rel = (ll - llp).abs() / llp.abs()
        ll_rel = rel[band].max().item()
        tail_rel = rel[fin].max().item()
        ll_abs = (ll[band] - llp[band]).abs().max().item()
        n_pattern = int((torch.isfinite(ll) != torch.isfinite(llp)).sum())
        same_model = torch.equal(ll_model, ll)
        if not (agree >= OK_AGREE_MIN and xm_rel <= XM_RTOL
                and ll_rel <= LL_RTOL and tail_rel <= SHAPE_TAIL_RTOL
                and n_pattern == 0 and same_model):
            raise RuntimeError(
                f"({n_s}, {n_k}): kernels disagree with their plain "
                f"versions: ok agreement {agree}, X/M {xm_rel:.3e}, loglike "
                f"{ll_rel:.3e} over {int(band.sum())} band lanes, "
                f"{tail_rel:.3e} over every finite lane, {n_pattern} "
                f"finite-pattern disagreements, model call equal to the "
                f"kernels' {same_model}")
        worst = dict(agree=min(worst["agree"], agree),
                     xm=max(worst["xm"], xm_rel), ll=max(worst["ll"], ll_rel),
                     tail=max(worst["tail"], tail_rel))

        cr_it = cr_iterations(A, B, C)
        ly_it = lyapunov_iterations(X[..., ok])
        re_flop = _work_flop(cr_it, lambda i: re_flops(n_s, n_k, i))
        kal_flop = _work_flop(ly_it, lambda i: kalman_flops(
            n_s, n_k, i, data_np.shape[1]))
        re_bytes = SHAPES_N * (8 * (3 * n_s * n_s + n_s * n_k)
                               + 8 * (n_s * n_s + n_s * n_k) + 1)
        kal_bytes = (SHAPES_N * (8 * (n_s * n_s + n_s * n_k + n_k * n_k
                                      + 3 * n_s + 3 + 9) + 1 + 8)
                     + 8 * data.numel())
        re_bound, re_by = bound_ms(re_flop, re_bytes)
        kal_bound, kal_by = bound_ms(kal_flop, kal_bytes)
        re_ms = cuda_ms(lambda: cuda_dsge.solve_linear_re(A, B, C, D), 20)
        kal_ms = cuda_ms(lambda: cuda_dsge.kalman_chandrasekhar(
            X, M, Q, Z, d, H, data, ok=ok), 20)
        re_plain = once_ms(lambda: bl_solve_linear_re(A, B, C, D))
        kal_plain = once_ms(lambda: torch.where(
            okp, bl_kalman_loglike_chandrasekhar(Xp, Mp, Q, Z, d, H, data),
            float("-inf")))
        regs = {k: ptxas.get(f"{k}<{n_s},{n_k}>") for k in ("re_kernel",
                                                            "kalman_kernel")}
        if None in regs.values():
            raise RuntimeError(f"({n_s}, {n_k}): no ptxas line for {regs}")
        print(f"# shape ({n_s}, {n_k}): ok {int(ok.sum())}/{SHAPES_N}, "
              f"agreement {agree:.6f}, X/M {xm_rel:.3e}, loglike {ll_rel:.3e}"
              f" over {int(band.sum())} band lanes, {tail_rel:.3e} over all; "
              f"cyclic reduction "
              f"{cr_it.double().mean().item():.3f}, doubling "
              f"{ly_it.double().mean().item():.3f}; re {re_ms:.4f} ms "
              f"({100 * re_bound / re_ms:.1f}% of {re_bound:.4f}, {re_by}) "
              f"plain {re_plain:.4f}; kalman {kal_ms:.4f} ms "
              f"({100 * kal_bound / kal_ms:.1f}% of {kal_bound:.4f}, "
              f"{kal_by}) plain {kal_plain:.4f}; re_kernel "
              f"{regs['re_kernel']}; kalman_kernel {regs['kalman_kernel']}")
        for name, src_line, err, ms, plain, bnd, by in (
                ("re_solve", 259, re_abs, re_ms, re_plain, re_bound, re_by),
                ("kalman_chandrasekhar", 379, ll_abs, kal_ms, kal_plain,
                 kal_bound, kal_by)):
            entries.append(dict(
                name=f"{name}<{n_s},{n_k}>", route="cuda",
                source="smc_tpu_torch/csrc/dsge_kernels.cu",
                replaces=f"smc_tpu/ops/pallas_dsge.py:{src_line}",
                launches=launches["re" if name == "re_solve" else "kalman"],
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bnd,
                bound_by=by, library_ms=None))
    spills = [f"{k}: {v}" for k, v in ptxas.items()
              if k.startswith(("re_kernel<", "kalman_kernel<"))
              and "0 bytes spill stores, 0 bytes spill loads" not in v]
    print(f"# shapes: {len(cuda_dsge.SIZES)} (n_state, n_shock) pairs, ok "
          f"agreement >= {worst['agree']:.6f}, X/M <= {worst['xm']:.3e}, "
          f"loglike <= {worst['ll']:.3e} in the band, <= {worst['tail']:.3e} "
          f"over all; instantiations with a spill: "
          f"{len(spills)}")
    if spills:
        raise RuntimeError(f"ptxas reports spills: {spills}")
    # the likelihood route's copy of the Kalman kernel's shared memory
    # (ops/cuda_dsge.py kalman_smem_bytes) against the library's
    off = [(n_s, n_t) for n_s in sorted({s for s, _ in cuda_dsge.SIZES})
           for n_t in (0, 80, 7936, 9301)
           if kernels.load(f"dsge_ns{n_s}", dev).smc_kalman_smem_bytes(
               n_s, n_t) != cuda_dsge.kalman_smem_bytes(n_s, n_t)]
    print(f"# shapes: the route's Kalman shared-memory sizes differ from "
          f"the libraries' at {off}")
    if off:
        raise RuntimeError("ops/cuda_dsge.py kalman_smem_bytes is not the "
                           "kernel's")
    return entries


# --- the general-shape DSGE kernels -----------------------------------------
# synthetic shapes of the general phase: n_state (both block sizes, SW's 37
# and the domain's 64) by n_obs (the cofactor form at 3, Cholesky else), at
# n_shock GEN_SHOCK, on GEN_N systems each
GEN_STATES = (1, 9, 17, 37, 64)
GEN_OBS = (1, 2, 3, 7)
GEN_SHOCK = 3
GEN_N = 2_048
# the Kalman kernel's blocks an SM at SW's shape (rows of 8) and sw_pi_fg's
# (rows of 16)
KALMAN_BLOCKS = {(37, 7, 7): 3, (44, 14, 14): 2}
# one SW likelihood call at the reference's production size
SW_LARGE_N = 12_000


def loglh_errors(got, want, agree=None):
    """Finite-pattern disagreements (outside the lanes where the RE solves
    disagree, `agree` False), then over the lanes finite in both: within
    BAND_NATS of the best the count, the largest relative and absolute
    error, within TAIL_NATS the largest relative error."""
    import torch
    from torch_parity import BAND_NATS, TAIL_NATS
    if agree is None:
        agree = torch.ones_like(got, dtype=torch.bool)
    pattern = int(((torch.isfinite(got) != torch.isfinite(want))
                   & agree).sum())
    fin = torch.isfinite(got) & torch.isfinite(want)
    best = want[fin].max()
    band = fin & (want > best - BAND_NATS)
    tail = fin & (want > best - TAIL_NATS)
    rel = (got - want).abs() / want.abs()
    return (pattern, int(band.sum()), rel[band].max().item(),
            (got - want)[band].abs().max().item(), rel[tail].max().item())


def chandrasekhar_steps(T_mat, R_mat, Q, Z, d_obs, H, data):
    """Per particle, the Chandrasekhar steps the general Kalman kernel runs
    on these inputs: it leaves the recursion after the step that rejects
    the particle (a guard fires or the total turns non-finite). The plain
    recursion (models/dsge.py bl_kalman_loglike_chandrasekhar) with that
    exit recorded."""
    import torch
    from smc_tpu_torch.models.dsge import (_bl_matvec, _bl_sym,
                                           bl_lyapunov_doubling)
    from smc_tpu_torch.ops.linalg import (bl_matmul, bl_transpose,
                                          bl_psd_fast_solve)
    n_s, n_o, nb = T_mat.shape[0], Z.shape[0], T_mat.shape[-1]
    RQR = bl_matmul(R_mat, bl_matmul(Q, bl_transpose(R_mat)))
    P0 = bl_lyapunov_doubling(T_mat, RQR)
    F = _bl_sym(bl_matmul(Z, bl_matmul(P0, bl_transpose(Z))) + H)
    K = bl_matmul(T_mat, bl_matmul(P0, bl_transpose(Z)))
    eye = torch.eye(n_o, dtype=F.dtype, device=F.device)[:, :, None]
    M = _bl_sym(-bl_psd_fast_solve(F, eye.expand(n_o, n_o, nb))[0])
    W = K
    s = torch.zeros((n_s, nb), dtype=F.dtype, device=F.device)
    tr_cap = torch.diagonal(F).sum(-1) * (1.0 + 1e-6) + 1e-12
    bad = torch.zeros(nb, dtype=torch.bool, device=F.device)
    rejected = torch.zeros(nb, dtype=torch.bool, device=F.device)
    total = torch.zeros(nb, dtype=F.dtype, device=F.device)
    steps = torch.full((nb,), data.shape[1], device=F.device)
    for t in range(data.shape[1]):
        v = data[:, t, None] - d_obs - _bl_matvec(Z, s)
        ZW = bl_matmul(Z, W)
        sol, logdet = bl_psd_fast_solve(F, torch.cat([v[:, None], ZW], 1))
        quad = torch.sum(v * sol[:, 0], dim=0)
        total = total - 0.5 * (n_o * 1.8378770664093453 + logdet + quad)
        s = _bl_matvec(T_mat, s) + _bl_matvec(K, sol[:, 0])
        MWtZt = bl_matmul(M, bl_transpose(ZW))
        WMWtZt = bl_matmul(W, MWtZt)
        F_new = _bl_sym(F + bl_matmul(Z, WMWtZt))
        K_new = K + bl_matmul(T_mat, WMWtZt)
        W = bl_matmul(T_mat, W) - bl_matmul(K, sol[:, 1:])
        M = _bl_sym(M - bl_matmul(MWtZt, bl_matmul(
            bl_psd_fast_solve(F_new, ZW)[0], M)))
        diag_F = torch.diagonal(F_new)
        bad = (bad | (quad < 0.0) | (diag_F <= 0.0).any(dim=1)
               | (diag_F.sum(-1) > tr_cap))
        now = bad | ~torch.isfinite(total)
        steps = torch.where(now & ~rejected, t + 1, steps)
        rejected = now
        F, K = F_new, K_new
    return steps


def general_work(A, B, C, X, M, ok, Q, Z, d, H, data, kalman=kalman_flops):
    """The flop and bytes of the general kernels' work on these inputs
    (the cyclic-reduction iterations, doubling steps and filter steps each
    particle needs) and the bounds: ((re flop, bytes, bound, by), (kalman
    flop, bytes, bound, by), iterations, doubling steps, filter steps).
    `kalman` counts a particle's filter: by default the plain filter's
    products (kalman_flops, the count perfbench/kernels/_counts.py
    freezes), kalman_general_flops for the kernel's own."""
    n_s, n_k, n_o, n = A.shape[0], M.shape[1], Z.shape[0], A.shape[-1]
    n_t = data.shape[1]
    cr_it = cr_iterations(A, B, C)
    okX, okM = X[..., ok], M[..., ok]
    sub = lambda t: t[..., ok].contiguous()
    ly_it = lyapunov_iterations(okX)
    steps = chandrasekhar_steps(okX, okM, sub(Q), sub(Z), sub(d), sub(H),
                                data)
    re_flop = _work_flop(cr_it, lambda i: re_flops(n_s, n_k, i))
    kal_flop = _add(_f(), *(kalman(n_s, n_k, int(i), int(st), n_o)
                            for i, st in zip(ly_it.tolist(),
                                             steps.tolist())))
    re_bytes = n * (8 * (3 * n_s * n_s + n_s * n_k)
                    + 8 * (n_s * n_s + n_s * n_k) + 1)
    kal_bytes = (n * (8 * (n_s * n_s + n_s * n_k + n_k * n_k + n_o * n_s
                           + n_o + n_o * n_o) + 1 + 8) + 8 * data.numel())
    return ((re_flop, re_bytes, *bound_ms(re_flop, re_bytes)),
            (kal_flop, kal_bytes, *bound_ms(kal_flop, kal_bytes)),
            cr_it, ly_it, steps)


def general_compare(name, A, B, C, D, Q, Z, d, H, data, tail_rtol,
                    min_band=1):
    """The general kernels against their plain versions on one batch: the
    RE ok agreement, X and M normwise, the likelihood's bands (tail_rtol
    within TAIL_NATS, at least min_band lanes within BAND_NATS); raises on
    a failed gate. Returns the kernels' outputs and the errors."""
    import torch
    from torch_parity import BAND_RTOL, normwise_rel
    from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                           bl_kalman_loglike_chandrasekhar)
    from smc_tpu_torch.ops import cuda_dsge_general as g
    X, M, ok = g.solve_linear_re(A, B, C, D)
    ll = g.kalman_chandrasekhar(X, M, Q, Z, d, H, data, ok=ok)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    llp = torch.where(okp, bl_kalman_loglike_chandrasekhar(
        Xp, Mp, Q, Z, d, H, data), float("-inf"))
    torch.cuda.synchronize()
    agree = (ok == okp).double().mean().item()
    both = ok & okp
    xm = max(normwise_rel(X[..., both], Xp[..., both]).max().item(),
             normwise_rel(M[..., both], Mp[..., both]).max().item())
    xm_abs = max((X[..., both] - Xp[..., both]).abs().max().item(),
                 (M[..., both] - Mp[..., both]).abs().max().item())
    pattern, n_band, band_rel, band_abs, tail_rel = loglh_errors(
        ll, llp, ok == okp)
    print(f"# general {name}: ok {int(ok.sum())}/{ok.numel()} (plain "
          f"{int(okp.sum())}), agreement {agree:.6f}, X/M {xm:.3e}; "
          f"loglike {band_rel:.3e} over {n_band} band lanes (gate "
          f"{BAND_RTOL:g}), {tail_rel:.3e} within the tail (gate "
          f"{tail_rtol:g}), finite-pattern disagreements {pattern}")
    if not (agree >= OK_AGREE_MIN and xm <= XM_RTOL and pattern == 0
            and n_band >= min_band and band_rel <= BAND_RTOL
            and tail_rel <= tail_rtol):
        raise RuntimeError(f"general {name}: the kernels disagree with "
                           "their plain versions")
    return X, M, ok, ll, xm_abs, band_abs


def general_phase(dev, ptxas):
    """The general-shape DSGE kernels (ops/cuda_dsge_general.py) against
    their plain versions on the card: at SW's shape on SW_N_PARTS prior
    draws and 4 near-mode draws (SW's tail band), a NaN particle there, at
    AS-2obs's shape on AS_N_PARTS prior draws, and at the synthetic shapes
    GEN_STATES x GEN_OBS; the kernels' times (back to back and from a CUDA
    graph), bounds, registers and spills, the plain versions' times, the
    library calls nearest the inner steps, and one SW likelihood call at
    SW_LARGE_N draws. Returns the kernels-line entries (launches filled in
    by phase (f))."""
    import numpy as np
    import torch
    from torch_parity import TAIL_RTOL, synthetic_system
    from smc_tpu_torch.models import as_dsge, sw_dsge
    from smc_tpu_torch.models.dsge import (bl_solve_linear_re,
                                           bl_kalman_loglike_chandrasekhar)
    from smc_tpu_torch.ops import cuda_dsge_general as g
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws

    def inputs(mod, params, measurement, data_np, n, seed, extra=None):
        th = ParamSpace(params).sample_prior(TorchDraws(seed, dev), n,
                                             device=dev)
        if extra is not None:
            th = torch.cat([th, torch.as_tensor(extra, device=dev)])
        d, Z, H = measurement(th)
        data = torch.as_tensor(data_np, device=dev).contiguous()
        return th, (*mod._system(th), mod._shock_cov(th), Z, d, H, data)

    near = sw_dsge.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                                  .standard_normal((4, 36)))
    _, sw_in = inputs(sw_dsge, sw_dsge.sw_parameters(), sw_dsge._measurement,
                      sw_dsge.load_sw_data(), SW_N_PARTS, 2, near)
    A, B, C, D, Q, Z, d, H, data = sw_in
    X, M, ok, ll, re_abs, ll_abs = general_compare(
        f"SW ({SW_N_PARTS} prior, 4 near-mode draws)", *sw_in, SW_TAIL_RTOL,
        min_band=2)
    # a NaN particle leaves its neighbours bitwise unchanged
    j = SW_N_PARTS // 2 + 3
    A_nan = A.clone()
    A_nan[:, :, j] = float("nan")
    ll2 = g.dsge_loglike(A_nan, B, C, D, Q, Z, d, H, data)
    keep = torch.arange(A.shape[-1], device=dev) != j
    same = torch.equal(ll2[keep], ll[keep])
    print(f"# general NaN particle {j}: loglh {ll2[j].item()}, neighbours "
          f"bitwise unchanged: {same}")
    if not (same and ll2[j].item() == float("-inf")):
        raise RuntimeError("general: a NaN particle changed other particles")

    (re_w, kal_w, cr_it, ly_it, steps) = general_work(
        A, B, C, X, M, ok, Q, Z, d, H, data, kalman=kalman_general_flops)
    re_flop, re_bytes, re_bound, re_by = re_w
    kal_flop, kal_bytes, kal_bound, kal_by = kal_w
    # the same steps at the plain filter's products (the benchmark's count)
    kal_plain_bound = bound_ms(_add(_f(), *(
        kalman_flops(A.shape[0], D.shape[1], int(i), int(st), Z.shape[0])
        for i, st in zip(ly_it.tolist(), steps.tolist()))), kal_bytes)[0]
    re_ms = cuda_ms(lambda: g.solve_linear_re(A, B, C, D), 5, 3)
    kal_ms = cuda_ms(lambda: g.kalman_chandrasekhar(
        X, M, Q, Z, d, H, data, ok=ok), 5, 3)
    re_graph = graph_ms(lambda: g.solve_linear_re(A, B, C, D), 5, 3)
    kal_graph = graph_ms(lambda: g.kalman_chandrasekhar(
        X, M, Q, Z, d, H, data, ok=ok), 5, 3)
    Xp, Mp, okp = bl_solve_linear_re(A, B, C, D)
    re_plain = once_ms(lambda: bl_solve_linear_re(A, B, C, D))
    kal_plain = once_ms(lambda: torch.where(
        okp, bl_kalman_loglike_chandrasekhar(Xp, Mp, Q, Z, d, H, data),
        float("-inf")))
    # the instantiations SW runs: 256 threads, n_obs 7 on rows of 8 lanes
    regs = {"re": ptxas.get("re_general_kernel<256>"),
            "kalman": ptxas.get("kalman_general_kernel<256,8>")}
    print(f"# general at SW's shape, N={A.shape[-1]}: cyclic reduction "
          f"{cr_it.double().mean().item():.4f} iterations, doubling "
          f"{ly_it.double().mean().item():.4f} steps and "
          f"{steps.double().mean().item():.4f} filter steps over "
          f"{int(ok.sum())} ok particles; re {_flop_str(re_flop)} "
          f"{re_bytes} B, bound {re_bound:.4f} ms ({re_by}); kalman "
          f"{_flop_str(kal_flop)} {kal_bytes} B, bound {kal_bound:.4f} ms "
          f"({kal_by}; {kal_plain_bound:.4f} ms at the plain filter's "
          f"products)")
    print(f"# general times at SW's shape (ms): re kernel {re_ms:.4f}, graph "
          f"{re_graph:.4f} ({100 * re_bound / re_ms:.2f}% of bound), plain "
          f"{re_plain:.4f}; kalman kernel {kal_ms:.4f}, graph {kal_graph:.4f} "
          f"({100 * kal_bound / kal_ms:.2f}% of bound, "
          f"{100 * kal_plain_bound / kal_ms:.2f}% at the plain filter's "
          f"products), plain "
          f"{kal_plain:.4f}; re_general_kernel<256> {regs['re']}; "
          f"kalman_general_kernel<256,8> {regs['kalman']}")
    # the large RE block runs two to an SM only within 128 registers, which
    # its launch bound holds it to: spilling is the price it must not pay
    if regs["re"] is None or \
            "0 bytes spill stores, 0 bytes spill loads" not in regs["re"]:
        raise RuntimeError(f"re_general_kernel<256> spills: {regs['re']}")
    # the Kalman kernel's blocks an SM at SW's and sw_pi_fg's shapes: three
    # on rows of 8, two on rows of 16 (the tile without the observations
    # and 128 registers let the second in)
    blocks = {shape: g.kalman_blocks_per_sm(*shape, device=dev)
              for shape in KALMAN_BLOCKS}
    kal_regs = {name: ptxas.get(name) for name in
                ("kalman_general_kernel<256,8>",
                 "kalman_general_kernel<256,16>")}
    shown = ", ".join(f"{s} {b} (want {KALMAN_BLOCKS[s]})"
                      for s, b in blocks.items())
    print(f"# general Kalman kernel blocks an SM: {shown}; "
          f"kalman_general_kernel<256,16> "
          f"{kal_regs['kalman_general_kernel<256,16>']}")
    if blocks != KALMAN_BLOCKS:
        raise RuntimeError(f"the Kalman kernel holds {blocks} blocks an SM, "
                           f"not {KALMAN_BLOCKS}")

    # AS-2obs's shape (n_state 6: the 64-thread block; n_obs 2: Cholesky)
    _, as_in = inputs(as_dsge, as_dsge.an_schorfheide_parameters(),
                      as_dsge._measurement_2obs, as_dsge.load_as_data()[:2],
                      AS_N_PARTS, 3)
    Xa, Ma, oka, _, _, _ = general_compare(
        f"AS-2obs ({AS_N_PARTS} prior draws)", *as_in, TAIL_RTOL)
    (re_a, kal_a, _, _, _) = general_work(*as_in[:3], Xa, Ma, oka,
                                          *as_in[4:],
                                          kalman=kalman_general_flops)
    Aa, Ba, Ca, Da, Qa, Za, da, Ha, ya = as_in
    re_ms_a = cuda_ms(lambda: g.solve_linear_re(Aa, Ba, Ca, Da), 10, 3)
    kal_ms_a = cuda_ms(lambda: g.kalman_chandrasekhar(
        Xa, Ma, Qa, Za, da, Ha, ya, ok=oka), 10, 3)
    print(f"# general times at AS-2obs's shape (ms): re kernel {re_ms_a:.4f} "
          f"({100 * re_a[2] / re_ms_a:.2f}% of {re_a[2]:.4f}, {re_a[3]}); "
          f"kalman kernel {kal_ms_a:.4f} ({100 * kal_a[2] / kal_ms_a:.2f}% "
          f"of {kal_a[2]:.4f}, {kal_a[3]}); re_general_kernel<64> "
          f"{ptxas.get('re_general_kernel<64>')}; kalman_general_kernel<64,4> "
          f"{ptxas.get('kalman_general_kernel<64,4>')}")

    for n_s in GEN_STATES:
        for n_o in GEN_OBS:
            sys_np, data_np = synthetic_system(n_s, GEN_SHOCK, GEN_N,
                                               n_o=n_o)
            sys_t = [torch.as_tensor(x, device=dev) for x in sys_np]
            y = torch.as_tensor(data_np, device=dev)
            general_compare(f"synthetic ({n_s}, {GEN_SHOCK}, {n_o})",
                            *sys_t, y, TAIL_RTOL)

    # the library calls nearest the inner steps (none computes either
    # function): one cyclic-reduction step's solve, the innovation factor
    lhs = B.permute(2, 0, 1).contiguous()
    rhs = torch.cat([A, C], dim=1).permute(2, 0, 1).contiguous()
    F = (Z.permute(2, 0, 1) @ Z.permute(2, 1, 0)
         + torch.eye(Z.shape[0], dtype=Z.dtype, device=dev))
    lu_ms = cuda_ms(lambda: torch.linalg.lu_solve(
        *torch.linalg.lu_factor_ex(lhs)[:2], rhs), 5, 3)
    chol_ms = cuda_ms(lambda: torch.linalg.cholesky_ex(F), 20, 3)
    print(f"# general library calls at N={A.shape[-1]}: torch.linalg."
          f"lu_factor_ex + lu_solve 37 x 37, 74 right-hand sides "
          f"{lu_ms:.4f} ms; torch.linalg.cholesky_ex 7 x 7 {chol_ms:.4f} ms")

    # one SW likelihood call at the reference's production size
    model = sw_dsge.smets_wouters()
    th, big = inputs(sw_dsge, sw_dsge.sw_parameters(), sw_dsge._measurement,
                     sw_dsge.load_sw_data(), SW_LARGE_N, 5)
    call = lambda: model.loglike_batched(th, sw_dsge.load_sw_data())
    big_ms = cuda_ms(call, 2, 3)
    Xb, Mb, okb = g.solve_linear_re(*big[:4])
    (re_b, kal_b, _, _, _) = general_work(*big[:3], Xb, Mb, okb, *big[4:],
                                          kalman=kalman_general_flops)
    bound_b, by_b = bound_ms(_add(re_b[0], kal_b[0]), re_b[1] + kal_b[1])
    print(f"# general SW likelihood call at N={SW_LARGE_N}: {big_ms:.4f} ms "
          f"(the model's loglike_batched, system matrices included), bound "
          f"of the kernels' work {bound_b:.4f} ms ({by_b}; "
          f"{100 * bound_b / big_ms:.2f}%), {int(okb.sum())} ok")
    src = "smc_tpu_torch/csrc/dsge_general_kernels.cu"
    return [
        dict(name="re_general", route="cuda", source=src,
             replaces="smc_tpu/models/dsge.py:306", max_abs_err=re_abs,
             ms=re_ms, plain_ms=re_plain, bound_ms=re_bound, bound_by=re_by,
             library_ms=None),
        dict(name="kalman_general", route="cuda", source=src,
             replaces="smc_tpu/models/dsge.py:351", max_abs_err=ll_abs,
             ms=kal_ms, plain_ms=kal_plain, bound_ms=kal_bound,
             bound_by=kal_by, library_ms=None,
             blocks_per_sm={",".join(map(str, s)): b
                            for s, b in blocks.items()},
             ptxas=kal_regs),
    ]


def as_runner(dev):
    """A function running the AS-16k estimation on `dev` with AS_CONFIG
    updated by its kwargs (the model and data made once, outside the
    runs)."""
    import smc_tpu_torch
    from smc_tpu_torch.models import as_dsge
    model, data = as_dsge.an_schorfheide(), as_dsge.load_as_data()
    return lambda **kw: smc_tpu_torch.smc(
        model.loglike_batched, as_dsge.an_schorfheide_parameters(), data,
        **dict(AS_CONFIG, **kw), device=dev)


def main_path(dev):
    import numpy as np
    from smc_tpu_torch.models import as_dsge

    run = as_runner(dev)
    # a 2-stage run first pays the process's one-time costs (CUDA module
    # loading, cuSOLVER and cuBLAS handles, the allocator's first blocks)
    _, wall = _timed(lambda: run(n_phi=3, seed=1))
    print(f"# warm-up (2 stages, first use in this process) {wall:.4f} s")
    _reset_launches()
    res, wall = _timed(lambda: run(seed=0))
    launches = _launches("re", "kalman", "eigh")
    n_stages = len(res.cloud.tempering_schedule) - 1
    expected = 1 + res.init_rounds + n_stages
    print(f"# AS estimation: {n_stages} stages, {res.init_rounds} redraw "
          f"rounds, launches {launches} (expected {expected} of re and "
          f"kalman, {n_stages} of eigh: one block, one MH step)")
    if n_stages != AS_N_PHI - 1 or any(launches[k] != expected
                                       for k in ("re", "kalman")):
        raise RuntimeError("the main path did not go through the kernels "
                           "once per likelihood call")
    if launches["eigh"] != n_stages:
        raise RuntimeError("the main path did not factor the proposal "
                           "through the eigh kernel once per stage")
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - as_dsge.TRUE_PARAMS) / np.maximum(sd, 1e-9)
    print(f"# log-MDD {res.log_mdd:.4f} (JAX package {REF_LOG_MDD}); "
          f"max |z| vs TRUE_PARAMS {z.max():.3f}; resamples "
          f"{res.cloud.resamples}; final accept {res.cloud.accept_rate:.4f}")
    if not (np.isfinite(res.log_mdd)
            and abs(res.log_mdd - REF_LOG_MDD) <= MDD_TOL):
        raise RuntimeError(f"log-MDD {res.log_mdd} not within {MDD_TOL} "
                           f"nats of {REF_LOG_MDD}")
    if not (np.all(np.isfinite(mu)) and np.all(z < 4.0)):
        raise RuntimeError(f"posterior means off: z={z.tolist()}")
    print(f"# AS wall {wall:.4f} s, {1e3 * wall / n_stages:.4f} ms/stage, "
          f"{AS_N_PARTS * n_stages / wall:.1f} mutations/s, host reads per "
          f"stage {res.host_reads / n_stages:.4f}; {_loop_kind(res)}")
    if not res.fused:
        raise RuntimeError("the main path did not run the fused recursion")
    return launches, res, wall


def _loop_kind(res) -> str:
    """Which stage loop ran, and a fused run's capture time and masked
    stages."""
    if not res.fused:
        return "host loop"
    return (f"fused (graph capture {res.capture_seconds:.4f} s, "
            f"{res.masked_stages} masked stages)")


def _eigh_launch_gate(name, n_stages, n_blocks):
    """One eigh launch per stage, whatever the number of blocks."""
    n = _launches("eigh")["eigh"]
    print(f"# {name}: {n} eigh launches for {n_stages} stages of "
          f"{n_blocks} blocks (one per stage)")
    if n != n_stages:
        raise RuntimeError(f"{name}: {n} eigh launches for {n_stages} "
                           "stages: the blocks' factors did not come from "
                           "one launch per stage")


def _reset_launches():
    from smc_tpu_torch.ops.kernels import LAUNCHES
    LAUNCHES.update(dict.fromkeys(LAUNCHES, 0))


def _launches(*keys) -> dict:
    """{key: launches} of the kernels' launch registry, for `keys`."""
    from smc_tpu_torch.ops.kernels import LAUNCHES
    return {k: LAUNCHES[k] for k in keys}


def _timed(run):
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _linear_gates(name, res, exact, band=True):
    """Posterior means within LIN_MEAN_TOL of the exact ones; log-MDD equal
    to the w/W formula, every W column summing to N and, with `band`,
    log-MDD inside LIN_BAND. Returns the largest mean error."""
    import numpy as np
    from smc_tpu_torch import marginal_data_density
    err = float(np.max(np.abs(res.posterior_mean() - exact["mean"])))
    mdd_w = marginal_data_density(res.w, res.W)
    col_err = float(np.max(np.abs(res.W.sum(0) / LIN_N_PARTS - 1.0)))
    print(f"# {name}: max |mean - exact| {err:.4f} (gate {LIN_MEAN_TOL}); "
          f"log-MDD {res.log_mdd:.4f} (w/W formula {mdd_w:.4f}, exact "
          f"evidence {exact['log_evidence']:.2f}); W columns sum to N within "
          f"{col_err:.2e}; resamples {res.cloud.resamples}")
    if not err < LIN_MEAN_TOL:
        raise RuntimeError(f"{name}: posterior means off by {err}")
    if not (np.isclose(res.log_mdd, mdd_w, rtol=1e-10, atol=0.0)
            and col_err <= 1e-8):
        raise RuntimeError(f"{name}: weight bookkeeping disagrees")
    if band and not LIN_BAND[0] <= res.log_mdd <= LIN_BAND[1]:
        raise RuntimeError(f"{name}: log-MDD {res.log_mdd} outside the JAX "
                           f"package's band {LIN_BAND}")
    return err


def linear_phase(dev):
    """(a) The linear fixture at bench.py's configuration, seed 0, after a
    2-stage warm-up; the workload of the JAX package's primary metric."""
    import smc_tpu_torch
    from smc_tpu_torch.models.linear import (linear_parameters,
                                             make_linear_loglike,
                                             generate_linear_data,
                                             exact_linear_posterior)
    data, X = generate_linear_data(seed=1793)
    ll = make_linear_loglike(X)
    exact = exact_linear_posterior(data, X)
    cfg = dict(LIN_CONFIG, n_phi=3)
    _timed(lambda: smc_tpu_torch.smc(ll, linear_parameters(), data, **cfg,
                                     seed=1, device=dev))
    _reset_launches()
    res, wall = _timed(lambda: smc_tpu_torch.smc(
        ll, linear_parameters(), data, **LIN_CONFIG, seed=0, device=dev))
    n_stages = len(res.cloud.tempering_schedule) - 1
    _eigh_launch_gate("(a) linear fixture", n_stages, LIN_CONFIG["n_blocks"])
    _linear_gates("(a) linear fixture", res, exact)
    print(f"# (a) linear wall {wall:.4f} s, {n_stages} stages, "
          f"{1e3 * wall / n_stages:.4f} ms/stage, "
          f"{LIN_N_PARTS * n_stages / wall:.1f} mutations/s, host reads per "
          f"stage {res.host_reads / n_stages:.4f}; {_loop_kind(res)}")
    return (data, X, ll, exact), res, wall


ADAPTIVE = dict(use_fixed_schedule=False, tempering_target=0.97)


def adaptive_phase(dev):
    """(b) AS-16k with the adaptive schedule; both kernels on this path."""
    import numpy as np
    import torch
    from smc_tpu_torch.models import as_dsge
    from smc_tpu_torch.ops.schedule import solve_adaptive_phi, fixed_schedule
    from smc_tpu_torch.smc import LOOKAHEAD

    run = as_runner(dev)
    _reset_launches()
    res, wall = _timed(lambda: run(seed=0, **ADAPTIVE))
    launches = _launches("re", "kalman")
    sched = np.asarray(res.cloud.tempering_schedule)
    n_stages = len(sched) - 1
    # a masked stage (a replay past phi = 1) launches the kernels too
    expected = 1 + res.init_rounds + n_stages + res.masked_stages
    print(f"# (b) adaptive AS: {n_stages} stages (the JAX package took 220), "
          f"launches {launches} (expected {expected} each, "
          f"{res.masked_stages} of them masked stages), wall "
          f"{wall:.4f} s, {1e3 * wall / n_stages:.4f} ms/stage, host reads "
          f"per stage {res.host_reads / n_stages:.4f}; {_loop_kind(res)}")
    if not (np.all(np.diff(sched) > 0) and sched[-1] == 1.0):
        raise RuntimeError("adaptive schedule does not rise strictly to 1")
    if any(v != expected for v in launches.values()):
        raise RuntimeError("the adaptive path did not go through the kernels "
                           "once per likelihood call")
    if not (res.fused and res.masked_stages <= LOOKAHEAD):
        raise RuntimeError(f"(b) fused {res.fused}, {res.masked_stages} "
                           f"masked stages (at most {LOOKAHEAD})")
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - as_dsge.TRUE_PARAMS) / np.maximum(sd, 1e-9)
    print(f"# (b) log-MDD {res.log_mdd:.4f} (JAX package "
          f"{REF_LOG_MDD_ADAPTIVE}); max |z| vs TRUE_PARAMS {z.max():.3f}")
    if not abs(res.log_mdd - REF_LOG_MDD_ADAPTIVE) <= MDD_TOL:
        raise RuntimeError(f"adaptive log-MDD {res.log_mdd} not within "
                           f"{MDD_TOL} nats of {REF_LOG_MDD_ADAPTIVE}")
    if not (np.all(np.isfinite(mu)) and np.all(z < 4.0)):
        raise RuntimeError(f"adaptive posterior means off: z={z.tolist()}")
    # the solver alone, on the final cloud, from the first schedule entry:
    # the host and device cost of one stage's advance and bisection
    c = res.cloud
    solve = lambda: solve_adaptive_phi(c.loglh, c.weights, c.old_loglh, 0.0,
                                       fixed_schedule(AS_N_PHI, 2.0), 1, 0.0,
                                       0.97 * AS_N_PARTS)
    solve()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        solve()
    t_host = (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    t_all = (time.perf_counter() - t0) / 20
    print(f"# (b) solve_adaptive_phi: {1e3 * t_host:.4f} ms of host time "
          f"per call (enqueue), {1e3 * t_all:.4f} ms per call to completion "
          f"(20 calls)")
    return res, wall


METROPOLIS_CONFIG = dict(LIN_CONFIG, resampling_method="metropolis")


def metropolis_phase(dev, lin):
    """(c) The linear fixture with Metropolis resampling, fused: its gates,
    one chain launch per stage (the identity where a stage does not
    resample), one host read for the chunk and one at the end. Returns the
    run, its wall time and the chain's launches."""
    import smc_tpu_torch
    from smc_tpu_torch.models.linear import linear_parameters
    data, _, ll, exact = lin
    _reset_launches()
    res, wall = _timed(lambda: smc_tpu_torch.smc(
        ll, linear_parameters(), data, **METROPOLIS_CONFIG, seed=0,
        device=dev))
    launches = _launches("metropolis")["metropolis"]
    n_stages = len(res.cloud.tempering_schedule) - 1
    _linear_gates("(c) metropolis", res, exact, band=False)
    capped = [b for b in res.chain_lengths if b > 10_000]
    print(f"# (c) metropolis: Doeblin chain lengths of the "
          f"{len(res.chain_lengths)} resample stages {res.chain_lengths}; "
          f"the 10,000 cap bound on {len(capped)}; wall {wall:.4f} s "
          f"({1e3 * wall / n_stages:.4f} ms/stage), host reads per stage "
          f"{res.host_reads / n_stages:.4f} ({res.host_reads} for "
          f"{n_stages} stages); chain launches {launches} (one per stage); "
          f"{_loop_kind(res)}")
    if not (res.fused and res.host_reads == 2):
        raise RuntimeError(f"(c) fused {res.fused}, {res.host_reads} host "
                           "reads: not one for the chunk and one at the end")
    if launches != n_stages:
        raise RuntimeError(f"(c) {launches} chain launches for {n_stages} "
                           "stages: the stage did not run the chain kernel "
                           "once per stage")
    if len(res.chain_lengths) != res.cloud.resamples:
        raise RuntimeError(f"(c) Doeblin lengths {res.chain_lengths} for "
                           f"{res.cloud.resamples} resamples")
    return res, wall, launches


# the instructions a chain step needs (csrc/metropolis_chain.cuh), with
# the parts of the Philox call that its slot and key fix (the round keys,
# most of rounds 1-3) worked out once a slot: 16 32x32->64 multiplies and
# 18 three-input XORs for the Philox call, a multiply for
# the proposal, 2 shifts, a conversion and a multiply for the uniform, 2
# for the gather's address and the gather, a multiply and a compare for
# the accept test, 3 selects and the counter's add. No pipe limits them
# before the issue rate does, with the shifts as IMAD.SHL: per SM per
# clock the IMAD pipe takes 19 at 64, the ALU the other 24 integer ones
# at 64, the f64 pipe 3 at 64 and the conversion 1 at 16, against 48
# issued at 128 (tests/torch_chain_sass.py counts the kernel's own).
CHAIN_INSNS_PER_STEP = 16 + 18 + 1 + 4 + 3 + 2 + 3 + 1


def chain_bound(n, n_out, steps):
    """The least time for a chain launch: steps x n_out steps of
    CHAIN_INSNS_PER_STEP at PEAK_ISSUE, or the weights read once (8 n),
    the ancestors written once (8 n_out) and the key, flag and length, at
    the memory rate; the larger, and which."""
    t_ops = steps * n_out * CHAIN_INSNS_PER_STEP / PEAK_ISSUE * 1e3
    t_bytes = (8 * n + 8 * n_out + 16 + 1 + 8) / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _stage_weights(res):
    """The weights the first resampling stage of a run resampled: its
    normalized weights, W_{s-1} w_s scaled to sum to N (a resample stage's
    own W column is all ones)."""
    import numpy as np
    import torch
    s = next(s for s in range(1, res.W.shape[1])
             if np.all(res.W[:, s] == 1.0))
    w = res.W[:, s - 1] * res.w[:, s]
    return s, torch.as_tensor(w.shape[0] * w / w.sum())


def chain_phase(dev, runs, launches):
    """The Metropolis chain kernel against its plain version on the card,
    bit for bit: at the weights of a resample stage of each run in `runs`
    [(name, result)], n_out != n, a single non-zero weight, zero and NaN
    weights (0 steps: the identity), a stage that does not resample and a
    capped chain. Times at each run's stage (kernel back to back and from
    a CUDA graph, plain) against the bound. Returns the kernels-line entry
    at the first run's stage, with `launches` from phase (c)."""
    import torch
    from smc_tpu_torch.ops import cuda_metropolis as cm
    from smc_tpu_torch.ops.resample import chain_steps
    print(f"# (c) chain kernel: {smi_line()}")
    key = torch.tensor([0x243F6A88, 0x85A308D3], dtype=torch.int64,
                       device=dev)
    yes = torch.ones((), dtype=torch.bool, device=dev)

    def check(name, w, n_out=None, cap=10_000, flag=yes):
        steps, doeblin = chain_steps(w, 0.01, cap)
        got = cm.metropolis_chain(w, key, steps, flag, n_out)
        want = cm.metropolis_chain_plain(w, key, steps, flag, n_out)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        print(f"# (c) chain {name}: n {w.shape[0]}, n_out {got.shape[0]}, "
              f"{int(steps) if bool(flag) else 0} steps (Doeblin "
              f"{float(doeblin):.0f}), bit for bit equal to the plain "
              f"version: {same}")
        if not same:
            raise RuntimeError(f"(c) chain kernel differs from its plain "
                               f"version: {name}")
        return steps, got

    entry = w_stage = None
    for name, res in runs:
        s, w = _stage_weights(res)
        w = w.to(dev)
        if not bool(torch.isfinite(w).all()):
            raise RuntimeError(f"(c) chain: {name} stage {s}'s weights are "
                               "not finite")
        steps, _ = check(f"{name} stage {s}", w)
        n = w.shape[0]
        run = lambda: cm.metropolis_chain(w, key, steps, yes)
        ms, in_graph_ms = cuda_ms(run, 20), graph_ms(run, 20)
        plain_ms = cuda_ms(lambda: cm.metropolis_chain_plain(w, key, steps,
                                                             yes), 1, 3)
        bound, by = chain_bound(n, n, int(steps))
        print(f"# (c) chain {name} stage {s}: kernel {ms:.4f} ms "
              f"({in_graph_ms:.4f} ms replayed from a CUDA graph), plain "
              f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}; "
              f"{int(steps)} x {n} steps), "
              f"{100 * bound / in_graph_ms:.1f}% of the bound (graph)")
        if entry is None:
            entry = dict(name="metropolis_chain", route="cuda",
                         source="smc_tpu_torch/csrc/metropolis_kernel.cu",
                         replaces="smc_tpu/ops/resample.py:150",
                         launches=launches, max_abs_err=0.0, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=None)
            w_stage = w
    n = w_stage.shape[0]
    check("n_out = n / 2 + 3", w_stage, n_out=n // 2 + 3)
    check("n_out = 2 n", w_stage[:n // 4], n_out=n // 2)
    spike = torch.zeros(256, dtype=torch.float64, device=dev)
    spike[17] = 1.0
    _, got = check("one non-zero weight", spike)
    if (got == 17).float().mean() < 0.98:
        raise RuntimeError("(c) chain: the slots did not reach the one "
                           "non-zero weight")
    ident = torch.arange(n, device=dev)
    for name, w, flag in (
            ("zero weights", torch.zeros_like(w_stage), yes),
            ("NaN weights", torch.full_like(w_stage, float("nan")), yes),
            ("no resample", w_stage, ~yes)):
        _, got = check(name, w, flag=flag)
        if not torch.equal(got, ident):
            raise RuntimeError(f"(c) chain: {name} did not give the "
                               "identity")
    capped = torch.ones(4096, dtype=torch.float64, device=dev)
    capped[5] = 1e6
    steps, _ = check("4,095 ones and 1e6", capped)
    if int(steps) != 10_000:
        raise RuntimeError("(c) chain: the 10,000 cap did not bind")
    return entry


def _same_run(a, b) -> bool:
    import numpy as np
    import torch
    return (torch.equal(a.cloud.params, b.cloud.params)
            and torch.equal(a.cloud.weights, b.cloud.weights)
            and a.log_mdd == b.log_mdd
            and np.array_equal(a.w, b.w) and np.array_equal(a.W, b.W)
            and a.cloud.tempering_schedule == b.cloud.tempering_schedule)


def checkpoint_phase(dev, lin, res_a):
    """(d) Save every 20 stages, resume from stage 60: bitwise equal to the
    uninterrupted run."""
    import tempfile
    import smc_tpu_torch
    from smc_tpu_torch import io as smc_io
    from smc_tpu_torch.models.linear import linear_parameters
    data, _, ll, _ = lin
    with tempfile.TemporaryDirectory() as tmp:
        savepath = os.path.join(tmp, "linear.npz")
        full = smc_tpu_torch.smc(ll, linear_parameters(), data, **LIN_CONFIG,
                                 seed=0, device=dev, savepath=savepath,
                                 save_intermediate=True,
                                 intermediate_stage_increment=20)
        resumed, wall = _timed(lambda: smc_tpu_torch.smc(
            ll, linear_parameters(), data, **LIN_CONFIG, seed=0, device=dev,
            continue_intermediate=True,
            loadpath=smc_io.intermediate_path(savepath, 60)))
    same_resume, same_a = _same_run(resumed, full), _same_run(full, res_a)
    print(f"# (d) resume from stage 60 ({wall:.4f} s for stages 61-120): "
          f"bitwise equal to the uninterrupted run: {same_resume}; the "
          f"checkpointing run bitwise equal to (a): {same_a}")
    if not (same_resume and same_a):
        raise RuntimeError("resume from a checkpoint is not bit-identical")


def tempered_phase(dev, lin):
    """(e) Estimate on the first 50 periods, then update to all 100 with
    prior weight 0 (tempered update) and 0.5 (bridge distribution)."""
    import numpy as np
    import smc_tpu_torch
    from smc_tpu_torch.models.linear import linear_parameters
    data, _, ll, exact = lin
    half = data[:, :50]
    old = smc_tpu_torch.smc(ll, linear_parameters(), half, **LIN_CONFIG,
                            seed=0, device=dev)
    for omega in (0.0, 0.5):
        res, wall = _timed(lambda: smc_tpu_torch.smc(
            ll, linear_parameters(), data, **LIN_CONFIG, seed=1, device=dev,
            old_data=half, old_cloud=old.cloud,
            tempered_update_prior_weight=omega,
            log_prob_old_data=old.log_mdd))
        err = float(np.max(np.abs(res.posterior_mean() - exact["mean"])))
        print(f"# (e) update with prior weight {omega}: max |mean - exact| "
              f"{err:.4f} (gate {LIN_MEAN_TOL}); log-MDD {res.log_mdd:.4f} "
              f"(old data {old.log_mdd:.4f}); wall {wall:.4f} s")
        if not err < LIN_MEAN_TOL:
            raise RuntimeError(f"tempered update (omega={omega}) posterior "
                               f"means off by {err}")


def card_vs_cpu(dev, name, model, th, data, tail_rtol):
    """Thetas th [N, P] (on the CPU) through the model's likelihood on the
    card and on the CPU: the same -inf pattern, rtol BAND_RTOL within
    BAND_NATS of the best lane and tail_rtol within TAIL_NATS (the bands of
    tests/torch_parity.py; SW's tail is tests/test_torch_cuda.py's)."""
    import numpy as np
    from torch_parity import BAND_NATS, BAND_RTOL, TAIL_NATS
    t0 = time.perf_counter()
    want = model.loglike_batched(th, data).numpy()
    t_cpu = time.perf_counter() - t0
    got = model.loglike_batched(th.to(dev), data).cpu().numpy()
    fin = np.isfinite(want)
    n_pattern = int((np.isfinite(got) != fin).sum())
    best = want[fin].max()
    band = fin & (want > best - BAND_NATS)
    tail = fin & (want > best - TAIL_NATS) & np.isfinite(got)
    rel = np.abs(got[tail] - want[tail]) / np.abs(want[tail])
    band_err = rel[band[tail]].max()
    print(f"# {name} card vs CPU at {len(want)} thetas: {int(fin.sum())} "
          f"finite, finite-pattern disagreements {n_pattern}; "
          f"{int(band.sum())} band lanes max rel err {band_err:.3e} "
          f"(gate {BAND_RTOL:g}); "
          f"{int(tail.sum())} lanes within {TAIL_NATS:g} nats max rel err "
          f"{rel.max():.3e} (gate {tail_rtol:g}); CPU {t_cpu:.2f} s")
    if not (n_pattern == 0 and band_err <= BAND_RTOL
            and rel.max() <= tail_rtol):
        raise RuntimeError(f"{name}: the card's likelihood disagrees with "
                           "the CPU's")


def prior_draws(params, n, seed=11):
    """n prior draws [n, P] made on the CPU."""
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    return ParamSpace(params).sample_prior(TorchDraws(seed, "cpu"), n,
                                           device="cpu")


def sw_call_stats(dev, model, data):
    """One SW likelihood call at SW_N_PARTS prior draws through the model
    (on the card the general-shape kernels): its time between CUDA events,
    its host time, its device launches (the profiler's count, and the
    kernels' counters) and its share of the least time for the work these
    draws need (the kernels' iteration counts), beside the plain call
    (models/dsge.py bl_dsge_loglike on the same system matrices) and its
    bound at the plain path's fixed counts."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    from torch.autograd import DeviceType
    from smc_tpu_torch.models import sw_dsge
    from smc_tpu_torch.models.dsge import bl_dsge_loglike
    from smc_tpu_torch.ops import cuda_dsge_general as g
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    th = ParamSpace(sw_dsge.sw_parameters()).sample_prior(
        TorchDraws(2, dev), SW_N_PARTS, device=dev)
    y = torch.as_tensor(data, device=dev).contiguous()

    def plain():
        d, Z, H = sw_dsge._measurement(th)
        return bl_dsge_loglike(*sw_dsge._system(th), sw_dsge._shock_cov(th),
                               Z, d, H, y)

    def launches_of(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(1 for e in prof.events()
                   if e.device_type == DeviceType.CUDA)

    call = lambda: model.loglike_batched(th, data)
    ms = cuda_ms(call, 3, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call()
    host_ms = 1e3 * (time.perf_counter() - t0)
    torch.cuda.synchronize()
    before = _launches("re_general", "kalman_general")
    launches = launches_of(call)
    counted = {k: v - before[k] for k, v in _launches(*before).items()}
    plain_ms = once_ms(plain)
    plain_launches = launches_of(plain)
    ns, nk, no, n_t = sw_dsge.N_STATE, sw_dsge.N_SHOCK, sw_dsge.N_OBS, \
        data.shape[1]
    n_bytes = (8 * SW_N_PARTS * (3 * ns * ns + ns * nk + nk * nk + no * ns
                                 + no + no * no + 1) + 8 * no * n_t)
    flop = _mul(SW_N_PARTS, _add(re_flops(ns, nk, 16),
                                 kalman_general_flops(ns, nk, 30, n_t, no)))
    bound, by = bound_ms(flop, n_bytes)
    A, B, C, D = sw_dsge._system(th)
    d, Z, H = sw_dsge._measurement(th)
    X, M, ok = g.solve_linear_re(A, B, C, D)
    re_w, kal_w, cr_it, ly_it, steps = general_work(
        A, B, C, X, M, ok, sw_dsge._shock_cov(th), Z, d, H, y,
        kalman=kalman_general_flops)
    need_flop = _add(re_w[0], kal_w[0])
    need_bound, need_by = bound_ms(need_flop, n_bytes)
    print(f"# (f) SW likelihood call at N={SW_N_PARTS} (the general "
          f"kernels): {ms:.4f} ms between CUDA events, {host_ms:.4f} ms of "
          f"host time, {launches} device launches ({counted}); these draws "
          f"need {cr_it.double().mean().item():.4f} iterations, "
          f"{ly_it.double().mean().item():.4f} doubling steps and "
          f"{steps.double().mean().item():.4f} filter steps on average "
          f"({int(ok.sum())} ok): {_flop_str(need_flop)}, bound "
          f"{need_bound:.4f} ms ({need_by}), {100 * need_bound / ms:.2f}% of "
          f"it; the plain call: {plain_ms:.4f} ms, {plain_launches} device "
          f"launches; work at its fixed counts (16 cyclic-reduction "
          f"iterations, 30 doubling steps, every filter step) "
          f"{_flop_str(flop)}, bound {bound:.4f} ms ({by}), "
          f"{100 * bound / ms:.2f}% of "
          f"the kernels' call")
    if counted != {"re_general": 1, "kalman_general": 1}:
        raise RuntimeError(f"(f) the SW likelihood call launched {counted}, "
                           "not one of each general kernel")


def _run_line(name, res, wall, n_parts):
    n_stages = len(res.cloud.tempering_schedule) - 1
    print(f"# {name} wall {wall:.4f} s, {n_stages} stages, "
          f"{1e3 * wall / n_stages:.4f} ms/stage, "
          f"{n_parts * n_stages / wall:.1f} mutations/s, host reads per "
          f"stage {res.host_reads / n_stages:.4f}; {_loop_kind(res)}")


def sw_runner(dev):
    import smc_tpu_torch
    from smc_tpu_torch.models import sw_dsge
    model, data = sw_dsge.smets_wouters(), sw_dsge.load_sw_data()
    return model, data, lambda **kw: smc_tpu_torch.smc(
        model.loglike_batched, sw_dsge.sw_parameters(), data,
        **dict(SW_CONFIG, **kw), device=dev)


def sw_gates(name, res, mod=None):
    """The JAX package's tests/test_sw_estimation.py gates on an SW run (of
    the model module `mod`, sw_dsge unless told otherwise): a sound
    schedule, finite likelihoods and log-MDD, max |z| of the posterior
    means against TRUE_PARAMS below 6, over 85% of them below 3, and crhoa
    and crhog within 0.1."""
    import numpy as np
    import torch
    from smc_tpu_torch.models import sw_dsge
    sw_dsge = mod or sw_dsge
    sched = np.asarray(res.cloud.tempering_schedule)
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - sw_dsge.TRUE_PARAMS) / np.maximum(sd, 1e-8)
    idx = {n: i for i, n in enumerate(sw_dsge.PARAM_NAMES)}
    ar = {n: abs(mu[idx[n]] - sw_dsge.TRUE_PARAMS[idx[n]])
          for n in ("crhoa", "crhog")}
    print(f"# {name}: log-MDD {res.log_mdd:.4f}; max |z| vs "
          f"TRUE_PARAMS {z.max():.3f} ({sw_dsge.PARAM_NAMES[int(z.argmax())]})"
          f", share |z| < 3 {np.mean(z < 3.0):.4f}; |mean - true| crhoa "
          f"{ar['crhoa']:.4f} crhog {ar['crhog']:.4f}; resamples "
          f"{res.cloud.resamples}; final accept {res.cloud.accept_rate:.4f}")
    if not (sched[-1] == 1.0 and np.all(np.diff(sched) > 0)
            and bool(torch.isfinite(res.cloud.loglh).all())
            and np.isfinite(res.log_mdd)):
        raise RuntimeError(f"{name}: schedule, loglh or log-MDD not sound")
    if not (z.max() < 6.0 and np.mean(z < 3.0) > 0.85
            and max(ar.values()) < 0.1):
        raise RuntimeError(f"{name} posterior off: z={z.tolist()}")


def sw_phase(dev):
    """(f) SW-4k: Smets-Wouters at the reference dsge_model.jl's
    configuration on the committed data, through the general-shape kernels
    (their launches counted, one of each per likelihood call), gated as the
    JAX package's tests/test_sw_estimation.py; then one likelihood call's
    cost, and prior draws and posterior particles on the card against the
    CPU. Returns the general kernels' launches."""
    import numpy as np
    import torch
    from smc_tpu_torch.models import sw_dsge
    model, data, run = sw_runner(dev)
    _, wall = _timed(lambda: run(n_phi=3, seed=1))
    print(f"# (f) warm-up (2 stages) {wall:.4f} s")
    _reset_launches()
    res, wall = _timed(lambda: run(seed=0))
    launches = _launches("re_general", "kalman_general")
    sched = np.asarray(res.cloud.tempering_schedule)
    sw_gates(f"(f) SW-{SW_N_PARTS}", res)
    # one likelihood call per block per stage, masked stages too
    expected = (1 + res.init_rounds + (len(sched) - 1 + res.masked_stages)
                * SW_CONFIG["n_blocks"])
    print(f"# (f) kernel launches {_launches('re', 'kalman')}, general "
          f"{launches} (expected {expected} each: 1 + {res.init_rounds} "
          f"redraw rounds + {SW_CONFIG['n_blocks']} a stage)")
    if any(v != expected for v in launches.values()):
        raise RuntimeError("(f) SW did not go through the general kernels "
                           "once per likelihood call")
    _run_line("(f) SW", res, wall, SW_N_PARTS)
    _eigh_launch_gate("(f) SW", len(sched) - 1, SW_CONFIG["n_blocks"])
    sw_call_stats(dev, model, data)
    th = torch.cat([prior_draws(sw_dsge.sw_parameters(), SW_CMP_DRAWS),
                    res.cloud.params[:SW_CMP_POSTERIOR].cpu()])
    card_vs_cpu(dev, f"(f) SW ({SW_CMP_DRAWS} prior draws, "
                f"{SW_CMP_POSTERIOR} posterior particles)", model, th, data,
                SW_TAIL_RTOL)
    return launches


# (l) Smets-Wouters with FRBNY m1002's inflation target and forward
# guidance (models/sw_pi_fg.py) at SW's configuration, as the benchmark's
# swpifg-4k-fixed runs it; the expectation-rows kernel against its plain
# version normwise per particle (f64 rounding over a chain of 40
# vector-matrix products)
EXPECT_RTOL = 1e-12
# (l)'s deep tail: far in the prior's tail the recursion drifts in every
# method. On (l)'s 4,101 draws on the CPU, the plain route, the plain
# reference (tests/reference_sw_pi_fg.py) and the Riccati filter, three
# exact float64 computations, differ by over 1e-3 on 14-17 lanes (by up to
# 34%) and each leaves the other two's range, widened by SW's tail band, on
# 8-10; so no lane-by-lane tail band holds there. (l) holds the card to the
# plain route within the posterior band lane by lane, and in the tail to
# the drift of an exact method: at each of TAIL_LEVELS it leaves the
# reference on at most DRIFT_FACTOR times as many lanes as the plain route
# does, plus DRIFT_SLACK, and in finiteness likewise.
TAIL_LEVELS = (1e-3, 1e-4, 1e-5)
DRIFT_FACTOR, DRIFT_SLACK = 2, 2


def expectation_flops(n_s, rows):
    """flop of one ok particle's expectation rows (csrc/dsge_expectations
    .cuh): each base row's chain v <- v X to the last horizon of its rows,
    2 n_s^2 a step (vector-matrix products, on the FMA pipes), an addition
    per entry a horizon a row holds and a division per entry a row."""
    last = {}
    for _, base, _, hi in rows:
        last[base] = max(last.get(base, 0), hi)
    return _f(other=(2 * n_s * n_s * sum(last.values())
                     + n_s * sum(hi - lo + 1 for _, _, lo, hi in rows)
                     + n_s * len(rows)))


def expectation_bytes(n_s, n_o, n_rows, n, n_ok):
    """Bytes the kernel has to move: X and the rows of Z it does not fill
    of each ok particle, Z whole of the others, ok, and Z written whole."""
    return (8 * n_ok * (n_s * n_s + (n_o - n_rows) * n_s)
            + 8 * (n - n_ok) * n_o * n_s + n * (1 + 8 * n_o * n_s))


def sw_pi_fg_runner(dev):
    import smc_tpu_torch
    from smc_tpu_torch.models import sw_pi_fg as fg
    model, data = fg.sw_pi_fg(), fg.load_sw_pi_fg_data()
    return model, data, lambda **kw: smc_tpu_torch.smc(
        model.loglike_batched, fg.sw_pi_fg_parameters(), data,
        **dict(SW_CONFIG, **kw), device=dev)


def sw_pi_fg_kalman_inputs(dev, th, data):
    """(X, M, Q, Z, d, H, data, ok) of the model's Kalman filter at thetas
    th [N, 43] on the card: the RE kernel's solution, Z with its
    expectation rows from the kernel."""
    import torch
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.ops import cuda_dsge_expectations as ce
    from smc_tpu_torch.ops import cuda_dsge_general as g
    X, M, ok = g.solve_linear_re(*fg._system(th))
    d, Z, H = fg._measurement(th)
    Z = ce.expectation_rows(Z, X, ok, fg.EXPECTATION_ROWS)
    y = torch.as_tensor(data, device=dev).contiguous()
    return X, M, fg._shock_cov(th), Z, d, H, y, ok


def kalman_sets(dev, posterior):
    """The general Kalman kernel's inputs on rows of 16 (n_obs 9-16) the
    way they differ: the general phase's synthetic draws (tests/
    torch_parity.py synthetic_system, SYNTHETIC_T = 80 steps) at (37, 7,
    16) and at the model's (44, 14, 14); the model's SW_N_PARTS prior draws
    on the first 80 quarters and on all 156; its posterior cloud
    `posterior` [N, 43] on all 156. name -> (X, M, Q, Z, d, H, data, ok)."""
    import torch
    from torch_parity import synthetic_system
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.ops import cuda_dsge_general as g
    sets = {}
    for n_s, n_k, n_o in ((37, 7, 16), (44, 14, 14)):
        sys_np, data_np = synthetic_system(n_s, n_k, SW_N_PARTS, n_o=n_o)
        A, B, C, D, Q, Z, d, H = (torch.as_tensor(x, device=dev)
                                  for x in sys_np)
        X, M, ok = g.solve_linear_re(A, B, C, D)
        sets[f"synthetic ({n_s}, {n_k}, {n_o}), T {data_np.shape[1]}"] = (
            X, M, Q, Z, d, H, torch.as_tensor(data_np, device=dev), ok)
    data = fg.load_sw_pi_fg_data()
    prior = prior_draws(fg.sw_pi_fg_parameters(), SW_N_PARTS).to(dev)
    sets["prior draws, T 80"] = sw_pi_fg_kalman_inputs(dev, prior,
                                                       data[:, :80])
    sets[f"prior draws, T {data.shape[1]}"] = sw_pi_fg_kalman_inputs(
        dev, prior, data)
    sets[f"posterior cloud, T {data.shape[1]}"] = sw_pi_fg_kalman_inputs(
        dev, posterior, data)
    return sets


def kalman_turns(sets, reps=3):
    """Each set's Kalman kernel call timed in turns, the sets forward then
    backward (cuda_ms, `reps` calls a batch, 3 batches): name -> the mean
    of its two times (ms)."""
    from smc_tpu_torch.ops import cuda_dsge_general as g
    times = {name: [] for name in sets}
    order = list(sets)
    for name in order + order[::-1]:
        X, M, Q, Z, d, H, y, ok = sets[name]
        times[name].append(cuda_ms(lambda: g.kalman_chandrasekhar(
            X, M, Q, Z, d, H, y, ok=ok), reps, 3))
    return {name: sum(t) / len(t) for name, t in times.items()}


def kalman_other_turns(sets, other, reps=2):
    """The sets' Kalman kernel calls (bare launches, tests/
    torch_general_turns.py) of this checkout's build and of the build of
    `other`, another csrc/ tree, in turns (other, this, this, other): one
    line a set with both builds' times and whether their outputs are equal
    bit for bit."""
    import torch
    from torch_general_turns import build_other, kalman_launcher, library
    from torch_turns import turns
    from smc_tpu_torch import _build
    paths = {"other": build_other(other),
             "this": _build.build_cuda_library("dsge_general")}
    for name, path in paths.items():
        for line in ptxas_lines(path.with_suffix(".log").read_text()):
            if line.startswith("kalman_general_kernel<256,16>"):
                print(f"# (l) ptxas {name}: {line}")
    for set_name, (X, M, Q, Z, d, H, y, ok) in sets.items():
        fns, outs = {}, {}
        for name, path in paths.items():
            outs[name] = torch.empty(X.shape[-1], dtype=X.dtype,
                                     device=X.device)
            fns[name] = kalman_launcher(library(path, X.device), X, M, Q, Z,
                                        d, H, y, ok, outs[name])
            fns[name]()
        torch.cuda.synchronize()
        equal = torch.equal(outs["this"], outs["other"])
        t = turns(fns, reps)
        ms = {name: statistics.mean(b for b, _ in t[name]) for name in t}
        shown = {name: ", ".join(f"{b:.4f}/{c:.4f}" for b, c in t[name])
                 for name in t}
        print(f"# (l) kalman {set_name} in turns (other, this, this, other; "
              f"ms/graph ms): this {shown['this']}, other "
              f"{shown['other']}; other/this {ms['other'] / ms['this']:.4f}; "
              f"outputs bitwise equal: {equal}")


def kalman_work_line(name, inputs, ms):
    """One set's line: ok draws, filter steps and the share of ok draws the
    divergence guards cut short, doubling steps, the kernel's time and its
    share of the bound of its own work (kalman_general_flops); returns the
    ms per ok particle-step."""
    X, M, Q, Z, d, H, y, ok = inputs
    sub = lambda t: t[..., ok].contiguous()
    steps = chandrasekhar_steps(sub(X), sub(M), sub(Q), sub(Z), sub(d),
                                sub(H), y)
    ly_it = lyapunov_iterations(sub(X))
    n_s, n_k, n_o, n_t = X.shape[0], M.shape[1], Z.shape[0], y.shape[1]
    flop = _add(_f(), *(kalman_general_flops(n_s, n_k, int(i), int(st), n_o)
                        for i, st in zip(ly_it.tolist(), steps.tolist())))
    n = X.shape[-1]
    nbytes = (n * (8 * (n_s * n_s + n_s * n_k + n_k * n_k + n_o * n_s + n_o
                        + n_o * n_o) + 1 + 8) + 8 * y.numel())
    bound, by = bound_ms(flop, nbytes)
    total = int(steps.sum())
    cut = (steps < n_t).double().mean().item() if steps.numel() else 0.0
    per_step = ms / max(total, 1)
    print(f"# (l) kalman {name}: {int(ok.sum())}/{n} ok, filter steps "
          f"{steps.double().mean().item():.4f} of {n_t} on average, "
          f"{100 * cut:.2f}% of ok draws cut short by the guards, doubling "
          f"{ly_it.double().mean().item():.4f}; kernel {ms:.4f} ms "
          f"({1e6 * per_step:.4f} ns an ok particle-step), bound "
          f"{bound:.4f} ms ({by}), {100 * bound / ms:.2f}% of it")
    return per_step


def sw_pi_fg_phase(dev, ptxas, other=None):
    """(l) sw_pi_fg-4k: Smets-Wouters with FRBNY m1002's inflation target
    and forward guidance (44 states, 14 shocks, 14 observables) at SW's
    configuration through the general route (the RE kernel, the
    expectation-rows kernel, the Kalman kernel on rows of 16; one launch of
    each per likelihood call, counted from zero), gated as (f); then, at
    SW_N_PARTS prior draws, 4 near-mode draws and one without a unique
    stable solution, the expectation-rows
    kernel against bl_expectation_rows on the same X, Z and ok (within
    EXPECT_RTOL, the rejected draws' rows untouched; its time, plain time
    and bound), the whole likelihood against the plain route on the card
    (bl_dsge_loglike: within the posterior band lane by lane; in the tail,
    against the plain reference, no more drift than the plain route's),
    and the Kalman kernel timed in turns on
    the model's prior and posterior draws and on synthetic draws
    (kalman_sets), and with `other` (another csrc/ tree) against that
    tree's build (kalman_other_turns). Returns the kernels-line entry of
    the expectation-rows kernel."""
    import numpy as np
    import torch
    import reference_sw_pi_fg
    from torch_parity import BAND_RTOL
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.models.dsge import (bl_dsge_loglike,
                                           bl_expectation_rows,
                                           bl_solve_linear_re)
    from smc_tpu_torch.ops import cuda_dsge_expectations as ce
    from smc_tpu_torch.ops import cuda_dsge_general as g
    rows = fg.EXPECTATION_ROWS
    model, data, run = sw_pi_fg_runner(dev)
    _, wall = _timed(lambda: run(n_phi=3, seed=1))
    print(f"# (l) warm-up (2 stages) {wall:.4f} s")
    _reset_launches()
    res, wall = _timed(lambda: run(seed=0))
    launches = _launches("re_general", "kalman_general", "expectation_rows")
    sched = np.asarray(res.cloud.tempering_schedule)
    sw_gates(f"(l) sw_pi_fg-{SW_N_PARTS}", res, fg)
    expected = (1 + res.init_rounds + (len(sched) - 1 + res.masked_stages)
                * SW_CONFIG["n_blocks"])
    print(f"# (l) kernel launches {launches} (expected {expected} each: 1 + "
          f"{res.init_rounds} redraw rounds + {SW_CONFIG['n_blocks']} a "
          f"stage); graph capture {res.capture_seconds:.4f} s")
    if set(launches) != {"re_general", "kalman_general", "expectation_rows"} \
            or any(v != expected for v in launches.values()):
        raise RuntimeError("(l) sw_pi_fg did not go through the general "
                           "route once per likelihood call")
    if not res.fused:
        raise RuntimeError("(l) sw_pi_fg did not run the fused recursion")
    _run_line("(l) sw_pi_fg", res, wall, SW_N_PARTS)
    _eigh_launch_gate("(l) sw_pi_fg", len(sched) - 1, SW_CONFIG["n_blocks"])

    near = fg.TRUE_PARAMS * (1.0 + 1e-4 * np.random.default_rng(1)
                             .standard_normal((5, fg.TRUE_PARAMS.size)))
    near[-1, fg.PARAM_NAMES.index("crpi")] = 0.5   # no unique stable solution
    th = torch.cat([prior_draws(fg.sw_pi_fg_parameters(), SW_N_PARTS),
                    torch.as_tensor(near)]).to(dev)
    y = torch.as_tensor(data, device=dev).contiguous()
    A, B, C, D = fg._system(th)
    d, Z, H = fg._measurement(th)
    Q = fg._shock_cov(th)
    X, M, ok = g.solve_linear_re(A, B, C, D)
    before = _launches("expectation_rows")["expectation_rows"]
    out = ce.expectation_rows(Z, X, ok, rows)
    if _launches("expectation_rows")["expectation_rows"] != before + 1:
        raise RuntimeError("(l) the expectation rows were not one launch")
    plain = bl_expectation_rows(Z, X, rows, ok)
    torch.cuda.synchronize()
    err = (torch.linalg.vector_norm(out - plain, dim=(0, 1))
           / torch.linalg.vector_norm(plain, dim=(0, 1)))[ok].max().item()
    abs_err = (out - plain).abs().max().item()
    kept = torch.equal(out[..., ~ok], Z[..., ~ok])
    n_ok, (n_o, n_s, n) = int(ok.sum()), Z.shape
    flop = _mul(n_ok, expectation_flops(n_s, rows))
    nbytes = expectation_bytes(n_s, n_o, len(rows), n, n_ok)
    bound, by = bound_ms(flop, nbytes)
    call = lambda: ce.expectation_rows(Z, X, ok, rows)
    ms, in_graph = cuda_ms(call, 20), graph_ms(call, 20)
    plain_ms = cuda_ms(lambda: bl_expectation_rows(Z, X, rows, ok), 5, 3)
    print(f"# (l) expectation rows at N={n} ({n_ok} ok): normwise rel err "
          f"{err:.3e} (gate {EXPECT_RTOL:g}), max abs err {abs_err:.3e}, "
          f"rejected draws' rows untouched: {kept}; kernel {ms:.4f} ms "
          f"({in_graph:.4f} ms replayed from a CUDA graph), plain "
          f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}; "
          f"{_flop_str(flop)}, {nbytes} B), {100 * bound / in_graph:.2f}% "
          f"of it; expectation_rows_kernel<64> "
          f"{ptxas.get('expectation_rows_kernel<64>')}")
    if not (err <= EXPECT_RTOL and kept and 0 < n_ok < n):
        raise RuntimeError("(l) the expectation-rows kernel disagrees with "
                           "its plain version")

    before = _launches("re_general", "kalman_general", "expectation_rows")
    got = model.loglike_batched(th, data)
    counted = {k: v - before[k] for k, v in _launches(*before).items()}
    want = bl_dsge_loglike(A, B, C, D, Q, Z, d, H, y, expectation_rows=rows)
    okp = bl_solve_linear_re(A, B, C, D)[2]
    agree = (ok == okp).double().mean().item()
    exact = reference_sw_pi_fg.loglike(th, y)
    pattern, n_band, band_rel, _, _ = loglh_errors(got, want, ok == okp)

    def drift(a):
        """Lanes on which a leaves the reference: in finiteness, then by
        more than each of TAIL_LEVELS (relative)."""
        both = torch.isfinite(a) & torch.isfinite(exact)
        rel = ((a - exact).abs() / exact.abs())[both]
        return [int((torch.isfinite(a) != torch.isfinite(exact)).sum())] + [
            int((rel > t).sum()) for t in TAIL_LEVELS]
    card_drift, plain_drift = drift(got), drift(want)
    drift_ok = all(c <= DRIFT_FACTOR * p + DRIFT_SLACK
                   for c, p in zip(card_drift, plain_drift))
    call_ms = cuda_ms(lambda: model.loglike_batched(th, data), 3, 3)
    plain_call = once_ms(lambda: bl_dsge_loglike(
        A, B, C, D, Q, Z, d, H, y, expectation_rows=rows))
    print(f"# (l) likelihood at N={n}, general route against the plain "
          f"route on the card: launches {counted}; RE ok agreement "
          f"{agree:.6f}; {band_rel:.3e} over {n_band} band lanes (gate "
          f"{BAND_RTOL:g}); lanes off the plain reference in finiteness and "
          f"by over {TAIL_LEVELS}: the card {card_drift}, the plain route "
          f"{plain_drift} (gate {DRIFT_FACTOR}x + {DRIFT_SLACK}); "
          f"finite-pattern disagreements with the plain route "
          f"{pattern}; call {call_ms:.4f} ms, plain {plain_call:.4f} ms; "
          f"re_general_kernel<256> {ptxas.get('re_general_kernel<256>')}; "
          f"kalman_general_kernel<256,16> "
          f"{ptxas.get('kalman_general_kernel<256,16>')}")
    if counted != {"re_general": 1, "kalman_general": 1,
                   "expectation_rows": 1}:
        raise RuntimeError(f"(l) the likelihood call launched {counted}")
    if not (agree >= OK_AGREE_MIN and n_band >= 2
            and band_rel <= BAND_RTOL and drift_ok):
        raise RuntimeError("(l) the general route disagrees with the plain "
                           "route")

    sets = kalman_sets(dev, res.cloud.params)
    times = kalman_turns(sets)
    for name, inputs in sets.items():
        kalman_work_line(name, inputs, times[name])
    if other is None:
        print("# (l) kalman against another tree's build: not run, no "
              "--other")
    else:
        kalman_other_turns(sets, other)
    return dict(name="expectation_rows", route="cuda",
                source="smc_tpu_torch/csrc/dsge_expectations.cu",
                replaces=None, max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None,
                launches=launches["expectation_rows"])


def as2obs_phase(dev):
    """(g) AS-2obs-16k: An-Schorfheide on output growth and inflation
    (the Cholesky innovation path, the general-shape kernels, one launch of
    each per likelihood call) at AS-16k's configuration, and 16,384 prior
    draws on the card against the CPU."""
    import numpy as np
    import smc_tpu_torch
    from torch_parity import TAIL_RTOL
    from smc_tpu_torch.models import as_dsge
    model, data = as_dsge.an_schorfheide_2obs(), as_dsge.load_as_data()[:2]
    run = lambda **kw: smc_tpu_torch.smc(
        model.loglike_batched, as_dsge.an_schorfheide_parameters(), data,
        **dict(AS_CONFIG, **kw), device=dev)
    _timed(lambda: run(n_phi=3, seed=1))
    _reset_launches()
    res, wall = _timed(lambda: run(seed=0))
    launches = _launches("re_general", "kalman_general")
    expected = (1 + res.init_rounds + len(res.cloud.tempering_schedule) - 1
                + res.masked_stages)
    mu, sd = res.posterior_mean(), res.posterior_std()
    z = np.abs(mu - as_dsge.TRUE_PARAMS) / np.maximum(sd, 1e-9)
    print(f"# (g) AS-2obs: log-MDD {res.log_mdd:.4f} (JAX package "
          f"{REF_LOG_MDD_AS2}); max |z| vs TRUE_PARAMS {z.max():.3f}; "
          f"general kernel launches {launches} (expected {expected} each)")
    if any(v != expected for v in launches.values()):
        raise RuntimeError("(g) AS-2obs did not go through the general "
                           "kernels once per likelihood call")
    _run_line("(g) AS-2obs", res, wall, AS_N_PARTS)
    if not abs(res.log_mdd - REF_LOG_MDD_AS2) <= MDD_TOL:
        raise RuntimeError(f"(g) log-MDD {res.log_mdd} not within {MDD_TOL} "
                           f"nats of {REF_LOG_MDD_AS2}")
    if not (np.all(np.isfinite(mu)) and np.all(z < 4.0)):
        raise RuntimeError(f"(g) posterior means off: z={z.tolist()}")
    card_vs_cpu(dev, "(g) AS-2obs", model,
                prior_draws(as_dsge.an_schorfheide_parameters(), AS_N_PARTS),
                data, TAIL_RTOL)
    return res, wall


def capm_phase(dev):
    """(h) CAPM at the JAX package's tests/test_capm.py configuration,
    seeds 42 and 0-3: the median over the seeds of each parameter's |z|
    below 5, and every log-MDD finite."""
    import numpy as np
    import smc_tpu_torch
    from smc_tpu_torch.models import capm
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    ll = capm.make_capm_loglike(market)
    run = lambda **kw: smc_tpu_torch.smc(ll, capm.capm_parameters(), lik,
                                         **dict(CAPM_CONFIG, **kw),
                                         device=dev)
    _timed(lambda: run(n_phi=3, seed=1))
    zs = []
    for seed in CAPM_SEEDS:
        res, wall = _timed(lambda: run(seed=seed))
        mu, sd = res.posterior_mean(), res.posterior_std()
        zs.append(np.abs(mu - CAPM_TRUE) / np.maximum(sd, 1e-9))
        print(f"# (h) CAPM seed {seed}: log-MDD {res.log_mdd:.4f}, |z| "
              f"{np.array2string(zs[-1], precision=2)}")
        _run_line(f"(h) CAPM seed {seed}", res, wall, CAPM_CONFIG["n_parts"])
        if not np.isfinite(res.log_mdd):
            raise RuntimeError(f"(h) CAPM seed {seed}: log-MDD not finite")
    med = np.median(zs, axis=0)
    print(f"# (h) CAPM median |z| over seeds "
          f"{np.array2string(med, precision=2)} (gate < 5)")
    if not np.all(med < 5.0):
        raise RuntimeError(f"(h) CAPM median |z| {med.tolist()}")


# (k) the examples of examples/torch/ at their own configurations. Each
# run's log-MDD must equal the w/W formula and its W columns sum to N (the
# estimator's bookkeeping, exact), and lie within a band of the JAX
# package's script's (examples/, same configuration and seed, on a CPU): four
# standard deviations of the difference of two runs, each with the port's
# spread over seeds 0-9 on a CPU (4 sqrt(2) sd, rounded up to a whole nat;
# `python tests/torch_example_bands.py` prints the port's seeds and the
# bands, `--jax` the JAX scripts' values). The linear and CAPM bands are as
# wide as their values: at these configurations the estimate is decided by
# how many equations' clouds stay in a large-sigma basin, which the random
# stream decides (PERF.md section 4). So those scripts, and the regression
# script, are also held to the CPU exactly: each runs once on the CPU with
# its draws recorded, then on the card replaying those draws, and the two
# runs' log-MDD and posterior moments must agree to REPLAY_RTOL. SW (too
# heavy for a CPU run of the JAX script) is held to phase (f)'s gates; the
# real-data SW script to its exit without the dataset.
EXAMPLE_REF = {                    # script: (JAX log-MDD, band in nats)
    "estimate_regression.py": (-155.080, 1.0),
    "estimate_linear.py": (-1272.101, 1066.0),
    "estimate_capm.py": (-2164.054, 1485.0),
    "estimate_as_dsge.py": (-1419.402, 10.0),
}
EXAMPLES = ("estimate_regression.py", "estimate_linear.py",
            "estimate_capm.py", "estimate_as_dsge.py", "estimate_sw_dsge.py",
            "estimate_sw_real.py")
REPLAYED = ("estimate_regression.py", "estimate_linear.py",
            "estimate_capm.py")
# the card against the CPU at the same draws, relative: log-MDD, and the
# posterior means and sds. Rounding differences (~1e-16) grow through a
# stuck cloud's ill-conditioned covariance: over the regression, linear
# (seeds 42, 0-4) and CAPM (seeds 0-5) examples the card was within 5.2e-8
# of the CPU in log-MDD and 7.0e-6 in the moments, with either eigh
# (PERF.md section 4)
REPLAY_MDD_RTOL = 1e-6
REPLAY_RTOL = 1e-4


def _example_main(script):
    """main() of one examples/torch/ script."""
    import importlib.util
    path = os.path.join(HERE, "examples", "torch", script)
    spec = importlib.util.spec_from_file_location(
        f"smc_example_{script[:-3]}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _record_draws(seed, device):
    """A TorchDraws that keeps every draw it serves, as (kind, numpy array)
    entries in .entries, for a ReplayDraws."""
    from smc_tpu_torch.rng import TorchDraws

    class RecordDraws(TorchDraws):
        def __init__(self):
            super().__init__(seed, device)
            self.entries, self._depth = [], 0

        def _keep(self, kind, fn, *args):
            self._depth += 1      # categorical draws its uniforms itself
            try:
                v = fn(*args)
            finally:
                self._depth -= 1
            if self._depth == 0:
                self.entries.append((kind, v.cpu().numpy().copy()))
            return v

    for kind in ("uniform", "normal", "integers", "categorical",
                 "permutation", "standard_gamma"):
        setattr(RecordDraws, kind,
                (lambda k: lambda self, *a: self._keep(
                    k, getattr(TorchDraws, k).__get__(self), *a))(kind))
    return RecordDraws()


def _with_key(main, argv, make_key):
    """main(argv) with smc_tpu_torch.smc given key=make_key(seed)."""
    import smc_tpu_torch
    smc = smc_tpu_torch.smc
    smc_tpu_torch.smc = lambda *a, **kw: smc(*a, key=make_key(kw["seed"]),
                                             **kw)
    try:
        return main(argv)
    finally:
        smc_tpu_torch.smc = smc


def _replay_gate(script, main, dev, quiet):
    """The script on the CPU with its draws recorded, then on the card
    replaying them: log-MDD within REPLAY_MDD_RTOL, posterior means and sds
    within REPLAY_RTOL (relative)."""
    import numpy as np
    from smc_tpu_torch.rng import ReplayDraws
    rec = {}

    def record(seed):
        rec["draws"] = _record_draws(seed, "cpu")
        return rec["draws"]

    with quiet():
        cpu, cpu_wall = _timed(lambda: _with_key(main, ["--device", "cpu"],
                                                 record))
        entries = rec["draws"].entries
        card, wall = _timed(lambda: _with_key(
            main, ["--device", str(dev)],
            lambda seed: ReplayDraws(entries, device=dev)))
    rel = lambda a, b: float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
    mdd = abs(card.log_mdd - cpu.log_mdd) / abs(cpu.log_mdd)
    mean = rel(card.posterior_mean(), cpu.posterior_mean())
    sd = rel(card.posterior_std(), cpu.posterior_std())
    print(f"# (k) {script}: the card replaying the CPU run's {len(entries)} "
          f"draws (CPU {cpu_wall:.4f} s, card {wall:.4f} s, "
          f"{_loop_kind(card)}): log-MDD {card.log_mdd:.9f} vs "
          f"{cpu.log_mdd:.9f}, relative difference {mdd:.3e} (gate "
          f"{REPLAY_MDD_RTOL:g}); means {mean:.3e}, sds {sd:.3e} (gate "
          f"{REPLAY_RTOL:g})")
    if not (mdd <= REPLAY_MDD_RTOL and max(mean, sd) <= REPLAY_RTOL):
        raise RuntimeError(f"(k) {script}: the card's run at the CPU's "
                           f"draws differs: log-MDD {mdd}, means {mean}, "
                           f"sds {sd}")


def _weights_gate(script, res):
    """The run's log-MDD equals the w/W formula and every W column sums to
    N: the estimator's bookkeeping, exact on any draws."""
    import numpy as np
    from smc_tpu_torch import marginal_data_density
    mdd_w = marginal_data_density(res.w, res.W)
    n = res.cloud.params.shape[0]
    col_err = float(np.max(np.abs(res.W.sum(0) / n - 1.0)))
    print(f"# (k) {script}: log-MDD {res.log_mdd:.6f}, w/W formula "
          f"{mdd_w:.6f}; W columns sum to N within {col_err:.2e}")
    if not (np.isclose(res.log_mdd, mdd_w, rtol=1e-10, atol=0.0)
            and col_err <= 1e-8):
        raise RuntimeError(f"(k) {script}: weight bookkeeping disagrees")


def _capm_note(res):
    """The CAPM example against the exact posterior of its simulated data
    (CAPM is the linear fixture's model with the market as every
    equation's regressor): printed, not gated."""
    import numpy as np
    from smc_tpu_torch.models import capm
    from smc_tpu_torch.models.linear import exact_linear_posterior
    lik, market = capm.generate_capm_data(T=200, seed=1793)
    exact = exact_linear_posterior(lik, np.tile(market, (3, 1)))
    mu, sd = res.posterior_mean(), res.posterior_std()
    off = np.abs(mu - exact["mean"]) / exact["sd"]
    print(f"# (k) estimate_capm.py: exact log evidence "
          f"{exact['log_evidence']:.4f}; |mean - exact| / exact sd "
          f"{np.array2string(off, precision=2)}; sd / exact sd "
          f"{np.array2string(sd / exact['sd'], precision=2)}")


def examples_phase(dev):
    """(k) Each examples/torch/ script's main() on the card at the script's
    own configuration (its printout kept to its data and log-MDD lines),
    timed, and gated: a finite log-MDD equal to the w/W formula and within
    its band of the JAX script's, the regression, linear and CAPM scripts
    equal to their CPU runs at the same draws, SW on phase (f)'s gates,
    the real-data script at its exit; the AS script's likelihood through
    the kernels. Runs in a scratch working directory (the linear script
    writes its checkpoint and particle store there), with no
    $SW_REAL_DATA."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    quiet = lambda: contextlib.redirect_stdout(io.StringIO())
    cwd, sw_data = os.getcwd(), os.environ.pop("SW_REAL_DATA", None)
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for script in EXAMPLES:
                main = _example_main(script)
                out = io.StringIO()
                _reset_launches()
                with contextlib.redirect_stdout(out):
                    res, wall = _timed(lambda: main(["--device", str(dev)]))
                lines = out.getvalue().strip().splitlines()
                data = [ln for ln in lines if ln.startswith("data: ")]
                mdd_line = [ln for ln in lines
                            if ln.startswith("log marginal data density")]
                print(f"# (k) {script}: wall {wall:.4f} s; "
                      f"{mdd_line[-1] if mdd_line else 'no log-MDD line'}"
                      + (f"; {data[0]}" if data else ""))
                if not mdd_line:
                    raise RuntimeError(f"(k) {script} printed no log-MDD")
                if script == "estimate_sw_real.py":
                    if res is None and mdd_line[-1].endswith("n/a"):
                        continue
                    raise RuntimeError(f"(k) {script}: the dataset is not "
                                       "in the repository; expected the "
                                       "script's exit")
                if not np.isfinite(res.log_mdd):
                    raise RuntimeError(f"(k) {script}: log-MDD not finite")
                _weights_gate(script, res)
                if script == "estimate_sw_dsge.py":
                    sw_gates("(k) SW-1000", res)
                    continue
                if script == "estimate_capm.py":
                    if data != ["data: simulated (T = 200, seed 1793)"]:
                        raise RuntimeError(f"(k) {script}: expected the "
                                           f"simulated data, got {data}")
                    _capm_note(res)
                ref, band = EXAMPLE_REF[script]
                print(f"# (k) {script}: log-MDD {res.log_mdd:.4f}, JAX "
                      f"script {ref} (gate within {band} nats); "
                      f"{_loop_kind(res)}")
                if abs(res.log_mdd - ref) > band:
                    raise RuntimeError(f"(k) {script}: log-MDD "
                                       f"{res.log_mdd} not within {band} of "
                                       f"{ref}")
                if script in REPLAYED:
                    _replay_gate(script, main, dev, quiet)
                if script == "estimate_as_dsge.py":
                    n_calls = (1 + res.init_rounds
                               + len(res.cloud.tempering_schedule) - 1)
                    launches = _launches("re", "kalman")
                    print(f"# (k) {script}: kernel launches {launches} "
                          f"({n_calls} likelihood calls)")
                    if any(v != n_calls for v in launches.values()):
                        raise RuntimeError(f"(k) {script}: the likelihood "
                                           "did not go through the kernels")
        finally:
            os.chdir(cwd)
            if sw_data is not None:
                os.environ["SW_REAL_DATA"] = sw_data


def _mesh_result(res, launches, wall) -> dict:
    """What a mesh rank reports of its AS run, as numpy arrays."""
    import numpy as np
    c = res.cloud
    return dict(log_mdd=res.log_mdd, params=c.params.cpu().numpy(),
                loglh=c.loglh.cpu().numpy(), weights=c.weights.cpu().numpy(),
                schedule=np.asarray(c.tempering_schedule),
                ESS=np.asarray(c.ESS), W=res.W, mean=res.posterior_mean(),
                std=res.posterior_std(), init_rounds=res.init_rounds,
                launches_re=launches["re"],
                launches_kalman=launches["kalman"], wall=wall,
                collectives=res.collectives, bytes=res.collective_bytes,
                host_reads=res.host_reads, fused=res.fused,
                capture_seconds=res.capture_seconds)


def _mesh_rank(rank, world, backend, device, store, out):
    """One rank of a spawned mesh: a 2-stage warm-up under the mesh, then
    AS-16k at AS_CONFIG, seed 0, with the launches counted from 0, and
    under NCCL (fused) adaptive AS-16k too, whose replays must be the same
    on every rank; the result goes to OUT/rank<rank>.npz."""
    import datetime
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    import torch.distributed as dist
    from smc_tpu_torch.parallel import initialize_multihost, particle_mesh
    dev = torch.device(device.format(rank=rank))
    initialize_multihost(num_processes=world, process_id=rank,
                         backend=backend, device=dev,
                         store=torch.distributed.FileStore(store, world),
                         timeout=datetime.timedelta(seconds=MESH_PG_TIMEOUT))
    try:
        mesh = particle_mesh()
        run = as_runner(dev)
        run(n_phi=3, seed=1, mesh=mesh)
        _reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        res = run(seed=0, mesh=mesh)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        launches = _launches("re", "kalman")
        adaptive = {}
        if backend == "nccl":
            ad = run(seed=0, mesh=mesh, **ADAPTIVE)
            adaptive = dict(
                adaptive_stages=len(ad.cloud.tempering_schedule) - 1,
                adaptive_masked=ad.masked_stages,
                adaptive_collectives=ad.collectives,
                adaptive_log_mdd=ad.log_mdd,
                adaptive_params=ad.cloud.params.cpu().numpy())
        np.savez(os.path.join(out, f"rank{rank}.npz"), **_mesh_result(
            res, launches, wall), **adaptive)
    finally:
        dist.destroy_process_group()


def _spawn_mesh(world, backend, device):
    """Run _mesh_rank on `world` spawned processes (rank r on
    device.format(rank=r)); a rank that fails, or ranks that take longer
    than MESH_TIMEOUT, raise. Returns each rank's result and the wall time
    of the whole, process start included."""
    import tempfile
    import numpy as np
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            _mesh_rank, args=(world, backend, device,
                              os.path.join(tmp, "store"), tmp),
            nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > MESH_TIMEOUT:
                    raise RuntimeError(f"mesh ranks ({backend}) not done "
                                       f"after {MESH_TIMEOUT} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        wall = time.perf_counter() - t0
        return [dict(np.load(os.path.join(tmp, f"rank{r}.npz")))
                for r in range(world)], wall


def _mesh_gates(name, ranks, ref_mdd, n_parts, fused):
    """Every rank bitwise equal to rank 0, log-MDD within MESH_RTOL of
    `ref_mdd` and MDD_TOL of the JAX package's, posterior means within 4
    sd, each rank's launches 1 + rounds + stages, the driver smc() chose
    (`fused`) on every rank; prints the wall times, the collectives and the
    host reads."""
    import numpy as np
    from smc_tpu_torch.models import as_dsge
    r0 = ranks[0]
    same = all(np.array_equal(r0[k], r[k]) for r in ranks[1:] for k in r0
               if k not in ("wall", "capture_seconds"))
    n_stages = len(r0["schedule"]) - 1
    expected = 1 + int(r0["init_rounds"]) + n_stages
    launches = [(int(r["launches_re"]), int(r["launches_kalman"]))
                for r in ranks]
    rel = abs(float(r0["log_mdd"]) - ref_mdd) / abs(ref_mdd)
    z = np.abs(r0["mean"] - as_dsge.TRUE_PARAMS) / np.maximum(r0["std"],
                                                               1e-9)
    print(f"# {name}: {len(ranks)} ranks of {n_parts // len(ranks)} "
          f"particles; ranks bitwise equal: {same}; log-MDD "
          f"{float(r0['log_mdd']):.10f} (rel. diff {rel:.3e} from (i.1)); "
          f"max |z| {z.max():.3f}; launches per rank (re, kalman) "
          f"{launches} (expected {expected} each)")
    walls = ", ".join(f"{float(r['wall']):.4f}" for r in ranks)
    captures = [f"{float(r['capture_seconds']):.4f}" for r in ranks]
    print(f"# {name} wall per rank {walls} s ({n_stages} stages); "
          f"collectives {int(r0['collectives'])} "
          f"({(int(r0['collectives']) - 2) / n_stages:.4f} per stage, "
          f"plus the initial and final gathers), bytes from the other ranks "
          f"{int(r0['bytes'])} ({int(r0['bytes']) / n_stages:.1f} per stage, "
          f"the two gathers included); host reads per stage "
          f"{float(r0['host_reads']) / n_stages:.4f}; "
          f"{'fused' if bool(r0['fused']) else 'host loop'} (capture "
          f"{', '.join(captures)} s)")
    if "adaptive_stages" in r0:
        print(f"# {name} adaptive: {int(r0['adaptive_stages'])} stages, "
              f"masked stages per rank "
              f"{[int(r['adaptive_masked']) for r in ranks]}, collectives "
              f"per rank {[int(r['adaptive_collectives']) for r in ranks]}, "
              f"log-MDD {float(r0['adaptive_log_mdd']):.4f}")
    if any(bool(r["fused"]) != fused for r in ranks):
        raise RuntimeError(f"{name}: smc() did not choose the "
                           f"{'fused recursion' if fused else 'host loop'}")
    if not same:
        raise RuntimeError(f"{name}: the ranks' results differ")
    if not (rel <= MESH_RTOL
            and abs(float(r0["log_mdd"]) - REF_LOG_MDD) <= MDD_TOL):
        raise RuntimeError(f"{name}: log-MDD {float(r0['log_mdd'])} off")
    if not np.all(z < 4.0):
        raise RuntimeError(f"{name}: posterior means off: z={z.tolist()}")
    if any(v != expected for pair in launches for v in pair):
        raise RuntimeError(f"{name}: a rank did not go through the kernels "
                           "once per likelihood call")


def mesh_phase(dev, res_as, wall_as):
    """(i) AS-16k under smc(mesh=particle_mesh()): (i.1) one NCCL rank in
    this process, fused (the collectives captured in the graph), against
    the unsharded fused run of the main path, bit for bit, and once on the
    host loop, bit for bit against the fused mesh run; (i.2) two gloo ranks
    sharing the card (NCCL takes one rank per card), spawned, on the host
    loop (smc()'s choice: gloo cannot be captured); (i.3) one NCCL rank per
    card, fused, where there are two or more."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from smc_tpu_torch.parallel import initialize_multihost, particle_mesh

    run = as_runner(dev)
    with tempfile.TemporaryDirectory() as tmp:
        initialize_multihost(num_processes=1, process_id=0, backend="nccl",
                             device=dev, store=dist.FileStore(
                                 os.path.join(tmp, "store"), 1))
        try:
            mesh = particle_mesh()
            run(n_phi=3, seed=1, mesh=mesh)     # warm-up, as the main path's
            _reset_launches()
            res, wall = _timed(lambda: run(seed=0, mesh=mesh))
            launches = _launches("re", "kalman")
            host, wall_host = _timed(lambda: run(seed=0, mesh=mesh,
                                                 fused=False))
        finally:
            dist.destroy_process_group()
    n_stages = len(res.cloud.tempering_schedule) - 1
    expected = 1 + res.init_rounds + n_stages
    bitwise = _equal_runs(res, res_as)
    host_bitwise = _equal_runs(host, res)
    print(f"# (i.1) one NCCL rank, fused: log-MDD {res.log_mdd:.10f} "
          f"(unsharded {res_as.log_mdd:.10f}); bit for bit equal to the "
          f"unsharded fused run: {bitwise}; launches {launches} (expected "
          f"{expected} each)")
    print(f"# (i.1) wall {wall:.4f} s ({n_stages} stages, "
          f"{1e3 * wall / n_stages:.4f} ms/stage; the unsharded run "
          f"{1e3 * wall_as / n_stages:.4f}); collectives {res.collectives} "
          f"({(res.collectives - 2) / n_stages:.4f} per stage), bytes from "
          f"other ranks {res.collective_bytes}; host reads per stage "
          f"{res.host_reads / n_stages:.4f}; {_loop_kind(res)}")
    print(f"# (i.1) one NCCL rank, host loop: wall {wall_host:.4f} s "
          f"({1e3 * wall_host / n_stages:.4f} ms/stage), host reads per "
          f"stage {host.host_reads / n_stages:.4f}, collectives "
          f"{host.collectives}; bit for bit equal to the fused mesh run: "
          f"{host_bitwise}")
    if not (res.fused and not host.fused):
        raise RuntimeError("(i.1) the NCCL mesh did not run fused, or the "
                           "host loop did not run as asked")
    if not bitwise:
        raise RuntimeError("(i.1) the one-rank fused mesh run differs from "
                           "the unsharded fused run")
    if not host_bitwise:
        raise RuntimeError("(i.1) the host-loop mesh run differs from the "
                           "fused mesh run")
    if any(v != expected for v in launches.values()):
        raise RuntimeError("(i.1) the mesh run did not go through the "
                           "kernels once per likelihood call")
    if res.collectives != host.collectives or res.host_reads != 2:
        raise RuntimeError(f"(i.1) collectives {res.collectives} (host loop "
                           f"{host.collectives}), {res.host_reads} host "
                           "reads")

    ranks, wall2 = _spawn_mesh(2, "gloo", f"cuda:{dev.index}")
    print(f"# (i.2) two gloo ranks on {dev}: {wall2:.4f} s for the spawn, "
          "the warm-up and the run")
    _mesh_gates("(i.2) gloo, one card", ranks, res.log_mdd, AS_N_PARTS,
                fused=False)

    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"# mesh nccl multi-card: not run, {n_cards} card")
        return
    world = 1 << (n_cards.bit_length() - 1)     # R must divide 2^14
    ranks, wall3 = _spawn_mesh(world, "nccl", "cuda:{rank}")
    print(f"# (i.3) {world} NCCL ranks, one per card: {wall3:.4f} s for the "
          "spawn, the warm-up and the run; the run itself per rank against "
          f"(i.1)'s {wall:.4f} s on one rank")
    _mesh_gates(f"(i.3) nccl, {world} cards", ranks, res.log_mdd, AS_N_PARTS,
                fused=True)

# (j) SW is timed both ways on a cut run (20 stages of the n_phi=100
# schedule's spacing would change the run; n_phi=21 keeps its configuration
# otherwise); the full fused SW run is phase (f)
SW_J_N_PHI = 21
# the CPU body's tolerances (tests/test_torch_kernel_body_cpu.py)
EIGH_TOL = 1e-12


def _equal_runs(a, b) -> bool:
    """Two runs bit for bit: cloud, weights, log-MDD, w/W, schedule, ESS,
    resamples and c."""
    import torch
    return (_same_run(a, b)
            and torch.equal(a.cloud.loglh, b.cloud.loglh)
            and a.cloud.ESS == b.cloud.ESS
            and a.cloud.resamples == b.cloud.resamples
            and a.cloud.c == b.cloud.c)


def _both_line(name, fused, f_wall, host, h_wall):
    n_f = len(fused.cloud.tempering_schedule) - 1
    n_h = len(host.cloud.tempering_schedule) - 1
    same = _equal_runs(fused, host)
    print(f"# (j) {name}: fused {f_wall:.4f} s ({n_f} stages, "
          f"{1e3 * f_wall / n_f:.4f} ms/stage, graph capture "
          f"{fused.capture_seconds:.4f} s, host reads per stage "
          f"{fused.host_reads / n_f:.4f}, masked stages "
          f"{fused.masked_stages}); host loop {h_wall:.4f} s ({n_h} stages, "
          f"{1e3 * h_wall / n_h:.4f} ms/stage, host reads per stage "
          f"{host.host_reads / n_h:.4f}); host loop / fused "
          f"{h_wall / f_wall:.4f}; bit for bit equal: {same}")
    if not (fused.fused and not host.fused):
        raise RuntimeError(f"(j) {name}: the two loops did not run as asked")
    return same


def fused_phase(dev, res_as, wall_as, res_a, wall_a, res_b, wall_b, lin,
                res_g, wall_g, res_c, wall_c):
    """(j) The host loop (fused=False) at the seeds of the main path, (b),
    (a) and (c): each equal to its fused run bit for bit ((c) with the same
    Doeblin lengths). AS-2obs against
    (g)'s fused run, and SW on a cut run both ways, timed (equality
    printed, not gated). Returns SW's cut cloud for the eigh shapes."""
    import smc_tpu_torch
    from smc_tpu_torch.models import as_dsge
    from smc_tpu_torch.models.linear import linear_parameters
    print(f"# (j) {smi_line()}")
    run = as_runner(dev)
    host, wall = _timed(lambda: run(seed=0, fused=False))
    gated = [("AS-16k fixed", _both_line("AS-16k fixed", res_as, wall_as,
                                         host, wall))]
    host, wall = _timed(lambda: run(seed=0, fused=False, **ADAPTIVE))
    gated.append(("adaptive AS-16k", _both_line(
        "adaptive AS-16k", res_b, wall_b, host, wall)))
    data, _, ll, _ = lin
    host, wall = _timed(lambda: smc_tpu_torch.smc(
        ll, linear_parameters(), data, **LIN_CONFIG, seed=0, device=dev,
        fused=False))
    gated.append(("linear-32k", _both_line("linear-32k", res_a, wall_a, host,
                                           wall)))
    host, wall = _timed(lambda: smc_tpu_torch.smc(
        ll, linear_parameters(), data, **METROPOLIS_CONFIG, seed=0,
        device=dev, fused=False))
    gated.append(("Metropolis linear-32k", _both_line(
        "Metropolis linear-32k", res_c, wall_c, host, wall)
        and res_c.chain_lengths == host.chain_lengths))
    model2, data2 = as_dsge.an_schorfheide_2obs(), as_dsge.load_as_data()[:2]
    host, wall = _timed(lambda: smc_tpu_torch.smc(
        model2.loglike_batched, as_dsge.an_schorfheide_parameters(), data2,
        **AS_CONFIG, seed=0, device=dev, fused=False))
    _both_line("AS-2obs-16k", res_g, wall_g, host, wall)
    _, _, run_sw = sw_runner(dev)
    sw_f, wall_f = _timed(lambda: run_sw(seed=0, n_phi=SW_J_N_PHI))
    sw_h, wall_h = _timed(lambda: run_sw(seed=0, n_phi=SW_J_N_PHI,
                                         fused=False))
    _both_line(f"SW-4k (n_phi={SW_J_N_PHI})", sw_f, wall_f, sw_h, wall_h)
    bad = [name for name, same in gated if not same]
    if bad:
        raise RuntimeError(f"(j) fused and host loop differ: {bad}")
    return sw_f


def eigh_bound(ks):
    """The least time for the symmetric eigendecompositions, with vectors,
    of matrices of these sizes, whatever the method: about 9 k^3 flop per
    matrix (the symmetric QR algorithm with the vectors accumulated, Golub
    and Van Loan), all of it counted as matrix products (a blocked method
    puts it there, on the tensor cores), and each matrix read once, its
    eigenvalues and vectors written once."""
    flop = _f(prod=sum(9 * k ** 3 for k in ks))
    nbytes = sum(8 * (2 * k * k + k) for k in ks)
    return bound_ms(flop, nbytes)


def eigh_gates(name, a, lam, u):
    """The eigh kernel's (lam, u) of one matrix a against torch.linalg.eigh
    on the card: eigenvalues within 1e-12 max|lam|, U diag(lam) U' within
    1e-12 of A normwise, U'U within 1e-12 of I, _deg_factor's kept
    eigenvalues equal. Raises if one fails; returns the eigenvalues' max
    abs error."""
    import torch
    k = a.shape[0]
    lam_l = torch.linalg.eigh(a)[0]
    scale = lam_l.abs().max()
    e_lam = ((lam - lam_l).abs().max() / scale).item()
    e_rec = (torch.linalg.matrix_norm(u @ torch.diag(lam) @ u.T - a)
             / torch.linalg.matrix_norm(a)).item()
    e_orth = (u.T @ u - torch.eye(k, dtype=a.dtype, device=a.device)
              ).abs().max().item()
    keep = lambda x: x > 1e-12 * x.max().clamp(min=1e-300)
    same_keep = torch.equal(keep(lam), keep(lam_l))
    if not (e_lam <= EIGH_TOL and e_rec <= EIGH_TOL and e_orth <= EIGH_TOL
            and same_keep):
        raise RuntimeError(f"(j) eigh {name} k={k}: eigenvalues {e_lam:.3e}, "
                           f"reconstruction {e_rec:.3e}, orthogonality "
                           f"{e_orth:.3e}, keep {same_keep}")
    return (lam - lam_l).abs().max().item()


def _block_stacks(mats):
    """The mutation's stacks of block matrices: the equal blocks, then a
    smaller last one (ops/mutation.py block_factors)."""
    import torch
    n_eq = sum(1 for m in mats if m.shape == mats[0].shape)
    return [torch.stack(mats[:n_eq])] + [m[None] for m in mats[n_eq:]]


def _batched_gates(name, mats):
    """One eigh_batched launch on the blocks `mats`: each block within
    eigh_gates, and bit for bit what a call on it alone gives. Returns the
    largest eigenvalue error."""
    import torch
    from smc_tpu_torch.ops import cuda_eigh
    before = _launches("eigh")["eigh"]
    out = cuda_eigh.eigh_batched(_block_stacks(mats))
    if _launches("eigh")["eigh"] != before + 1:
        raise RuntimeError(f"(j) eigh {name}: not one launch")
    got = [(lam[i], u[i]) for lam, u in out for i in range(lam.shape[0])]
    err = 0.0
    for a, (lam, u) in zip(mats, got):
        err = max(err, eigh_gates(name, a, lam, u))
        lam1, u1 = cuda_eigh.eigh(a)
        if not (torch.equal(lam, lam1) and torch.equal(u, u1)):
            raise RuntimeError(f"(j) eigh {name}: a block in the batched "
                               "call differs from a call on it alone")
    return err


EIGH_SPD_KS = (36, 64, 100, 128)   # shared memory up to 118, then global


def eigh_phase(dev, clouds):
    """(j) The eigh kernel against torch.linalg.eigh on the card. At the
    mutation's blocks of the posterior clouds (AS's 13x13, the linear
    fixture's three 3x3, SW's three 12x12), each cell's blocks in one
    batched launch as a stage makes it, with eigh_gates and bit for bit
    against each block alone; a NaN block in SW's batch leaves the others'
    bits; a batch of two sizes (12, 12, 11); then SPD matrices at
    EIGH_SPD_KS. Times per call and per stage (kernel back to back and
    replayed from a CUDA graph, plain, library) and the bound. Returns the
    kernels-line entry at AS's shape."""
    import numpy as np
    import torch
    from smc_tpu_torch.cloud import weighted_cov
    from smc_tpu_torch.ops import cuda_eigh
    from smc_tpu_torch.ops.mutation import block_sizes
    print(f"# (j) eigh: {smi_line()}")
    entry = None
    for name, cloud, space, n_blocks in clouds:
        vals = cloud.params[:, torch.as_tensor(space.free_inds, device=dev)]
        cov = weighted_cov(vals, cloud.weights)
        cov = 0.5 * (cov + cov.T)
        offs = np.concatenate([[0], np.cumsum(block_sizes(space.n_free,
                                                          n_blocks))])
        mats = [cov[o:e, o:e].contiguous() for o, e in zip(offs[:-1],
                                                          offs[1:])]
        err = _batched_gates(name, mats)
        stacks = _block_stacks(mats)
        k, a = mats[0].shape[0], mats[0]
        stage = lambda: cuda_eigh.eigh_batched(stacks)
        ms, in_graph_ms = cuda_ms(stage, 20), graph_ms(stage, 20)
        one_ms = cuda_ms(lambda: cuda_eigh.eigh(a), 20)
        one_graph_ms = graph_ms(lambda: cuda_eigh.eigh(a), 20)
        plain_ms = cuda_ms(lambda: [cuda_eigh.eigh_plain(x) for x in stacks],
                           20)
        lib_ms = cuda_ms(lambda: [torch.linalg.eigh(x) for x in stacks], 20)
        lib_one_ms = cuda_ms(lambda: torch.linalg.eigh(a), 20)
        bound, by = eigh_bound([m.shape[0] for m in mats])
        print(f"# (j) eigh {name}: {len(mats)} block(s) of k={k}, max abs "
              f"err of the eigenvalues {err:.3e}, all gates held, batched "
              f"bits equal each block's alone; per stage (one launch) "
              f"kernel {ms:.4f} ms ({in_graph_ms:.4f} ms replayed from a "
              f"CUDA graph), plain {plain_ms:.4f} ms, torch.linalg.eigh "
              f"{lib_ms:.4f} ms, bound {bound:.8f} ms ({by}); per call at "
              f"one block kernel {one_ms:.4f} ms ({one_graph_ms:.4f} ms "
              f"graph), torch.linalg.eigh {lib_one_ms:.4f} ms")
        if entry is None:
            entry = dict(name="eigh_jacobi", route="cuda",
                         source="smc_tpu_torch/csrc/eigh_kernel.cu",
                         replaces="smc_tpu/ops/mutation.py:76",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound, bound_by=by, library_ms=lib_ms)
        if name.startswith("SW"):
            bad = stacks[0].clone()
            bad[1, k - 1, 0] = float("nan")
            lam, u = cuda_eigh.eigh(bad)
            lam0, u0 = cuda_eigh.eigh(stacks[0])
            keep = [i for i in range(bad.shape[0]) if i != 1]
            if not (bool(torch.isnan(lam[1]).all() and torch.isnan(u[1]).all())
                    and torch.equal(lam[keep], lam0[keep])
                    and torch.equal(u[keep], u0[keep])):
                raise RuntimeError("(j) eigh: a NaN block changed its "
                                   "neighbours or was not NaN")
            print("# (j) eigh: a NaN block in SW's batch gives NaN and "
                  "leaves the other blocks' bits")
    rng = np.random.default_rng(0)
    mats = []
    for k in (12, 12, 11):
        x = rng.standard_normal((k, k + 3))
        mats.append(torch.as_tensor(x @ x.T, device=dev))
    err = _batched_gates("two sizes (12, 12, 11)", mats)
    print(f"# (j) eigh two sizes (12, 12, 11) in one launch: max abs err "
          f"{err:.3e}, all gates held, bits equal each block's alone")
    for k in EIGH_SPD_KS:
        x = np.random.default_rng(k).standard_normal((k, k + 3))
        a = torch.as_tensor(x @ x.T, device=dev)
        lam, u = cuda_eigh.eigh(a)
        err = eigh_gates("SPD", a, lam, u)
        reps = 5
        ms = cuda_ms(lambda: cuda_eigh.eigh(a), reps)
        in_graph_ms = graph_ms(lambda: cuda_eigh.eigh(a), reps)
        lib_ms = cuda_ms(lambda: torch.linalg.eigh(a), reps)
        path = ("shared memory" if k <= cuda_eigh.SHARED_K
                else "global workspace")
        print(f"# (j) eigh SPD k={k} ({path}): max abs err of the "
              f"eigenvalues {err:.3e}, all gates held; kernel {ms:.4f} ms "
              f"({in_graph_ms:.4f} ms graph), torch.linalg.eigh "
              f"{lib_ms:.4f} ms")
    return entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh-only", action="store_true",
                    help="run the kernel build, the AS main path and phase "
                         "(i) only (the particle mesh; on a machine with "
                         "several cards, one NCCL rank per card)")
    ap.add_argument("--other", type=os.path.abspath, default=None,
                    help="another csrc/ tree (an older commit's, unpacked "
                         "with git archive): phase (l) times its Kalman "
                         "kernel against this checkout's in turns")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import torch
    import smc_tpu_torch
    from smc_tpu_torch import _build
    pkg = os.path.join(HERE, "smc_tpu_torch")
    if os.path.dirname(os.path.abspath(smc_tpu_torch.__file__)) != pkg:
        raise RuntimeError(f"chip_smoke.py runs the checkout's own package "
                           f"({pkg}), not {smc_tpu_torch.__file__}")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    dev = torch.device("cuda", 0)
    print(f"# {smi_line()}")
    print(f"# torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t_start = t0 = time.perf_counter()
    libs = _build.build_cuda_libraries()
    print(f"# kernel build {time.perf_counter() - t0:.2f} s, one nvcc per "
          f"library in parallel ({', '.join(p.name for p in libs.values())})")
    ptxas = ptxas_table(libs)
    # the DSGE kernels' other shapes are printed by the shape phase
    for name, line in ptxas.items():
        if (not name.startswith(("re_kernel<", "kalman_kernel<"))
                or name.endswith("<6,3>")):
            print(f"# ptxas {name}: {line}")

    if args.mesh_only:
        _, res_as, wall_as = main_path(dev)
        mesh_phase(dev, res_as, wall_as)
        print(f"# all phases {time.perf_counter() - t_start:.1f} s (build "
              "included)")
        print(json.dumps(_device_line()))
        return 0
    kernels = kernel_phase(dev)
    shapes = shape_phase(dev, ptxas)
    general = general_phase(dev, ptxas)
    launches, res_as, wall_as = main_path(dev)
    lin, res_a, wall_a = linear_phase(dev)
    res_b, wall_b = adaptive_phase(dev)
    res_c, wall_c, chain_launches = metropolis_phase(dev, lin)
    chain = chain_phase(dev, [("linear-32k", res_c), ("AS-16k", res_as)],
                        chain_launches)
    checkpoint_phase(dev, lin, res_a)
    tempered_phase(dev, lin)
    sw_launches = sw_phase(dev)
    expectations = sw_pi_fg_phase(dev, ptxas, args.other)
    res_g, wall_g = as2obs_phase(dev)
    capm_phase(dev)
    mesh_phase(dev, res_as, wall_as)
    res_sw = fused_phase(dev, res_as, wall_as, res_a, wall_a, res_b, wall_b,
                         lin, res_g, wall_g, res_c, wall_c)
    kernels.append(eigh_phase(dev, [
        ("AS-16k", res_as.cloud, res_as.space, AS_CONFIG["n_blocks"]),
        ("linear-32k", res_a.cloud, res_a.space, LIN_CONFIG["n_blocks"]),
        ("SW-4k", res_sw.cloud, res_sw.space, SW_CONFIG["n_blocks"])]))
    examples_phase(dev)
    for k, key in zip(kernels, ("re", "kalman", "eigh")):
        k["launches"] = launches[key]
    kernels.append(chain)
    for k, key in zip(general, ("re_general", "kalman_general")):
        k["launches"] = sw_launches[key]
    kernels.extend(general)
    kernels.append(expectations)
    kernels.extend(shapes)
    print(f"# all phases {time.perf_counter() - t_start:.1f} s (build "
          "included)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps(_device_line()))
    return 0


def _device_line():
    import torch
    return {"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}


if __name__ == "__main__":
    sys.exit(main())
