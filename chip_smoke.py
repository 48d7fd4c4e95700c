#!/usr/bin/env python3
"""GPU smoke run of smc_tpu_torch: build the CUDA kernels, hold them against
their plain PyTorch versions, then run the An-Schorfheide estimation through
smc_tpu_torch.smc on the card.

    python3 chip_smoke.py                 # kernel phase + main path
    python3 chip_smoke.py --profile DIR   # also profile a second AS run

Needs one CUDA card and nvcc (the kernels are built from csrc/ at first
use). Every phase raises on failure and the script exits nonzero; it never
falls back to the CPU. The line before the last is a JSON object with each
kernel's launches on the main path, error against its plain version and
time; the last line is {"ok": true, "device": {...}}.
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

AS_N_PARTS = 16_384
AS_N_PHI = 100
REF_LOG_MDD = -1416.22     # JAX package, same data and configuration
MDD_TOL = 3.0              # nats
OK_AGREE_MIN = 0.9999
XM_RTOL = 1e-10
LL_RTOL = 1e-9             # over the posterior band (50 nats of the best)


def smi_line() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: command not found"
    p = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return (p.stdout.strip().splitlines() or [p.stderr.strip()])[0]


def cuda_ms(fn, reps: int) -> float:
    """Median ms of `reps` synchronized runs of fn, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def normwise_rel(a, b):
    """Per particle max|a-b| / max|b| over a batch-last [r, c, N] pair."""
    import torch
    num = (a - b).abs().amax(dim=(0, 1))
    den = b.abs().amax(dim=(0, 1)).clamp(min=1e-300)
    return num / den


def kernel_phase(dev):
    import torch
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

    # --- times at the main path's shapes ----------------------------------
    re_ms = cuda_ms(lambda: cuda_dsge.solve_linear_re(A, B, C, D), 20)
    re_plain_ms = cuda_ms(lambda: bl_solve_linear_re(A, B, C, D), 5)
    kal_ms = cuda_ms(lambda: cuda_dsge.kalman_chandrasekhar(
        X, M, Q, Z, d, H, data, ok=ok), 20)
    kal_plain_ms = cuda_ms(lambda: torch.where(okp, bl_kalman_loglike_chandrasekhar(
        Xp, Mp, Q, Z, d, H, data), float("-inf")), 5)
    print(f"# times at N={AS_N_PARTS} (median ms): re kernel {re_ms:.4f} "
          f"plain {re_plain_ms:.4f}; kalman kernel {kal_ms:.4f} plain "
          f"{kal_plain_ms:.4f}")
    return [
        dict(name="re_solve", route="cuda",
             source="smc_tpu_torch/csrc/dsge_kernels.cu",
             replaces="smc_tpu/ops/pallas_dsge.py:259",
             max_abs_err=re_abs, ms=re_ms, plain_ms=re_plain_ms),
        dict(name="kalman_chandrasekhar", route="cuda",
             source="smc_tpu_torch/csrc/dsge_kernels.cu",
             replaces="smc_tpu/ops/pallas_dsge.py:379",
             max_abs_err=ll_abs, ms=kal_ms, plain_ms=kal_plain_ms),
    ]


def main_path(dev):
    import numpy as np
    import torch
    import smc_tpu_torch
    from smc_tpu_torch.models import as_dsge
    from smc_tpu_torch.ops import cuda_dsge

    model = as_dsge.an_schorfheide()
    data = as_dsge.load_as_data()
    # a 2-stage run first pays the process's one-time costs (CUDA module
    # loading, cuSOLVER and cuBLAS handles, the allocator's first blocks)
    t0 = time.perf_counter()
    smc_tpu_torch.smc(model.loglike_batched,
                      as_dsge.an_schorfheide_parameters(), data,
                      batched=True, n_parts=AS_N_PARTS, n_phi=3, lam=2.0,
                      alpha=0.9, verbose="none", seed=1, device=dev)
    torch.cuda.synchronize()
    print(f"# warm-up (2 stages, first use in this process) "
          f"{time.perf_counter() - t0:.4f} s")
    for k in cuda_dsge.LAUNCHES:
        cuda_dsge.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    res = smc_tpu_torch.smc(
        model.loglike_batched, as_dsge.an_schorfheide_parameters(), data,
        batched=True, n_parts=AS_N_PARTS, n_phi=AS_N_PHI, lam=2.0,
        n_blocks=1, alpha=0.9, resampling_method="systematic",
        verbose="none", seed=0, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda_dsge.LAUNCHES)
    n_stages = len(res.cloud.tempering_schedule) - 1
    expected = 1 + res.init_rounds + n_stages
    print(f"# AS estimation: {n_stages} stages, {res.init_rounds} redraw "
          f"rounds, launches {launches} (expected {expected} each)")
    if n_stages != AS_N_PHI - 1 or any(v != expected
                                       for v in launches.values()):
        raise RuntimeError("the main path did not go through the kernels "
                           "once per likelihood call")
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
          f"{AS_N_PARTS * n_stages / wall:.1f} mutations/s")
    return launches


def profile_path(dev, out_dir):
    """Profile one more AS estimation with torch.profiler: device busy time
    (the sum of the device-side events: one stream, so they do not overlap)
    against wall time, and the kernels that take the device's time."""
    import torch
    from torch.profiler import profile, ProfilerActivity
    import smc_tpu_torch
    from smc_tpu_torch.models import as_dsge

    model = as_dsge.an_schorfheide()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smc_tpu_torch.smc(
            model.loglike_batched, as_dsge.an_schorfheide_parameters(),
            as_dsge.load_as_data(), batched=True, n_parts=AS_N_PARTS,
            n_phi=AS_N_PHI, lam=2.0, n_blocks=1, alpha=0.9,
            resampling_method="systematic", verbose="none", seed=0,
            device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in kernels.values()) / 1e6
    print(f"# profile: wall {wall:.4f} s (under the profiler), device busy "
          f"{busy:.4f} s, idle share {1.0 - busy / wall:.4f}")
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "profile_as16k.txt"), "w") as f:
        f.write(f"{smi_line()}\nwall {wall} s, device busy {busy} s\n")
        for name, (t, n) in rows:
            f.write(f"{t / 1e3:12.3f} ms {n:7d}x  {name}\n")
        f.write(prof.key_averages().table(sort_by="cpu_time_total",
                                          row_limit=40))
    for name, (t, n) in rows[:12]:
        print(f"# profile {t / 1e3:10.3f} ms {n:6d}x  {name[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="after the main path, profile another AS run and "
                         "write the table to DIR")
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

    t0 = time.perf_counter()
    lib = _build.build_cuda_library()
    print(f"# kernel build {time.perf_counter() - t0:.2f} s ({lib.name})")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"# ptxas {line.strip()}")

    kernels = kernel_phase(dev)
    launches = main_path(dev)
    if args.profile:
        profile_path(dev, args.profile)
    for k, key in zip(kernels, ("re", "kalman")):
        k["launches"] = launches[key]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
