#!/usr/bin/env python3
"""The benchmark of smc_tpu_torch: one cell of BENCHMARK.json, run once.

    python3 perfbench/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (setup_s, from process start): import torch and start CUDA, load
(at the first run of a checkout, build, all at once) the kernel libraries
the configuration names in smc_tpu_torch/_build/, build the model from the
committed data and run one estimation of WARMUP_STAGES stages at the
cell's own shapes.

--trace 0: the window. Whole estimations run back to back through
smc_tpu_torch.smc(loglike_batched, parameters, data, batched=True,
verbose="none", testing=True, **mix), estimation i on the seed
estimation_seed(--seed, i); a new one starts only while less than
--seconds have passed, and every one that starts is finished. The line
holds the cell's end-to-end metrics, taken over all of them.

--trace 1: a torch.profiler span over the mix's `traced_estimations`
whole estimations; the line holds the cell's per-layer metrics (each read
by metrics/<name>.py), the device's busy time and the breakdown.

Then, the window closed and the device's peak memory read, the check
(check.py) compares what the estimations returned with the plain
reference; its numbers and limits end standard error and the result's
line. A mix with "ranks": R > 1 runs R processes, one NCCL rank per card,
under smc(mesh=particle_mesh()); rank 0 prints the line.

Without a CUDA card, or with fewer than the cell asks for, the run exits
with code 3 and prints no result; so does a run whose process holds jax,
jaxlib, flax or smc_tpu (the JAX package) once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()
_T0_WALL = time.time()

import argparse                      # noqa: E402
import hashlib                       # noqa: E402
import json                          # noqa: E402
import math                          # noqa: E402
import os                            # noqa: E402
import shutil                        # noqa: E402
import subprocess                    # noqa: E402
import sys                           # noqa: E402
import tempfile                      # noqa: E402
import traceback                     # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "smc_tpu")
NO_RESULT = 3
# set-up's estimation: two stages at the cell's shapes, which the first
# stage (eager) and the second (captured as a CUDA graph) take
WARMUP_STAGES = 2


def estimation_seed(seed: int, i: int) -> int:
    """The seed of estimation i of a run on --seed: 63 bits of a hash, so
    any whole number (negative, or past 64 bits) gives a valid torch
    seed."""
    h = hashlib.sha256(f"perfbench {seed} {i}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _unit(seed: int, i: int) -> float:
    h = hashlib.sha256(f"perfbench check {seed} {i}".encode()).digest()
    return int.from_bytes(h[:8], "little") / 2.0 ** 64


def is_checked(seed: int, i: int, share: float) -> bool:
    """Whether estimation i is among those the check compares: the first
    always, each other with probability `share`, drawn from the seed."""
    return i == 0 or _unit(seed, i) < share


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (smc_tpu_torch is not smc_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _smi() -> str:
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "nvidia-smi: not found"
    p = subprocess.run([exe, "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True)
    return " | ".join(p.stdout.strip().splitlines()) or p.stderr.strip()


def build_libraries(names):
    """The program's kernel libraries (smc_tpu_torch/_build.py), built
    where missing, all at once."""
    from concurrent.futures import ThreadPoolExecutor
    from smc_tpu_torch import _build
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return [f.result() for f in [pool.submit(_build.build_cuda_library, n)
                                     for n in names]]


class Rank:
    """One process of a run: its device and, under a mesh, its place."""

    def __init__(self, device, rank=0, world=1):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self.rank, self.world = rank, world
        self.mesh = None

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize(self.device)

    def join(self, store_path):
        from smc_tpu_torch.parallel import (initialize_multihost,
                                            particle_mesh)
        store = self.torch.distributed.FileStore(store_path, self.world)
        initialize_multihost(num_processes=self.world, process_id=self.rank,
                             backend="nccl" if self.cuda else "gloo",
                             device=self.device, store=store)
        self.mesh = particle_mesh()

    def agree(self, flag: bool) -> bool:
        """Rank 0's flag on every rank (one collective); the flag itself
        on one card."""
        if self.mesh is None:
            return flag
        t = self.torch.tensor([1.0 if flag else 0.0], device=self.device)
        self.torch.distributed.broadcast(t, 0)
        return bool(t.item())

    def reduce(self, value: float, op: str) -> float:
        """value reduced over the ranks ("max" or "sum")."""
        if self.mesh is None:
            return value
        dist = self.torch.distributed
        t = self.torch.tensor([float(value)], dtype=self.torch.float64,
                              device=self.device)
        dist.all_reduce(t, dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
        return float(t.item())

    def disagreement(self, results):
        """ranks_gap: the largest difference, over the kept estimations,
        between what rank 0 and any other rank got back (a digest of the
        whole cloud, its weight matrices and log-MDD; a mesh returns the
        same whole result on every rank, so 0); None on one card."""
        if self.mesh is None:
            return None
        torch = self.torch
        dig = torch.tensor([[float(x) for x in (
            r.cloud.params.sum(), r.cloud.loglh.sum(), r.cloud.weights.sum(),
            r.cloud.params.abs().max(), r.w.sum(), r.W.sum(), r.log_mdd,
            len(r.cloud.tempering_schedule))] for r in results] or [[0.0]],
            dtype=torch.float64, device=self.device)
        every = [torch.empty_like(dig) for _ in range(self.world)]
        torch.distributed.all_gather(every, dig)
        gap = max(float((d - every[0]).abs().max()) for d in every)
        return math.inf if math.isnan(gap) else gap

    def close(self):
        if self.mesh is not None:
            self.torch.distributed.destroy_process_group()


def run(cell, seed: int, seconds: float, trace: bool, rank: Rank,
        t0_wall: float = None):
    """One run of `cell` on `rank`; returns the result's dict on rank 0
    (None elsewhere). Set-up is timed from this process's start, or from
    the wall clock's t0_wall (a mesh rank: its launcher's start)."""
    import numpy as np
    torch = rank.torch
    import smc_tpu_torch
    pkg = os.path.join(ROOT, "smc_tpu_torch")
    if os.path.dirname(os.path.abspath(smc_tpu_torch.__file__)) != pkg:
        raise RuntimeError(f"the program imported is {smc_tpu_torch.__file__}"
                           f", not the checkout's own {pkg}")
    if rank.cuda:
        build_libraries(cell.config.LIBRARIES)
    if rank.world > 1 and rank.mesh is None:
        raise RuntimeError("a mesh cell's rank runs after Rank.join")
    loglike, parameters = cell.config.program()
    data = np.load(os.path.join(ROOT, cell.config.DATA))
    kw = dict(cell.mix["smc"], batched=True, verbose="none", testing=True,
              device=rank.device)
    if rank.mesh is not None:
        kw["mesh"] = rank.mesh

    def estimate(i, **over):
        return smc_tpu_torch.smc(loglike, parameters, data,
                                 **dict(kw, seed=estimation_seed(seed, i),
                                        **over))

    estimate(-1, n_phi=WARMUP_STAGES + 1)
    rank.sync()
    setup_s = (time.perf_counter() - _T0 if t0_wall is None
               else time.time() - t0_wall)

    kept, walls, stages = [], [], []
    attempted = failed = 0
    tracer = None

    def one(i, keep):
        nonlocal attempted, failed
        attempted += 1
        t = time.perf_counter()
        try:
            res = estimate(i)
            rank.sync()
        except Exception:           # counted, and the run goes on
            failed += 1
            _log(f"estimation {i} raised:\n{traceback.format_exc()}")
            return
        walls.append(time.perf_counter() - t)
        stages.append(len(res.cloud.tempering_schedule) - 1)
        if not math.isfinite(res.log_mdd):
            failed += 1
        if keep:
            kept.append(res)

    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        from perfbench.trace import SPAN
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if rank.cuda else [])
        with profile(activities=acts) as tracer:
            with record_function(SPAN):
                for i in range(int(cell.mix["traced_estimations"])):
                    one(i, True)
                rank.sync()
    else:
        share = float(cell.mix["checked_share"])
        start = time.perf_counter()
        i = 0
        while rank.agree(time.perf_counter() - start < seconds):
            one(i, is_checked(seed, i, share))
            i += 1

    ranks_gap = rank.disagreement(kept)
    peak = 0
    if rank.cuda:
        peak = int(rank.reduce(torch.cuda.max_memory_allocated(rank.device),
                               "max"))
    tr = None
    if trace:
        tr = _read_trace(tracer, rank)
    found = forbidden_modules()
    if found:
        _log(f"rank {rank.rank}'s process holds {found}")
    held = rank.reduce(len(found), "max")
    if rank.rank != 0:
        rank.close()
        return None

    out = {"attempted": attempted, "failed": failed, "_held": held}
    out["device"] = _device(rank, peak)
    if trace:
        from perfbench.traced import TracedRun
        ctx = TracedRun(kept, walls, tr, cell, data, rank.world, rank.rank)
        metrics = {}
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        if tr is not None:
            out["device"]["busy_s"] = tr.mean_busy_s
            out["device"]["window_s"] = tr.mean_window_s
            out["breakdown"] = {"device_ops": tr.device_ops(),
                                "idle_gaps": tr.idle_gaps()}
    else:
        out["metrics"] = _end_to_end(cell, setup_s, walls, stages)

    # the check: the program's state freed first, the reference in blocks
    from perfbench import check
    records = [check.Record.of(r) for r in kept]
    del kept
    if rank.cuda:
        torch.cuda.empty_cache()
    per = []
    for rec in records:
        ref = check.reference_outputs(rec, cell.reference, data,
                                      cell.mix["smc"])
        per.append(check.gaps(check.program_outputs(rec), ref,
                              cell.posterior))
    numbers = (check.widest(per) if per
               else {k: math.inf for k in check.NUMBERS})
    if ranks_gap is not None:
        numbers["ranks_gap"] = ranks_gap
    out["correct"] = check.judge(numbers, cell.limits, failed, len(per))
    out["checks"] = check.as_json(numbers, cell.limits)
    out["_lines"] = check.lines(numbers, cell.limits) + [
        f"check estimations_checked {len(per)} of {attempted}",
        f"check failed {failed} limit 0"]
    rank.close()
    return out


def _read_trace(tracer, rank):
    """The trace of this rank's span (trace.Trace), with busy_s and
    window_s averaged over the ranks; None without a card."""
    if not rank.cuda:
        return None
    from perfbench.trace import Trace
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        tracer.export_chrome_trace(path)
        tr = Trace.load(path)
    finally:
        os.remove(path)
    busy = rank.reduce(tr.busy_s, "sum") / rank.world
    window = rank.reduce(tr.window_s, "sum") / rank.world
    tr.mean_busy_s, tr.mean_window_s = busy, window
    return tr


def _device(rank, peak):
    torch = rank.torch
    if not rank.cuda:
        return {"platform": "cpu", "kind": "cpu", "count": rank.world,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(rank.device),
            "count": rank.world, "memory_peak_bytes": peak}


def _end_to_end(cell, setup_s, walls, stages):
    values = {"setup_s": setup_s}
    if walls:
        values["stage_ms"] = 1e3 * sum(walls) / sum(stages)
        values["estimation_s"] = sum(walls) / len(walls)
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def emit(out) -> int:
    """Standard error's last lines, then the result's line last on
    standard output, its `checks` last; nothing printed (exit 3) where
    this process, or any rank's once the window closed, holds JAX."""
    found = forbidden_modules()
    if found or out.pop("_held") > 0:
        _log(f"a process of the run holds {found or 'jax'}: the benchmark "
             "runs smc_tpu_torch alone")
        return NO_RESULT
    lines = out.pop("_lines")
    _log(f"# {_smi()}")
    for line in lines:
        _log(line)
    checks = out.pop("checks")
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": out["device"]}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = checks
    sys.stdout.flush()
    print(json.dumps(line), flush=True)
    return 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--t0-wall", type=float, default=None,
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import spec
    cell = spec.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < \
            cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
             f"device_count() {torch.cuda.device_count()}")
        return NO_RESULT
    world = int(cell.mix.get("ranks", 1))
    if world == 1:
        out = run(cell, args.seed, args.seconds, bool(args.trace),
                  Rank("cuda:0"))
        return emit(out)
    if args.rank is None:
        return _spawn(args, cell, world)
    rank = Rank(f"cuda:{args.rank}", args.rank, world)
    rank.join(args.store)
    out = run(cell, args.seed, args.seconds, bool(args.trace), rank,
              t0_wall=args.t0_wall)
    return emit(out) if out is not None else 0


def _spawn(args, cell, world) -> int:
    """The ranks of a mesh cell, one process per card, after the kernel
    libraries are built here once; rank 0 prints the line."""
    build_libraries(cell.config.LIBRARIES)
    found = forbidden_modules()
    if found:
        _log(f"the launcher's process holds {found}")
        return NO_RESULT
    tmp = tempfile.mkdtemp(prefix="perfbench_store_")
    store = os.path.join(tmp, "store")
    cmd = [sys.executable, os.path.abspath(__file__),
           "--workload", args.workload, "--seed", str(args.seed),
           "--seconds", str(args.seconds), "--trace", str(args.trace),
           "--store", store, "--t0-wall", repr(_T0_WALL)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)])
             for r in range(world)]
    try:
        codes = [p.wait() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    if any(codes):
        _log(f"rank exit codes {codes}")
        return codes[0] or 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
