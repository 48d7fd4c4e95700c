"""Time this checkout's DSGE kernels at one (n_state, n_shock), by default
An-Schorfheide's (6, 3), against another csrc/ tree's, in turns (other,
this, this, other) on one card.

    python3 tests/torch_dsge_turns.py --other DIR [--shape NS,NK] [--out FILE]

DIR holds a dsge_kernels.cu with this checkout's C interface
(smc_dsge_prepare, smc_re_solve, smc_kalman): unpack an older commit with
`git archive` into a gitignored directory and pass its smc_tpu_torch/csrc.
It is built with nvcc and this checkout's DSGE flags (-DSMC_MAX_DIM, and
-DSMC_NS=NS, which a tree from before the per-n_state libraries ignores;
tests/torch_turns.py); this checkout's library through
smc_tpu_torch._build. A variant of this checkout's kernels (another lane
count, launch bounds, -maxrregcount in NVCC_FLAGS) is measured the same
way, from a copy of csrc/ edited by hand in a gitignored directory. Both
are launched through the same bare ctypes calls on outputs allocated once,
on chip_smoke.py's inputs: at (6, 3) its kernel phase's (16,384 AS prior
draws, the AS data), elsewhere its shape phase's (16,384 synthetic
systems, 80 observations). Each turn times the RE solve and the Kalman
filter back to back (chip_smoke.cuda_ms: the median of 5 batches of 20
calls) and from a CUDA graph (chip_smoke.graph_ms).
Prints both builds' ptxas lines at the shape (registers, spills) and one
line per turn; with --out, writes the numbers, with the card's name and
power limit, to FILE as JSON."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_turns import build_tree, turns  # noqa: E402


def launchers(path: Path, inputs, n_s: int, n_k: int):
    """(re(), kalman()): bare launches of the library's kernels on `inputs`
    into outputs allocated once."""
    import torch
    from smc_tpu_torch.ops import kernels
    A, B, C, D, Q, Z, d, H, data = inputs
    lib = kernels.typed(path, f"dsge_ns{n_s}")
    kernels.prepare(lib, f"dsge_ns{n_s}", A.device)
    n = A.shape[-1]
    X = torch.empty((n_s, n_s, n), dtype=A.dtype, device=A.device)
    M = torch.empty((n_s, n_k, n), dtype=A.dtype, device=A.device)
    ok = torch.empty(n, dtype=torch.bool, device=A.device)
    out = torch.empty(n, dtype=A.dtype, device=A.device)
    stream = lambda: torch.cuda.current_stream().cuda_stream

    def re():
        rc = lib.smc_re_solve(n_s, n_k, A.data_ptr(), B.data_ptr(),
                              C.data_ptr(), D.data_ptr(), X.data_ptr(),
                              M.data_ptr(), ok.data_ptr(), n, 16, 1e-8,
                              stream())
        if rc != 0:
            raise RuntimeError(f"RE launch failed ({rc})")

    def kalman():
        rc = lib.smc_kalman(n_s, n_k, X.data_ptr(), M.data_ptr(), Q.data_ptr(),
                            Z.data_ptr(), d.data_ptr(), H.data_ptr(),
                            data.data_ptr(), data.shape[1], ok.data_ptr(), n,
                            30, out.data_ptr(), stream())
        if rc != 0:
            raise RuntimeError(f"Kalman launch failed ({rc})")

    re()
    kalman()
    torch.cuda.synchronize()
    return re, kalman, (X, M, ok, out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--shape", default="6,3",
                    help="n_state,n_shock (default 6,3)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    n_s, n_k = (int(v) for v in args.shape.split(","))
    import torch
    import chip_smoke
    from torch_parity import synthetic_system
    from smc_tpu_torch import _build
    from smc_tpu_torch.models import as_dsge
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    dev = torch.device("cuda", 0)
    if (n_s, n_k) == (6, 3):
        th = ParamSpace(as_dsge.an_schorfheide_parameters()).sample_prior(
            TorchDraws(1, dev), chip_smoke.AS_N_PARTS, device=dev)
        d, Z, H = as_dsge._measurement(th)
        inputs = (*as_dsge._system(th), as_dsge._shock_cov(th), Z, d, H,
                  torch.as_tensor(as_dsge.load_as_data(), device=dev))
    else:
        sys_np, data = synthetic_system(n_s, n_k, chip_smoke.SHAPES_N)
        inputs = tuple(torch.as_tensor(x, device=dev)
                       for x in (*sys_np, data))
    flags = _build.CUDA_LIBRARIES[f"dsge_ns{n_s}"].flags
    libs = {"other": build_tree(args.other.resolve(), "dsge_kernels.cu",
                                f"libsmc_dsge_other_ns{n_s}", flags),
            "this": _build.build_cuda_library(f"dsge_ns{n_s}")}
    print(f"# {chip_smoke.smi_line()}")
    for name, path in libs.items():
        for line in chip_smoke.ptxas_lines(path.with_suffix(".log")
                                           .read_text()):
            if f"<{n_s},{n_k}>" in line:
                print(f"# ptxas {name}: {line}")
    runs = {name: launchers(path, inputs, n_s, n_k)
            for name, path in libs.items()}
    same = all(torch.equal(a, b) for a, b in zip(runs["other"][2],
                                                 runs["this"][2]))
    print(f"# ({n_s}, {n_k}): outputs bitwise equal: {same}")
    times = {kern: turns({name: runs[name][i] for name in runs}, 20)
             for i, kern in enumerate(("re", "kalman"))}
    for kern, t in times.items():
        for name, ms in t.items():
            print(f"# {kern} {name} (ms, graph ms) per turn: {ms}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=chip_smoke.smi_line(), shape=[n_s, n_k],
                           equal=same, ms=times), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
