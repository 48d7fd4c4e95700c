"""Time this checkout's eigh kernel against another csrc/ tree's, in turns
(other, this, this, other) on one card, beside torch.linalg.eigh.

    python3 tests/torch_eigh_turns.py --other DIR [--two-part] [--out FILE]

DIR holds an eigh_kernel.cu whose launcher takes one size per call,
smc_eigh(k, batch, a, lam, u, work, stream), as the kernels before the
two-part launch did: unpack an older commit with `git archive` into a
gitignored directory and pass its smc_tpu_torch/csrc. With --two-part its
launcher is this checkout's, smc_eigh(k0, n0, k1, n1, a, lam, u, work,
stream) (a variant of this kernel, in a gitignored copy). The other tree is
built with nvcc into smc_tpu_torch/_build/ (keyed by a hash of its files;
tests/torch_turns.py); this checkout's through smc_tpu_torch._build. Both
are launched through the same bare ctypes call on outputs allocated once,
so a back-to-back time at a small k compares the kernels and not their
Python wrappers.

Per single SPD matrix at each k of KS: the mean ms of back-to-back calls
(chip_smoke.cuda_ms) and of calls replayed from a CUDA graph
(chip_smoke.graph_ms), for both kernels and the library. Per stage at the
models' block shapes (AS 1 x 13, the linear fixture 3 x 3, SW 3 x 12): one
batched launch of this kernel against the other's launch per block, both
ways of timing. Prints one line per measurement; with --out, writes every
number, with the card's name and power limit, to FILE as JSON."""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_turns import build_tree, turns  # noqa: E402

KS = (3, 12, 13, 36, 64, 100, 128)
STAGES = (("AS", 1, 13), ("linear", 3, 3), ("SW", 3, 12))
REPS = 20             # calls per timing; 5 past k = 36


def build_other(csrc: Path, two_part: bool):
    """(the other kernel's launcher, a function of the stack a [batch, k, k]
    giving (lam, U), and the path of its library)."""
    from smc_tpu_torch import _build
    if csrc == _build.CSRC:
        out = _build.build_cuda_library("eigh")
    else:
        out = build_tree(csrc, "eigh_kernel.cu", "libsmc_eigh_other")
    return _launcher(ctypes.CDLL(str(out)), csrc, two_part), out


def _launcher(lib, csrc: Path, two_part: bool):
    """launch(a): the bare launch of lib's kernel on a stack a [batch, k,
    k], with its outputs (lam, U) allocated once per stack."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.smc_eigh.argtypes = ([I, L, I, L] if two_part else [I, L]) + [P] * 5
    lib.smc_eigh.restype = I
    lib.smc_eigh_prepare.restype = I
    if lib.smc_eigh_prepare() != 0:
        raise RuntimeError("the other kernel's set-up failed")
    shared_k = _shared_k(csrc)

    import torch
    outs = {}

    def launch(a):
        k, batch = a.shape[-1], a.shape[0]
        if a.data_ptr() not in outs:
            # room for A and V at any row stride up to k + 3
            work = (torch.empty(batch * 2 * k * (k + 3), dtype=a.dtype,
                                device=a.device) if k > shared_k else None)
            outs[a.data_ptr()] = (
                torch.empty(a.shape[:-1], dtype=a.dtype, device=a.device),
                torch.empty_like(a), work,
                ((k, batch, k, 0) if two_part else (k, batch))
                + (a.data_ptr(),))
        lam, u, work, head = outs[a.data_ptr()]
        rc = lib.smc_eigh(*head, lam.data_ptr(), u.data_ptr(),
                          None if work is None else work.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel launch failed ({rc})")
        return lam, u

    return launch


def _shared_k(csrc: Path) -> int:
    """kSharedK of the other tree's eigh_jacobi.cuh."""
    import re
    m = re.search(r"kSharedK\s*=\s*(\d+)",
                  (csrc / "eigh_jacobi.cuh").read_text())
    return int(m.group(1))


def spd(k, n, seed, dev):
    import numpy as np
    import torch
    x = np.random.default_rng(seed).standard_normal((n, k, k + 3))
    return torch.as_tensor(x @ x.transpose(0, 2, 1) / (k + 3), device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--two-part", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import cuda_ms, ptxas_lines, smi_line
    from smc_tpu_torch import _build
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = smi_line()
    print(f"# {card}")
    other_eigh, other_path = build_other(args.other.resolve(),
                                         args.two_part)
    this_eigh, this_path = build_other(_build.CSRC, True)
    for name, path in (("other", other_path), ("this", this_path)):
        for line in ptxas_lines(path.with_suffix(".log").read_text()):
            print(f"# ptxas {name}: {line}")
    rows = {"card": card, "reps": REPS, "single": {}, "stage": {}}
    for k in KS:
        reps = REPS if k <= 36 else 5
        a = spd(k, 1, k, dev)
        lam, u = this_eigh(a)
        lam_o, _ = other_eigh(a)
        lam_l = torch.linalg.eigh(a)[0]
        err = max(float((lam - lam_l).abs().max()),
                  float((lam_o - lam_l).abs().max()))
        t = turns({"other": lambda: other_eigh(a),
                   "this": lambda: this_eigh(a)}, reps)
        t["library"] = [(cuda_ms(lambda: torch.linalg.eigh(a), reps), None)]
        rows["single"][k] = t
        print(f"k={k}: max |lam - library| {err:.3e}; other (ms, graph ms) "
              f"{t['other']}; this {t['this']}; torch.linalg.eigh "
              f"{t['library'][0][0]:.4f} ms")
    for name, n, k in STAGES:
        a = spd(k, n, 100 + k, dev)
        blocks = [a[i:i + 1].contiguous() for i in range(n)]

        def other_stage():
            for b in blocks:
                other_eigh(b)

        t = turns({"other": other_stage, "this": lambda: this_eigh(a)},
                  REPS)
        t["library"] = [(cuda_ms(lambda: torch.linalg.eigh(a), REPS), None)]
        rows["stage"][name] = t
        print(f"stage {name} ({n} x {k}): other, {n} launches (ms, graph ms) "
              f"{t['other']}; this, one launch {t['this']}; "
              f"torch.linalg.eigh (one batched call) "
              f"{t['library'][0][0]:.4f} ms")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
