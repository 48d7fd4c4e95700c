"""Count the SASS instructions of one Metropolis chain step in the sm_90a
kernel (csrc/metropolis_kernel.cu), by opcode, and time the kernel.

    python3 tests/torch_chain_sass.py [--other DIR] [--time] [--out FILE]

Builds the kernel library with nvcc (this checkout's through
smc_tpu_torch._build, as its wrapper does; with --other, also DIR's
metropolis_kernel.cu, a csrc/ tree unpacked from another commit or a
variant, into smc_tpu_torch/_build/), disassembles it with cuobjdump -sass
from the same CUDA toolkit, takes the metropolis kernel's innermost loop
that holds the weight gathers (LDG.E.64), and divides its instruction
counts by the number of those gathers, one per step. The loop's branches
and its guards of a partial last block count in full. With --time (a card
needed) it also times each library's launch in turns (this, other, other,
this) at n = n_out = 32,768 weights and 100 steps, the size of a linear-32k
resample, between CUDA events. Prints one JSON object per library: the
per-step count of each opcode (its modifiers kept), the loop's
instructions and gathers, the kernel's instructions, and the times; with
--out, writes it to FILE and each kernel's SASS beside it.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"\s*(0x[0-9a-f]+)?")


def kernel_sass(lib: Path) -> list:
    """The metropolis kernel's SASS lines (labels and instructions)."""
    from smc_tpu_torch import _build
    cuobjdump = Path(_build.find_nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    lines, inside = [], False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "metropolis_kernel" in line
        elif inside:
            lines.append(line)
    if not lines:
        raise RuntimeError(f"no metropolis_kernel in {lib}")
    return lines


def step_counts(lines: list) -> dict:
    """Per-step opcode counts of the innermost loop holding the gathers:
    the instructions from a backward branch's target to the branch."""
    insns = []
    for line in lines:
        m = _INSN.search(line)
        if m:
            insns.append((int(m.group(1), 16), m.group(3),
                          int(m.group(4), 16) if m.group(4) else None))
    loops = []
    for addr, op, target in insns:
        if op.startswith("BRA") and target is not None and target <= addr:
            body = [o for a, o, _ in insns if target <= a <= addr]
            gathers = sum(o.startswith("LDG.E.64") for o in body)
            if gathers:
                loops.append((len(body), body, gathers))
    if not loops:
        raise RuntimeError("no loop with weight gathers in the kernel")
    _, body, gathers = min(loops)
    counts = collections.Counter(body)
    return {"per_step": {o: counts[o] / gathers for o in sorted(counts)},
            "loop_instructions": len(body), "gathers": gathers,
            "kernel_instructions": len(insns)}


def build_other(csrc: Path) -> Path:
    """DIR's metropolis_kernel.cu built with nvcc (keyed by its files)."""
    from smc_tpu_torch import _build
    h = hashlib.sha256()
    for f in sorted(csrc.iterdir()):
        if f.is_file():
            h.update(f.name.encode() + f.read_bytes())
    out = (_build.BUILD_DIR
           / f"libsmc_metropolis_other_{h.hexdigest()[:16]}.so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(csrc), "-o", str(out),
                        str(csrc / "metropolis_kernel.cu")], check=True,
                       capture_output=True)
    return out


def time_turns(libs: dict, reps: int = 200) -> dict:
    """Mean ms per launch of each library, in turns (a, b, b, a)."""
    import numpy as np
    import torch
    import chip_smoke
    from smc_tpu_torch.ops import kernels
    n, dev = 32768, torch.device("cuda")
    w = torch.as_tensor(np.random.default_rng(0).exponential(size=n),
                        device=dev)
    key = torch.tensor([0x243F6A88, 0x85A308D3], device=dev)
    flag = torch.ones((), dtype=torch.bool, device=dev)
    steps = torch.tensor(100, device=dev)
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    calls = {}
    for name, path in libs.items():
        lib = kernels.typed(path, "metropolis")
        args = (w.data_ptr(), n, n, key.data_ptr(), flag.data_ptr(),
                steps.data_ptr(), idx.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        calls[name] = lambda lib=lib, args=args: lib.smc_metropolis(*args)
    names = list(libs)
    order = names + names[::-1]
    times = {name: [] for name in names}
    for name in order:
        times[name].append(chip_smoke.cuda_ms(calls[name], reps))
    return times


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    from smc_tpu_torch import _build
    libs = {"this": _build.build_cuda_library("metropolis")}
    if args.other:
        libs["other"] = build_other(args.other)
    res = {}
    for name, path in libs.items():
        lines = kernel_sass(path)
        if args.out:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.with_name(f"{args.out.stem}_{name}.sass").write_text(
                "\n".join(lines) + "\n")
        res[name] = step_counts(lines)
    if args.time:
        for name, ms in time_turns(libs).items():
            res[name]["ms"] = ms
    text = json.dumps(res, sort_keys=True)
    print(text)
    if args.out:
        args.out.write_text(text + "\n")


if __name__ == "__main__":
    main()
