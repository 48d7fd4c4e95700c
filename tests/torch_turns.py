"""What the kernel-against-kernel tools (tests/torch_dsge_turns.py,
tests/torch_eigh_turns.py) share: building another csrc/ tree's kernel
with nvcc, and timing two builds in turns on one card. Not a test module.
"""

from __future__ import annotations

import hashlib
import subprocess
from pathlib import Path


def build_tree(csrc: Path, source: str, stem: str, flags=()) -> Path:
    """The library of csrc/source built with nvcc and this checkout's flags
    plus `flags` into smc_tpu_torch/_build/, keyed by a hash of csrc's files
    and the flags; the compiler's output (ptxas registers and spills) beside
    it as <library>.log."""
    from smc_tpu_torch import _build
    h = hashlib.sha256(" ".join(flags).encode())
    for f in sorted(csrc.iterdir()):
        if f.is_file():
            h.update(f.name.encode() + f.read_bytes())
    out = _build.BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                               *flags, "-I", str(csrc), "-o", str(out),
                               str(csrc / source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {csrc / source} failed:\n"
                               f"{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    return out


def turns(fns, reps):
    """{name: [(back-to-back ms, graph ms) per turn]} for fns = {"other": f,
    "this": g}, in the order other, this, this, other (chip_smoke.cuda_ms
    and chip_smoke.graph_ms)."""
    from chip_smoke import cuda_ms, graph_ms
    out = {name: [] for name in fns}
    for name in ("other", "this", "this", "other"):
        out[name].append((cuda_ms(fns[name], reps), graph_ms(fns[name], reps)))
    return out
