"""Build the hand-written kernels from csrc/ into shared libraries.

Each CUDA source is compiled by nvcc for sm_90a (Hopper) into a plain-C
shared library that its wrapper loads with ctypes: dsge_kernels.cu for
ops/cuda_dsge.py, once per n_state of the domain (library "dsge_ns<n>",
with every n_shock: `DSGE_MAX_DIM`, csrc/dsge_sizes.cuh),
dsge_general_kernels.cu for ops/cuda_dsge_general.py, dsge_expectations.cu
for ops/cuda_dsge_expectations.py, eigh_kernel.cu for ops/cuda_eigh.py,
metropolis_kernel.cu for ops/cuda_metropolis.py. No
PyTorch headers are involved; `build_cuda_libraries` runs one nvcc per
library, all at once. A
wrapper builds the library it needs at its first use, into
smc_tpu_torch/_build/, under a name keyed by a hash of the sources and flags
(an edit rebuilds). Each build writes a temporary file and renames it into
place, so concurrent builds cannot leave a partial library behind. The
compiler's output (for nvcc, ptxas registers and spills) is kept beside the
library as <library>.log.

`build_cpu_library(n_state, n_shock)` compiles csrc/dsge_cpu.cpp (the
per-particle bodies as plain host loops) for one shape,
`build_general_cpu_library` csrc/dsge_general_cpu.cpp (the general-shape
block bodies, particle by particle), `build_expectations_cpu_library`
csrc/dsge_expectations_cpu.cpp (the expectation rows' block body),
`build_eigh_cpu_library`
csrc/eigh_cpu.cpp (the Jacobi body, block by block) and
`build_metropolis_cpu_library` csrc/metropolis_cpu.cpp (the chain, slot by
slot) with g++. Only the tests use them.

A missing compiler or a failed build raises RuntimeError with the
compiler's output; nothing here returns None.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def _key(source: Path, flags) -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join([source.name, *flags]).encode())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found in $CUDA_HOME/bin, /usr/local/cuda/bin "
                       "or PATH: the CUDA kernels cannot be built")


def _compile(compiler, flags, source: Path, stem: str) -> Path:
    key = _key(source, flags)
    out = BUILD_DIR / f"{stem}_{key}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [compiler, *flags, "-I", str(CSRC), "-o", str(tmp), str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot run {compiler}: {e}") from e
    if proc.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"build of {source.name} failed "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


# dynamic shared memory a block may use on Hopper (227 KB; above 48 KB a
# kernel must be allowed it, once per device). The one place it is set: the
# build passes it to the compiler for the kernels that size their tiles by it
# (csrc/dsge_general.cuh, csrc/eigh_jacobi.cuh) and the wrappers read it.
SMEM_LIMIT = 227 * 1024
_SMEM_FLAGS = (f"-DSMC_SMEM_LIMIT={SMEM_LIMIT}",)

# the DSGE kernels' domain, that of the TPU kernels they replace: n_state
# and n_shock 1..DSGE_MAX_DIM (n_obs 3). The one place it is set: the build
# passes it to the compiler (csrc/dsge_sizes.cuh checks it) and
# ops/cuda_dsge.py reads it.
DSGE_MAX_DIM = 8
DSGE_STATES = range(1, DSGE_MAX_DIM + 1)
_DSGE_FLAGS = (f"-DSMC_MAX_DIM={DSGE_MAX_DIM}",)

# the general-shape DSGE kernels' domain: n_state, n_shock and n_obs up to
# these, at run time (the tiles of the largest shape fit a block's shared
# memory; csrc/dsge_general.cuh checks it). The one place they are set: the
# build passes them to the compiler and ops/cuda_dsge_general.py reads them.
GENERAL_MAX_STATE = 64
GENERAL_MAX_SHOCK = 64
GENERAL_MAX_OBS = 16
_GENERAL_FLAGS = (f"-DSMC_GEN_MAX_STATE={GENERAL_MAX_STATE}",
                  f"-DSMC_GEN_MAX_SHOCK={GENERAL_MAX_SHOCK}",
                  f"-DSMC_GEN_MAX_OBS={GENERAL_MAX_OBS}", *_SMEM_FLAGS)

# the kernel libraries: name -> (source, library stem, extra nvcc flags)
CUDA_LIBRARIES = {
    **{f"dsge_ns{k}": ("dsge_kernels.cu", f"libsmc_dsge_ns{k}_cuda",
                       (*_DSGE_FLAGS, f"-DSMC_NS={k}")) for k in DSGE_STATES},
    "dsge_general": ("dsge_general_kernels.cu", "libsmc_dsge_general_cuda",
                     _GENERAL_FLAGS),
    "dsge_expectations": ("dsge_expectations.cu",
                          "libsmc_dsge_expectations_cuda", ()),
    "eigh": ("eigh_kernel.cu", "libsmc_eigh_cuda", _SMEM_FLAGS),
    "metropolis": ("metropolis_kernel.cu", "libsmc_metropolis_cuda", ()),
}


def build_cuda_library(name: str = "dsge_ns6") -> Path:
    """Path of one sm_90a kernel library (a key of CUDA_LIBRARIES; the
    default is An-Schorfheide's n_state), built if missing."""
    source, stem, extra = CUDA_LIBRARIES[name]
    return _compile(find_nvcc(), [*NVCC_FLAGS, *extra], CSRC / source, stem)


def build_cuda_libraries() -> dict:
    """Every kernel library, one nvcc per library, all started together:
    {name: path}."""
    with ThreadPoolExecutor(len(CUDA_LIBRARIES)) as pool:
        futures = {n: pool.submit(build_cuda_library, n)
                   for n in CUDA_LIBRARIES}
        return {n: f.result() for n, f in futures.items()}


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host build of the kernel "
                           "bodies cannot be made")
    return gxx


def build_cpu_library(n_state: int = 6, n_shock: int = 3) -> Path:
    """Path of the host build of the DSGE kernel bodies at one shape
    (tests only; the default is An-Schorfheide's)."""
    return _compile(_gxx(), [*GXX_FLAGS, *_DSGE_FLAGS,
                             f"-DSMC_NS={n_state}", f"-DSMC_NK={n_shock}"],
                    CSRC / "dsge_cpu.cpp",
                    f"libsmc_dsge_cpu_ns{n_state}_nk{n_shock}")


def build_general_cpu_library() -> Path:
    """Path of the host build of the general-shape DSGE block bodies (tests
    only)."""
    return _compile(_gxx(), [*GXX_FLAGS, *_GENERAL_FLAGS],
                    CSRC / "dsge_general_cpu.cpp", "libsmc_dsge_general_cpu")


def build_expectations_cpu_library() -> Path:
    """Path of the host build of the expectation rows' block body (tests
    only)."""
    return _compile(_gxx(), GXX_FLAGS, CSRC / "dsge_expectations_cpu.cpp",
                    "libsmc_dsge_expectations_cpu")


def build_eigh_cpu_library() -> Path:
    """Path of the host build of the Jacobi eigh body (tests only)."""
    return _compile(_gxx(), [*GXX_FLAGS, *_SMEM_FLAGS], CSRC / "eigh_cpu.cpp",
                    "libsmc_eigh_cpu")


def build_metropolis_cpu_library() -> Path:
    """Path of the host build of the Metropolis chain (tests only)."""
    return _compile(_gxx(), GXX_FLAGS, CSRC / "metropolis_cpu.cpp",
                    "libsmc_metropolis_cpu")
