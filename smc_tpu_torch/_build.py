"""Build the hand-written kernels from csrc/ into shared libraries, and
describe each library once.

`CUDA_LIBRARIES` is the one table of the kernel libraries: for each, the
CUDA source nvcc compiles for sm_90a (Hopper) into a plain-C shared
library, the host source g++ compiles into its host build, the flags both
take, and every C entry point with its ctypes types (`Library`).
ops/kernels.py loads, types and launches them from this table:
dsge_kernels.cu for ops/cuda_dsge.py, once per n_state of the domain
(library "dsge_ns<n>", with every n_shock: `DSGE_MAX_DIM`,
csrc/dsge_sizes.cuh), dsge_general_kernels.cu for
ops/cuda_dsge_general.py, dsge_expectations.cu for
ops/cuda_dsge_expectations.py, eigh_kernel.cu for ops/cuda_eigh.py,
metropolis_kernel.cu for ops/cuda_metropolis.py. No PyTorch headers are
involved; `build_cuda_libraries` runs one nvcc per library, all at once.
A library is built at its first use, into smc_tpu_torch/_build/, under a
name keyed by a hash of the sources and flags (an edit rebuilds). Each
build writes a temporary file and renames it into place, so concurrent
builds cannot leave a partial library behind. The compiler's output (for
nvcc, ptxas registers and spills) is kept beside the library as
<library>.log.

`build_cpu_library(name)` compiles a library's host build with g++: the
kernel bodies as plain host loops (csrc/*_cpu.cpp), with the card build's
flags. Only the tests use them.

A missing compiler or a failed build raises RuntimeError with the
compiler's output; nothing here returns None.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

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

# the ctypes types of the entry points' arguments and results
_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_double)


@dataclasses.dataclass(frozen=True)
class Library:
    """One kernel library: its builds and its C entry points, each declared
    once. The card build is nvcc on csrc/`source` with NVCC_FLAGS and
    `flags`, named `stem`_cuda; the host build g++ on csrc/`host_source`
    with GXX_FLAGS and `flags`, named `stem`_cpu. An entry point is
    (restype, argtypes) in ctypes types. `kernels` maps each kernel's entry
    to its launch counter (ops/kernels.py LAUNCHES) and its arguments
    before the stream, its last one; it returns a CUDA error code (0: it
    launched). The host build holds each as <entry>_cpu with the same
    arguments less the stream, unless `host` declares it otherwise; `host`
    also holds the host build's other entries and `queries` the card
    build's. `prepare` is (symbol, int arguments): the call that readies
    the kernels on a device before their first launch there, or None."""
    source: str
    host_source: str
    stem: str
    flags: tuple
    kernels: dict
    queries: dict = dataclasses.field(default_factory=dict)
    host: dict = dataclasses.field(default_factory=dict)
    prepare: Optional[tuple] = None

    def entries(self, host: bool = False) -> dict:
        """{symbol: (restype, argtypes)} of the card build, or with `host`
        of the host build."""
        if host:
            return {**{f"{k}_cpu": (_I, args)
                       for k, (_, args) in self.kernels.items()},
                    **self.host}
        out = {k: (_I, (*args, _P)) for k, (_, args) in self.kernels.items()}
        if self.prepare is not None:
            out[self.prepare[0]] = (_I, (_I,) * len(self.prepare[1]))
        return {**out, **self.queries}


# the RE solve's arguments (csrc/dsge_kernels.cu smc_re_solve,
# csrc/dsge_general_kernels.cu smc_general_re): n_state, n_shock, A, B, C,
# D, X, M, ok, N, n_iter, tol; the Kalman filter's after its shapes: T, R,
# Q, Z, d, H, data, n_t, ok, N, lyap_iter, out
_RE_ARGS = (_I, _I, *(_P,) * 7, _L, _I, _F)
_KALMAN_ARGS = (*(_P,) * 7, _I, _P, _L, _I, _P)

# the kernel libraries, by name
CUDA_LIBRARIES = {
    **{f"dsge_ns{k}": Library(
        "dsge_kernels.cu", "dsge_cpu.cpp", f"libsmc_dsge_ns{k}",
        (*_DSGE_FLAGS, f"-DSMC_NS={k}"),
        kernels={"smc_re_solve": ("re", _RE_ARGS),
                 "smc_kalman": ("kalman", (_I, _I, *_KALMAN_ARGS))},
        queries={"smc_kalman_smem_bytes": (_L, (_I, _I))},
        prepare=("smc_dsge_prepare", (SMEM_LIMIT,))) for k in DSGE_STATES},
    "dsge_general": Library(
        "dsge_general_kernels.cu", "dsge_general_cpu.cpp",
        "libsmc_dsge_general", _GENERAL_FLAGS,
        kernels={"smc_general_re": ("re_general", _RE_ARGS),
                 "smc_general_kalman": ("kalman_general",
                                        (_I, _I, _I, *_KALMAN_ARGS))},
        queries={"smc_general_re_smem": (_L, (_I, _I)),
                 "smc_general_kalman_smem": (_L, (_I, _I, _I, _I)),
                 "smc_general_kalman_blocks_per_sm": (_I, (_I, _I, _I))},
        host={"smc_general_re_smem_cpu": (_L, (_I, _I)),
              "smc_general_kalman_smem_cpu": (_L, (_I, _I, _I, _I)),
              "smc_general_gj_cpu": (_I, (_I, _I, _P, _P)),
              "smc_general_psd_cpu": (_I, (_I, _I, _P, _P, _P, _P, _L)),
              "smc_general_quot_cpu": (_I, (_P, _P, _P, _L))},
        prepare=("smc_general_prepare", (SMEM_LIMIT,))),
    "dsge_expectations": Library(
        "dsge_expectations.cu", "dsge_expectations_cpu.cpp",
        "libsmc_dsge_expectations", (),
        kernels={"smc_expectation_rows": (
            "expectation_rows", (_I, _I, _I, _P, _P, _P, _P, _P, _L))},
        queries={"smc_expectation_smem": (_L, (_I, _I))}),
    "eigh": Library(
        "eigh_kernel.cu", "eigh_cpu.cpp", "libsmc_eigh", _SMEM_FLAGS,
        kernels={"smc_eigh": ("eigh", (_I, _L, _I, _L, _P, _P, _P, _P))},
        host={"smc_eigh_cpu": (_I, (_I, _L, _I, _L, _P, _P, _P))},
        prepare=("smc_eigh_prepare", ())),
    "metropolis": Library(
        "metropolis_kernel.cu", "metropolis_cpu.cpp", "libsmc_metropolis", (),
        kernels={"smc_metropolis": ("metropolis",
                                    (_P, _L, _L, _P, _P, _P, _P))},
        host={"smc_philox_cpu": (None, (_P, _P, _P))}),
}


def build_cuda_library(name: str = "dsge_ns6") -> Path:
    """Path of one sm_90a kernel library (a key of CUDA_LIBRARIES; the
    default is An-Schorfheide's n_state), built if missing."""
    lib = CUDA_LIBRARIES[name]
    return _compile(find_nvcc(), [*NVCC_FLAGS, *lib.flags],
                    CSRC / lib.source, f"{lib.stem}_cuda")


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


def build_cpu_library(name: str, n_shock: Optional[int] = None) -> Path:
    """Path of the host build of one library's kernel bodies (a key of
    CUDA_LIBRARIES; tests only). A DSGE library's (dsge_ns<k>) holds every
    n_shock, or with `n_shock` that one alone, a shorter build."""
    lib = CUDA_LIBRARIES[name]
    flags, stem = [*GXX_FLAGS, *lib.flags], f"{lib.stem}_cpu"
    if n_shock is not None:
        flags.append(f"-DSMC_NK={n_shock}")
        stem += f"_nk{n_shock}"
    return _compile(_gxx(), flags, CSRC / lib.host_source, stem)
