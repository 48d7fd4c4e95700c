"""The kernel libraries at run time: each library of _build.CUDA_LIBRARIES
loaded and typed once from its row of that table, readied once per device,
its kernels launched through one helper and counted in one registry.

`LAUNCHES` counts kernel launches under the table's counter keys (re,
kalman, re_general, kalman_general, expectation_rows, eigh, metropolis),
one per `launch` that reaches the card. A launch inside a CUDA graph
capture runs nothing; smc()'s fused recursion moves the launches counted
during its capture to each replay. The wrappers (ops/cuda_*.py) hold what
is each kernel's own (domain, CPU branch, tile sizes) and validate their
tensors with `check` and `cuda_device` before they launch.
"""

from __future__ import annotations

import ctypes

import torch

from smc_tpu_torch import _build

LAUNCHES = {key: 0 for lib in _build.CUDA_LIBRARIES.values()
            for key, _ in lib.kernels.values()}

_loaded = {}        # library name -> typed card build
_prepared = set()   # (library name, device index)


def typed(path, name: str, host: bool = False,
          missing_ok: bool = False) -> ctypes.CDLL:
    """The library at `path` with every entry point that
    CUDA_LIBRARIES[name] declares for its card build (with `host`, its host
    build) typed: this checkout's build, or another tree's with the same C
    interface. With `missing_ok` the entries a build lacks (an older tree's,
    built before they were declared) are left out instead of raising."""
    lib = ctypes.CDLL(str(path))
    for symbol, (restype, argtypes) in (
            _build.CUDA_LIBRARIES[name].entries(host).items()):
        if missing_ok and not hasattr(lib, symbol):
            continue
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def prepare(lib, name: str, device: torch.device) -> None:
    """Ready the kernels of `lib`, a build of library `name`, on `device`
    (the table's prepare call, if it has one)."""
    spec = _build.CUDA_LIBRARIES[name].prepare
    if spec is None:
        return
    symbol, args = spec
    with torch.cuda.device(device):
        rc = getattr(lib, symbol)(*args)
    if rc != 0:
        raise RuntimeError(f"set-up of the {name} kernels failed (CUDA "
                           f"error {rc})")


def load(name: str, device: torch.device) -> ctypes.CDLL:
    """The card build of library `name`: built, loaded and typed at its
    first use, readied at its first use on `device` (an eager call, before
    any graph capture, so no launch and none inside a capture sets an
    attribute)."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = typed(_build.build_cuda_library(name), name)
    if (name, device.index) not in _prepared:
        prepare(lib, name, device)
        _prepared.add((name, device.index))
    return lib


def launch(name: str, entry: str, device: torch.device, *args) -> None:
    """Launch kernel `entry` of library `name` with `args` on the current
    stream of `device`, under its device guard; raise RuntimeError unless
    it launched, and count it in LAUNCHES."""
    lib = load(name, device)
    with torch.cuda.device(device):
        rc = getattr(lib, entry)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed (CUDA error {rc})")
    LAUNCHES[_build.CUDA_LIBRARIES[name].kernels[entry][0]] += 1


def check(name, t, shape, device, dtype=torch.float64) -> None:
    """Raise unless `t` is a contiguous tensor of `shape` and `dtype` on
    `device`: what a kernel reads through its pointer."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def cuda_device(t: torch.Tensor) -> torch.device:
    """The CUDA device of `t`; ValueError for any other device."""
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {t.device}")
    return t.device
