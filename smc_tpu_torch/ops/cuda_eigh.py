"""Symmetric eigendecomposition for the mutation's proposal factor: a
hand-written CUDA kernel (cyclic Jacobi, csrc/eigh_kernel.cu, body in
csrc/eigh_jacobi.cuh) and its dispatch.

Not a TPU kernel: the JAX package runs `jnp.linalg.eigh` through XLA. On a
CUDA tensor `torch.linalg.eigh` reads its status back to the host, so it
waits for the device and cannot be captured in a CUDA graph; the kernel
does neither.

Dispatch: a CPU tensor runs the plain version (`torch.linalg.eigh`), at any
k; a CUDA tensor launches the kernel (k <= MAX_K), or raises. Past SHARED_K
the kernel keeps each matrix and its rotations in a workspace allocated
here instead of shared memory. Both return the same form:
eigenvalues ascending, each eigenvector's sign fixed so that its
largest-magnitude entry (the first of equal ones) is positive, and NaN
everywhere for a matrix with a non-finite entry (nothing raises, as with
`jnp.linalg.eigh`). Only the lower triangle is read. `LAUNCHES["eigh"]`
counts kernel launches, one per call that reaches the GPU.
"""

from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"eigh": 0}
MAX_K = 1024     # smc_jacobi::kMaxK
SHARED_K = 64    # smc_jacobi::kSharedK

_lib = None
_prepared = set()


def _library(device: torch.device):
    """The kernel library, loaded once; its shared-memory limit raised once
    per device (outside any graph capture: the first call on a device is
    an eager one)."""
    global _lib
    if _lib is None:
        from smc_tpu_torch import _build
        lib = ctypes.CDLL(str(_build.build_cuda_library("eigh")))
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.smc_eigh.argtypes = [I, L, P, P, P, P, P]
        lib.smc_eigh.restype = I
        lib.smc_eigh_prepare.argtypes = []
        lib.smc_eigh_prepare.restype = I
        _lib = lib
    if device.index not in _prepared:
        with torch.cuda.device(device):
            rc = _lib.smc_eigh_prepare()
        if rc != 0:
            raise RuntimeError(f"eigh kernel set-up failed (CUDA error {rc})")
        _prepared.add(device.index)
    return _lib


def eigh_plain(A: torch.Tensor):
    """The plain version: torch.linalg.eigh in the kernel's form (each
    column negated where its largest-magnitude entry, the first of equal
    ones, is negative)."""
    bad = ~torch.isfinite(torch.tril(A)).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    safe = torch.where(bad[..., None, None], eye, A)
    lam, U = torch.linalg.eigh(safe)
    lead = torch.gather(U, -2, torch.argmax(U.abs(), dim=-2, keepdim=True))
    U = torch.where(lead < 0, -U, U)
    nan = float("nan")
    return (torch.where(bad[..., None], nan, lam),
            torch.where(bad[..., None, None], nan, U))


def check_block(k: int) -> None:
    """Raise ValueError unless the kernel takes k x k matrices (the CPU's
    plain version takes any k)."""
    if not 1 <= k <= MAX_K:
        raise ValueError(f"the eigh kernel serves blocks of 1 <= k <= {MAX_K} "
                         f"parameters on a CUDA device, not {k}; use more "
                         "blocks (n_blocks)")


def eigh(A: torch.Tensor):
    """(lam [..., k], U [..., k, k]) of the symmetric f64 matrices
    A [..., k, k]: A = U diag(lam) U'. On the card k <= MAX_K."""
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"eigh needs square matrices, not {tuple(A.shape)}")
    if A.dtype != torch.float64:
        raise ValueError(f"eigh needs float64, not {A.dtype}")
    if A.device.type == "cpu":
        return eigh_plain(A)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for tensors on {A.device}")
    k = A.shape[-1]
    check_block(k)
    a = A.contiguous()
    batch = a.numel() // (k * k)
    lam = torch.empty(A.shape[:-1], dtype=torch.float64, device=A.device)
    U = torch.empty(A.shape, dtype=torch.float64, device=A.device)
    if batch == 0:
        return lam, U
    work = (torch.empty(batch * 2 * k * (k | 1), dtype=torch.float64,
                        device=A.device) if k > SHARED_K else None)
    lib = _library(A.device)
    with torch.cuda.device(A.device):
        rc = lib.smc_eigh(k, batch, a.data_ptr(), lam.data_ptr(),
                          U.data_ptr(), None if work is None
                          else work.data_ptr(),
                          torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"eigh kernel launch failed (CUDA error {rc})")
    LAUNCHES["eigh"] += 1
    return lam, U
