"""Symmetric eigendecomposition for the mutation's proposal factor: a
hand-written CUDA kernel (cyclic Jacobi, csrc/eigh_kernel.cu, body in
csrc/eigh_jacobi.cuh) and its dispatch.

Not a TPU kernel: the JAX package runs `jnp.linalg.eigh` through XLA. On a
CUDA tensor `torch.linalg.eigh` reads its status back to the host, so it
waits for the device and cannot be captured in a CUDA graph; the kernel
does neither.

Dispatch: a CPU tensor runs the plain version (`torch.linalg.eigh`), at any
k; a CUDA tensor launches the kernel (k <= MAX_K), or raises. The kernel
runs two warps per matrix up to k = 32, a block per matrix with the matrix
in shared memory up to SHARED_K, and past it a block per matrix with the
matrix in a workspace allocated here. `eigh_batched` takes one or two
stacks of matrices (two sizes: the mutation's equal blocks and its smaller
last one) in one launch; each matrix's result is bit for bit that of a call
on it alone. Both versions return the same form: eigenvalues ascending,
each eigenvector's sign fixed so that its largest-magnitude entry (the
first of equal ones) is positive, and NaN everywhere for a matrix with a
non-finite entry (nothing raises, as with `jnp.linalg.eigh`). Only the
lower triangle is read. The kernel launches through ops/kernels.py, which
counts it under "eigh".
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from smc_tpu_torch.ops.kernels import cuda_device, launch

MAX_K = 1024     # smc_jacobi::kMaxK
SHARED_K = 118   # smc_jacobi::kSharedK

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


def _check_square(A: torch.Tensor) -> None:
    if A.dim() < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"eigh needs square matrices, not {tuple(A.shape)}")
    if A.dtype != torch.float64:
        raise ValueError(f"eigh needs float64, not {A.dtype}")


def eigh(A: torch.Tensor):
    """(lam [..., k], U [..., k, k]) of the symmetric f64 matrices
    A [..., k, k]: A = U diag(lam) U'. On the card k <= MAX_K."""
    _check_square(A)
    if A.device.type == "cpu":
        return eigh_plain(A)
    a = A.contiguous()
    lam = torch.empty(A.shape[:-1], dtype=torch.float64, device=A.device)
    U = torch.empty_like(a)
    _launch(a, lam, U, [(A.shape[-1], a.numel() // max(A.shape[-1], 1) ** 2)])
    return lam, U


def eigh_batched(stacks: Sequence[torch.Tensor]
                 ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """[(lam, U)] of one or two stacks of symmetric f64 matrices
    [..., k_i, k_i] on one device, in one kernel launch on a card; each
    matrix's (lam, U) is bit for bit what eigh gives it alone."""
    if not 1 <= len(stacks) <= 2:
        raise ValueError(f"eigh_batched takes one or two stacks, not "
                         f"{len(stacks)}")
    if len(stacks) == 1:
        return [eigh(stacks[0])]
    for A in stacks:
        _check_square(A)
    dev = stacks[0].device
    if stacks[1].device != dev:
        raise ValueError("eigh_batched needs its stacks on one device")
    if dev.type == "cpu":
        return [eigh_plain(A) for A in stacks]
    parts = [(A.shape[-1], A.numel() // max(A.shape[-1], 1) ** 2)
             for A in stacks]
    a = torch.cat([A.reshape(-1) for A in stacks])
    lam = torch.empty(sum(n * k for k, n in parts), dtype=torch.float64,
                      device=dev)
    U = torch.empty_like(a)
    _launch(a, lam, U, parts)
    out, lo, uo = [], 0, 0
    for A, (k, n) in zip(stacks, parts):
        out.append((lam[lo:lo + n * k].view(A.shape[:-1]),
                    U[uo:uo + n * k * k].view(A.shape)))
        lo, uo = lo + n * k, uo + n * k * k
    return out


def _launch(a, lam, U, parts) -> None:
    """The kernel on the packed matrices a (parts: [(k, n)], one or two)
    into lam and U, on the current stream of a's device; raises unless it
    launched."""
    dev = cuda_device(a)
    for k, _ in parts:
        check_block(k)
    if sum(n for _, n in parts) == 0:
        return
    # A and V at the kernel's row stride, smc_jacobi::stride
    nw = sum(n * 2 * k * (k + ((2 - k) & 3)) for k, n in parts
             if k > SHARED_K)
    work = (torch.empty(nw, dtype=torch.float64, device=dev) if nw
            else None)
    k0, n0 = parts[0]
    k1, n1 = parts[1] if len(parts) > 1 else (k0, 0)
    launch("eigh", "smc_eigh", dev, k0, n0, k1, n1, a.data_ptr(),
           lam.data_ptr(), U.data_ptr(),
           None if work is None else work.data_ptr())
