"""Batch-last small-matrix helpers (port of the bl_* part of
smc_tpu/ops/linalg.py).

Matrices are stored [r, c, N] with the particle batch last, the layout the
CUDA kernels read (neighbouring threads, neighbouring particles). These are
the plain PyTorch versions; the TPU lowering workarounds of the JAX package
(broadcast FMAs instead of dot_general, one-hot pivot selects) are not
needed here.
"""

from __future__ import annotations

import torch


def bl_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """[i,j,N] @ [j,k,N] -> [i,k,N] per particle."""
    return torch.einsum("ijn,jkn->ikn", A, B)


def bl_transpose(A: torch.Tensor) -> torch.Tensor:
    """[i,j,N] -> [j,i,N]."""
    return A.transpose(0, 1)


def bl_gj_solve(A: torch.Tensor, B: torch.Tensor,
                return_logabsdet: bool = False):
    """Gauss-Jordan with partial pivoting, per particle: A [n,n,N],
    B [n,m,N] -> X [n,m,N] (and log|det A| [N]). The pivot is the first
    maximal |entry| at or below the diagonal."""
    n = A.shape[0]
    nb = A.shape[-1]
    M = torch.cat([A, B.to(A.dtype)], dim=1).clone()      # [n, n+m, N]
    lanes = torch.arange(nb, device=A.device)
    logabsdet = torch.zeros(nb, dtype=A.dtype, device=A.device)
    for k in range(n):
        p = k + torch.argmax(M[k:, k, :].abs(), dim=0)     # [N]
        row_p = M[p, :, lanes].T                           # [n+m, N]
        row_k = M[k].clone()
        M[p, :, lanes] = row_k.T
        M[k] = row_p
        pivot = M[k, k]
        logabsdet = logabsdet + torch.log(torch.abs(pivot))
        factor = M[:, k, :] / pivot
        factor[k] = 0.0
        M = M - factor[:, None, :] * M[k:k + 1]
        M[k] = M[k] / pivot
    X = M[:, n:, :]
    if return_logabsdet:
        return X, logabsdet
    return X


def bl_psd_cofactor_solve3(F: torch.Tensor, B: torch.Tensor):
    """(X, logdet) for symmetric PD F [3,3,N], B [3,m,N] by the adjugate,
    X = adj(F) B / det(F); logdet is nan for det < 0 (callers map it to
    -inf)."""
    a, b, c = F[0, 0], F[0, 1], F[0, 2]
    d, e = F[1, 1], F[1, 2]
    f = F[2, 2]
    C00 = d * f - e * e
    C01 = c * e - b * f
    C02 = b * e - c * d
    C11 = a * f - c * c
    C12 = b * c - a * e
    C22 = a * d - b * b
    det = a * C00 + b * C01 + c * C02
    inv_det = 1.0 / det
    logdet = torch.log(det)
    B0, B1, B2 = B[0], B[1], B[2]
    X0 = (C00 * B0 + C01 * B1 + C02 * B2) * inv_det
    X1 = (C01 * B0 + C11 * B1 + C12 * B2) * inv_det
    X2 = (C02 * B0 + C12 * B1 + C22 * B2) * inv_det
    return torch.stack([X0, X1, X2], dim=0), logdet
