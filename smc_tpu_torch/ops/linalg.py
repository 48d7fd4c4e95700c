"""Small-matrix linear algebra (port of smc_tpu/ops/linalg.py).

Matrices are stored [r, c, N] with the particle batch last, the layout the
CUDA kernels read (neighbouring threads, neighbouring particles). These are
the plain PyTorch versions; the TPU lowering workarounds of the JAX package
(broadcast FMAs instead of dot_general, one-hot pivot selects, a statically
unrolled Cholesky) are not needed here. The per-matrix functions (`gj_solve`,
`gj_inv`, `small_psd_logdet_solve`) take [..., n, n] matrices and run the
batch-last elimination with the leading dimensions as the batch.
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
    maximal |entry| at or below the diagonal. The row swap is one gather and
    one scatter along the row axis, and the elimination updates the working
    tensor in place (it is [37, 111, N] for a Smets-Wouters cyclic-reduction
    step), so a pivot step is a dozen launches."""
    n = A.shape[0]
    nb = A.shape[-1]
    M = torch.cat([A, B.to(A.dtype)], dim=1)              # [n, n+m, N]
    logabsdet = torch.zeros(nb, dtype=A.dtype, device=A.device)
    for k in range(n):
        p = k + torch.argmax(M[k:, k, :].abs(), dim=0)     # [N]
        rows = p.view(1, 1, nb).expand(1, M.shape[1], nb)
        row_p = M.gather(0, rows)                          # [1, n+m, N]
        M.scatter_(0, rows, M[k:k + 1].clone())
        M[k:k + 1] = row_p
        pivot = row_p[0, k]
        if return_logabsdet:
            logabsdet = logabsdet + torch.log(torch.abs(pivot))
        factor = M[:, k, :] / pivot
        factor[k] = 0.0
        M.addcmul_(factor[:, None, :], row_p, value=-1.0)
        M[k].div_(pivot)
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


def bl_psd_logdet_solve(F: torch.Tensor, B: torch.Tensor):
    """(X, logdet) for F [n,n,N], B [n,m,N] by Gauss-Jordan. logdet is
    log|det F| (the sum of log|pivot|), so a non-PD F with positive |det|
    gets a finite value: callers guard definiteness (the Kalman filters'
    quad < 0 test)."""
    return bl_gj_solve(F, B, return_logabsdet=True)


def bl_chol_solve(F: torch.Tensor, B: torch.Tensor):
    """(X, logdet) for symmetric PD F [n,n,N], B [n,m,N] by Cholesky,
    logdet = 2 sum log diag L. A lane whose factorization fails (F not PD,
    or NaN) gets NaN in X and logdet, as the JAX version's sqrt of a
    negative pivot does; the callers' guards map it to -inf. The lanes are
    factored independently, so a failing lane leaves its neighbours
    unchanged."""
    Fb = F.permute(2, 0, 1)                                # [N, n, n] views
    Bb = B.permute(2, 0, 1)
    L, info = torch.linalg.cholesky_ex(Fb)
    # two batched triangular solves (torch.cholesky_solve may loop over
    # the batch on the card when the right-hand side has several columns)
    Y = torch.linalg.solve_triangular(L, Bb, upper=False)
    X = torch.linalg.solve_triangular(L.transpose(1, 2), Y, upper=True)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(-1)
    failed = info != 0
    X = torch.where(failed[:, None, None], float("nan"), X)
    logdet = torch.where(failed, float("nan"), logdet)
    return X.permute(1, 2, 0), logdet


def bl_psd_fast_solve(F: torch.Tensor, B: torch.Tensor):
    """Pivot-free (X, logdet) for symmetric PD F: the cofactor form at
    n = 3, Cholesky otherwise."""
    if F.shape[0] == 3:
        return bl_psd_cofactor_solve3(F, B)
    return bl_chol_solve(F, B)


def _batch_last(x: torch.Tensor) -> torch.Tensor:
    """[..., r, c] -> [r, c, prod(...)]."""
    return x.reshape(-1, *x.shape[-2:]).permute(1, 2, 0)


def gj_solve(A: torch.Tensor, B: torch.Tensor, return_logabsdet: bool = False):
    """Solve A X = B by Gauss-Jordan with partial pivoting for A [..., n, n],
    B [..., n, m] (bl_gj_solve over the leading dimensions); with
    return_logabsdet also log|det A| [...]."""
    batch = A.shape[:-2]
    out = bl_gj_solve(_batch_last(A), _batch_last(B), return_logabsdet)
    X, logabsdet = out if return_logabsdet else (out, None)
    X = X.permute(2, 0, 1).reshape(*batch, *X.shape[:2])
    if return_logabsdet:
        return X, logabsdet.reshape(batch)
    return X


def gj_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of A [..., n, n] by gj_solve against the identity."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return gj_solve(A, eye.expand(A.shape))


def small_psd_logdet_solve(F: torch.Tensor, B: torch.Tensor,
                           jitter: float = 0.0):
    """(X, logdet) for symmetric PD F [..., n, n] by gj_solve, with
    bl_psd_logdet_solve's caveat: logdet is log|det F|, so callers that may
    pass a non-PD F guard definiteness themselves."""
    if jitter:
        F = F + jitter * torch.eye(F.shape[-1], dtype=F.dtype,
                                   device=F.device)
    return gj_solve(F, B, return_logabsdet=True)
