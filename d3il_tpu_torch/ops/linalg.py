"""Small SPD solvers for the control and physics loop, on torch tensors.

Counterpart of ``d3il_tpu/ops/linalg.py``: the closed-form inverses of
3x3, 6x6 and 9x9 matrices (adjugate and block Schur complement), an
unrolled Cholesky, substitution, the symmetrized SPD inverse and the
clamped SPD solve that stands in for the IK controller's SVD clamp. All
functions act on the last two axes and broadcast over leading dims; none
pivots, so each wants well-conditioned (SPD) input.
"""
from __future__ import annotations

import torch


def inv3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices: adjugate over determinant."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    inv_det = 1.0 / (a * A + b * B + c * C)
    cof = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return cof * inv_det[..., None, None]


def _schur_inv(M: torch.Tensor, k: int, inv_lead) -> torch.Tensor:
    """Inverse of [..., k + 3, k + 3] matrices by the Schur complement of
    the leading k x k block (inverted by ``inv_lead``) and ``inv3``."""
    P, Q = M[..., :k, :k], M[..., :k, k:]
    R, S = M[..., k:, :k], M[..., k:, k:]
    Pinv = inv_lead(P)
    Scinv = inv3(S - R @ Pinv @ Q)
    PiQ = Pinv @ Q
    RPi = R @ Pinv
    top = torch.cat([Pinv + PiQ @ Scinv @ RPi, -PiQ @ Scinv], dim=-1)
    bot = torch.cat([-Scinv @ RPi, Scinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv6(M: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 6, 6] SPD matrices: 3x3-block Schur complement."""
    return _schur_inv(M, 3, inv3)


def inv9(M: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 9, 9] SPD matrices: 6 + 3 block Schur complement.
    Loses accuracy in float32 where the leading blocks are near singular
    (the Panda mass matrix near wrist-aligned poses): ``inv_spd`` does
    not."""
    return _schur_inv(M, 6, inv6)


def chol(A: torch.Tensor) -> torch.Tensor:
    """Unrolled Cholesky factor L (lower) of [..., n, n] SPD matrices."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = torch.sqrt(s.clamp_min(1e-12)) if i == j else s / L[j][j]
    z = torch.zeros_like(A[..., 0, 0])
    return torch.stack([torch.stack([L[i][j] if j <= i else z
                                     for j in range(n)], dim=-1)
                        for i in range(n)], dim=-2)


def tri_solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Forward substitution: solve L Y = B, B [..., n, m]."""
    n = L.shape[-1]
    Y = [None] * n
    for i in range(n):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k:k + 1] * Y[k]
        Y[i] = s / L[..., i, i:i + 1]
    return torch.stack(Y, dim=-2)


def tri_solve_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Back substitution: solve U X = B, U upper-triangular."""
    n = U.shape[-1]
    X = [None] * n
    for i in range(n - 1, -1, -1):
        s = B[..., i, :]
        for k in range(i + 1, n):
            s = s - U[..., i, k:k + 1] * X[k]
        X[i] = s / U[..., i, i:i + 1]
    return torch.stack(X, dim=-2)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B given the Cholesky factor."""
    return tri_solve_upper(L.transpose(-1, -2), tri_solve_lower(L, B))


def inv_spd(M: torch.Tensor) -> torch.Tensor:
    """Symmetrized inverse of small SPD matrices via Cholesky."""
    n = M.shape[-1]
    I = torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)
    X = chol_solve(chol(M), I)
    return 0.5 * (X + X.transpose(-1, -2))


def clamped_spd_solve(A: torch.Tensor, b: torch.Tensor, lo: float):
    """Tikhonov solve (A + lo I)^-1 b plus one refinement step (the
    spectral filter (w + 2 lo) / (w + lo)^2; see the JAX counterpart)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    Ainv = inv_spd(A + lo * eye)
    x0 = torch.einsum("...ij,...j->...i", Ainv, b)
    return x0 + lo * torch.einsum("...ij,...j->...i", Ainv, x0)
