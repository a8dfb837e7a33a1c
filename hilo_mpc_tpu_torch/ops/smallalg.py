"""Small-matrix linear algebra, batched over leading dims.

PyTorch port of ``hilo_mpc_tpu/ops/smallalg.py``. The index arithmetic is
unrolled into elementwise expressions over the batch, exactly as the JAX
helpers do, so the plain Riccati sweeps (ops/riccati.py) compute the same
numbers as the JAX sweeps: in particular ``solve_psd_small`` uses the SCALED
ADJUGATE for n <= 3, not Cholesky. Dimensions above the unroll limits use the
stock ``torch.linalg`` routines.
"""
from __future__ import annotations

import torch

# adjugate-based solves stay well-conditioned (and cheaper than Cholesky) only
# for tiny n; Cholesky unrolls stay exact a bit further
_SOLVE_UNROLL = 3
_CHOL_UNROLL = 6


def solve_small(G, rhs):
    """Solve G @ X = rhs for general invertible G, unrolled for n <= 3, by
    LU with partial pivoting and two triangular solves above.

    The n=2/3 paths are cofactor (adjugate) solves made scale-invariant by
    normalizing G to unit max-entry first — otherwise det overflows f32 at
    ||G|| ~ 1e13, which the barrier-condensed Schur complements can reach.

    Shapes: G (..., n, n), rhs (..., n) or (..., n, k).
    """
    n = G.shape[-1]
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    if 2 <= n <= 3:
        scale = torch.clamp(G.abs().amax(dim=(-2, -1), keepdim=True), min=1e-30)
        G = G / scale
    if n == 1:
        out = rhs / G[..., :1, :]
    elif n == 2:
        a, b = G[..., 0, 0], G[..., 0, 1]
        c, d = G[..., 1, 0], G[..., 1, 1]
        det = a * d - b * c
        x0 = (d[..., None] * rhs[..., 0, :] - b[..., None] * rhs[..., 1, :])
        x1 = (-c[..., None] * rhs[..., 0, :] + a[..., None] * rhs[..., 1, :])
        out = torch.stack([x0, x1], dim=-2) / (det[..., None, None] * scale)
    elif n == 3:
        a, b, c = G[..., 0, 0], G[..., 0, 1], G[..., 0, 2]
        d, e, f = G[..., 1, 0], G[..., 1, 1], G[..., 1, 2]
        g, h, i = G[..., 2, 0], G[..., 2, 1], G[..., 2, 2]
        A00 = e * i - f * h
        A01 = c * h - b * i
        A02 = b * f - c * e
        A10 = f * g - d * i
        A11 = a * i - c * g
        A12 = c * d - a * f
        A20 = d * h - e * g
        A21 = b * g - a * h
        A22 = a * e - b * d
        det = a * A00 + b * A10 + c * A20
        adj = torch.stack([
            torch.stack([A00, A01, A02], dim=-1),
            torch.stack([A10, A11, A12], dim=-1),
            torch.stack([A20, A21, A22], dim=-1)], dim=-2)
        out = (torch.einsum("...ij,...jk->...ik", adj, rhs)
               / (det[..., None, None] * scale))
    else:
        # LAPACK getrs' own steps: torch.linalg.solve and lu_solve give wrong
        # tangents when J is batched over an outer vmap only and rhs also
        # over jacfwd's tangents (torch 2.13), as the Newton's correction
        # (core/integrators.py:newton_solve) meets them under Model.linearize
        P, L, U = torch.lu_unpack(*torch.linalg.lu_factor(G))
        y = torch.linalg.solve_triangular(L, P.mT @ rhs, upper=False,
                                          unitriangular=True)
        out = torch.linalg.solve_triangular(U, y, upper=True)
    return out[..., 0] if vec else out


def chol_small(G):
    """Lower-Cholesky factor, unrolled for n <= 6.

    G must be symmetric PD. Shapes: (..., n, n) -> (..., n, n).
    """
    n = G.shape[-1]
    if n > _CHOL_UNROLL:
        return torch.linalg.cholesky(G)
    L = [[None] * n for _ in range(n)]
    zero = torch.zeros_like(G[..., 0, 0])
    for i in range(n):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(s)
            else:
                L[i][j] = s / L[j][j]
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def solve_psd_small(G, rhs):
    """Solve G @ X = rhs for symmetric PD G.

    Scaled adjugate for n <= 3; unrolled Cholesky + unrolled substitution for
    n <= 6; stock ``torch.linalg`` Cholesky above.
    Shapes: G (..., n, n), rhs (..., n) or (..., n, k).
    """
    n = G.shape[-1]
    if n <= _SOLVE_UNROLL:
        return solve_small(G, rhs)
    vec = rhs.ndim == G.ndim - 1
    if vec:
        rhs = rhs[..., None]
    if n <= _CHOL_UNROLL:
        L = chol_small(G)
        ncol = rhs.shape[-1]
        Lv = [[L[..., i, j] for j in range(n)] for i in range(n)]
        # forward substitution L Y = rhs, then back substitution L^T X = Y
        Y = [[None] * ncol for _ in range(n)]
        for i in range(n):
            for m in range(ncol):
                acc = rhs[..., i, m]
                for l in range(i):
                    acc = acc - Lv[i][l] * Y[l][m]
                Y[i][m] = acc / Lv[i][i]
        X = [[None] * ncol for _ in range(n)]
        for i in range(n - 1, -1, -1):
            for m in range(ncol):
                acc = Y[i][m]
                for l in range(i + 1, n):
                    acc = acc - Lv[l][i] * X[l][m]
                X[i][m] = acc / Lv[i][i]
        out = torch.stack([torch.stack([X[i][m] for m in range(ncol)], dim=-1)
                           for i in range(n)], dim=-2)
    else:
        out = torch.cholesky_solve(rhs, torch.linalg.cholesky(G))
    return out[..., 0] if vec else out


_MM_UNROLL = 8


def mm_small(X, Y):
    """X @ Y as a broadcast-multiply-sum for tiny trailing dims (the same
    summation the JAX helper emits); ``@`` above n=8."""
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL \
            and Y.shape[-1] <= _MM_UNROLL:
        return (X[..., :, :, None] * Y[..., None, :, :]).sum(dim=-2)
    return X @ Y


def mv_small(X, y):
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL:
        return (X * y[..., None, :]).sum(dim=-1)
    return (X @ y[..., None])[..., 0]


def tmm_small(X, Y):
    """X.T @ Y (transpose on the two trailing dims)."""
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL \
            and Y.shape[-1] <= _MM_UNROLL:
        return (X[..., :, :, None] * Y[..., :, None, :]).sum(dim=-3)
    return X.transpose(-1, -2) @ Y


def tmv_small(X, y):
    if X.shape[-1] <= _MM_UNROLL and X.shape[-2] <= _MM_UNROLL:
        return (X * y[..., :, None]).sum(dim=-2)
    return (X.transpose(-1, -2) @ y[..., None])[..., 0]
