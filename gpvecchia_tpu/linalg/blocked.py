"""Batched dense Cholesky / triangular-solve wrappers.

Thin wrappers over XLA's native batched kernels (cuSOLVER / cuBLAS on the
GPU, LAPACK on the CPU) with HIGHEST matmul precision, so an f32 product is
never taken in TF32 or bf16: the multifrontal factor loses digits of its
logdet below that.

Replaces the role of LAPACK chol/solve inside the reference's hot loops
(/root/reference/src/U_NZentries.cpp:60-63 and the Matrix-package sparse
cholesky at /root/reference/R/vecchia_prediction.R:74-84).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["chol", "trsm_right", "trsm_rightT", "lower_solve_vec",
           "upper_solve_vec", "tri_inv_lower"]


def chol(A):
    """Lower Cholesky factor of batched SPD A (..., P, P).

    Non-SPD inputs yield NaNs in the affected columns (no clamping) so
    failures surface rather than silently corrupting results.
    """
    if A.shape[-1] == 0:
        return A
    with jax.default_matmul_precision("highest"):
        return jnp.linalg.cholesky(A)


def trsm_right(B, L):
    """Solve X L^T = B for X, i.e. X = B L^{-T}; L lower (..., P, P)."""
    if L.shape[-1] == 0 or B.shape[-2] == 0:
        return B
    with jax.default_matmul_precision("highest"):
        return jax.lax.linalg.triangular_solve(
            L, B, left_side=False, lower=True, transpose_a=True)


def trsm_rightT(B, L):
    """Solve X L = B for X, i.e. X = B L^{-1}; L lower (..., P, P)."""
    if L.shape[-1] == 0 or B.shape[-2] == 0:
        return B
    with jax.default_matmul_precision("highest"):
        return jax.lax.linalg.triangular_solve(
            L, B, left_side=False, lower=True, transpose_a=False)


def lower_solve_vec(L, b):
    """Solve L y = b; b (..., P)."""
    return trsm_right(b[..., None, :], L)[..., 0, :]


def upper_solve_vec(L, b):
    """Solve L^T x = b; b (..., P)."""
    return trsm_rightT(b[..., None, :], L)[..., 0, :]


def tri_inv_lower(L):
    """L^{-1} for batched lower-triangular L (..., P, P)."""
    P = L.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(P, dtype=L.dtype), L.shape)
    # Z L = I  =>  Z = L^{-1}
    return trsm_rightT(eye, L)
