"""Cholesky factors with their triangular inverses, and the solves that
use them.

The factor-with-inverse representation keeps L^-1 next to L, so every
later solve is a pair of GEMVs (K^-1 v = L^-T (L^-1 v)) instead of two
substitution sweeps.  The solver's always-on iterative refinement
(kkt.py _solve_condensed_refined) recovers what the explicit inverse
gives up in backward stability.

- ``cholesky_with_inverse``: XLA's Cholesky and a triangular solve
  against the identity (cuSOLVER potrf and cuBLAS trsm on the GPU).
- ``cholesky_inverse_apply``: factor, inverse and Y = K^-1 RHS for the
  cyclic-reduction chain step of the multistage backend.
- ``signed_cholesky_with_inverse``: K = L S L^T for quasi-definite K (the
  dense_ldlt backend), built on the blocked ops/ldlt.py factorization.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def cholesky_with_inverse(K: jax.Array) -> tuple[jax.Array, jax.Array]:
    """L = chol(K) and Linv = L^-1 for one (n, n) SPD matrix.  Solves then
    become GEMVs: K^-1 v = Linv^T (Linv v).  A non-positive pivot leaves
    NaNs in L (the retry ladder's failure signal, kkt._factor_dense)."""
    L = jnp.linalg.cholesky(K)
    eye = jnp.eye(K.shape[-1], dtype=K.dtype)
    Linv = lax.linalg.triangular_solve(L, eye, left_side=True, lower=True)
    return L, Linv


def inv_solve(Linv: jax.Array, v: jax.Array) -> jax.Array:
    """K^-1 v via the precomputed triangular inverse: two GEMVs.
    Shapes: Linv (..., n, n), v (..., n)."""
    y = jnp.einsum("...ij,...j->...i", Linv, v)
    return jnp.einsum("...ji,...j->...i", Linv, y)


def cholesky_inverse_apply(K, RHS):
    """L = chol(K), Linv = L^-1 and Y = K^-1 RHS for one (n, n) SPD matrix
    and an (n, R) right-hand block: the cyclic-reduction chain step
    (multistage.cr_chain_factor), where Y stacks the level's three
    substitution operators."""
    L, Linv = cholesky_with_inverse(K)
    Y = Linv.T @ (Linv @ RHS)
    return L, Linv, Y


def signed_cholesky_with_inverse(K, signs):
    """L (lower, scaled-Cholesky convention) and Linv = L^-1 with
    K = L diag(signs) L^T, for one (n, n) quasi-definite matrix: the blocked
    signed Cholesky of ops/ldlt.py plus the full triangular inverse by
    block forward substitution against the identity.  Solves become GEMVs:
    K^-1 v = Linv^T (signs * (Linv v))."""
    from . import ldlt

    L, Linvs = ldlt.signed_cholesky(K, signs, block=ldlt.DEFAULT_BLOCK)
    N = L.shape[-1]
    nb, bs, _ = Linvs.shape
    eye = jnp.eye(N, dtype=K.dtype)

    def fwd(k, X):
        off = k * bs
        Lrow = lax.dynamic_slice(L, (off, 0), (bs, N))
        R = lax.dynamic_slice(eye, (off, 0), (bs, N)) - Lrow @ X
        return lax.dynamic_update_slice(X, Linvs[k] @ R, (off, 0))

    Linv = lax.fori_loop(0, nb, fwd, jnp.zeros_like(L))
    return L, Linv


def signed_inv_solve(Linv, signs, v):
    """(L S L^T)^-1 v via the precomputed inverse: two GEMVs and a sign
    flip.  Shapes: Linv (..., n, n), signs (n,), v (..., n)."""
    y = jnp.einsum("...ij,...j->...i", Linv, v)
    return jnp.einsum("...ji,...j->...i", Linv, signs * y)
