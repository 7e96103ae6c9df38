"""Blocked signed Cholesky (LDL^T without pivoting) for quasi-definite
KKT matrices.

Re-design of the reference's dense no-pivot LDL^T kernel
(/root/reference/include/piqp/dense/ldlt_no_pivot.hpp:279-354: unblocked
kernel + blocked driver with block sizes 8..128).  The reference keeps that
kernel for quasi-definite systems and benchmarking; here it additionally
fills a real capability gap: the full 3-block KKT matrix

    [ P + diag(x_reg)   A'                G'                ]
    [ A                 -delta I                            ]
    [ G                                   -diag(z_reg_fact) ]

is *quasi-definite* (positive definite on the first n rows, negative
definite on the trailing p+m), so its LDL^T factorization exists without
pivoting and the signs of D are known STATICALLY: +1 for the n primal
rows, -1 for the p+m dual rows (Vanderbei, "Symmetric quasi-definite
matrices", 1995).  That turns LDL^T into a *signed Cholesky*
``K = L S L^T`` with S = diag(signs) fixed at trace time — a Cholesky-cost
factorization built entirely from rank-updates and GEMMs.

Design (accelerator-first, not a port):

- Blocked right-looking sweep as a ``lax.fori_loop`` over fixed-size
  column blocks (static shapes; one compiled body regardless of N).
- The small diagonal-block factorization *fuses the triangular inverse*:
  step j produces row j of Lkk^-1 by
  substitution against rows < j.  The panel update and both solve sweeps
  then become pure GEMMs against the stored per-block inverses — no
  sequential scalar substitution anywhere outside the bs-step inner loop.
- The trailing update is a single full-shape GEMM per block; the panel is
  masked to zero outside the trailing rows, so the product vanishes on
  already-final columns without explicit index arithmetic (O(3x) flop
  waste vs a shrinking trailing submatrix, traded for fixed shapes).

Failure semantics: a numerically indefinite pivot (d2 <= 0) produces NaN
through ``sqrt``, the factor check ``isfinite`` fails, and the solver's
regularization-boost ladder reacts — mirroring the reference where
LDLTNoPivot reports info != Success (ldlt_no_pivot.hpp:367-378).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

# Default column-block width. 64 keeps the bs-step sequential inner loop
# short while the panel/trailing GEMMs stay large.
DEFAULT_BLOCK = 64


def _small_signed_ldl(Skk: jax.Array, s: jax.Array):
    """Factor one (bs, bs) diagonal block: K = L S L^T with S = diag(s),
    s in {+1, -1}; returns (L, Linv) with L lower triangular (scaled
    Cholesky convention: diag(L) = sqrt(|d|), not unit) and Linv = L^-1.

    Step j produces row j of Linv by forward substitution against rows
    < j, with the sign woven into the pivot and the rank-1 update.
    """
    bs = Skk.shape[-1]
    dt = Skk.dtype
    idx = jnp.arange(bs)
    col_ids = idx[None, :]
    row_ids = idx[:, None]

    def step(j, carry):
        W, L, Linv = carry
        sj = s[j]
        d2 = W[j, j] * sj  # > 0 for a quasi-definite matrix
        d = jnp.sqrt(d2)  # NaN on indefinite pivot -> ok=False upstream
        # uniform column formula: l_ij = W_ij / (s_j d); gives l_jj = d
        lcol = jnp.where(idx >= j, W[:, j] / (sj * d), jnp.zeros((), dt))
        L = L.at[:, j].set(lcol)
        # trailing rank-1 downdate, restricted to columns > j
        upd = sj * lcol[:, None] * lcol[None, :]
        W = W - jnp.where(col_ids > j, upd, jnp.zeros((), dt))
        # fused substitution: row j of Linv
        lrow = jnp.where(idx < j, L[j, :], jnp.zeros((), dt))
        ej = jnp.where(idx == j, jnp.ones((), dt), jnp.zeros((), dt))
        Linv = Linv.at[j, :].set((ej - lrow @ Linv) / d)
        return W, L, Linv

    W0 = Skk
    L0 = jnp.zeros((bs, bs), dt)
    Linv0 = jnp.zeros((bs, bs), dt)
    _, L, Linv = lax.fori_loop(0, bs, step, (W0, L0, Linv0))
    # zero any upper-triangle garbage (contract: strictly lower + diag)
    L = jnp.where(col_ids > row_ids, jnp.zeros((), dt), L)
    return L, Linv


def signed_cholesky(K: jax.Array, signs: jax.Array, block: int = DEFAULT_BLOCK):
    """Blocked K = L S L^T, S = diag(signs), signs in {+1, -1}.

    K must be (N, N) with N a multiple of ``block`` (pad with identity
    rows/cols and +1 signs; see ``pad_quasidef``).  Returns
    (L, Linv_blocks) where L is (N, N) lower triangular and Linv_blocks is
    (N/block, block, block) holding the inverse of each diagonal block —
    the substitution-free solve currency.
    """
    N = K.shape[-1]
    bs = block
    nb = N // bs
    assert nb * bs == N, (N, bs)
    dt = K.dtype

    def blk(k, carry):
        W, Linvs = carry
        off = k * bs
        Skk = lax.dynamic_slice(W, (off, off), (bs, bs))
        sk = lax.dynamic_slice(signs, (off,), (bs,))
        Lkk, Linvk = _small_signed_ldl(Skk, sk)

        # panel: L_ik = K_ik Lkk^-T S_k for rows i >= off+bs, zero elsewhere
        C = lax.dynamic_slice(W, (0, off), (N, bs))
        rowsN = jnp.arange(N)[:, None]
        panel = jnp.where(
            rowsN >= off + bs, (C @ Linvk.T) * sk[None, :], jnp.zeros((), dt)
        )
        strip = lax.dynamic_update_slice(panel, Lkk, (off, 0))
        W = lax.dynamic_update_slice(W, strip, (0, off))

        # trailing downdate: W -= panel S_k panel^T.  panel is zero outside
        # the trailing rows, so the product only touches the trailing
        # submatrix — no explicit masking needed.
        W = W - (panel * sk[None, :]) @ panel.T

        Linvs = lax.dynamic_update_slice(Linvs, Linvk[None], (k, 0, 0))
        return W, Linvs

    Linvs0 = jnp.zeros((nb, bs, bs), dt)
    W, Linvs = lax.fori_loop(0, nb, blk, (K, Linvs0))
    rowsN = jnp.arange(N)[:, None]
    colsN = jnp.arange(N)[None, :]
    L = jnp.where(colsN > rowsN, jnp.zeros((), dt), W)
    return L, Linvs


def signed_solve(
    L: jax.Array, Linvs: jax.Array, signs: jax.Array, b: jax.Array
) -> jax.Array:
    """Solve (L S L^T) x = b using the stored per-block inverses: both
    sweeps are nb GEMV/GEMM steps against (block, N) strips — no scalar
    substitution."""
    N = L.shape[-1]
    nb, bs, _ = Linvs.shape

    def fwd(k, y):
        off = k * bs
        Lrow = lax.dynamic_slice(L, (off, 0), (bs, N))
        r = lax.dynamic_slice(b, (off,), (bs,)) - Lrow @ y
        return lax.dynamic_update_slice(y, Linvs[k] @ r, (off,))

    y = lax.fori_loop(0, nb, fwd, jnp.zeros_like(b))
    z = signs * y

    def bwd(i, x):
        k = nb - 1 - i
        off = k * bs
        Lcol = lax.dynamic_slice(L, (0, off), (N, bs))
        r = lax.dynamic_slice(z, (off,), (bs,)) - Lcol.T @ x
        return lax.dynamic_update_slice(x, Linvs[k].T @ r, (off,))

    return lax.fori_loop(0, nb, bwd, jnp.zeros_like(b))


def padded_dim(N: int, block: int = DEFAULT_BLOCK) -> int:
    """Factorization dimension: N rounded up to a multiple of the block
    (minimum one block)."""
    return max(block, ((N + block - 1) // block) * block)


def pad_quasidef(K: jax.Array, Np: int) -> jax.Array:
    """Embed K (N, N) into (Np, Np) with identity (sign +1) padding."""
    N = K.shape[-1]
    if N == Np:
        return K
    out = jnp.eye(Np, dtype=K.dtype)
    return lax.dynamic_update_slice(out, K, (0, 0))


def kkt_signs(n: int, p: int, m: int, Np: int, dtype) -> jax.Array:
    """Static sign vector of the 3-block KKT matrix embedded in Np rows:
    +1 for the n primal rows, -1 for the p+m dual rows, +1 padding."""
    s = jnp.ones((Np,), dtype)
    return s.at[n : n + p + m].set(-1.0)
