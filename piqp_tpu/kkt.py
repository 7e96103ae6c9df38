"""Condensed KKT system: scalings, assembly, Cholesky factor/solve,
slack/dual recovery, iterative refinement.

Accelerator-first re-design of the reference KKT layer:
  - condensation of the 10-block KKT system to the 3-block (x, y, z) system:
    /root/reference/include/piqp/kkt_system.hpp:143-369
  - the fully condensed n-by-n dense backend (K = P + diag(x_reg)
    + (1/delta) A'A + G' W^-1 G + Cholesky):
    /root/reference/include/piqp/dense/kkt.hpp:39-177

Design deltas vs the reference (accelerator-first):

- All per-bound index-set loops (kkt_system.hpp:161-193, 219-252, 310-366)
  become masked vector expressions.  In particular the three-way per-row
  branch in the dual recovery (kkt_system.hpp:321-343) collapses to a single
  vector formula: with ``W_l_inv = 0`` on rows without a lower bound the
  two-sided expressions degenerate *exactly* to the one-sided ones.

- The backend is matmul/Cholesky shaped: K is assembled with two GEMMs +
  a diagonal add, factored with XLA's Cholesky (cuSOLVER on the GPU), and
  solved with batched triangular solves.  Everything vmaps for batched QPs.
"""

from __future__ import annotations

import dataclasses
from functools import singledispatch

import jax
import jax.numpy as jnp
from jax import lax

from . import ops
from .types import (
    FullKKTQPData,
    LDLTKKTQPData,
    QPData,
    Settings,
    Vars,
    _pytree_dataclass,
    use_pallas,
)


@_pytree_dataclass
class KKTState:
    """Factorization-time state (analog of KKTSystem's members,
    kkt_system.hpp:32-65, plus the dense backend's factor)."""

    rho: jax.Array  # scalar
    delta: jax.Array  # scalar (unregularized)
    delta_reg: jax.Array  # scalar delta + static reg (if refinement active)

    # slack / dual copies at factorization time (kkt_system.hpp:152-159)
    s_l: jax.Array
    s_u: jax.Array
    s_bl: jax.Array
    s_bu: jax.Array
    z_l_inv: jax.Array  # masked-safe 1/z (0 where bound inactive)
    z_u_inv: jax.Array
    z_bl_inv: jax.Array
    z_bu_inv: jax.Array

    # diagonal scalings
    W_l_inv: jax.Array  # (m,) 1/(s_l/z_l + delta), 0 where inactive
    W_u_inv: jax.Array
    W_bl_inv: jax.Array  # (n,) box analogs
    W_bu_inv: jax.Array
    x_reg: jax.Array  # (n,) rho + box contributions (+ static reg if IR)
    z_reg: jax.Array  # (m,) 1/(W_l_inv + W_u_inv) (no static reg)
    z_reg_fact: jax.Array  # (m,) z_reg + static reg; used by the backend

    L: jax.Array  # (n, n) lower Cholesky factor of the condensed matrix
    use_ir: jax.Array  # bool scalar: iterative refinement active


def _safe_inv(x: jax.Array, mask: jax.Array) -> jax.Array:
    return jnp.where(mask, 1.0 / jnp.where(mask, x, 1.0), 0.0)


def compute_scalings(
    data: QPData,
    settings: Settings,
    vars: Vars,
    rho: jax.Array,
    delta: jax.Array,
    use_ir: jax.Array,
    P_diag: jax.Array,
) -> KKTState:
    """Build the diagonal scalings x_reg/z_reg (kkt_system.hpp:143-211).

    ``use_ir`` adds the static regularization used by iterative refinement
    (kkt_system.hpp:195-207): the factorized system gets x_reg + reg,
    z_reg + reg and delta + reg, while the refinement matvec target keeps
    the unregularized z_reg and delta but (mirroring the reference, which
    mutates m_x_reg in place) the *regularized* x_reg.
    """
    z_l_inv = _safe_inv(vars.z_l, data.hl_mask)
    z_u_inv = _safe_inv(vars.z_u, data.hu_mask)
    z_bl_inv = _safe_inv(vars.z_bl, data.xl_mask)
    z_bu_inv = _safe_inv(vars.z_bu, data.xu_mask)

    W_l_inv = jnp.where(data.hl_mask, 1.0 / (z_l_inv * vars.s_l + delta), 0.0)
    W_u_inv = jnp.where(data.hu_mask, 1.0 / (z_u_inv * vars.s_u + delta), 0.0)
    W_bl_inv = jnp.where(data.xl_mask, 1.0 / (z_bl_inv * vars.s_bl + delta), 0.0)
    W_bu_inv = jnp.where(data.xu_mask, 1.0 / (z_bu_inv * vars.s_bu + delta), 0.0)

    xb2 = data.x_b_scaling * data.x_b_scaling
    x_reg = rho + xb2 * W_bl_inv + xb2 * W_bu_inv  # kkt_system.hpp:161-175

    z_reg_sum = W_l_inv + W_u_inv
    z_reg = jnp.where(z_reg_sum > 0, 1.0 / jnp.where(z_reg_sum > 0, z_reg_sum, 1.0), 0.0)

    # static regularization (kkt_system.hpp:195-207)
    max_diag = jnp.max(jnp.abs(P_diag + x_reg), initial=0.0)
    max_diag = jnp.maximum(max_diag, jnp.max(jnp.abs(z_reg), initial=0.0))
    reg = (
        settings.iterative_refinement_static_regularization_eps
        + settings.static_reg_rel() * max_diag
    )
    reg = jnp.where(use_ir, reg, 0.0)

    dtype = data.c.dtype
    return KKTState(
        rho=jnp.asarray(rho, dtype),
        delta=jnp.asarray(delta, dtype),
        delta_reg=jnp.asarray(delta + reg, dtype),
        s_l=vars.s_l,
        s_u=vars.s_u,
        s_bl=vars.s_bl,
        s_bu=vars.s_bu,
        z_l_inv=z_l_inv,
        z_u_inv=z_u_inv,
        z_bl_inv=z_bl_inv,
        z_bu_inv=z_bu_inv,
        W_l_inv=W_l_inv,
        W_u_inv=W_u_inv,
        W_bl_inv=W_bl_inv,
        W_bu_inv=W_bu_inv,
        x_reg=x_reg + reg,
        z_reg=z_reg,
        z_reg_fact=z_reg + reg,
        L=empty_factor(data, settings),
        use_ir=jnp.asarray(use_ir, bool),
    )


@singledispatch
def empty_factor(data, settings: Settings = None):
    """Placeholder for the backend factor pytree (filled by ``factor``).
    The placeholder's pytree STRUCTURE selects the factor representation:
    a (L, Linv) tuple selects the factor-with-inverse representation
    (settings.pallas_kernels, ops/pallas_chol.py)."""
    raise NotImplementedError(type(data))


@empty_factor.register
def _(data: QPData, settings: Settings = None):
    if use_pallas(settings):
        return (jnp.zeros_like(data.P), jnp.zeros_like(data.P))
    return jnp.zeros_like(data.P)


@singledispatch
def precompute(data, mixed: bool = False):
    """Constant per-problem terms reused across factorizations (the
    reference caches AT_A at setup, dense/kkt.hpp:51-55).  Computed once
    outside the IPM loop; None when the representation has nothing to
    cache.

    ``mixed=True`` additionally materializes float32 copies of the problem
    matrices (``data32``, ``AtA32``) ONCE, outside the IPM while_loop, so
    the phase-A matvecs read half the bytes and no factorization re-reads
    the f64 matrices just to cast them."""
    return None


@precompute.register
def _(data: QPData, mixed: bool = False):
    pre = {}
    if data.p > 0:
        pre["AtA"] = data.A.T @ data.A
    if mixed:
        f32 = jnp.float32
        pre["data32"] = data.replace(
            P=data.P.astype(f32), A=data.A.astype(f32), G=data.G.astype(f32)
        )
        if data.p > 0:
            pre["AtA32"] = pre["AtA"].astype(f32)
    return pre or None


@precompute.register
def _(data: FullKKTQPData, mixed: bool = False):
    return None


def assemble_condensed(data: QPData, ks: KKTState, pre=None) -> jax.Array:
    """K = P + diag(x_reg) + (1/delta_reg) A'A + G' diag(1/z_reg_fact) G
    (dense/kkt.hpp:140-160)."""
    K = data.P + jnp.diag(ks.x_reg)
    if data.p > 0:
        AtA = pre.get("AtA") if pre else None
        if AtA is None:
            AtA = data.A.T @ data.A
        if K.dtype == jnp.float32 and pre and "AtA32" in pre:
            AtA = pre["AtA32"]
        K = K + AtA.astype(K.dtype) / ks.delta_reg
    if data.m > 0:
        z_reg_fact_inv = 1.0 / ks.z_reg_fact
        K = K + data.G.T @ (z_reg_fact_inv[:, None] * data.G)
    return K


@singledispatch
def factor(
    data, ks: KKTState, mixed: bool = False, pre=None
) -> tuple[KKTState, jax.Array]:
    """Factor the condensed system; backend chosen by data representation.

    ``mixed=True`` assembles and factors in float32;
    iterative refinement in the solver dtype recovers accuracy.  ``pre``
    carries the loop-invariant terms from ``precompute``.
    """
    raise NotImplementedError(type(data))


@factor.register
def _factor_dense(data: QPData, ks: KKTState, mixed: bool = False, pre=None):
    """Cholesky-factor the condensed matrix; ok=False when the factorization
    produced non-finite values (XLA's cholesky yields NaNs where Eigen's LLT
    reports failure, dense/kkt.hpp:82-83).

    When ks.L is an (L, Linv) tuple placeholder (settings.pallas_kernels),
    the factorization also builds L^-1 (ops/pallas_chol.py) and solves
    become GEMVs against Linv."""
    if isinstance(ks.L, tuple):
        from .ops.pallas_chol import cholesky_with_inverse

        dt = jnp.float32 if mixed else data.P.dtype
        if mixed and pre and "data32" in pre:
            dd = pre["data32"]  # hoisted cast (see precompute)
        else:
            dd = data.replace(
                P=data.P.astype(dt), A=data.A.astype(dt), G=data.G.astype(dt)
            )
        ks_f = ks.replace(
            x_reg=ks.x_reg.astype(dt),
            z_reg_fact=ks.z_reg_fact.astype(dt),
            delta_reg=ks.delta_reg.astype(dt),
        )
        K = assemble_condensed(dd, ks_f, pre)
        # Jacobi-scale to unit diagonal (exact: chol(K) = D chol(Ks)); see
        # the mixed branch below for the conditioning rationale
        dK = jnp.sqrt(jnp.maximum(jnp.diagonal(K), jnp.asarray(1e-30, dt)))
        dinv = 1.0 / dK
        Ks = K * dinv[:, None] * dinv[None, :]
        Ls, Lsinv = cholesky_with_inverse(Ks)
        L = Ls * dK[:, None]
        Linv = Lsinv * dinv[None, :]
        ok = jnp.logical_and(
            jnp.all(jnp.isfinite(L)), jnp.all(jnp.isfinite(Linv))
        )
        return ks.replace(L=(L, Linv)), ok
    if mixed:
        f32 = jnp.float32
        if pre and "data32" in pre:
            data = pre["data32"]  # hoisted cast (see precompute)
        else:
            data = data.replace(
                P=data.P.astype(f32), A=data.A.astype(f32), G=data.G.astype(f32)
            )
        ks_f = ks.replace(
            x_reg=ks.x_reg.astype(f32),
            z_reg_fact=ks.z_reg_fact.astype(f32),
            delta_reg=ks.delta_reg.astype(f32),
        )
        K = assemble_condensed(data, ks_f, pre)
        # Jacobi-scale to unit diagonal before the f32 Cholesky: the
        # barrier terms spread K's diagonal over ~1/mu^2, and factoring
        # the equilibrated K_s = D^-1 K D^-1 keeps the pivots inside f32
        # range.  chol(K) = D chol(K_s) exactly, so the returned factor
        # drops into the standard triangular solves; any factor-quality
        # loss only slows refinement, never corrupts the solution.
        dK = jnp.sqrt(jnp.maximum(jnp.diagonal(K), jnp.asarray(1e-30, f32)))
        dinv = 1.0 / dK
        Ks = K * dinv[:, None] * dinv[None, :]
        L = jnp.linalg.cholesky(Ks) * dK[:, None]
    else:
        K = assemble_condensed(data, ks, pre)
        L = jnp.linalg.cholesky(K)
    ok = jnp.all(jnp.isfinite(L))
    return ks.replace(L=L), ok


@singledispatch
def condensed_solve_x(data, ks: KKTState, v):
    """Solve K lx = v with the factored condensed matrix.  The factor may be
    lower precision than v (mixed mode); solve in factor precision and cast
    back."""
    raise NotImplementedError(type(data))


@condensed_solve_x.register
def _(data: QPData, ks: KKTState, v):
    if isinstance(ks.L, tuple):
        from .ops.pallas_chol import inv_solve

        _, Linv = ks.L
        return inv_solve(Linv, v.astype(Linv.dtype)).astype(v.dtype)
    vf = v.astype(ks.L.dtype)
    lx = lax.linalg.triangular_solve(ks.L, vf, left_side=True, lower=True)
    lx = lax.linalg.triangular_solve(
        ks.L, lx, left_side=True, lower=True, transpose_a=True
    )
    return lx.astype(v.dtype)


@singledispatch
def _backend_solve(data, ks: KKTState, rx, ry, rz, mat32=None):
    """Condensed backend solve (dense/kkt.hpp:86-105); structure-agnostic
    given the dispatched (fused) matvecs and K-solve.

    ``mat32``: optional f32-matrix copy of ``data`` (precompute's data32)
    — when given, the RHS-condensation and recovery matvecs read the f32
    matrices with f32 operands (the mixed phase-A byte/emulation
    optimization); the surrounding vector arithmetic stays in the solver
    dtype via promotion."""
    if mat32 is not None:
        f32 = jnp.float32
        v = ops.add_AtGt(
            mat32, rx,
            (ry / ks.delta_reg).astype(f32),
            (rz / ks.z_reg_fact).astype(f32),
        )
        lx = condensed_solve_x(data, ks, v)
        Ax, Gx = ops.AG_x(mat32, lx.astype(f32))
    else:
        v = ops.add_AtGt(data, rx, ry / ks.delta_reg, rz / ks.z_reg_fact)
        lx = condensed_solve_x(data, ks, v)
        Ax, Gx = ops.AG_x(data, lx)
    ly = (Ax - ry) / ks.delta_reg if data.p > 0 else jnp.zeros_like(ry)
    lz = (Gx - rz) / ks.z_reg_fact if data.m > 0 else jnp.zeros_like(rz)
    return lx, ly, lz


# ---------------------------------------------------------------------------
# full 3-block dense KKT backends (KKTBackend.dense_lu / dense_ldlt)
# ---------------------------------------------------------------------------

def assemble_full_kkt(data: QPData, ks: KKTState, dt) -> jax.Array:
    """The full regularized 3-block (n+p+m) dense KKT matrix

        [ P + diag(x_reg)   A'                G'               ]
        [ A                 -delta_reg I                       ]
        [ G                                   -diag(z_reg_fac) ]

    — the dense-device analog of the reference's KKT_FULL sparse mode
    (sparse/kkt_full.hpp:22-252)."""
    p, m = data.p, data.m
    P = data.P.astype(dt)
    A = data.A.astype(dt)
    G = data.G.astype(dt)
    top = jnp.concatenate([P + jnp.diag(ks.x_reg.astype(dt)), A.T, G.T], axis=1)
    mid = jnp.concatenate(
        [A, -ks.delta_reg.astype(dt) * jnp.eye(p, dtype=dt),
         jnp.zeros((p, m), dt)], axis=1,
    )
    bot = jnp.concatenate(
        [G, jnp.zeros((m, p), dt), -jnp.diag(ks.z_reg_fact.astype(dt))], axis=1
    )
    return jnp.concatenate([top, mid, bot], axis=0)


@empty_factor.register
def _(data: FullKKTQPData, settings: Settings = None):
    N = data.n + data.p + data.m
    return (
        jnp.zeros((N, N), data.P.dtype),
        jnp.zeros((N,), jnp.int32),
    )


@factor.register
def _factor_full_lu(
    data: FullKKTQPData, ks: KKTState, mixed: bool = False, pre=None
):
    """Pivoted LU of the full (n+p+m) regularized 3-block KKT matrix

        [ P + diag(x_reg)   A'                G'               ]
        [ A                 -delta_reg I                       ]
        [ G                                   -diag(z_reg_fac) ]

    — the dense-device analog of the reference's KKT_FULL sparse mode
    (sparse/kkt_full.hpp:22-252).  The full form keeps the condition
    number at kappa(KKT) instead of the condensed form's kappa^2, which is
    what ill-conditioned SQP subproblems (robot_arm fixtures) need to
    factor reliably in f64.
    """
    K = assemble_full_kkt(data, ks, jnp.float32 if mixed else data.P.dtype)
    lu, piv, _ = lax.linalg.lu(K)
    ok = jnp.all(jnp.isfinite(lu))
    return ks.replace(L=(lu, piv)), ok


@_backend_solve.register
def _(data: FullKKTQPData, ks: KKTState, rx, ry, rz, mat32=None):
    import jax.scipy.linalg as jsl

    lu, piv = ks.L
    rhs = jnp.concatenate([rx, ry, rz]).astype(lu.dtype)
    sol = jsl.lu_solve((lu, piv), rhs).astype(rx.dtype)
    n, p = data.n, data.p
    return sol[:n], sol[n:n + p], sol[n + p:]


@empty_factor.register
def _(data: LDLTKKTQPData, settings: Settings = None):
    from .ops import ldlt

    Np = ldlt.padded_dim(data.n + data.p + data.m)
    dt = data.P.dtype
    if use_pallas(settings):
        # full-inverse representation
        # (ops/pallas_chol.signed_cholesky_with_inverse)
        return (jnp.zeros((Np, Np), dt), jnp.zeros((Np, Np), dt))
    nb = Np // ldlt.DEFAULT_BLOCK
    bs = ldlt.DEFAULT_BLOCK
    return (jnp.zeros((Np, Np), dt), jnp.zeros((nb, bs, bs), dt))


@precompute.register
def _(data: LDLTKKTQPData, mixed: bool = False):
    return None


@factor.register
def _factor_full_ldlt(
    data: LDLTKKTQPData, ks: KKTState, mixed: bool = False, pre=None
):
    """Blocked signed Cholesky (LDL^T, no pivoting) of the full 3-block
    quasi-definite KKT matrix (ops/ldlt.py) — the device analog of the
    reference's dense::LDLTNoPivot (dense/ldlt_no_pivot.hpp:279-354) applied
    to the KKT_FULL system: a Cholesky-cost robustness route for
    ill-conditioned problems where the condensed form's squared condition
    number bites."""
    from .ops import ldlt

    dt = jnp.float32 if mixed else data.P.dtype
    K = assemble_full_kkt(data, ks, dt)
    Np = ldlt.padded_dim(data.n + data.p + data.m)
    Kp = ldlt.pad_quasidef(K, Np)
    signs = ldlt.kkt_signs(data.n, data.p, data.m, Np, dt)
    if ks.L[1].ndim == 2:
        # full-inverse representation (settings.pallas_kernels): solves
        # become GEMVs
        from .ops.pallas_chol import signed_cholesky_with_inverse

        L, Linvs = signed_cholesky_with_inverse(Kp, signs)
    else:
        L, Linvs = ldlt.signed_cholesky(Kp, signs)
    ok = jnp.logical_and(
        jnp.all(jnp.isfinite(L)), jnp.all(jnp.isfinite(Linvs))
    )
    return ks.replace(L=(L, Linvs)), ok


@_backend_solve.register
def _(data: LDLTKKTQPData, ks: KKTState, rx, ry, rz, mat32=None):
    from .ops import ldlt

    L, Linvs = ks.L
    n, p, m = data.n, data.p, data.m
    Np = L.shape[-1]
    signs = ldlt.kkt_signs(n, p, m, Np, L.dtype)
    rhs = jnp.concatenate([rx, ry, rz]).astype(L.dtype)
    rhs = jnp.concatenate([rhs, jnp.zeros((Np - n - p - m,), L.dtype)])
    if Linvs.ndim == 2:
        from .ops.pallas_chol import signed_inv_solve

        sol = signed_inv_solve(Linvs, signs, rhs).astype(rx.dtype)
    else:
        sol = ldlt.signed_solve(L, Linvs, signs, rhs).astype(rx.dtype)
    return sol[:n], sol[n:n + p], sol[n + p:n + p + m]


def mul_condensed(data, ks: KKTState, lx, ly, lz, mat32=None):
    """Condensed KKT matvec for refinement (kkt_system.hpp:507-519).

    Note: uses the (possibly statically regularized) x_reg but the
    *unregularized* delta and z_reg, exactly as the reference does.

    ``mat32``: optional f32-matrix copy — the matvecs then run with f32
    matrices AND f32 operands (phase-A mixed optimization; the residual
    is f32-accurate, which is exactly the factor's accuracy there).
    """
    md = data if mat32 is None else mat32
    f32 = jnp.float32
    lxm = lx if mat32 is None else lx.astype(f32)
    Px, Ax, Gx = ops.PAG_x(md, lxm)
    rx0 = Px + ks.x_reg * lx
    if mat32 is None:
        rx = ops.add_AtGt(md, rx0, ly, lz)
    else:
        rx = ops.add_AtGt(md, rx0, ly.astype(f32), lz.astype(f32))
    ry = Ax - ks.delta * ly if data.p > 0 else jnp.zeros_like(ly)
    rz = Gx - ks.z_reg * lz if data.m > 0 else jnp.zeros_like(lz)
    return rx, ry, rz


def mul_full(data: QPData, ks: KKTState, lhs: Vars) -> Vars:
    """Full (uncondensed) 10-block regularized KKT matvec
    (kkt_system.hpp:392-425).  Used by tests as the round-trip oracle."""
    rx = ops.P_x(data, lhs.x) + ks.rho * lhs.x
    ry = jnp.zeros_like(lhs.y)
    if data.p > 0:
        rx = rx + ops.AT_y(data, lhs.y)
        ry = ops.A_x(data, lhs.x) - ks.delta * lhs.y
    Gx = ops.G_x(data, lhs.x) if data.m > 0 else jnp.zeros_like(lhs.z_l)
    if data.m > 0:
        rx = rx + ops.GT_z(data, lhs.z_u - lhs.z_l)
    rz_l = jnp.where(data.hl_mask, -Gx + lhs.s_l - ks.delta * lhs.z_l, 0.0)
    rz_u = jnp.where(data.hu_mask, Gx + lhs.s_u - ks.delta * lhs.z_u, 0.0)
    # complementarity rows: S dz + Z ds (ks holds s and 1/z at factor time)
    z_l = jnp.where(data.hl_mask, 1.0 / jnp.where(data.hl_mask, ks.z_l_inv, 1.0), 0.0)
    z_u = jnp.where(data.hu_mask, 1.0 / jnp.where(data.hu_mask, ks.z_u_inv, 1.0), 0.0)
    z_bl = jnp.where(data.xl_mask, 1.0 / jnp.where(data.xl_mask, ks.z_bl_inv, 1.0), 0.0)
    z_bu = jnp.where(data.xu_mask, 1.0 / jnp.where(data.xu_mask, ks.z_bu_inv, 1.0), 0.0)
    rs_l = ks.s_l * lhs.z_l + z_l * lhs.s_l
    rs_u = ks.s_u * lhs.z_u + z_u * lhs.s_u

    xb = data.x_b_scaling
    rx = rx - jnp.where(data.xl_mask, xb * lhs.z_bl, 0.0)
    rx = rx + jnp.where(data.xu_mask, xb * lhs.z_bu, 0.0)
    rz_bl = jnp.where(
        data.xl_mask, -xb * lhs.x - ks.delta * lhs.z_bl + lhs.s_bl, 0.0
    )
    rz_bu = jnp.where(
        data.xu_mask, xb * lhs.x - ks.delta * lhs.z_bu + lhs.s_bu, 0.0
    )
    rs_bl = ks.s_bl * lhs.z_bl + z_bl * lhs.s_bl
    rs_bu = ks.s_bu * lhs.z_bu + z_bu * lhs.s_bu

    return Vars(
        x=rx, y=ry, z_l=rz_l, z_u=rz_u, z_bl=rz_bl, z_bu=rz_bu,
        s_l=rs_l, s_u=rs_u, s_bl=rs_bl, s_bu=rs_bu,
    )


def _inf3(x, y, z):
    # per-block reductions: x/y/z can carry different shardings in the
    # horizon-sharded path, where a concatenation would force a reshard
    return jnp.maximum(
        jnp.max(jnp.abs(x), initial=0.0),
        jnp.maximum(jnp.max(jnp.abs(y), initial=0.0), jnp.max(jnp.abs(z), initial=0.0)),
    )


def _refine_error(data, ks, lx, ly, lz, rx, ry, rz, mat32=None):
    ex, ey, ez = mul_condensed(data, ks, lx, ly, lz, mat32)
    ex, ey, ez = rx - ex, ry - ey, rz - ez
    return ex, ey, ez, _inf3(ex, ey, ez)


def _solve_condensed_refined(
    data: QPData, settings: Settings, ks: KKTState, rx, ry, rz, mu=None,
    mat32=None,
):
    """Backend solve + iterative refinement (kkt_system.hpp:254-308).

    Refinement is ALWAYS on (unlike the reference, which gates it together
    with static regularization): the condensed n-by-n system squares the
    KKT condition number, and on ill-conditioned SQP instances (e.g. the
    robot_arm fixtures) the unrefined primal residual floors at ~1e-3.
    Refining against the *unregularized* target recovers the accuracy while
    leaving well-conditioned trajectories untouched; the cost when already
    accurate is one extra condensed matvec per solve.  ``ks.use_ir``
    continues to gate only the static regularization of the factored system
    (the recovery-ladder escalation).

    ``mu``: current complementarity measure; when set and
    ``settings.refine_mu_factor > 0``, the refinement exit tolerance is
    relaxed to ``max(tol, refine_mu_factor * mu)`` — the inexact-IPM rule
    (solve the Newton system to an accuracy proportional to the barrier
    parameter).  Early IPM iterations then accept the direct f32-factor
    solve, while late iterations tighten automatically as mu -> 0; final
    accuracy is still governed by
    the unregularized residual checks in the solver's termination test.
    """
    lx, ly, lz = _backend_solve(data, ks, rx, ry, rz, mat32)

    if (
        mat32 is not None
        and mu is not None
        and settings.refine_mu_factor > 0
        and settings.refine_static_passes >= 0
    ):
        # Statically unrolled phase-A refinement (types.Settings.
        # refine_static_passes): a FIXED number of correction passes with
        # no error norms, no improvement-rate logic and no while_loop: the
        # lockstep while_loop's per-trip machinery (three masked norm
        # reductions, rate/slow/done selects, batched cond sync) can cost
        # more than the arithmetic.  Inexact-IPM theory only needs solve
        # accuracy proportional to mu here, the f64 endgame re-solves adaptively,
        # and termination always checks true residuals, so fixed passes
        # in phase A trade nothing but unmeasurable accuracy.  The
        # factor-ladder's failure signal is preserved via one finiteness
        # check on the final iterate.
        for _ in range(settings.refine_static_passes):
            ex, ey, ez = mul_condensed(data, ks, lx, ly, lz, mat32)
            ex, ey, ez = rx - ex, ry - ey, rz - ez
            dx, dy, dz = _backend_solve(data, ks, ex, ey, ez, mat32)
            lx, ly, lz = lx + dx, ly + dy, lz + dz
        ok = jnp.isfinite(jnp.sum(lx) + jnp.sum(ly) + jnp.sum(lz))
        return lx, ly, lz, ok

    def with_refinement(args):
        lx, ly, lz = args
        rhs_norm = _inf3(rx, ry, rz)
        ex, ey, ez, err = _refine_error(data, ks, lx, ly, lz, rx, ry, rz,
                                        mat32)
        ok0 = jnp.isfinite(err)

        tol = (
            settings.iterative_refinement_eps_abs
            + settings.iterative_refinement_eps_rel * rhs_norm
        )
        if settings.refine_mu_factor > 0 and mu is not None:
            tol = jnp.maximum(tol, settings.refine_mu_factor * mu)
        if mat32 is not None:
            # the residual itself is computed against f32 matrices, so
            # error below ~f32 noise is unmeasurable — don't chase it
            # (the improvement-rate exit would also stop, but only after
            # wasted passes)
            tol = jnp.maximum(
                tol, 32.0 * float(jnp.finfo(jnp.float32).eps) * rhs_norm
            )

        def cond(c):
            i, _lx, _ly, _lz, _ex, _ey, _ez, err, done, ok = c
            return jnp.logical_and(
                jnp.logical_and(~done, ok),
                jnp.logical_and(i < settings.iterative_refinement_max_iter, err > tol),
            )

        def body(c):
            i, lx, ly, lz, ex, ey, ez, err, done, ok = c
            dx, dy, dz = _backend_solve(data, ks, ex, ey, ez, mat32)
            cx, cy, cz = lx + dx, ly + dy, lz + dz
            nex, ney, nez, nerr = _refine_error(data, ks, cx, cy, cz,
                                                rx, ry, rz, mat32)
            ok = jnp.isfinite(nerr)
            rate = err / nerr
            slow = rate < settings.iterative_refinement_min_improvement_rate
            accept = jnp.logical_and(ok, jnp.logical_or(~slow, rate > 1.0))
            # kkt_system.hpp:289-301: on slow improvement keep the better
            # iterate and stop; otherwise accept and continue.
            lx = jnp.where(accept, cx, lx)
            ly = jnp.where(accept, cy, ly)
            lz = jnp.where(accept, cz, lz)
            ex = jnp.where(accept, nex, ex)
            ey = jnp.where(accept, ney, ey)
            ez = jnp.where(accept, nez, ez)
            err = jnp.where(accept, nerr, err)
            done = slow
            return (i + 1, lx, ly, lz, ex, ey, ez, err, done, ok)

        c = (
            jnp.asarray(0, jnp.int32),
            lx, ly, lz, ex, ey, ez, err,
            jnp.asarray(False), ok0,
        )
        c = lax.while_loop(cond, body, c)
        _, lx, ly, lz, _, _, _, _, _, ok = c
        return lx, ly, lz, ok

    return with_refinement((lx, ly, lz))


def solve(
    data: QPData, settings: Settings, ks: KKTState, rhs: Vars, mu=None,
    mat32=None,
) -> tuple[Vars, jax.Array]:
    """Full KKT solve: condense RHS, solve the (x,y,z) system, recover the
    slack/dual directions (kkt_system.hpp:213-369).

    ``mu`` feeds the inexact-IPM refinement tolerance (see
    ``_solve_condensed_refined``); ``mat32`` routes the heavy matvecs
    through hoisted f32 matrix copies (mixed phase A).  Returns (lhs, ok).
    """
    # condensed inequality RHS (kkt_system.hpp:219-234)
    rz_l_bar = jnp.where(data.hl_mask, rhs.z_l - ks.z_l_inv * rhs.s_l, 0.0)
    rz_u_bar = jnp.where(data.hu_mask, rhs.z_u - ks.z_u_inv * rhs.s_u, 0.0)
    rhs_z_bar = ks.z_reg * (-ks.W_l_inv * rz_l_bar + ks.W_u_inv * rz_u_bar)

    # condensed primal RHS with box eliminations (kkt_system.hpp:236-252)
    rb_l_bar = jnp.where(data.xl_mask, rhs.z_bl - ks.z_bl_inv * rhs.s_bl, 0.0)
    rb_u_bar = jnp.where(data.xu_mask, rhs.z_bu - ks.z_bu_inv * rhs.s_bu, 0.0)
    rhs_x_bar = (
        rhs.x
        - data.x_b_scaling * ks.W_bl_inv * rb_l_bar
        + data.x_b_scaling * ks.W_bu_inv * rb_u_bar
    )

    lx, ly, lz, ok = _solve_condensed_refined(
        data, settings, ks, rhs_x_bar, rhs.y, rhs_z_bar, mu, mat32
    )

    # inequality dual/slack recovery (kkt_system.hpp:310-345).  The uniform
    # masked formula reproduces all three per-row cases of the reference.
    r_sum = ks.W_l_inv * ks.W_u_inv * (rz_l_bar + rz_u_bar)
    lz_l = jnp.where(data.hl_mask, -ks.z_reg * (r_sum + ks.W_l_inv * lz), 0.0)
    lz_u = jnp.where(data.hu_mask, -ks.z_reg * (r_sum - ks.W_u_inv * lz), 0.0)
    ls_l = jnp.where(data.hl_mask, ks.z_l_inv * (rhs.s_l - ks.s_l * lz_l), 0.0)
    ls_u = jnp.where(data.hu_mask, ks.z_u_inv * (rhs.s_u - ks.s_u * lz_u), 0.0)

    # box dual/slack recovery (kkt_system.hpp:347-366)
    lz_bl = jnp.where(
        data.xl_mask,
        (-data.x_b_scaling * lx - rhs.z_bl + ks.z_bl_inv * rhs.s_bl) * ks.W_bl_inv,
        0.0,
    )
    lz_bu = jnp.where(
        data.xu_mask,
        (data.x_b_scaling * lx - rhs.z_bu + ks.z_bu_inv * rhs.s_bu) * ks.W_bu_inv,
        0.0,
    )
    ls_bl = jnp.where(
        data.xl_mask, ks.z_bl_inv * (rhs.s_bl - ks.s_bl * lz_bl), 0.0
    )
    ls_bu = jnp.where(
        data.xu_mask, ks.z_bu_inv * (rhs.s_bu - ks.s_bu * lz_bu), 0.0
    )

    lhs = Vars(
        x=lx, y=ly,
        z_l=lz_l, z_u=lz_u, z_bl=lz_bl, z_bu=lz_bu,
        s_l=ls_l, s_u=ls_u, s_bl=ls_bl, s_bu=ls_bu,
    )
    return lhs, ok
