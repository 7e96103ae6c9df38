"""Multistage (block-tridiagonal + arrow) KKT backend.

Accelerator-first re-design of the reference's flagship native component,
sparse::MultistageKKT (/root/reference/include/piqp/sparse/multistage_kkt.hpp):
solves QPs whose variables split into stages x = (x_0 ... x_{T-1}, g) with
nearest-neighbor coupling plus a global "arrow" block g, keeping cost
*linear in the horizon* T (multistage_kkt.hpp:420-597 detects this structure;
docs/_pages/multistage.md describes the problem class).

Design deltas vs the reference (accelerator-first):

- The reference's BLASFEO panel kernels (blocksparse/*, utils/blasfeo_*)
  become batched einsums over the stage axis — every per-stage syrk/gemm in
  the assembly runs as ONE batched matrix op across all stages at once
  (the reference parallelizes these loops with OpenMP, multistage_kkt.hpp:
  855-994; here the batch dimension does it).
- The sequential stage recursion of the factorization
  (factor_kkt, multistage_kkt.hpp:1253-1352):
      L_i = chol(D_i - C_{i-1} C_{i-1}'),  C_i = K_{i+1,i} L_i^{-T},
      F_i = (K_{g,i} - F_{i-1} C_{i-1}') L_i^{-T},
      L_g = chol(K_gg - sum_i F_i F_i')
  is expressed as ``lax.scan`` over stages; the forward/backward triangular
  sweeps (solve_llt_in_place, multistage_kkt.hpp:1709-1816) are scans too.
- Stages are padded to a uniform width D so every block op is a fixed-shape
  batched kernel; constraint rows are bucketed by stage with uniform bucket
  sizes (the reference's BlockMat row permutation, blocksparse/block_mat.hpp).
- Unlike the reference (double-only, static_assert multistage_kkt.hpp:44),
  this backend inherits the solver dtype.

The IPM core (solver.py / kkt.py) is representation-agnostic: this module
plugs in by registering implementations of the dispatched ops
(P_x/A_x/..., factor, condensed_solve_x, equilibrate).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import kkt as kkt_mod
from . import ruiz as ruiz_mod
from .ops import matvec as mv
from .types import PIQP_INF, QPData, Scaling, _pytree_dataclass, use_pallas


@_pytree_dataclass
class StageQPData:
    """Stage-structured problem data.

    Variable layout (flat): x = [x_0, ..., x_{T-1}, g], n = T*D + Da.
    Constraint rows are bucketed by stage (bucket j touches stages j, j+1 and
    the arrow): p = T*ra, m = T*rg.

    Flat fields (c, b, h_l, ... masks) use exactly the QPData conventions so
    the IPM core works unchanged; the structured blocks replace the dense
    P/A/G for matvecs and factorization.

    Block conventions:
      Pd[i]   = P[stage i, stage i]            (T, D, D), full symmetric
      Psub[i] = P[stage i+1, stage i]          (T, D, D), Psub[T-1] = 0
      Pa[i]   = P[g, stage i]                  (T, Da, D)
      Pc      = P[g, g]                        (Da, Da)
      A1[j]   = A[bucket j, stage j]           (T, ra, D)
      A2[j]   = A[bucket j, stage j+1]         (T, ra, D), A2[T-1] = 0
      Ag[j]   = A[bucket j, g]                 (T, ra, Da)
      G1/G2/Gg analogous                       (T, rg, *)
    """

    # flat IPM-facing fields
    c: jax.Array
    b: jax.Array
    h_l: jax.Array
    h_u: jax.Array
    x_l: jax.Array
    x_u: jax.Array
    x_b_scaling: jax.Array
    hl_mask: jax.Array
    hu_mask: jax.Array
    xl_mask: jax.Array
    xu_mask: jax.Array

    # structured blocks
    Pd: jax.Array
    Psub: jax.Array
    Pa: jax.Array
    Pc: jax.Array
    A1: jax.Array
    A2: jax.Array
    Ag: jax.Array
    G1: jax.Array
    G2: jax.Array
    Gg: jax.Array

    @property
    def T(self) -> int:
        return self.Pd.shape[-3]

    @property
    def D(self) -> int:
        return self.Pd.shape[-1]

    @property
    def Da(self) -> int:
        return self.Pc.shape[-1]

    @property
    def ra(self) -> int:
        return self.A1.shape[-2]

    @property
    def rg(self) -> int:
        return self.G1.shape[-2]

    @property
    def n(self) -> int:
        return self.T * self.D + self.Da

    @property
    def p(self) -> int:
        return self.T * self.ra

    @property
    def m(self) -> int:
        return self.T * self.rg


def _split_x(data: StageQPData, x):
    T, D = data.T, data.D
    return x[: T * D].reshape(T, D), x[T * D:]


def _join_x(xs, xg):
    return jnp.concatenate([xs.reshape(-1), xg])


def _shift_up(a):
    """out[i] = a[i+1], out[-1] = 0 (along leading axis)."""
    return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)


def _shift_down(a):
    """out[i] = a[i-1], out[0] = 0."""
    return jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]], axis=0)


# ---------------------------------------------------------------------------
# structured matvecs (the reference's blocked symv/gemv,
# multistage_kkt.hpp:1354-1706, as batched einsums)
# ---------------------------------------------------------------------------

@mv.P_x.register
def _(data: StageQPData, x):
    xs, xg = _split_x(data, x)
    u = jnp.einsum("tij,tj->ti", data.Pd, xs)
    u = u + _shift_down(jnp.einsum("tij,tj->ti", data.Psub, xs))
    u = u + jnp.einsum("tij,ti->tj", data.Psub, _shift_up(xs))
    u = u + jnp.einsum("tad,a->td", data.Pa, xg)
    yg = jnp.einsum("tad,td->a", data.Pa, xs) + data.Pc @ xg
    return _join_x(u, yg)


@mv.P_diag.register
def _(data: StageQPData):
    d = jnp.diagonal(data.Pd, axis1=-2, axis2=-1).reshape(-1)
    return jnp.concatenate([d, jnp.diagonal(data.Pc)])


@mv.A_x.register
def _(data: StageQPData, x):
    xs, xg = _split_x(data, x)
    ys = (
        jnp.einsum("trd,td->tr", data.A1, xs)
        + jnp.einsum("trd,td->tr", data.A2, _shift_up(xs))
        + jnp.einsum("tra,a->tr", data.Ag, xg)
    )
    return ys.reshape(-1)


@mv.AT_y.register
def _(data: StageQPData, y):
    ys = y.reshape(data.T, data.ra)
    us = jnp.einsum("trd,tr->td", data.A1, ys)
    us = us + _shift_down(jnp.einsum("trd,tr->td", data.A2, ys))
    ug = jnp.einsum("tra,tr->a", data.Ag, ys)
    return _join_x(us, ug)


@mv.G_x.register
def _(data: StageQPData, x):
    xs, xg = _split_x(data, x)
    zs = (
        jnp.einsum("trd,td->tr", data.G1, xs)
        + jnp.einsum("trd,td->tr", data.G2, _shift_up(xs))
        + jnp.einsum("tra,a->tr", data.Gg, xg)
    )
    return zs.reshape(-1)


@mv.GT_z.register
def _(data: StageQPData, z):
    zs = z.reshape(data.T, data.rg)
    us = jnp.einsum("trd,tr->td", data.G1, zs)
    us = us + _shift_down(jnp.einsum("trd,tr->td", data.G2, zs))
    ug = jnp.einsum("tra,tr->a", data.Gg, zs)
    return _join_x(us, ug)


@mv.abs_data.register
def _(data: StageQPData):
    return data.replace(
        Pd=jnp.abs(data.Pd), Psub=jnp.abs(data.Psub), Pa=jnp.abs(data.Pa),
        Pc=jnp.abs(data.Pc), A1=jnp.abs(data.A1), A2=jnp.abs(data.A2),
        Ag=jnp.abs(data.Ag), G1=jnp.abs(data.G1), G2=jnp.abs(data.G2),
        Gg=jnp.abs(data.Gg),
    )


@kkt_mod.precompute.register
def _(data: StageQPData, mixed: bool = False):
    """Mixed-precision support: hoisted f32 copies of the stage blocks.
    The phase-A residual/refinement matvecs and the block assembly then
    run in f32, reading half the bytes (the same lever as the dense
    backend's data32)."""
    if not mixed:
        return None
    f32 = jnp.float32

    def cast(a):
        return a.astype(f32) if a.dtype == jnp.float64 else a

    return {"data32": data.replace(
        Pd=cast(data.Pd), Psub=cast(data.Psub), Pa=cast(data.Pa),
        Pc=cast(data.Pc), A1=cast(data.A1), A2=cast(data.A2),
        Ag=cast(data.Ag), G1=cast(data.G1), G2=cast(data.G2),
        Gg=cast(data.Gg),
    )}


# ---------------------------------------------------------------------------
# block factorization (factor_kkt + block_syrk assembly,
# multistage_kkt.hpp:820-1352)
# ---------------------------------------------------------------------------

def _assemble_blocks(data: StageQPData, ks):
    """Blockwise K = P + diag(x_reg) + (1/dr) A'A + G' W G."""
    dr_inv = 1.0 / ks.delta_reg
    W = (1.0 / ks.z_reg_fact).reshape(data.T, data.rg)
    xreg_s, xreg_g = _split_x(data, ks.x_reg)

    GW1 = data.G1 * W[:, :, None]
    GW2 = data.G2 * W[:, :, None]
    GWg = data.Gg * W[:, :, None]

    Kd = data.Pd + jax.vmap(jnp.diag)(xreg_s)
    Kd = Kd + dr_inv * jnp.einsum("tri,trj->tij", data.A1, data.A1)
    Kd = Kd + _shift_down(dr_inv * jnp.einsum("tri,trj->tij", data.A2, data.A2))
    Kd = Kd + jnp.einsum("tri,trj->tij", GW1, data.G1)
    Kd = Kd + _shift_down(jnp.einsum("tri,trj->tij", GW2, data.G2))

    Ksub = data.Psub + dr_inv * jnp.einsum("tri,trj->tij", data.A2, data.A1)
    Ksub = Ksub + jnp.einsum("tri,trj->tij", GW2, data.G1)

    Ka = data.Pa + dr_inv * jnp.einsum("tra,trd->tad", data.Ag, data.A1)
    Ka = Ka + _shift_down(dr_inv * jnp.einsum("tra,trd->tad", data.Ag, data.A2))
    Ka = Ka + jnp.einsum("tra,trd->tad", GWg, data.G1)
    Ka = Ka + _shift_down(jnp.einsum("tra,trd->tad", GWg, data.G2))

    Kc = data.Pc + jnp.diag(xreg_g)
    Kc = Kc + dr_inv * jnp.einsum("tra,trb->ab", data.Ag, data.Ag)
    Kc = Kc + jnp.einsum("tra,trb->ab", GWg, data.Gg)
    return Kd, Ksub, Ka, Kc


def _tsolve(L, B, transpose=False):
    """Solve L X = B (or L' X = B) for matrix/vector B."""
    vec = B.ndim == 1
    if vec:
        B = B[:, None]
    X = lax.linalg.triangular_solve(
        L, B, left_side=True, lower=True, transpose_a=transpose
    )
    return X[:, 0] if vec else X


@kkt_mod.empty_factor.register
def _(data: StageQPData, settings=None):
    T, D, Da = data.T, data.D, data.Da
    dt = data.c.dtype
    if _use_cr(T):
        # placeholder structure selects the factor representation (see
        # kkt.empty_factor): 5-tuple CR levels keep the odd-block inverses,
        # so every block solve is a pair of GEMMs
        pallas = use_pallas(settings)
        return _cr_empty(T, D, Da, dt, pallas)
    C = _chunk_count(T)
    if C is not None:
        Q = T // C
        Qi = Q - 1
        W = 2 * D + Da
        z = jnp.zeros
        if _use_cr(Qi):
            # chunk interiors factor by cyclic reduction (C-batched);
            # level arity again selects the factor-with-inverse form
            pallas = use_pallas(settings)
            local = jax.tree.map(
                lambda a: jnp.zeros((C,) + a.shape, dt),
                _cr_chain_empty(Qi, D, W, dt, pallas),
            )
        else:
            local = (
                z((C, Qi, D, D), dt), z((C, Qi, D, D), dt),
                z((C, Qi, W, D), dt),
            )
        return (
            local,
            z((C, D, D), dt), z((C, D, D), dt), z((C, Da, D), dt),
            z((Da, Da), dt),
        )
    return (
        jnp.zeros((T, D, D), dt),
        jnp.zeros((T, D, D), dt),
        jnp.zeros((T, Da, D), dt),
        jnp.zeros((Da, Da), dt),
    )


def chain_factor(Kd, Ksub, Ka):
    """Block Cholesky sweep of a block-tridiagonal chain with a width-W
    coupling ("arrow") row — the reference's sequential stage recursion
    (factor_kkt, multistage_kkt.hpp:1253-1352) as a ``lax.scan``:

        L_i = chol(Kd_i - C_{i-1} C_{i-1}'),  C_i = Ksub_i L_i^{-T},
        F_i = (Ka_i - F_{i-1} C_{i-1}') L_i^{-T},  acc = sum_i F_i F_i'

    Shapes: Kd (T,D,D); Ksub (T,D,D) with Ksub[i] = K[i+1,i] (last entry
    must be zero); Ka (T,W,D).  Returns (Ls, Cs, Fs, acc) with acc (W,W).
    Also the building block of the horizon-sharded factorization
    (parallel/horizon.py), where W = 2D+Da couples each chunk to its
    boundary separators plus the global arrow.
    """
    D = Kd.shape[-1]
    W = Ka.shape[-2]
    dt = Kd.dtype

    def step(carry, blocks):
        C_prev, F_prev, acc = carry
        Kd_i, Ksub_i, Ka_i = blocks
        M = Kd_i - C_prev @ C_prev.T
        L = jnp.linalg.cholesky(M)
        C = _tsolve(L, Ksub_i.T).T  # C_i = Ksub_i L^{-T}
        F = _tsolve(L, (Ka_i - F_prev @ C_prev.T).T).T
        acc = acc + F @ F.T
        return (C, F, acc), (L, C, F)

    init = (jnp.zeros((D, D), dt), jnp.zeros((W, D), dt), jnp.zeros((W, W), dt))
    (_, _, acc), (Ls, Cs, Fs) = lax.scan(step, init, (Kd, Ksub, Ka))
    return Ls, Cs, Fs, acc


def chain_fwd(Ls, Cs, Fs, vs):
    """Forward block-triangular sweep w = L^{-1} v over the chain; returns
    (ws, gacc) with gacc = sum_i F_i w_i, the RHS contribution to the
    arrow/coupling rows (solve_llt_in_place fwd, multistage_kkt.hpp:1709+)."""
    D = Ls.shape[-1]
    W = Fs.shape[-2]
    dt = Ls.dtype
    C_prevs = _shift_down(Cs)  # C_prevs[i] = C_{i-1}, zero for i=0

    def fwd(carry, blocks):
        v_prev, gacc = carry
        L_i, C_prev, F_i, r_i = blocks
        u = r_i - C_prev @ v_prev
        w = _tsolve(L_i, u)
        return (w, gacc + F_i @ w), w

    (_, gacc), ws = lax.scan(
        fwd, (jnp.zeros(D, dt), jnp.zeros(W, dt)), (Ls, C_prevs, Fs, vs)
    )
    return ws, gacc


def chain_bwd(Ls, Cs, Fs, ws, xa):
    """Backward sweep x_i = L_i^{-T} (w_i - C_i' x_{i+1} - F_i' xa) given the
    solved arrow/coupling variables xa (W,)."""
    D = Ls.shape[-1]
    dt = Ls.dtype

    def bwd(carry, blocks):
        x_next = carry
        L_i, C_i, F_i, w_i = blocks
        u = w_i - C_i.T @ x_next - F_i.T @ xa
        x_i = _tsolve(L_i, u, transpose=True)
        return x_i, x_i

    _, xs = lax.scan(bwd, jnp.zeros(D, dt), (Ls, Cs, Fs, ws), reverse=True)
    return xs


# ---------------------------------------------------------------------------
# two-level chunked factorization (single-device horizon parallelism)
# ---------------------------------------------------------------------------
#
# A plain scan over T stages is latency-bound on an accelerator: each step
# is a handful of tiny block ops, so wall time is T * kernel-latency with
# the device mostly idle.  For larger horizons the factorization runs the
# partitioned Schur-complement scheme of parallel/horizon.py with chunks
# BATCHED on one device instead of sharded: C ~ sqrt(T) interior chains
# factor as ONE scan of length T/C over (C, ...)-batched block ops, the
# C-stage coarse separator system factors sequentially, and sequential
# depth drops from T to ~2*sqrt(T) while every step feeds the device C
# blocks at once.

_CHUNK_MIN_T = 16


def _chunk_count(T: int):
    """Largest divisor C of T with C <= sqrt(T)-ish and T/C >= 2; None if
    chunking is not worthwhile (static, trace-time)."""
    if T < _CHUNK_MIN_T:
        return None
    best = None
    c = 1
    while c * c <= T:
        if T % c == 0 and T // c >= 2:
            best = c
        c += 1
    return best if best and best > 1 else None


def _chunked_factor(Kd, Ksub, Ka, Kc, C, pallas: bool = False):
    T, D, _ = Kd.shape
    Da = Kc.shape[0]
    Q = T // C
    Qi = Q - 1
    W = 2 * D + Da
    dt = Kd.dtype

    KdC = Kd.reshape(C, Q, D, D)
    KsubC = Ksub.reshape(C, Q, D, D)
    KaC = Ka.reshape(C, Q, Da, D)

    # chunk k's coupling to the previous separator: Ksub[kQ-1], i.e. the
    # previous chunk's last sub-diagonal block (zeros for chunk 0)
    E_prev = _shift_down(KsubC[:, Q - 1])  # (C, D, D)

    Ea = jnp.zeros((C, Qi, W, D), dt)
    Ea = Ea.at[:, :, 2 * D:, :].set(KaC[:, :Qi])
    Ea = Ea.at[:, 0, :D, :].set(jnp.swapaxes(E_prev, -1, -2))
    Ea = Ea.at[:, Qi - 1, D:2 * D, :].set(KsubC[:, Qi - 1])

    Ksub_int = KsubC[:, :Qi].at[:, Qi - 1].set(0.0)
    if _use_cr(Qi):
        # interiors by C-batched cyclic reduction: sequential depth drops
        # from Qi scan steps to log2(Qi) levels of (C*H)-batched block ops
        local, Sacc, ok_i = jax.vmap(
            lambda kd, ks, ka: cr_chain_factor(kd, ks, ka, pallas)
        )(KdC[:, :Qi], Ksub_int, Ea)
        ok_int = jnp.all(ok_i)
    else:
        Ls, Cs, Fs, Sacc = jax.vmap(chain_factor)(KdC[:, :Qi], Ksub_int, Ea)
        local = (Ls, Cs, Fs)
        ok_int = jnp.all(jnp.isfinite(Ls))

    # coarse separator system (same algebra as horizon._chunk_factor)
    S_pp = Sacc[:, :D, :D]
    S_oo = Sacc[:, D:2 * D, D:2 * D]
    S_op = Sacc[:, D:2 * D, :D]
    S_ap = Sacc[:, 2 * D:, :D]
    S_ao = Sacc[:, 2 * D:, D:2 * D]
    S_aa = Sacc[:, 2 * D:, 2 * D:]

    cKd = KdC[:, Q - 1] - S_oo - _shift_up_c(S_pp)
    cKsub = -_shift_up_c(S_op)
    cKa = KaC[:, Q - 1] - S_ao - _shift_up_c(S_ap)
    cKc = Kc - jnp.sum(S_aa, axis=0)

    cLs, cCs, cFs, cacc = chain_factor(cKd, cKsub, cKa)
    cLc = jnp.linalg.cholesky(cKc - cacc)

    ok = jnp.logical_and(ok_int, jnp.all(jnp.isfinite(cLs)))
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(cLc)))
    return (local, cLs, cCs, cFs, cLc), ok


def _shift_up_c(a):
    """out[k] = a[k+1], out[-1] = 0."""
    return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)


def _chunked_solve(factors, vs_flat, vg, T, D, Da):
    local, cLs, cCs, cFs, cLc = factors
    cr = isinstance(local[0], tuple)  # (levels, base) vs (Ls, Cs, Fs)
    C = cLs.shape[0]
    Q = T // C
    Qi = Q - 1
    vsC = vs_flat.reshape(C, Q, D)

    if cr:
        state, gacc = jax.vmap(cr_chain_fwd)(local, vsC[:, :Qi])
    else:
        Ls, Cs, Fs = local
        ws, gacc = jax.vmap(chain_fwd)(Ls, Cs, Fs, vsC[:, :Qi])  # gacc (C, W)

    c_rhs = vsC[:, Q - 1] - gacc[:, D:2 * D] - _shift_up_c(gacc[:, :D])
    c_rhs_g = vg - jnp.sum(gacc[:, 2 * D:], axis=0)

    cws, cgacc = chain_fwd(cLs, cCs, cFs, c_rhs)
    cwg = _tsolve(cLc, c_rhs_g - cgacc)
    xg = _tsolve(cLc, cwg, transpose=True)
    x_sep = chain_bwd(cLs, cCs, cFs, cws, xg)  # (C, D)

    x_prev_sep = _shift_down(x_sep)
    xa = jnp.concatenate(
        [x_prev_sep, x_sep, jnp.broadcast_to(xg, (C, Da))], axis=-1
    )  # (C, W)
    if cr:
        x_int = jax.vmap(cr_chain_bwd)(local, state, xa)  # (C, Qi, D)
    else:
        x_int = jax.vmap(chain_bwd)(Ls, Cs, Fs, ws, xa)  # (C, Qi, D)

    xs = jnp.concatenate([x_int, x_sep[:, None, :]], axis=1).reshape(T, D)
    return xs, xg


# ---------------------------------------------------------------------------
# block cyclic reduction (log-depth factorization for long power-of-two
# horizons)
# ---------------------------------------------------------------------------
#
# Even-odd elimination of the block-tridiagonal + arrow system: each level
# Cholesky-factors all ODD diagonal blocks at once (one batched potrf +
# three batched solves + five batched GEMMs), substitutes them out — the
# reduced system is again block-tridiagonal + arrow over the evens — and
# recurses.  Sequential depth drops from ~2*sqrt(T) scan steps (two-level
# chunked scheme above) to log2(T) batched levels, each one GEMM-shaped.
# On SPD systems this is block Cholesky under a nested-dissection
# permutation, so stability matches the sequential recursion.
#
# Scheme selection (pinned by test_multistage.py::test_scheme_selection):
#   T < 16            -> sequential chain scan (latency fine at tiny T)
#   16 <= T <= 256    -> cyclic reduction (any parity)
#   T > 256           -> two-level chunked: CR unrolls log2(T) distinctly
#                        shaped batched levels and its XLA compile time
#                        grows with them on long horizons, while chunked
#                        stays at two scans regardless of T.

_CR_MIN_T = 16
_CR_MAX_T = 256


def _use_cr(T: int) -> bool:
    return _CR_MIN_T <= T <= _CR_MAX_T


def _bsolve(L, B):
    """Batched cho_solve: (..., D, D) lower factors applied to (..., D, r)."""
    X = lax.linalg.triangular_solve(L, B, left_side=True, lower=True)
    return lax.linalg.triangular_solve(
        L, X, left_side=True, lower=True, transpose_a=True
    )


def _inv_bsolve(Linv, B):
    """Batched cho_solve via the precomputed triangular inverse:
    Do^-1 B = Linv' (Linv B) — two batched GEMMs instead of two
    substitution sweeps (the factor-with-inverse form, ops/pallas_chol.py)."""
    return jnp.swapaxes(Linv, -1, -2) @ (Linv @ B)


def cr_chain_factor(Kd, Ksub, Ka, pallas: bool = False):
    """Cyclic-reduction factorization of a block-tridiagonal chain with
    width-W coupling rows — the log-depth analog of ``chain_factor``.

    Each level eliminates the odd-indexed stages (H_o = T//2 of them) at
    once; the reduced system lives on the H_e = T - H_o even stages.  For
    odd T the last stage is even-indexed and every odd stage has a right
    neighbor; for even T the last odd stage's right-coupling S_out is zero
    by the Ksub convention, so both parities use the same formulas with
    parity-dependent slicing.

    Shapes: Kd/Ksub (T, D, D), Ka (T, W, D) for any coupling width W.
    Returns ((levels, base), Sacc, ok) where levels[l] = (Lo, X1, X2, XE)
    holds the odd-block Cholesky factors and the substitution operators
    X1 = Do^-1 S_in, X2 = Do^-1 S_out', XE = Do^-1 Eo' of level l, base =
    (Ls, Cs, Fs) are the 1-stage reduced chain factors, and Sacc (W, W) is
    the total Schur contribution of the chain onto the coupling rows —
    exactly what ``chain_factor`` accumulates, so the two are drop-in
    interchangeable inside the partitioned schemes (the chunked scheme
    below and parallel/horizon.py use whichever ``_use_cr`` selects for
    the chunk-interior length).

    ``pallas=True`` (settings.pallas_kernels): the batched odd-block
    factor also builds its inverse (ops/pallas_chol.cholesky_inverse_apply)
    and levels become 5-tuples (Lo, Lo_inv, X1, X2, XE); every block solve
    in the factor and in the solves is then a pair of batched GEMMs against
    Lo_inv instead of a substitution sweep (the batched block-potrf/trsm
    replacement for the reference's per-stage kernel calls,
    multistage_kkt.hpp:1253-1352)."""
    if pallas:
        from .ops.pallas_chol import cholesky_inverse_apply

    T = Kd.shape[0]
    W = Ka.shape[-2]
    Sacc = jnp.zeros((W, W), Kd.dtype)
    levels = []
    ok = jnp.asarray(True)
    while T > 1:
        H_o = T // 2
        H_e = T - H_o
        Do, De = Kd[1::2], Kd[0::2]
        S_in = Ksub[0::2][:H_o]   # K[j, j-1] for odd j = 2k+1
        S_out = Ksub[1::2]        # K[j+1, j]
        Eo, Ee = Ka[1::2], Ka[0::2]

        if pallas:
            # chain step: factor + inverse + all three substitution
            # operators (ops/pallas_chol.cholesky_inverse_apply — the
            # batched analog of the reference's per-stage potrf+trsm panel
            # calls, multistage_kkt.hpp:1253-1352)
            D = Do.shape[-1]
            RHS = jnp.concatenate(
                [S_in, jnp.swapaxes(S_out, -1, -2),
                 jnp.swapaxes(Eo, -1, -2)], axis=-1,
            )  # (H_o, D, 2D + W)
            Lo, Lo_inv, Y = jax.vmap(cholesky_inverse_apply)(Do, RHS)
            ok = ok & jnp.all(jnp.isfinite(Lo)) & jnp.all(jnp.isfinite(Lo_inv))
            X1, X2, XE = Y[..., :D], Y[..., D:2 * D], Y[..., 2 * D:]
            levels.append((Lo, Lo_inv, X1, X2, XE))
        else:
            Lo = jnp.linalg.cholesky(Do)
            ok = ok & jnp.all(jnp.isfinite(Lo))
            X1 = _bsolve(Lo, S_in)
            X2 = _bsolve(Lo, jnp.swapaxes(S_out, -1, -2))
            XE = _bsolve(Lo, jnp.swapaxes(Eo, -1, -2))
            levels.append((Lo, X1, X2, XE))

        left = jnp.einsum("kji,kjl->kil", S_in, X1)
        right = jnp.einsum("kij,kjl->kil", S_out, X2)
        leftE = jnp.einsum("kaj,kjl->kal", Eo, X1)
        rightE = jnp.einsum("kaj,kjl->kal", Eo, X2)
        sub = -jnp.einsum("kij,kjl->kil", S_out, X1)
        if T % 2 == 0:
            # right-contribution of the last odd stage is zero (S_out = 0)
            Kd = De - left
            Kd = Kd.at[1:].add(-right[:-1])
            Ksub = sub
            Ka = Ee - leftE
            Ka = Ka.at[1:].add(-rightE[:-1])
        else:
            Kd = De.at[:H_o].add(-left).at[1:].add(-right)
            Ksub = jnp.concatenate([sub, jnp.zeros_like(sub[:1])], axis=0)
            Ka = Ee.at[:H_o].add(-leftE).at[1:].add(-rightE)
        Sacc = Sacc + jnp.einsum("kaj,kjb->ab", Eo, XE)
        T = H_e

    Ls, Cs, Fs, acc = chain_factor(Kd, Ksub, Ka)
    ok = ok & jnp.all(jnp.isfinite(Ls))
    return (tuple(levels), (Ls, Cs, Fs)), Sacc + acc, ok


def cr_chain_fwd(factors, vs):
    """Forward cyclic-reduction sweep: ~log2(T) batched levels condense
    the RHS onto the evens, then the 1-stage base forward sweep.  Returns
    (state, gacc) with gacc (W,) = sum_i E_i K^{-1} v_i, the coupling-row
    RHS contribution — the log-depth analog of ``chain_fwd``; ``state``
    carries the per-level odd RHS plus the base ws for ``cr_chain_bwd``."""
    levels, (Ls, Cs, Fs) = factors
    W = Fs.shape[-2]
    gacc = jnp.zeros(W, Ls.dtype)
    v_odds = []
    for lev in levels:
        X1, X2, XE = lev[-3], lev[-2], lev[-1]
        T = vs.shape[0]
        H_o = T // 2
        v_o, v_e = vs[1::2], vs[0::2]
        v_odds.append(v_o)
        lv = jnp.einsum("kji,kj->ki", X1, v_o)
        rv = jnp.einsum("kji,kj->ki", X2, v_o)
        if T % 2 == 0:
            vs = (v_e - lv).at[1:].add(-rv[:-1])
        else:
            vs = v_e.at[:H_o].add(-lv).at[1:].add(-rv)
        gacc = gacc + jnp.einsum("kja,kj->a", XE, v_o)

    ws, gb = chain_fwd(Ls, Cs, Fs, vs)
    return (tuple(v_odds), ws), gacc + gb


def cr_chain_bwd(factors, state, xa):
    """Backward cyclic-reduction sweep given the solved coupling variables
    xa (W,): base backward sweep, then the same levels back-substitute the
    odd stages — the log-depth analog of ``chain_bwd``."""
    levels, (Ls, Cs, Fs) = factors
    v_odds, ws = state
    x = chain_bwd(Ls, Cs, Fs, ws, xa)  # (1, D)

    for lev, v_o in zip(reversed(levels), reversed(v_odds)):
        X1, X2, XE = lev[-3], lev[-2], lev[-1]
        x_e = x
        H_o = v_o.shape[0]
        T = H_o + x_e.shape[0]
        if T % 2 == 0:
            x_next = jnp.concatenate([x_e[1:], jnp.zeros_like(x_e[:1])], axis=0)
        else:
            x_next = x_e[1:]
        if len(lev) == 5:  # pallas: Do^-1 via GEMMs against Lo_inv
            x_o = _inv_bsolve(lev[1], v_o[..., None])[..., 0]
        else:
            x_o = _bsolve(lev[0], v_o[..., None])[..., 0]
        x_o = x_o - jnp.einsum("kij,kj->ki", X1, x_e[:H_o])
        x_o = x_o - jnp.einsum("kij,kj->ki", X2, x_next)
        x_o = x_o - jnp.einsum("kia,a->ki", XE, xa)
        D = x_e.shape[1]
        x = jnp.zeros((T, D), x_e.dtype)
        x = x.at[0::2].set(x_e).at[1::2].set(x_o)
    return x


def cr_factor(Kd, Ksub, Ka, Kc, pallas: bool = False):
    """Cyclic-reduction factorization of the full tridiagonal + arrow
    system (``cr_chain_factor`` with the arrow as the coupling rows, plus
    the Cholesky of the arrow's Schur complement)."""
    (levels, (Ls, Cs, Fs)), Sacc, ok = cr_chain_factor(Kd, Ksub, Ka, pallas)
    Lc = jnp.linalg.cholesky(Kc - Sacc)
    ok = ok & jnp.all(jnp.isfinite(Lc))
    return (levels, (Ls, Cs, Fs, Lc)), ok


def cr_solve(factors, vs, vg):
    """Forward/backward cyclic-reduction sweeps: levels down (condense the
    RHS onto the evens + arrow), arrow solve, the same levels up."""
    levels, (Ls, Cs, Fs, Lc) = factors
    chain = (levels, (Ls, Cs, Fs))
    state, gacc = cr_chain_fwd(chain, vs)
    cwg = _tsolve(Lc, vg - gacc)
    xg = _tsolve(Lc, cwg, transpose=True)
    x = cr_chain_bwd(chain, state, xg)
    return x, xg


def _cr_chain_empty(T, D, W, dt, pallas: bool = False):
    """Placeholder pytree matching ``cr_chain_factor``'s (levels, base)."""
    z = jnp.zeros
    levels = []
    t = T
    while t > 1:
        H = t // 2
        lev = (z((H, D, D), dt), z((H, D, D), dt),
               z((H, D, D), dt), z((H, D, W), dt))
        if pallas:  # 5-tuple: (Lo, Lo_inv, X1, X2, XE)
            lev = (z((H, D, D), dt),) + lev
        levels.append(lev)
        t -= H
    base = (z((1, D, D), dt), z((1, D, D), dt), z((1, W, D), dt))
    return (tuple(levels), base)


def _cr_empty(T, D, Da, dt, pallas: bool = False):
    levels, (Ls, Cs, Fs) = _cr_chain_empty(T, D, Da, dt, pallas)
    return (levels, (Ls, Cs, Fs, jnp.zeros((Da, Da), dt)))


@kkt_mod.factor.register
def _(data: StageQPData, ks, mixed: bool = False, pre=None):
    """Block Cholesky of the tridiagonal+arrow condensed matrix: a scan
    over stages for short horizons (the reference's sequential recursion,
    multistage_kkt.hpp:1253-1352), cyclic reduction for medium horizons
    (16 <= T <= 256, any parity), two-level chunked beyond that (see the
    scheme-selection note above _use_cr)."""
    if mixed:
        f32 = jnp.float32
        # assemble directly in f32 from the hoisted data32 blocks (see the
        # precompute registration)
        src = (pre["data32"] if isinstance(pre, dict) and "data32" in pre
               else None)
        if src is not None:
            ks_f = ks.replace(
                x_reg=ks.x_reg.astype(f32),
                z_reg_fact=ks.z_reg_fact.astype(f32),
                delta_reg=ks.delta_reg.astype(f32),
            )
            Kd, Ksub, Ka, Kc = _assemble_blocks(src, ks_f)
        else:
            Kd, Ksub, Ka, Kc = _assemble_blocks(data, ks)
            Kd, Ksub, Ka, Kc = (
                Kd.astype(f32), Ksub.astype(f32),
                Ka.astype(f32), Kc.astype(f32),
            )
    else:
        Kd, Ksub, Ka, Kc = _assemble_blocks(data, ks)
    if _use_cr(data.T):
        # the placeholder's level arity picks the representation
        # (empty_factor)
        pallas = len(ks.L[0][0]) == 5
        factors, ok = cr_factor(Kd, Ksub, Ka, Kc, pallas)
        return ks.replace(L=factors), ok
    C = _chunk_count(data.T)
    if C is not None:
        pallas = (
            isinstance(ks.L[0][0], tuple)  # CR interiors selected
            and len(ks.L[0][0][0]) == 5
        )
        factors, ok = _chunked_factor(Kd, Ksub, Ka, Kc, C, pallas)
        return ks.replace(L=factors), ok

    Ls, Cs, Fs, acc = chain_factor(Kd, Ksub, Ka)
    Lc = jnp.linalg.cholesky(Kc - acc)

    ok = jnp.logical_and(
        jnp.all(jnp.isfinite(Ls)), jnp.all(jnp.isfinite(Lc))
    )
    return ks.replace(L=(Ls, Cs, Fs, Lc)), ok


@kkt_mod.condensed_solve_x.register
def _(data: StageQPData, ks, v):
    """Forward/backward block-triangular sweeps
    (solve_llt_in_place, multistage_kkt.hpp:1709-1816); two-level chunked
    or cyclic-reduction for long horizons."""
    if _use_cr(data.T):
        Lo0 = ks.L[0][0][0]
        dt = Lo0.dtype
        vs, vg = _split_x(data, v.astype(dt))
        xs, xg = cr_solve(ks.L, vs.reshape(data.T, data.D), vg)
        return _join_x(xs, xg).astype(v.dtype)
    C = _chunk_count(data.T)
    if C is not None:
        dt = ks.L[-1].dtype  # cLc
        vs, vg = _split_x(data, v.astype(dt))
        xs, xg = _chunked_solve(
            ks.L, vs.reshape(data.T, data.D), vg, data.T, data.D, data.Da
        )
        return _join_x(xs, xg).astype(v.dtype)

    Ls, Cs, Fs, Lc = ks.L
    dt = Ls.dtype  # solve in factor precision, cast back at the end
    vs, vg = _split_x(data, v.astype(dt))

    ws, gacc = chain_fwd(Ls, Cs, Fs, vs)
    wg = _tsolve(Lc, vg - gacc)
    xg = _tsolve(Lc, wg, transpose=True)
    xs = chain_bwd(Ls, Cs, Fs, ws, xg)
    return _join_x(xs, xg).astype(v.dtype)


# ---------------------------------------------------------------------------
# structured Ruiz equilibration
# ---------------------------------------------------------------------------

def _stage_col_norms(data_blocks):
    """Column infinity norms of the stage-structured KKT matrix."""
    Pd, Psub, Pa, Pc, A1, A2, Ag, G1, G2, Gg, xb_s, xb_g = data_blocks

    def colmax(M):  # (T, r, d) -> (T, d)
        return jnp.max(jnp.abs(M), axis=-2, initial=0.0)

    def rowmax(M):  # (T, r, d) -> (T, r)
        return jnp.max(jnp.abs(M), axis=-1, initial=0.0)

    norm_x = colmax(Pd)
    norm_x = jnp.maximum(norm_x, colmax(Psub))  # P[i+1,i] columns -> stage i
    norm_x = jnp.maximum(norm_x, _shift_down(rowmax(Psub)))  # P[i,i+1] cols
    norm_x = jnp.maximum(norm_x, colmax(Pa))
    norm_x = jnp.maximum(norm_x, colmax(A1))
    norm_x = jnp.maximum(norm_x, _shift_down(colmax(A2)))
    norm_x = jnp.maximum(norm_x, colmax(G1))
    norm_x = jnp.maximum(norm_x, _shift_down(colmax(G2)))
    norm_x = jnp.maximum(norm_x, xb_s)

    norm_g = jnp.max(rowmax(Pa), axis=0, initial=0.0)  # P[g,i] rows -> g cols
    norm_g = jnp.maximum(norm_g, jnp.max(jnp.abs(Pc), axis=0, initial=0.0))
    norm_g = jnp.maximum(norm_g, jnp.max(colmax(Ag), axis=0, initial=0.0))
    norm_g = jnp.maximum(norm_g, jnp.max(colmax(Gg), axis=0, initial=0.0))
    norm_g = jnp.maximum(norm_g, xb_g)

    norm_y = jnp.maximum(rowmax(A1), jnp.maximum(rowmax(A2), rowmax(Ag)))
    norm_z = jnp.maximum(rowmax(G1), jnp.maximum(rowmax(G2), rowmax(Gg)))
    return norm_x, norm_g, norm_y, norm_z


def _scale_blocks(blocks, dx, dg, dy, dz, db_s, db_g):
    Pd, Psub, Pa, Pc, A1, A2, Ag, G1, G2, Gg, xb_s, xb_g = blocks
    dx_next = _shift_up(dx)
    Pd = Pd * dx[:, :, None] * dx[:, None, :]
    Psub = Psub * dx_next[:, :, None] * dx[:, None, :]
    Pa = Pa * dg[None, :, None] * dx[:, None, :]
    Pc = Pc * dg[:, None] * dg[None, :]
    A1 = A1 * dy[:, :, None] * dx[:, None, :]
    A2 = A2 * dy[:, :, None] * dx_next[:, None, :]
    Ag = Ag * dy[:, :, None] * dg[None, None, :]
    G1 = G1 * dz[:, :, None] * dx[:, None, :]
    G2 = G2 * dz[:, :, None] * dx_next[:, None, :]
    Gg = Gg * dz[:, :, None] * dg[None, None, :]
    xb_s = xb_s * db_s * dx
    xb_g = xb_g * db_g * dg
    return (Pd, Psub, Pa, Pc, A1, A2, Ag, G1, G2, Gg, xb_s, xb_g)


@ruiz_mod.equilibrate.register
def _equilibrate_stage(
    data: StageQPData,
    max_iter: int = 10,
    scale_cost: bool = False,
    epsilon: float = 1e-3,
):
    """Ruiz equilibration over the stage-block representation; same
    algorithm as the dense path (preconditioner.hpp:64-222) with blockwise
    norm reductions."""
    from .ruiz import _limit_scaling

    dt = data.c.dtype
    T, D, Da = data.T, data.D, data.Da
    n = data.n

    xb_s, xb_g = _split_x(data, data.x_b_scaling)
    blocks0 = (
        data.Pd, data.Psub, data.Pa, data.Pc,
        data.A1, data.A2, data.Ag,
        data.G1, data.G2, data.Gg,
        xb_s, xb_g,
    )
    cs, cg = _split_x(data, data.c)

    def one_pass(carry):
        blocks, cs, cg, cost, d, i, _ = carry
        norm_x, norm_g, norm_y, norm_z = _stage_col_norms(blocks)

        dx = 1.0 / jnp.sqrt(_limit_scaling(norm_x))
        dg = 1.0 / jnp.sqrt(_limit_scaling(norm_g))
        dy = 1.0 / jnp.sqrt(_limit_scaling(norm_y))
        dz = 1.0 / jnp.sqrt(_limit_scaling(norm_z))
        db_s = 1.0 / jnp.sqrt(_limit_scaling(blocks[10]))
        db_g = 1.0 / jnp.sqrt(_limit_scaling(blocks[11]))

        blocks = _scale_blocks(blocks, dx, dg, dy, dz, db_s, db_g)
        cs_n, cg_n = cs * dx, cg * dg

        d = (d[0] * dx, d[1] * dg, d[2] * dy, d[3] * dz, d[4] * db_s, d[5] * db_g)

        if scale_cost:
            Pd, Psub, Pa, Pc = blocks[0], blocks[1], blocks[2], blocks[3]
            pn = jnp.max(jnp.abs(Pd), axis=-2, initial=0.0)
            pn = jnp.maximum(pn, jnp.max(jnp.abs(Psub), axis=-2, initial=0.0))
            pn = jnp.maximum(
                pn, _shift_down(jnp.max(jnp.abs(Psub), axis=-1, initial=0.0))
            )
            pn = jnp.maximum(pn, jnp.max(jnp.abs(Pa), axis=-2, initial=0.0))
            gsum = jnp.sum(pn) + jnp.sum(
                jnp.max(jnp.abs(Pc), axis=0, initial=0.0)
            )
            gamma = gsum / jnp.asarray(n, dt)
            gamma = _limit_scaling(gamma)
            cmax = jnp.maximum(
                jnp.max(jnp.abs(cs_n), initial=0.0), jnp.max(jnp.abs(cg_n), initial=0.0)
            )
            gamma = 1.0 / _limit_scaling(jnp.maximum(gamma, cmax))
            blocks = (
                blocks[0] * gamma, blocks[1] * gamma, blocks[2] * gamma,
                blocks[3] * gamma,
            ) + blocks[4:]
            cs_n, cg_n = cs_n * gamma, cg_n * gamma
            cost = cost * gamma

        measure = jnp.max(
            jnp.stack([
                jnp.max(jnp.abs(1.0 - dx), initial=0.0),
                jnp.max(jnp.abs(1.0 - dg), initial=0.0),
                jnp.max(jnp.abs(1.0 - dy), initial=0.0),
                jnp.max(jnp.abs(1.0 - dz), initial=0.0),
                jnp.max(jnp.abs(1.0 - db_s), initial=0.0),
                jnp.max(jnp.abs(1.0 - db_g), initial=0.0),
            ])
        )
        return (blocks, cs_n, cg_n, cost, d, i + 1, measure)

    d0 = (
        jnp.ones((T, D), dt), jnp.ones(Da, dt),
        jnp.ones((T, data.ra), dt), jnp.ones((T, data.rg), dt),
        jnp.ones((T, D), dt), jnp.ones(Da, dt),
    )
    carry = (
        blocks0, cs, cg, jnp.asarray(1.0, dt), d0,
        jnp.asarray(0, jnp.int32), jnp.asarray(jnp.inf, dt),
    )

    def cond(c):
        return jnp.logical_and(c[-2] < max_iter, c[-1] > epsilon)

    blocks, cs, cg, cost, d, _, _ = lax.while_loop(cond, one_pass, carry)
    dx, dg, dy, dz, db_s, db_g = d

    d_x = _join_x(dx, dg)
    d_y = dy.reshape(-1)
    d_z = dz.reshape(-1)
    d_b = _join_x(db_s, db_g)

    scaled = data.replace(
        Pd=blocks[0], Psub=blocks[1], Pa=blocks[2], Pc=blocks[3],
        A1=blocks[4], A2=blocks[5], Ag=blocks[6],
        G1=blocks[7], G2=blocks[8], Gg=blocks[9],
        x_b_scaling=_join_x(blocks[10], blocks[11]),
        c=_join_x(cs, cg),  # already scaled inside the loop
        b=data.b * d_y,
        h_l=data.h_l * d_z,
        h_u=data.h_u * d_z,
        x_l=data.x_l * d_b,
        x_u=data.x_u * d_b,
    )
    return scaled, Scaling(c=cost, d_x=d_x, d_y=d_y, d_z=d_z, d_b=d_b)


@ruiz_mod.apply_scaling.register
def _apply_scaling_stage(data: StageQPData, s: Scaling):
    T, D, Da = data.T, data.D, data.Da
    dx = s.d_x[: T * D].reshape(T, D)
    dg = s.d_x[T * D:]
    dy = s.d_y.reshape(T, data.ra)
    dz = s.d_z.reshape(T, data.rg)
    db_s = s.d_b[: T * D].reshape(T, D)
    db_g = s.d_b[T * D:]
    xb_s, xb_g = _split_x(data, data.x_b_scaling)
    blocks = _scale_blocks(
        (data.Pd, data.Psub, data.Pa, data.Pc, data.A1, data.A2, data.Ag,
         data.G1, data.G2, data.Gg, xb_s, xb_g),
        dx, dg, dy, dz, db_s, db_g,
    )
    return data.replace(
        Pd=s.c * blocks[0], Psub=s.c * blocks[1], Pa=s.c * blocks[2],
        Pc=s.c * blocks[3],
        A1=blocks[4], A2=blocks[5], Ag=blocks[6],
        G1=blocks[7], G2=blocks[8], Gg=blocks[9],
        x_b_scaling=_join_x(blocks[10], blocks[11]),
        c=s.c * data.c * s.d_x,
        b=data.b * s.d_y,
        h_l=data.h_l * s.d_z,
        h_u=data.h_u * s.d_z,
        x_l=data.x_l * s.d_b,
        x_u=data.x_u * s.d_b,
    )


# ---------------------------------------------------------------------------
# builders / converters
# ---------------------------------------------------------------------------

def from_stage_blocks(
    Pd, Psub, Pa, Pc, c,
    A1=None, A2=None, Ag=None, b=None,
    G1=None, G2=None, Gg=None, h_l=None, h_u=None,
    x_l=None, x_u=None, dtype=jnp.float64,
) -> StageQPData:
    """Build a StageQPData from numpy per-stage blocks (host-side analog of
    dense::Data construction + disable_inf_constraints)."""
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    Pd = np.asarray(Pd, np_dtype)
    T, D, _ = Pd.shape
    Pc = np.asarray(Pc, np_dtype) if Pc is not None else np.zeros((0, 0), np_dtype)
    Da = Pc.shape[0]
    Psub = (
        np.array(Psub, np_dtype, copy=True)
        if Psub is not None
        else np.zeros((T, D, D), np_dtype)
    )
    Psub[T - 1] = 0.0
    Pa = (
        np.asarray(Pa, np_dtype)
        if Pa is not None
        else np.zeros((T, Da, D), np_dtype)
    )
    n = T * D + Da

    def blocked(M1, M2, Mg, r):
        M1 = np.array(M1, np_dtype, copy=True) if M1 is not None else np.zeros((T, r, D), np_dtype)
        M2 = np.array(M2, np_dtype, copy=True) if M2 is not None else np.zeros((T, r, D), np_dtype)
        Mg = np.array(Mg, np_dtype, copy=True) if Mg is not None else np.zeros((T, r, Da), np_dtype)
        M2[T - 1] = 0.0
        return M1, M2, Mg

    ra = 0 if A1 is None else np.asarray(A1).shape[1]
    rg = 0 if G1 is None else np.asarray(G1).shape[1]
    A1, A2, Ag = blocked(A1, A2, Ag, ra)
    G1, G2, Gg = blocked(G1, G2, Gg, rg)

    p, m = T * ra, T * rg
    b = np.zeros(p, np_dtype) if b is None else np.asarray(b, np_dtype).reshape(p)
    h_l = np.full(m, -np.inf) if h_l is None else np.asarray(h_l, np_dtype).reshape(m)
    h_u = np.full(m, np.inf) if h_u is None else np.asarray(h_u, np_dtype).reshape(m)
    x_l = np.full(n, -np.inf) if x_l is None else np.asarray(x_l, np_dtype).reshape(n)
    x_u = np.full(n, np.inf) if x_u is None else np.asarray(x_u, np_dtype).reshape(n)

    hl_mask = h_l > -PIQP_INF
    hu_mask = h_u < PIQP_INF
    dead = ~hl_mask & ~hu_mask
    if dead.any():
        # disable_inf_constraints analog: zero the row, fake bounds [-1, 1]
        dead_b = dead.reshape(T, rg)
        G1[dead_b] = 0.0
        G2[dead_b] = 0.0
        Gg[dead_b] = 0.0
        h_l = np.where(dead, -1.0, h_l)
        h_u = np.where(dead, 1.0, h_u)
        hl_mask = h_l > -PIQP_INF
        hu_mask = h_u < PIQP_INF
    xl_mask = x_l > -PIQP_INF
    xu_mask = x_u < PIQP_INF

    return StageQPData(
        c=jnp.asarray(np.asarray(c, np_dtype).reshape(n)),
        b=jnp.asarray(b),
        h_l=jnp.asarray(np.where(hl_mask, h_l, 0.0)),
        h_u=jnp.asarray(np.where(hu_mask, h_u, 0.0)),
        x_l=jnp.asarray(np.where(xl_mask, x_l, 0.0)),
        x_u=jnp.asarray(np.where(xu_mask, x_u, 0.0)),
        x_b_scaling=jnp.ones(n, dtype),
        hl_mask=jnp.asarray(hl_mask),
        hu_mask=jnp.asarray(hu_mask),
        xl_mask=jnp.asarray(xl_mask),
        xu_mask=jnp.asarray(xu_mask),
        Pd=jnp.asarray(Pd), Psub=jnp.asarray(Psub), Pa=jnp.asarray(Pa),
        Pc=jnp.asarray(Pc),
        A1=jnp.asarray(A1), A2=jnp.asarray(A2), Ag=jnp.asarray(Ag),
        G1=jnp.asarray(G1), G2=jnp.asarray(G2), Gg=jnp.asarray(Gg),
    )


def to_dense(data: StageQPData) -> QPData:
    """Materialize the equivalent dense QPData (test oracle)."""
    T, D, Da, ra, rg = data.T, data.D, data.Da, data.ra, data.rg
    n, p, m = data.n, data.p, data.m
    P = np.zeros((n, n))
    for i in range(T):
        s = slice(i * D, (i + 1) * D)
        P[s, s] = np.asarray(data.Pd[i])
        if i + 1 < T:
            s2 = slice((i + 1) * D, (i + 2) * D)
            P[s2, s] = np.asarray(data.Psub[i])
            P[s, s2] = np.asarray(data.Psub[i]).T
        P[T * D:, s] = np.asarray(data.Pa[i])
        P[s, T * D:] = np.asarray(data.Pa[i]).T
    P[T * D:, T * D:] = np.asarray(data.Pc)

    def expand(M1, M2, Mg, r):
        M = np.zeros((T * r, n))
        for j in range(T):
            rs = slice(j * r, (j + 1) * r)
            M[rs, j * D:(j + 1) * D] = np.asarray(M1[j])
            if j + 1 < T:
                M[rs, (j + 1) * D:(j + 2) * D] = np.asarray(M2[j])
            M[rs, T * D:] = np.asarray(Mg[j])
        return M

    A = expand(data.A1, data.A2, data.Ag, ra) if ra else np.zeros((0, n))
    G = expand(data.G1, data.G2, data.Gg, rg) if rg else np.zeros((0, n))

    return QPData(
        P=jnp.asarray(P), c=data.c, A=jnp.asarray(A), b=data.b,
        G=jnp.asarray(G), h_l=data.h_l, h_u=data.h_u,
        x_l=data.x_l, x_u=data.x_u, x_b_scaling=data.x_b_scaling,
        hl_mask=data.hl_mask, hu_mask=data.hu_mask,
        xl_mask=data.xl_mask, xu_mask=data.xu_mask,
    )


@dataclasses.dataclass
class StageLayout:
    """Mapping between the user's original variable/row order and the padded
    stage layout (the analog of BlockMat's row permutation,
    blocksparse/block_mat.hpp:23-44, plus variable blocking)."""

    var_map: np.ndarray  # orig var -> flat stage-layout position
    a_row_map: np.ndarray  # orig A row -> flat position
    g_row_map: np.ndarray  # orig G row -> flat position
    n: int
    p: int
    m: int
    # padding waste: padded chain width T*D over the real (non-arrow)
    # variable count — the diagnostic the reference's print_info exposes
    # via its block-size report (multistage_kkt.hpp:385-393)
    waste: float = 1.0


def _reblock_uniform(S, is_arrow, starts, sizes):
    """Equalize detected block sizes for uniform-width batching.

    The reference optimizes per-block sizes with a flop model
    (multistage_kkt.hpp:397-510) because BLASFEO handles heterogeneous
    blocks natively; device batching (vmapped einsums, lax.scan, cyclic
    reduction) wants ONE width D, so the same arrow-vs-block tradeoff is
    re-cast as choosing a uniform target width D_t:

      - blocks larger than D_t spill their excess variables into the
        global arrow (always valid: moving a variable to the arrow only
        removes tridiagonal couplings, never creates distant ones);
      - runs of adjacent blocks with combined size <= D_t merge (always
        valid: coupling between merged neighbors becomes intra-block).

    D_t is picked by minimizing the factorization flop model over the
    candidate widths: T'(c_chain D^3 + 2 D^2 Da' + D Da'^2) + Da'^3/3 —
    the same potrf/trsm/syrk/gemm cost terms as the reference's
    extract_arrow_structure.  Spilled variables are chosen by descending
    pattern degree (hub variables cost the most tridiagonal couplings).
    """
    n = S.shape[0]
    sizes = np.asarray(sizes, np.int64)
    Da0 = int(is_arrow.sum())
    if len(sizes) == 0:
        return is_arrow, starts, sizes

    def simulate(Dt):
        spilled = np.maximum(sizes - Dt, 0)
        kept = sizes - spilled
        # greedy left-to-right merge of adjacent blocks into width <= Dt
        Tm = 0
        acc = 0
        for s in kept:
            if acc and acc + s <= Dt:
                acc += s
            else:
                Tm += 1
                acc = s
        Da = Da0 + int(spilled.sum())
        cost = Tm * ((7.0 / 3.0) * Dt**3 + 2.0 * Dt**2 * Da + Dt * Da**2)
        cost += Da**3 / 3.0
        return cost, int(spilled.sum()), Tm, Da

    cands = sorted(set(int(s) for s in sizes if s > 0))
    # a pure-merge width above the max is never better than max itself
    best_Dt, best_cost = int(sizes.max()), simulate(int(sizes.max()))[0]
    for Dt in cands:
        c, _, Tm, _ = simulate(Dt)
        if Tm >= 3 and c < best_cost:
            best_cost, best_Dt = c, Dt
    Dt = best_Dt

    # spill: highest-degree variables first (hub variables carry the most
    # couplings; mirrors the greedy cover of the initial detection)
    degree = np.diff(S.indptr)
    orig_idx = np.nonzero(~is_arrow)[0]
    new_arrow = is_arrow.copy()
    kept_sizes = []
    for t in range(len(starts)):
        blk = orig_idx[starts[t]:starts[t] + sizes[t]]
        if sizes[t] > Dt:
            order = np.argsort(-degree[blk], kind="stable")
            new_arrow[blk[order[: sizes[t] - Dt]]] = True
            kept_sizes.append(Dt)
        else:
            kept_sizes.append(int(sizes[t]))

    # merge adjacent runs
    new_starts, new_sizes = [], []
    pos = 0
    acc = 0
    for s in kept_sizes:
        if acc and acc + s <= Dt:
            acc += s
        else:
            if acc:
                new_starts.append(pos)
                new_sizes.append(acc)
                pos += acc
            acc = s
    if acc:
        new_starts.append(pos)
        new_sizes.append(acc)

    return (
        new_arrow,
        np.asarray(new_starts, np.int64),
        np.asarray(new_sizes, np.int64),
    )


def from_sparse(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    band_cap: int = 0, min_blocks: int = 3, dtype=jnp.float64,
):
    """Detect multistage structure in a general sparse QP and convert to
    StageQPData (analog of extract_arrow_structure + utri_to_kkt +
    transpose_to_block_mat, multistage_kkt.hpp:420-818).

    Returns (StageQPData, StageLayout) or raises ValueError when the
    problem has no usable block structure (callers fall back to the dense
    condensed backend).
    """
    import scipy.sparse as sp

    from . import _native

    # PIQP semantics: only the upper triangle of P is used (solver.hpp:182);
    # canonicalize to the full symmetric matrix for scattering.
    P = sp.csc_matrix(P)
    P = (sp.triu(P) + sp.triu(P, 1).T).tocsc()
    n = P.shape[0]
    A = sp.csc_matrix(A) if A is not None else sp.csc_matrix((0, n))
    G = sp.csc_matrix(G) if G is not None else sp.csc_matrix((0, n))
    p, m = A.shape[0], G.shape[0]

    # symmetric coupling pattern of P + A'A + G'G (multistage_kkt.hpp:425-431)
    S = (abs(P) + abs(P).T).astype(bool)
    if p:
        aT = abs(A).T.astype(bool).tocsc()
        S = (S + (aT @ aT.T).astype(bool)).astype(bool)
    if m:
        gT = abs(G).T.astype(bool).tocsc()
        S = (S + (gT @ gT.T).astype(bool)).astype(bool)
    S = sp.csc_matrix(S + sp.eye(n, dtype=bool, format="csc"))

    is_arrow, starts, sizes = _native.detect_structure(
        S.indptr, S.indices, n, band_cap
    )
    T = len(starts)
    if T < min_blocks:
        raise ValueError(f"no multistage structure (only {T} blocks)")
    is_arrow, starts, sizes = _reblock_uniform(S, is_arrow, starts, sizes)
    T = len(starts)
    if T < min_blocks:
        raise ValueError(f"no multistage structure (only {T} blocks)")
    Da = int(is_arrow.sum())
    D = int(sizes.max())

    # variable mapping: stage/offset per original variable
    var_stage = np.full(n, -1, np.int64)
    var_off = np.zeros(n, np.int64)
    keep = ~is_arrow
    compact = np.cumsum(keep) - 1  # compacted index of non-arrow vars
    blk_of = np.zeros(int(keep.sum()), np.int64)
    for t, (s0, sz) in enumerate(zip(starts, sizes)):
        blk_of[s0:s0 + sz] = t
    var_stage[keep] = blk_of[compact[keep]]
    var_off[keep] = compact[keep] - starts[blk_of[compact[keep]]]
    var_off[is_arrow] = np.cumsum(is_arrow)[is_arrow] - 1

    var_map = np.where(
        keep, var_stage * D + var_off, T * D + var_off
    ).astype(np.int64)

    used = np.zeros((T, D), bool)
    for t, (s0, sz) in enumerate(zip(starts, sizes)):
        used[t, :sz] = True

    # bucket constraint rows (rows may touch stages {j} or {j, j+1} + arrow)
    def bucket_rows(M):
        Mr = M.tocsr()
        rows = Mr.shape[0]
        bucket = np.zeros(rows, np.int64)
        for r in range(rows):
            cols = Mr.indices[Mr.indptr[r]:Mr.indptr[r + 1]]
            stg = var_stage[cols]
            stg = stg[stg >= 0]
            if stg.size == 0:
                bucket[r] = T - 1
                continue
            lo, hi = int(stg.min()), int(stg.max())
            if hi - lo > 1:
                raise ValueError("constraint row spans non-adjacent stages")
            bucket[r] = lo
        return Mr, bucket

    def layout_rows(bucket, rows):
        counts = np.bincount(bucket, minlength=T)
        rmax = int(counts.max()) if rows else 0
        slot = np.zeros(rows, np.int64)
        seen = np.zeros(T, np.int64)
        for r in range(rows):
            slot[r] = seen[bucket[r]]
            seen[bucket[r]] += 1
        row_map = bucket * rmax + slot
        return rmax, slot, row_map

    Ar, a_bucket = bucket_rows(A)
    ra, a_slot, a_row_map = layout_rows(a_bucket, p)
    Gr, g_bucket = bucket_rows(G)
    rg, g_slot, g_row_map = layout_rows(g_bucket, m)

    # Pad the horizon to a chunkable length — but only when the chunked
    # scheme is actually selected (T > _CR_MAX_T): cyclic reduction handles
    # any horizon length, so padding there would just add wasted stages and
    # an unnecessary arrow-coordinate shift.  The two-level scheme needs a
    # divisor C ~ sqrt(T); prime horizons would otherwise fall back to the
    # latency-bound sequential scan.  Padded stages are decoupled identity
    # sub-problems (see parallel.pad_stages); arrow coordinates shift by
    # (T_pad - T) * D.
    T_pad = T if _use_cr(T) else _next_chunkable(T)

    cache = _ScatterCache(
        n=n, p=p, m=m, T=T, D=D, Da=Da, T_pad=T_pad,
        var_stage=var_stage, var_off=var_off, var_map=var_map, used=used,
        a_bucket=a_bucket, a_slot=a_slot, a_row_map=a_row_map, ra=ra,
        g_bucket=g_bucket, g_slot=g_slot, g_row_map=g_row_map, rg=rg,
    )
    return _assemble(P, c, A, b, G, h_l, h_u, x_l, x_u, cache, dtype)


@dataclasses.dataclass
class _ScatterCache:
    """Everything the value-scatter needs, cached at setup so that
    update() re-scatters values without re-running structure detection
    (the analog of the reference's nnz-map based update_data,
    multistage_kkt.hpp:140-178 / kkt_full.hpp:212-251)."""

    n: int
    p: int
    m: int
    T: int
    D: int
    Da: int
    T_pad: int
    var_stage: np.ndarray
    var_off: np.ndarray
    var_map: np.ndarray  # UNSHIFTED (pre horizon-pad)
    used: np.ndarray  # (T, D) bool: real (non-pad) diagonal slots
    a_bucket: np.ndarray
    a_slot: np.ndarray
    a_row_map: np.ndarray
    ra: int
    g_bucket: np.ndarray
    g_slot: np.ndarray
    g_row_map: np.ndarray
    rg: int


def _assemble(P, c, A, b, G, h_l, h_u, x_l, x_u, cache, dtype):
    """Scatter values into stage blocks per the cached maps and build the
    StageQPData + StageLayout.  P/A/G may be None on the update path
    (vectors-only); scipy matrices otherwise."""
    import scipy.sparse as sp

    from . import _native

    T, D, Da = cache.T, cache.D, cache.Da
    n, p, m = cache.n, cache.p, cache.m
    var_stage, var_off, var_map = cache.var_stage, cache.var_off, cache.var_map

    P = sp.csc_matrix(P)
    Pd, Psub, Pa, Pc = _native.scatter_P(
        P.indptr, P.indices, P.data, var_stage, var_off, T, D, Da
    )
    idx_t, idx_d = np.nonzero(~cache.used)
    Pd[idx_t, idx_d, idx_d] = 1.0

    Ar = (sp.csc_matrix(A) if A is not None else sp.csc_matrix((0, n))).tocsr()
    Gr = (sp.csc_matrix(G) if G is not None else sp.csc_matrix((0, n))).tocsr()
    A1, A2, Ag = _native.scatter_constr(
        Ar.indptr, Ar.indices, Ar.data, var_stage, var_off,
        cache.a_bucket, cache.a_slot, T, cache.ra, D, Da,
    ) if p else (np.zeros((T, 0, D)), np.zeros((T, 0, D)), np.zeros((T, 0, Da)))
    G1, G2, Gg = _native.scatter_constr(
        Gr.indptr, Gr.indices, Gr.data, var_stage, var_off,
        cache.g_bucket, cache.g_slot, T, cache.rg, D, Da,
    ) if m else (np.zeros((T, 0, D)), np.zeros((T, 0, D)), np.zeros((T, 0, Da)))

    # flat vectors in stage layout
    n_pad, p_pad, m_pad = T * D + Da, T * cache.ra, T * cache.rg
    inf = np.inf
    c_f = np.zeros(n_pad)
    c_f[var_map] = np.asarray(c, np.float64).ravel()
    b_f = np.zeros(p_pad)
    if p:
        b_f[cache.a_row_map] = np.asarray(b, np.float64).ravel()
    # padded inequality rows are all-zero: give them the benign [-1, 1]
    # bounds disable_inf_constraints would produce
    hl_f = np.full(m_pad, -1.0)
    hu_f = np.full(m_pad, 1.0)
    if m:
        hl_f[cache.g_row_map] = (
            np.asarray(h_l, np.float64).ravel() if h_l is not None else -inf
        )
        hu_f[cache.g_row_map] = (
            np.asarray(h_u, np.float64).ravel() if h_u is not None else inf
        )
    xl_f = np.full(n_pad, -inf)
    xu_f = np.full(n_pad, inf)
    if x_l is not None:
        xl_f[var_map] = np.asarray(x_l, np.float64).ravel()
    if x_u is not None:
        xu_f[var_map] = np.asarray(x_u, np.float64).ravel()

    sdata = from_stage_blocks(
        Pd, Psub, Pa, Pc, c_f,
        A1=A1, A2=A2, Ag=Ag, b=b_f,
        G1=G1, G2=G2, Gg=Gg, h_l=hl_f, h_u=hu_f,
        x_l=xl_f, x_u=xu_f, dtype=dtype,
    )

    if cache.T_pad != T:
        from .parallel.horizon import pad_stages

        sdata = pad_stages(sdata, cache.T_pad)
        shift = (cache.T_pad - T) * D
        var_map = np.where(var_map >= T * D, var_map + shift, var_map)

    layout = StageLayout(
        var_map=var_map, a_row_map=cache.a_row_map,
        g_row_map=cache.g_row_map,
        n=n, p=p, m=m,
        waste=float(sdata.T * sdata.D) / max(1, n - Da),
    )
    layout._cache = cache
    # dead-row pattern (both bounds infinite) over the unpadded stage rows;
    # update_vectors compares against it to decide whether the resident G
    # tensors need re-zeroing (full update path) or can stay on device
    layout._dead = ~(hl_f > -PIQP_INF) & ~(hu_f < PIQP_INF)
    return sdata, layout


def update_values(
    layout: StageLayout,
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    dtype=jnp.float64,
):
    """Value-only multistage update: re-scatter new values through the
    cached maps of a prior from_sparse call, skipping structure detection
    and reblocking entirely (solver.hpp:318-359 semantics: nnz patterns
    must stay within the detected stage structure; a pattern that breaks
    adjacency raises ValueError exactly like setup would)."""
    cache = getattr(layout, "_cache", None)
    if cache is None:
        raise ValueError("layout has no scatter cache (not from from_sparse)")
    import scipy.sparse as sp

    P = sp.csc_matrix(P)
    P = (sp.triu(P) + sp.triu(P, 1).T).tocsc()
    return _assemble(P, c, A, b, G, h_l, h_u, x_l, x_u, cache, dtype)


def update_vectors(
    layout: StageLayout, sdata: StageQPData,
    c, b=None, h_l=None, h_u=None, x_l=None, x_u=None,
):
    """Vector-only multistage update: rebuild just the flat vector leaves
    (c, b, bounds, masks) of an existing StageQPData through the cached
    maps, leaving every (T, D, D)/(T, r, *) stage tensor as the SAME device
    buffer — the multistage analog of the dense selective-transfer update
    (solver.hpp:218-359's vector path; the reference's nnz-map update only
    touches values that changed).

    Returns the new StageQPData, or ``None`` when the inequality dead-row
    pattern changed (a bound flipped to/from both-infinite): that requires
    re-zeroing rows of the resident G tensors, i.e. the full
    ``update_values`` path.
    """
    cache = getattr(layout, "_cache", None)
    old_dead = getattr(layout, "_dead", None)
    if cache is None or old_dead is None:
        raise ValueError("layout has no scatter cache (not from from_sparse)")

    T, D, Da = cache.T, cache.D, cache.Da
    ra, rg = cache.ra, cache.rg
    Tp = cache.T_pad
    np_dtype = np.dtype(sdata.c.dtype.name)
    inf = np.inf

    n_pad, p_pad, m_pad = T * D + Da, T * ra, T * rg
    c_f = np.zeros(n_pad, np_dtype)
    c_f[cache.var_map] = np.asarray(c, np.float64).ravel()
    b_f = np.zeros(p_pad, np_dtype)
    if cache.p:
        b_f[cache.a_row_map] = np.asarray(b, np.float64).ravel()
    hl_f = np.full(m_pad, -1.0)
    hu_f = np.full(m_pad, 1.0)
    if cache.m:
        hl_f[cache.g_row_map] = (
            np.asarray(h_l, np.float64).ravel() if h_l is not None else -inf
        )
        hu_f[cache.g_row_map] = (
            np.asarray(h_u, np.float64).ravel() if h_u is not None else inf
        )
    new_dead = ~(hl_f > -PIQP_INF) & ~(hu_f < PIQP_INF)
    if (new_dead != old_dead).any():
        return None  # caller must take the full update_values path
    # dead rows keep the benign [-1, 1] bounds (their G rows are already 0)
    hl_f = np.where(new_dead, -1.0, hl_f)
    hu_f = np.where(new_dead, 1.0, hu_f)

    xl_f = np.full(n_pad, -inf)
    xu_f = np.full(n_pad, inf)
    if x_l is not None:
        xl_f[cache.var_map] = np.asarray(x_l, np.float64).ravel()
    if x_u is not None:
        xu_f[cache.var_map] = np.asarray(x_u, np.float64).ravel()

    if Tp != T:  # horizon padding (mirrors parallel.horizon.pad_stages)
        def pad_x(v, fill):
            stage = np.concatenate(
                [v[: T * D].reshape(T, D), np.full((Tp - T, D), fill)], axis=0
            )
            return np.concatenate([stage.reshape(-1), v[T * D:]])

        def pad_rows(v, r, fill):
            if r == 0:
                return v
            return np.concatenate(
                [v.reshape(T, r), np.full((Tp - T, r), fill)], axis=0
            ).reshape(-1)

        c_f, xl_f, xu_f = pad_x(c_f, 0.0), pad_x(xl_f, -inf), pad_x(xu_f, inf)
        b_f = pad_rows(b_f, ra, 0.0)
        hl_f = pad_rows(hl_f, rg, -1.0)
        hu_f = pad_rows(hu_f, rg, 1.0)

    hl_mask = hl_f > -PIQP_INF
    hu_mask = hu_f < PIQP_INF
    xl_mask = xl_f > -PIQP_INF
    xu_mask = xu_f < PIQP_INF
    return sdata.replace(
        c=jnp.asarray(c_f, np_dtype),
        b=jnp.asarray(b_f, np_dtype),
        h_l=jnp.asarray(np.where(hl_mask, hl_f, 0.0), np_dtype),
        h_u=jnp.asarray(np.where(hu_mask, hu_f, 0.0), np_dtype),
        x_l=jnp.asarray(np.where(xl_mask, xl_f, 0.0), np_dtype),
        x_u=jnp.asarray(np.where(xu_mask, xu_f, 0.0), np_dtype),
        hl_mask=jnp.asarray(hl_mask),
        hu_mask=jnp.asarray(hu_mask),
        xl_mask=jnp.asarray(xl_mask),
        xu_mask=jnp.asarray(xu_mask),
    )


def _next_chunkable(T: int) -> int:
    """Smallest T' >= T whose chunk split exists (or T if already fine /
    too small to benefit)."""
    if T < _CHUNK_MIN_T:
        return T
    Tp = T
    while _chunk_count(Tp) is None:
        Tp += 1
    return Tp


def random_multistage_qp(
    T: int, D: int, Da: int = 0, ra: int = 0, rg: int = 0, seed: int = 42
) -> StageQPData:
    """Random strongly convex multistage QP (block-diagonally dominant P,
    equalities consistent with a planted trajectory, inequalities around it —
    the multistage analog of random_utils.hpp:131)."""
    rng = np.random.default_rng(seed)
    n = T * D + Da

    Pd = rng.uniform(-1, 1, (T, D, D))
    Pd = 0.5 * (Pd + Pd.transpose(0, 2, 1))
    Psub = rng.uniform(-0.3, 0.3, (T, D, D))
    Psub[T - 1] = 0.0
    Pa = rng.uniform(-0.3, 0.3, (T, Da, D))
    Pc = rng.uniform(-1, 1, (Da, Da))
    Pc = 0.5 * (Pc + Pc.T)
    # block diagonal dominance => positive definite
    ridge = 2.0 * (D + Da) + 1.0
    Pd += ridge * np.eye(D)[None]
    Pc += ridge * np.eye(Da) if Da else 0.0

    c = rng.uniform(-1, 1, n)
    x_sol = rng.uniform(-1, 1, n)
    xs = x_sol[: T * D].reshape(T, D)
    xg = x_sol[T * D:]
    xs_next = np.concatenate([xs[1:], np.zeros((1, D))], axis=0)

    kw = {}
    if ra:
        A1 = rng.uniform(-1, 1, (T, ra, D))
        A2 = rng.uniform(-1, 1, (T, ra, D))
        A2[T - 1] = 0.0
        Ag = rng.uniform(-1, 1, (T, ra, Da))
        b = (
            np.einsum("trd,td->tr", A1, xs)
            + np.einsum("trd,td->tr", A2, xs_next)
            + np.einsum("tra,a->tr", Ag, xg)
        ).reshape(-1)
        kw.update(A1=A1, A2=A2, Ag=Ag, b=b)
    if rg:
        G1 = rng.uniform(-1, 1, (T, rg, D))
        G2 = rng.uniform(-1, 1, (T, rg, D))
        G2[T - 1] = 0.0
        Gg = rng.uniform(-1, 1, (T, rg, Da))
        Gx = (
            np.einsum("trd,td->tr", G1, xs)
            + np.einsum("trd,td->tr", G2, xs_next)
            + np.einsum("tra,a->tr", Gg, xg)
        ).reshape(-1)
        m = T * rg
        h_l = Gx - rng.uniform(0, 1, m)
        h_u = Gx + rng.uniform(0, 1, m)
        r = rng.uniform(0, 1, m)
        h_l = np.where(r < 0.3, -np.inf, h_l)
        h_u = np.where((r >= 0.3) & (r < 0.6), np.inf, h_u)
        kw.update(G1=G1, G2=G2, Gg=Gg, h_l=h_l, h_u=h_u)

    return from_stage_blocks(Pd, Psub, Pa, Pc, c, **kw)
