"""Horizon-sharded multistage backend: parallel block-tridiagonal + arrow
Cholesky across a device mesh.

The reference's multistage factorization is an inherently *sequential*
recursion over stages (factor_kkt, /root/reference/include/piqp/sparse/
multistage_kkt.hpp:1253-1352; its OpenMP parallelism covers only the
per-stage assembly, not the recursion itself).  On a device mesh that serial
chain would leave every device but one idle, so the factorization is
re-designed (not ported) as a **partitioned Schur-complement method**
(the block-tridiagonal analog of SPIKE / domain decomposition):

 1. The T stages are split into ndev contiguous chunks of Q stages; the
    last stage of each chunk is a *separator*.  Removing the separators
    decouples the chunks' interiors.
 2. Each device factors its interior chain (Q-1 stages) with the standard
    sequential sweep (``multistage.chain_factor``) — all devices in
    parallel — using an *extended arrow* of width W = 2D + Da that couples
    the interior to [previous separator | own separator | global arrow].
    The sweep's F-blocks simultaneously produce the chunk's Schur
    contribution S_k = sum_i F_i F_i' onto those coupling variables.
 3. The Schur complement onto the separators + arrow is itself a
    block-tridiagonal + arrow system of ndev stages — tiny.  It is
    all-gathered and factored redundantly on every device
    (cheaper than broadcasting factors).
 4. Solves run the same two levels: parallel interior forward sweeps,
    redundant coarse solve, parallel interior backward sweeps.

Per-iteration communication: one ppermute (neighbor coupling block, setup
of the factor), one all-gather of (ndev, W, W) Schur blocks, and one
all-gather of (ndev, W) reduced RHS per triangular solve — all O(ndev D^2),
independent of T.  Everything else in the IPM (assembly einsums, residual
matvecs, vector work) is sharded by GSPMD from the input shardings.

Cost model: sequential factor is T * O(D^3); sharded is (T/ndev) * O(D^3)
with a ~(1 + W/D) wider trailing matrix per stage plus an O(ndev * D^3)
coarse factor — near-linear speedup once T >> ndev * (2 + Da/D).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import kkt as kkt_mod
from ..multistage import (
    StageQPData,
    _assemble_blocks,
    _cr_chain_empty,
    _join_x,
    _split_x,
    _tsolve,
    _use_cr,
    chain_bwd,
    chain_factor,
    chain_fwd,
    cr_chain_bwd,
    cr_chain_factor,
    cr_chain_fwd,
)
from ..types import Result, Settings, use_pallas


def _shift_up(a):
    """out[k] = a[k+1], out[-1] = 0 (leading axis)."""
    return jnp.concatenate([a[1:], jnp.zeros_like(a[:1])], axis=0)


@dataclasses.dataclass
class ShardedStageQPData(StageQPData):
    """StageQPData whose stage-blocked leaves are sharded over a mesh axis.

    ``mesh``/``axis`` are static pytree metadata; the block tensors
    (Pd/Psub/Pa/A*/G*) carry NamedShardings over the leading T axis while
    flat vectors stay replicated (vector work is O(n) — negligible next to
    the O(T D^3) factorization).  The IPM core and the structured matvecs
    are representation-agnostic; only factor/solve dispatch here.
    """

    mesh: Any = None
    axis: str = "sp"


_SHARDED_FIELDS = [
    f.name for f in dataclasses.fields(ShardedStageQPData)
    if f.name not in ("mesh", "axis")
]
jax.tree_util.register_dataclass(
    ShardedStageQPData, data_fields=_SHARDED_FIELDS, meta_fields=["mesh", "axis"]
)
ShardedStageQPData.replace = dataclasses.replace


def _ndev(data: ShardedStageQPData) -> int:
    return data.mesh.shape[data.axis]


def pad_stages(data: StageQPData, T_pad: int) -> StageQPData:
    """Append decoupled identity stages so T divides the mesh axis.

    Padding stages have P = I, no couplings, no constraint rows active
    (padded inequality rows get the benign [-1, 1] bounds that
    disable_inf_constraints assigns to dead rows) — they contribute an
    isolated, already-optimal x = 0 sub-problem.
    """
    T, D = data.T, data.D
    extra = T_pad - T
    if extra == 0:
        return data
    if extra < 0:
        raise ValueError(f"T_pad={T_pad} < T={T}")

    def pad_t(a, fill=0.0):
        pad_shape = (extra,) + a.shape[1:]
        return jnp.concatenate(
            [a, jnp.full(pad_shape, fill, a.dtype)], axis=0
        )

    eye = jnp.broadcast_to(jnp.eye(D, dtype=data.Pd.dtype), (extra, D, D))
    Pd = jnp.concatenate([data.Pd, eye], axis=0)

    def pad_flat_x(v, fill=0.0):
        # flat x layout: [T*D stage coords, Da arrow coords]
        stage, arrow = v[: T * D].reshape(T, D), v[T * D:]
        stage = pad_t(stage, fill)
        return jnp.concatenate([stage.reshape(-1), arrow])

    def pad_flat_rows(v, r, fill=0.0):
        return pad_t(v.reshape(T, r), fill).reshape(-1) if r else v

    ra, rg = data.ra, data.rg
    return data.replace(
        Pd=Pd,
        Psub=pad_t(data.Psub),
        Pa=pad_t(data.Pa),
        A1=pad_t(data.A1), A2=pad_t(data.A2), Ag=pad_t(data.Ag),
        G1=pad_t(data.G1), G2=pad_t(data.G2), Gg=pad_t(data.Gg),
        c=pad_flat_x(data.c),
        x_b_scaling=pad_flat_x(data.x_b_scaling, 1.0),
        x_l=pad_flat_x(data.x_l),
        x_u=pad_flat_x(data.x_u),
        xl_mask=pad_flat_x(data.xl_mask.astype(data.c.dtype)).astype(bool),
        xu_mask=pad_flat_x(data.xu_mask.astype(data.c.dtype)).astype(bool),
        b=pad_flat_rows(data.b, ra),
        h_l=pad_flat_rows(data.h_l, rg, -1.0),
        h_u=pad_flat_rows(data.h_u, rg, 1.0),
        hl_mask=pad_flat_rows(data.hl_mask.astype(data.c.dtype), rg, 1.0).astype(bool),
        hu_mask=pad_flat_rows(data.hu_mask.astype(data.c.dtype), rg, 1.0).astype(bool),
    )


def shard_horizon(
    data: StageQPData, mesh: Mesh, axis: str = "sp", pad: bool = True
) -> ShardedStageQPData:
    """Place a StageQPData on the mesh with the stage axis sharded.

    Requires T % ndev == 0 and T/ndev >= 2 (each chunk needs at least one
    interior stage next to its separator); ``pad=True`` pads T up with
    decoupled identity stages.
    """
    ndev = mesh.shape[axis]
    T = data.T
    if T % ndev or T // ndev < 2:
        if not pad:
            raise ValueError(
                f"T={T} not shardable over {ndev} devices (need T % ndev == 0"
                " and T/ndev >= 2); pass pad=True"
            )
        T_pad = max(2 * ndev, ((T + ndev - 1) // ndev) * ndev)
        data = pad_stages(data, T_pad)

    stage_sharding = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def place(name, x):
        if name in ("Pd", "Psub", "Pa", "A1", "A2", "Ag", "G1", "G2", "Gg"):
            return jax.device_put(x, stage_sharding)
        return jax.device_put(x, repl)

    kw = {
        f.name: place(f.name, getattr(data, f.name))
        for f in dataclasses.fields(StageQPData)
    }
    return ShardedStageQPData(mesh=mesh, axis=axis, **kw)


# ---------------------------------------------------------------------------
# sharded factor / solve
# ---------------------------------------------------------------------------

@kkt_mod.empty_factor.register
def _(data: ShardedStageQPData, settings=None):
    T, D, Da = data.T, data.D, data.Da
    ndev = _ndev(data)
    Qi = T // ndev - 1  # interior stages per chunk
    W = 2 * D + Da
    dt = data.c.dtype
    z = jnp.zeros
    if _use_cr(Qi):
        # chunk interiors factor by cyclic reduction (log-depth per chip);
        # placeholder structure selects the scheme, level arity the
        # factor-with-inverse form (same convention as
        # multistage.empty_factor)
        pallas = use_pallas(settings)
        local = jax.tree.map(
            lambda a: jnp.zeros((ndev * a.shape[0],) + a.shape[1:], dt),
            _cr_chain_empty(Qi, D, W, dt, pallas),
        )
    else:
        local = (
            # local interior factors (global stacked shape; sharded)
            z((ndev * Qi, D, D), dt),  # Ls
            z((ndev * Qi, D, D), dt),  # Cs
            z((ndev * Qi, W, D), dt),  # Fs (extended arrow)
        )
    return (
        local,
        # coarse separator system factors (replicated)
        z((ndev, D, D), dt),  # cLs
        z((ndev, D, D), dt),  # cCs
        z((ndev, Da, D), dt),  # cFs
        z((Da, Da), dt),  # cLc
    )


def _chunk_factor(axis, ndev, use_cr, pallas, Kd, Ksub, Ka, Kc):
    """shard_map body: factor the local chunk + redundant coarse factor.

    Local shapes: Kd/Ksub (Q,D,D), Ka (Q,Da,D); Kc (Da,Da) replicated.
    """
    Q, D, _ = Kd.shape
    Da = Kc.shape[0]
    Qi = Q - 1
    W = 2 * D + Da

    # neighbor coupling: chunk k needs E_prev = Ksub_glob[kQ-1]
    # = K[first interior, previous separator], held by chunk k-1 as its last
    # local Ksub.  ppermute shifts it forward; chunk 0 receives zeros.
    E_prev = lax.ppermute(
        Ksub[Q - 1], axis, [(k, k + 1) for k in range(ndev - 1)]
    )

    # extended arrow rows over [prev separator | own separator | arrow]
    Ea = jnp.zeros((Qi, W, D), Kd.dtype)
    Ea = Ea.at[:, 2 * D:, :].set(Ka[:Qi])
    Ea = Ea.at[0, :D, :].set(E_prev.T)  # K[prev_sep, interior 0]
    Ea = Ea.at[Qi - 1, D:2 * D, :].set(Ksub[Qi - 1])  # K[own_sep, last int.]

    Ksub_int = Ksub[:Qi].at[Qi - 1].set(0.0)  # last chain entry unused
    if use_cr:
        # log-depth interior: each of the log2(Qi) levels is one batched
        # potrf + a handful of batched GEMMs instead of Qi tiny scan steps
        local, Sacc, ok_loc = cr_chain_factor(Kd[:Qi], Ksub_int, Ea, pallas)
    else:
        Ls, Cs, Fs, Sacc = chain_factor(Kd[:Qi], Ksub_int, Ea)
        local = (Ls, Cs, Fs)
        ok_loc = jnp.all(jnp.isfinite(Ls))

    # ---- coarse Schur system over separators + arrow (all-gather, tiny)
    g_Kd = lax.all_gather(Kd[Qi], axis)  # (ndev, D, D)
    g_Ka = lax.all_gather(Ka[Qi], axis)  # (ndev, Da, D)
    g_S = lax.all_gather(Sacc, axis)  # (ndev, W, W)

    S_pp = g_S[:, :D, :D]
    S_oo = g_S[:, D:2 * D, D:2 * D]
    S_op = g_S[:, D:2 * D, :D]
    S_ap = g_S[:, 2 * D:, :D]
    S_ao = g_S[:, 2 * D:, D:2 * D]
    S_aa = g_S[:, 2 * D:, 2 * D:]

    # separator k's diag: own-sep downdate from chunk k + prev-sep downdate
    # from chunk k+1; sub-diagonal (sep_{k+1}, sep_k) entirely from chunk
    # k+1's (own, prev) cross block (separators are never adjacent).
    cKd = g_Kd - S_oo - _shift_up(S_pp)
    cKsub = -_shift_up(S_op)
    cKa = g_Ka - S_ao - _shift_up(S_ap)
    cKc = Kc - jnp.sum(S_aa, axis=0)

    cLs, cCs, cFs, cacc = chain_factor(cKd, cKsub, cKa)
    cLc = jnp.linalg.cholesky(cKc - cacc)

    ok = jnp.logical_and(ok_loc, jnp.all(jnp.isfinite(cLs)))
    ok = jnp.logical_and(ok, jnp.all(jnp.isfinite(cLc)))
    ok = jnp.all(lax.all_gather(ok, axis))
    return local, cLs, cCs, cFs, cLc, ok


@kkt_mod.factor.register
def _(data: ShardedStageQPData, ks, mixed: bool = False, pre=None):
    """Partitioned Schur-complement factorization over the mesh axis."""
    Kd, Ksub, Ka, Kc = _assemble_blocks(data, ks)
    if mixed:
        f32 = jnp.float32
        Kd, Ksub, Ka, Kc = (
            Kd.astype(f32), Ksub.astype(f32), Ka.astype(f32), Kc.astype(f32)
        )
    axis, ndev = data.axis, _ndev(data)
    local_ph = ks.L[0]  # placeholder structure selects the interior scheme
    use_cr = isinstance(local_ph[0], tuple)
    pallas = use_cr and len(local_ph[0][0]) == 5

    fn = jax.shard_map(
        lambda *a: _chunk_factor(axis, ndev, use_cr, pallas, *a),
        mesh=data.mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(), P(), P(), P(), P()),
        check_vma=False,
    )
    local, cLs, cCs, cFs, cLc, ok = fn(Kd, Ksub, Ka, Kc)
    return ks.replace(L=(local, cLs, cCs, cFs, cLc)), ok


def _chunk_solve(axis, ndev, local, cLs, cCs, cFs, cLc, vs, vg):
    """shard_map body: two-level forward/backward sweeps.

    Local: interior factors over Qi stages (chain triple or CR levels),
    vs (Q,D).  Replicated: coarse factors, vg (Da,).
    """
    cr = isinstance(local[0], tuple)  # (levels, base) vs (Ls, Cs, Fs)
    Q, D = vs.shape
    Qi = Q - 1
    Da = cLc.shape[0]

    # parallel interior forward sweeps; gacc = coupling-row contributions
    if cr:
        state, gacc = cr_chain_fwd(local, vs[:Qi])
    else:
        Ls, Cs, Fs = local
        ws, gacc = chain_fwd(Ls, Cs, Fs, vs[:Qi])

    # coarse reduced RHS (all-gather, O(ndev * W))
    g_gacc = lax.all_gather(gacc, axis)  # (ndev, W)
    g_rsep = lax.all_gather(vs[Qi], axis)  # (ndev, D)
    c_rhs = g_rsep - g_gacc[:, D:2 * D] - _shift_up(g_gacc[:, :D])
    c_rhs_g = vg - jnp.sum(g_gacc[:, 2 * D:], axis=0)

    # redundant coarse solve (ndev-stage chain + arrow)
    cws, cgacc = chain_fwd(cLs, cCs, cFs, c_rhs)
    cwg = _tsolve(cLc, c_rhs_g - cgacc)
    xg = _tsolve(cLc, cwg, transpose=True)
    x_sep = chain_bwd(cLs, cCs, cFs, cws, xg)  # (ndev, D)

    # parallel interior backward sweeps
    k = lax.axis_index(axis)
    x_prev_sep = jnp.where(k > 0, x_sep[jnp.maximum(k - 1, 0)], 0.0)
    xa = jnp.concatenate([x_prev_sep, x_sep[k], xg])
    if cr:
        x_int = cr_chain_bwd(local, state, xa)  # (Qi, D)
    else:
        x_int = chain_bwd(Ls, Cs, Fs, ws, xa)  # (Qi, D)

    x_loc = jnp.concatenate([x_int, x_sep[k][None]], axis=0)  # (Q, D)
    return x_loc, xg


@kkt_mod.condensed_solve_x.register
def _(data: ShardedStageQPData, ks, v):
    local, cLs, cCs, cFs, cLc = ks.L
    dt = cLc.dtype
    vs, vg = _split_x(data, v.astype(dt))
    vs = vs.reshape(data.T, data.D)
    axis, ndev = data.axis, _ndev(data)

    fn = jax.shard_map(
        lambda *a: _chunk_solve(axis, ndev, *a),
        mesh=data.mesh,
        in_specs=(
            P(axis), P(), P(), P(), P(), P(axis), P(),
        ),
        out_specs=(P(axis), P()),
        check_vma=False,
    )
    xs, xg = fn(local, cLs, cCs, cFs, cLc, vs, vg)
    return _join_x(xs, xg).astype(v.dtype)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("settings", "has_cone"))
def _solve_sharded_jit(sdata: "ShardedStageQPData", settings: Settings,
                       has_cone: bool, warm=None) -> Result:
    """Module-level jitted sharded solve: the cache key is (leaf shapes,
    mesh/axis aux data, settings, has_cone), so repeated MPC-loop calls hit
    the compiled executable instead of retracing a fresh closure per call
    (round-1 weakness: jax.jit(run) on a per-call closure recompiled the
    most expensive executable in the repo every step)."""
    from .. import ruiz, solver

    with jax.default_matmul_precision("highest"):
        sd, sc = ruiz.equilibrate(
            sdata,
            max_iter=settings.preconditioner_iter,
            scale_cost=settings.preconditioner_scale_cost,
        )
        return solver.solve_scaled(sd, sc, settings, has_cone, warm)


def solve_horizon_sharded(
    data: StageQPData,
    mesh: Mesh,
    axis: str = "sp",
    settings: Settings = Settings(),
    has_cone: bool = True,
    warm=None,
) -> Result:
    """One-shot horizon-sharded multistage solve (BASELINE.md config 4).

    Shards the stage axis over ``mesh[axis]``, equilibrates and runs the
    full IPM with the partitioned factorization.  The result is in the
    (possibly padded) stage layout; padded coordinates solve an isolated
    identity sub-problem and can be dropped by the caller.

    ``warm``: a previous ``Result`` (or ``BasicVars``) from this function on
    a nearby problem — the MPC-loop pattern: solve, shift/update data, warm
    re-solve.  Warm iterates must be in the same (padded) stage layout this
    function returns; a warm/wrong-layout mismatch raises.
    """
    from ..types import BasicVars

    sdata = data if isinstance(data, ShardedStageQPData) else shard_horizon(
        data, mesh, axis
    )
    if warm is not None:
        if isinstance(warm, Result):
            warm = BasicVars(x=warm.x, y=warm.y, z_l=warm.z_l, z_u=warm.z_u,
                             z_bl=warm.z_bl, z_bu=warm.z_bu)
        n_pad = sdata.T * sdata.D + sdata.Da
        if warm.x.shape[-1] != n_pad:
            raise ValueError(
                f"warm.x has {warm.x.shape[-1]} coords, expected {n_pad} "
                "(the padded stage layout returned by solve_horizon_sharded)"
            )

    # the factor and solve name their mesh in shard_map(mesh=...), so no
    # ambient mesh context is needed
    return _solve_sharded_jit(sdata, settings, has_cone, warm)
