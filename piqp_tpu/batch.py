"""Batched QP solving — the headline capability on an accelerator.

The reference is a single-problem, single-core library; its throughput story
is SIMD + OpenMP (SURVEY.md section 2.10).  On a GPU the natural analog is
*batching*: every solver stage is a pure function over pytrees, so ``vmap``
turns it into a batched solver where the condensed-KKT Cholesky becomes a
batched factorization, and ``jax.sharding`` splits the batch across
devices (data-parallel).

All problems in a batch share shapes (n, p, m); masks may differ per
problem (different active bounds), but all problems must either have cone
constraints or none (the dispatch is static).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from . import ruiz, solver
from .api import _route_backend, prepare_data
from .types import BasicVars, QPData, Result, Settings


def prepare_batch(problems: Sequence[dict], dtype=jnp.float64) -> QPData:
    """Stack a sequence of problem dicts (keys P, c, A, b, G, h_l, h_u,
    x_l, x_u) into one batched QPData with a leading batch axis."""
    datas = [prepare_data(**prob, dtype=dtype) for prob in problems]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *datas)


@partial(jax.jit, static_argnames=("settings", "cone"))
def _solve_batch_jit(
    data: QPData, settings: Settings, cone: bool, warm=None
) -> Result:
    def one(d, w):
        sdata, sc = ruiz.equilibrate(
            d,
            max_iter=settings.preconditioner_iter,
            scale_cost=settings.preconditioner_scale_cost,
        )
        return solver.solve_scaled(sdata, sc, settings, cone, w)

    # see api._solve_fresh: f32 matmuls need full-precision accumulation
    with jax.default_matmul_precision("highest"):
        if warm is None:
            return jax.vmap(lambda d: one(d, None))(data)
        return jax.vmap(one)(data, warm)


def warm_from_result(res: Result) -> BasicVars:
    """Extract the warm-start iterates (x, y, z_*) from a previous
    ``Result`` (batched or single)."""
    return BasicVars(
        x=res.x, y=res.y, z_l=res.z_l, z_u=res.z_u,
        z_bl=res.z_bl, z_bu=res.z_bu,
    )


def _solve_batch_chunked(
    data: QPData, settings: Settings, cone: bool, chunk: int, warm=None
) -> Result:
    """Host-level loop of jit dispatches over ``chunk``-sized sub-batches.

    One executable compiles (per chunk shape); the loop issues async
    dispatches back-to-back, so device utilization matches the monolithic
    vmap while each dispatch's working set (device memory) stays bounded.
    """
    B = data.c.shape[0]
    outs = []
    for s in range(0, B, chunk):
        part = jax.tree.map(lambda x: x[s:s + chunk], data)
        wpart = (
            None if warm is None
            else jax.tree.map(lambda x: x[s:s + chunk], warm)
        )
        outs.append(_solve_batch_jit(part, settings, cone, wpart))
    return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)


def solve_batch(
    data: QPData,
    settings: Settings = Settings(),
    cone: bool = True,
    sharding: Optional[jax.sharding.Sharding] = None,
    chunk: int = 0,
    warm: Optional[object] = None,
) -> Result:
    """Solve a batch of QPs (leading axis on every leaf of ``data``).

    ``sharding``: optional sharding for the batch axis; pass a
    ``NamedSharding(mesh, P('batch'))`` to scale across devices.  The solve
    is embarrassingly parallel over the batch — XLA inserts no collectives.

    ``chunk``: when nonzero and smaller than the batch, the solve is issued
    as back-to-back jit dispatches of ``chunk``-sized sub-batches (see
    ``_solve_batch_chunked``); throughput is unchanged for compute-bound
    configs while the per-dispatch working set stays bounded.

    ``warm``: optional warm-start iterates — a previous batched ``Result``
    or a batched ``BasicVars`` — for MPC/SQP re-solves after small data
    updates.  Typically cuts the iteration count several-fold (no reference
    analog: the reference always cold-starts).
    """
    data = _route_backend(data, settings)
    if isinstance(warm, Result):
        warm = warm_from_result(warm)
    if sharding is not None:
        data = jax.device_put(data, sharding)
        if warm is not None:
            warm = jax.device_put(warm, sharding)
    B = data.c.shape[0]
    if chunk and B > chunk:
        return _solve_batch_chunked(data, settings, cone, chunk, warm)
    return _solve_batch_jit(data, settings, cone, warm)


@partial(jax.jit, static_argnames=("settings", "cone", "rounds"))
def _solve_batch_sqp_jit(
    data: QPData, settings: Settings, cone: bool, rounds: int, warm,
    c_rounds=None,
):
    """``rounds`` warm update->re-solve passes fused into ONE executable
    (``lax.scan`` over rounds, each re-solving from the previous round's
    iterates).

    This is the SQP/MPC usage pattern (the reference's warm loop:
    benchmarks/src/sqp_benchmarks.cpp:16-120 and solver.hpp:218-308's
    allocation-free update+solve) expressed as one program: the scan body is
    traced once, so the executable is the size of ONE warm solve while K
    rounds of work ride a single dispatch — on a dispatch-latency-bound
    runtime this amortizes both the dispatch floor and the executable load
    across all K x B solves.

    ``c_rounds``: optional (rounds, n) [or batched (B, rounds, n)] array of
    per-round linear costs.  Default mirrors benchmarks/ref_driver.cpp's
    warm pass: ``c_r = c * (1 + 0.01 (r+1))``.

    Returns (final_warm, statuses, iters) where statuses/iters are
    (B, rounds) int32 arrays.
    """

    def one(d, w, cr):
        # preconditioner_reuse_on_update (settings.hpp:66): equilibrate the
        # base problem once and re-apply the same scaling to each round's
        # perturbed data — the reference's update() fast path, and a large
        # win here because the 10-iteration Ruiz loop otherwise re-runs
        # inside every scan round.
        sc0 = None
        if settings.preconditioner_reuse_on_update:
            _, sc0 = ruiz.equilibrate(
                d,
                max_iter=settings.preconditioner_iter,
                scale_cost=settings.preconditioner_scale_cost,
            )

        def body(carry, xs):
            w = carry
            r, c_r = xs
            dr = d.replace(
                c=d.c * (1.0 + 0.01 * (r + 1.0)) if c_r is None else c_r
            )
            if sc0 is not None:
                sdata, sc = ruiz.apply_scaling(dr, sc0), sc0
            else:
                sdata, sc = ruiz.equilibrate(
                    dr,
                    max_iter=settings.preconditioner_iter,
                    scale_cost=settings.preconditioner_scale_cost,
                )
            res = solver.solve_scaled(sdata, sc, settings, cone, w)
            return warm_from_result(res), (res.info.status, res.info.iter)

        rs = jnp.arange(rounds, dtype=d.c.dtype)
        wf, (status, iters) = lax.scan(body, w, (rs, cr))
        return wf, status, iters

    with jax.default_matmul_precision("highest"):
        if c_rounds is None:
            return jax.vmap(lambda d, w: one(d, w, None))(data, warm)
        in_axes = (0, 0, 0 if c_rounds.ndim == 3 else None)
        return jax.vmap(one, in_axes=in_axes)(data, warm, c_rounds)


def solve_batch_sqp(
    data: QPData,
    settings: Settings = Settings(),
    cone: bool = True,
    rounds: int = 8,
    warm: Optional[object] = None,
    c_rounds=None,
) -> tuple:
    """Fused multi-round warm solving: see ``_solve_batch_sqp_jit``.

    ``warm`` may be a previous batched ``Result`` (e.g. from a cold
    ``solve_batch`` pass) or ``BasicVars``; when ``None``, a cold
    ``solve_batch`` pass on ``data`` provides the warm iterates.  Returns
    (final_warm: BasicVars, statuses: (B, rounds), iters: (B, rounds)).
    """
    data = _route_backend(data, settings)
    if isinstance(warm, Result):
        warm = warm_from_result(warm)
    if warm is None:
        warm = warm_from_result(_solve_batch_jit(data, settings, cone))
    return _solve_batch_sqp_jit(data, settings, cone, rounds, warm, c_rounds)


def _next_pow2(k: int) -> int:
    return 1 << max(0, (k - 1)).bit_length()


def solve_batch_compact(
    data: QPData,
    settings: Settings = Settings(),
    cone: bool = True,
    chunk: int = 0,
    warm: Optional[object] = None,
    phase1_iters: Optional[int] = None,
) -> Result:
    """Two-phase batched solve with straggler compaction.

    The lockstep vmapped IPM runs every problem in a (chunk of the) batch
    for the chunk's MAX iteration count, so a few hard problems hold the
    whole batch hostage: on the warm north-star workload, 99% of problems
    converge in 3 iterations while the chunk pays 9 (measured,
    docs/batching.md).  This solver runs the batch with a short iteration
    budget first, then gathers the unconverged few into ONE small batch
    (padded to the next power of two — a bounded set of phase-2
    executables) and re-solves them warm from their phase-1 iterates with
    the full budget.

    Every problem is solved to exactly the same tolerances; only the
    wasted lockstep iterations go away.  Phase 2 is a warm RESTART (the
    proximal state re-initializes), so iterate paths differ from a
    single-pass solve, but statuses and accuracy gates are identical.

    ``phase1_iters`` defaults to 4 for warm-started batches and 12 for
    cold ones (the measured medians plus margin, f64 path).  Workload
    shifts the distribution — mixed precision adds ~2 warm iterations —
    so for a repeated workload, probe once with the full budget and set
    ``phase1_iters`` at the ~95th percentile of ``result.info.iter`` + 1
    (benchmarks/northstar_bench.py self-tunes exactly this way).
    """
    import dataclasses

    if phase1_iters is None:
        phase1_iters = 4 if warm is not None else 12
    if isinstance(warm, Result):
        warm = warm_from_result(warm)

    s1 = dataclasses.replace(settings, max_iter=phase1_iters)
    res1 = solve_batch(data, s1, cone, None, chunk, warm)

    from .types import Status

    status = np.asarray(res1.info.status)
    idx = np.nonzero(status == int(Status.MAX_ITER_REACHED))[0]
    if idx.size == 0 or phase1_iters >= settings.max_iter:
        return res1

    B = data.c.shape[0]
    slots = min(_next_pow2(int(idx.size)), B)
    # pad by repeating the first straggler (duplicates are discarded on
    # scatter); fixed pow2 slot counts bound the phase-2 executable set
    pad_idx = np.concatenate([idx, np.full(slots - idx.size, idx[0])])
    gidx = jnp.asarray(pad_idx)

    gdata = jax.tree.map(lambda x: x[gidx], _route_backend(data, settings))
    gwarm = jax.tree.map(lambda x: x[gidx], warm_from_result(res1))
    res2 = _solve_batch_jit(gdata, settings, cone, gwarm)

    # account phase-1 work in the straggler iteration counts
    res2 = dataclasses.replace(
        res2,
        info=res2.info.replace(iter=res2.info.iter + phase1_iters),
    )
    k = idx.size
    sidx = jnp.asarray(idx)
    merged = jax.tree.map(
        lambda a, b: a.at[sidx].set(b[:k]), res1, res2
    )
    return merged
