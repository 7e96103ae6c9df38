"""Sparse problem frontend.

Mirrors piqp::SparseSolver's API (solver.hpp:1293-1322) over scipy.sparse
CSC inputs.  Device-first routing instead of a scalar sparse LDL^T
(sparse/ldlt.hpp is an etree up-looking factorization — exactly the kind of
scalar-chasing code accelerators are worst at):

- ``kkt_solver=dense_cholesky`` (default): the condensed KKT matrix is only
  n x n (all constraints eliminated, matching the reference's
  ``sparse_ldlt_cond`` / KKT_ALL_ELIMINATED mode); we densify that system
  and run the device Cholesky path, up to n of a few thousand.
- ``kkt_solver=multistage``: host-side structure detection
  (piqp_tpu._native, the analog of extract_arrow_structure) converts the
  problem to stage blocks and runs the block-tridiagonal+arrow backend —
  cost linear in the horizon.  Falls back to dense when no structure is
  found and ``multistage_fallback`` is True.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

import jax

from .api import DenseSolver, has_cone, _solve_fresh
from .types import KKTBackend, Result, Settings, Status


def _to_dense(M):
    if M is None:
        return None
    if hasattr(M, "toarray"):
        return M.toarray()
    return np.asarray(M)


class _PermutedResult:
    """User-order view of a stage-layout Result."""

    def __init__(self, res: Result, layout):
        self.info = res.info
        vm, am, gm = layout.var_map, layout.a_row_map, layout.g_row_map
        self.x = np.asarray(res.x)[vm]
        self.y = np.asarray(res.y)[am] if layout.p else np.zeros(0)
        self.z_l = np.asarray(res.z_l)[gm] if layout.m else np.zeros(0)
        self.z_u = np.asarray(res.z_u)[gm] if layout.m else np.zeros(0)
        self.s_l = np.asarray(res.s_l)[gm] if layout.m else np.zeros(0)
        self.s_u = np.asarray(res.s_u)[gm] if layout.m else np.zeros(0)
        self.z_bl = np.asarray(res.z_bl)[vm]
        self.z_bu = np.asarray(res.z_bu)[vm]
        self.s_bl = np.asarray(res.s_bl)[vm]
        self.s_bu = np.asarray(res.s_bu)[vm]


class SparseSolver(DenseSolver):
    """Sparse-input solver with PIQP's SparseSolver API.

    Accepts scipy.sparse matrices (any format) or dense arrays for P, A, G.
    """

    #: problems larger than this are routed to the host sparse backend when
    #: the backend is left at the default (densifying a 10^4-dim sparse
    #: problem onto the device wastes both memory and FLOPs;
    #: benchmarks/routing_crossover.py measures the crossover on a device).
    #: The value is not yet measured on the GPU.
    #: ``Settings.dense_routing_max_n`` overrides per solver instance.
    DENSE_ROUTING_MAX_N = 512

    @property
    def _dense_routing_max_n(self) -> int:
        cap = self._settings.dense_routing_max_n
        return self.DENSE_ROUTING_MAX_N if cap is None else cap

    def __init__(self, settings: Settings = Settings(),
                 multistage_fallback: bool = True,
                 host_kkt_mode: str = "auto"):
        super().__init__(settings)
        self._multistage_fallback = multistage_fallback
        #: KKT elimination level for the host sparse route ("auto" |
        #: "full" | "eq" | "ineq" | "cond" — the reference's KKTMode,
        #: sparse/kkt.hpp; hostsparse._KKT documents the systems).
        self._host_kkt_mode = host_kkt_mode
        self._stage_data = None
        self._layout = None
        self._stage_raw = None
        self._host_raw = None

    def setup(self, P, c, A=None, b=None, G=None, h_l=None, h_u=None,
              x_l=None, x_u=None) -> None:
        self._host_raw = None
        if self._settings.kkt_solver == KKTBackend.multistage:
            from . import multistage as ms

            try:
                self._stage_raw = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l,
                                       h_u=h_u, x_l=x_l, x_u=x_u)
                self._stage_data, self._layout = ms.from_sparse(
                    P, c, A, b, G, h_l, h_u, x_l, x_u,
                    dtype=self._settings.jnp_dtype,
                )
                self._cone = has_cone(self._stage_data)
                self._result = None
                self._first_run = True
                return
            except ValueError:
                if not self._multistage_fallback:
                    raise
                self._stage_data = None
                self._layout = None
        n = P.shape[0] if hasattr(P, "shape") else np.asarray(P).shape[0]
        if self._settings.kkt_solver == KKTBackend.sparse_host or (
            self._settings.kkt_solver == KKTBackend.dense_cholesky
            and n > self._dense_routing_max_n
        ):
            self._host_raw = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l,
                                  h_u=h_u, x_l=x_l, x_u=x_u)
            self._result = None
            self._first_run = True
            return
        super().setup(
            _to_dense(P), c, _to_dense(A), b, _to_dense(G), h_l, h_u, x_l, x_u
        )

    def update(self, P=None, c=None, A=None, b=None, G=None, h_l=None,
               h_u=None, x_l=None, x_u=None) -> None:
        if self._host_raw is not None:
            updates = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                           x_l=x_l, x_u=x_u)
            for k, v in updates.items():
                if v is not None:
                    self._host_raw[k] = v
            return
        if self._stage_data is not None:
            from . import multistage as ms

            updates = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                           x_l=x_l, x_u=x_u)
            for k, v in updates.items():
                if v is not None:
                    self._stage_raw[k] = v
            if P is None and A is None and G is None:
                # vector-only update: rebuild just the flat vectors; the
                # (T, D, D)/(T, r, *) stage tensors stay the same device
                # buffers (the multistage selective-transfer path).  Falls
                # through when the dead-row pattern changed.
                sr = self._stage_raw
                new = ms.update_vectors(
                    self._layout, self._stage_data,
                    c=sr["c"], b=sr.get("b"),
                    h_l=sr.get("h_l"), h_u=sr.get("h_u"),
                    x_l=sr.get("x_l"), x_u=sr.get("x_u"),
                )
                if new is not None:
                    self._stage_data = new
                    self._cone = has_cone(new)
                    return
            # value re-scatter through the cached maps: structure
            # detection and reblocking are skipped entirely (the analog of
            # the reference's nnz-map update, multistage_kkt.hpp:140-178)
            self._stage_data, self._layout = ms.update_values(
                self._layout, **self._stage_raw,
                dtype=self._settings.jnp_dtype,
            )
            self._cone = has_cone(self._stage_data)
            return
        super().update(
            _to_dense(P), c, _to_dense(A), b, _to_dense(G), h_l, h_u, x_l, x_u
        )

    def solve(self, warm_start: bool = False) -> Status:
        """Solve; ``warm_start=True`` seeds the IPM from the previous
        solve's iterates (all backends: dense-routed, multistage, and the
        host fallback — no reference analog, solver.hpp:398-577)."""
        if self._host_raw is not None:
            if not self._settings.verify():
                return Status.INVALID_SETTINGS
            from .hostsparse import HostResult, solve_sparse_host

            hwarm = (
                self._result
                if warm_start and isinstance(self._result, HostResult)
                else None
            )
            res = solve_sparse_host(
                **self._host_raw,
                settings=self._settings,
                verbose=self._settings.verbose,
                warm=hwarm,
                kkt_mode=self._host_kkt_mode,
            )
            self._result = res
            self._first_run = False
            return Status(int(res.info.status))
        if self._stage_data is None:
            return super().solve(warm_start)
        if not self._settings.verify():
            return Status.INVALID_SETTINGS
        cone = self._cone
        warm = None
        if warm_start and getattr(self, "_stage_result", None) is not None:
            r = self._stage_result  # stage-layout iterates (pre-permutation)
            from .types import BasicVars

            warm = BasicVars(x=r.x, y=r.y, z_l=r.z_l, z_u=r.z_u,
                             z_bl=r.z_bl, z_bu=r.z_bu)
        t0 = time.perf_counter()
        res, _ = _solve_fresh(self._stage_data, self._settings, cone, warm)
        res = jax.block_until_ready(res)
        solve_time = time.perf_counter() - t0
        if self._settings.compute_timings:
            from .api import _measure_kkt_times

            t_factor, t_solve = _measure_kkt_times(
                self._stage_data, self._settings,
                int(res.info.iter), int(res.info.factor_retires),
            )
            import jax.numpy as jnp

            f = lambda v: jnp.asarray(v, res.info.rho.dtype)
            res = res.replace(info=res.info.replace(
                solve_time=f(solve_time),
                kkt_factor_time=f(t_factor),
                kkt_solve_time=f(t_solve),
                run_time=f(solve_time),
            ))
        self._stage_result = res
        self._result = _PermutedResult(res, self._layout)
        self._first_run = False
        return Status(int(res.info.status))
