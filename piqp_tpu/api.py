"""User-facing API.

- :func:`prepare_data`: canonicalize user matrices into a :class:`QPData`
  pytree (the analog of dense::Data construction + disable_inf_constraints,
  /root/reference/include/piqp/dense/data.hpp:55-212).
- :func:`solve_dense` / :func:`solve_prepared`: one-shot functional solves.
- :class:`DenseSolver`: stateful wrapper mirroring piqp::DenseSolver
  (solver.hpp:1262-1291): settings / setup / update / solve / result.

The functional layer is pure JAX: jit once per (shape, settings); update +
re-solve hits the compiled cache with zero retracing (the analog of the
reference's allocation-free update path, solver.hpp:218-308).
"""

from __future__ import annotations

import time
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import kkt, ruiz, solver
from .types import (
    PIQP_INF,
    BasicVars,
    FullKKTQPData,
    Info,
    KKTBackend,
    LDLTKKTQPData,
    QPData,
    Result,
    Scaling,
    Settings,
    Status,
    identity_scaling,
)


def _route_backend(data: QPData, settings: Settings) -> QPData:
    """Re-wrap the data in the representation matching settings.kkt_solver
    (the representation type IS the backend selector; see kkt.py)."""
    import dataclasses

    fields = lambda: {
        f.name: getattr(data, f.name) for f in dataclasses.fields(QPData)
    }
    if settings.kkt_solver == KKTBackend.dense_lu and type(data) is QPData:
        return FullKKTQPData(**fields())
    if settings.kkt_solver == KKTBackend.dense_ldlt and type(data) is QPData:
        return LDLTKKTQPData(**fields())
    return data


def _as_2d(M, rows, cols, dtype):
    if M is None:
        return np.zeros((rows, cols), dtype=dtype)
    M = np.asarray(M, dtype=dtype)
    if M.shape != (rows, cols):
        raise ValueError(f"expected shape {(rows, cols)}, got {M.shape}")
    return M


def _as_1d(v, size, dtype, fill):
    if v is None:
        return np.full(size, fill, dtype=dtype)
    v = np.asarray(v, dtype=dtype)
    if v.shape != (size,):
        raise ValueError(f"expected shape {(size,)}, got {v.shape}")
    return v


def _canon_bounds(h_l, h_u, x_l, x_u):
    """Shared bound canonicalization: masks from the PIQP_INF convention
    (dense/data.hpp:100-142), dead-row fake bounds [-1, 1]
    (disable_inf_constraints, dense/data.hpp:144-169), exact zeros at
    inactive entries.  Returns the canonicalized vectors, the four masks and
    the dead-row mask (caller zeroes G rows)."""
    hl_mask = h_l > -PIQP_INF
    hu_mask = h_u < PIQP_INF
    dead = ~hl_mask & ~hu_mask
    if dead.any():
        h_l = np.where(dead, -1.0, h_l)
        h_u = np.where(dead, 1.0, h_u)
        hl_mask = h_l > -PIQP_INF
        hu_mask = h_u < PIQP_INF

    xl_mask = x_l > -PIQP_INF
    xu_mask = x_u < PIQP_INF

    h_l = np.where(hl_mask, h_l, 0.0)
    h_u = np.where(hu_mask, h_u, 0.0)
    x_l = np.where(xl_mask, x_l, 0.0)
    x_u = np.where(xu_mask, x_u, 0.0)
    return h_l, h_u, x_l, x_u, hl_mask, hu_mask, xl_mask, xu_mask, dead


def prepare_data(
    P,
    c,
    A=None,
    b=None,
    G=None,
    h_l=None,
    h_u=None,
    x_l=None,
    x_u=None,
    dtype=jnp.float64,
) -> QPData:
    """Canonicalize a QP into the internal masked representation.

    Mirrors the reference data layer semantics:
      - only the upper triangle of P is used and symmetrized
        (solver.hpp:182: ``P.triangularView<Upper>()``);
      - bounds with magnitude >= 1e30 (PIQP_INF) are inactive
        (dense/data.hpp:100-142);
      - rows of G with neither bound get zeroed with fake bounds [-1, 1]
        (``disable_inf_constraints``, dense/data.hpp:144-169).
    """
    np_dtype = np.dtype(jnp.dtype(dtype).name)
    P = np.asarray(P, dtype=np_dtype)
    if P.ndim != 2 or P.shape[0] != P.shape[1]:
        raise ValueError("P must be square")
    n = P.shape[0]
    # use upper triangle only, symmetrize (matches reference semantics)
    P_utri = np.triu(P)
    P_full = P_utri + np.triu(P, 1).T

    c = _as_1d(c, n, np_dtype, 0.0)

    p = 0 if A is None else np.asarray(A).shape[0]
    m = 0 if G is None else np.asarray(G).shape[0]
    A = _as_2d(A, p, n, np_dtype)
    b = _as_1d(b, p, np_dtype, 0.0)
    G = _as_2d(G, m, n, np_dtype)
    if m > 0 and h_l is None and h_u is None:
        raise ValueError("h_l or h_u should be provided when G is given")
    h_l = _as_1d(h_l, m, np_dtype, -np.inf)
    h_u = _as_1d(h_u, m, np_dtype, np.inf)
    x_l = _as_1d(x_l, n, np_dtype, -np.inf)
    x_u = _as_1d(x_u, n, np_dtype, np.inf)

    h_l, h_u, x_l, x_u, hl_mask, hu_mask, xl_mask, xu_mask, dead = (
        _canon_bounds(h_l, h_u, x_l, x_u)
    )
    if dead.any():
        # disable_inf_constraints (dense/data.hpp:144-169)
        G = G.copy()
        G[dead, :] = 0.0

    return QPData(
        P=jnp.asarray(P_full),
        c=jnp.asarray(c),
        A=jnp.asarray(A),
        b=jnp.asarray(b),
        G=jnp.asarray(G),
        h_l=jnp.asarray(h_l),
        h_u=jnp.asarray(h_u),
        x_l=jnp.asarray(x_l),
        x_u=jnp.asarray(x_u),
        x_b_scaling=jnp.ones(n, dtype),
        hl_mask=jnp.asarray(hl_mask),
        hu_mask=jnp.asarray(hu_mask),
        xl_mask=jnp.asarray(xl_mask),
        xu_mask=jnp.asarray(xu_mask),
    )


def has_cone(data: QPData) -> bool:
    """Static dispatch flag: any inequality or bound constraints present
    (the reference's ``m + n_x_l + n_x_u > 0`` gate, solver.hpp:504)."""
    return bool(
        data.m > 0
        or bool(np.asarray(jnp.any(data.xl_mask)))
        or bool(np.asarray(jnp.any(data.xu_mask)))
    )


@partial(jax.jit, static_argnames=("settings", "cone"))
def _solve_fresh(data: QPData, settings: Settings, cone: bool, warm=None):
    """Equilibrate + solve; returns (result, scaling)."""
    # an unscoped float32 matmul on the GPU runs in TF32 (about three
    # decimal digits) — catastrophic for a factorization-based solver;
    # force full-precision products (f64 is unaffected).
    with jax.default_matmul_precision("highest"):
        sdata, sc = ruiz.equilibrate(
            data,
            max_iter=settings.preconditioner_iter,
            scale_cost=settings.preconditioner_scale_cost,
        )
        return solver.solve_scaled(sdata, sc, settings, cone, warm), sc


@partial(jax.jit, static_argnames=("settings", "cone"))
def _solve_reuse(
    data: QPData, sc: Scaling, settings: Settings, cone: bool, warm=None
):
    with jax.default_matmul_precision("highest"):
        sdata = ruiz.apply_scaling(data, sc)
        return solver.solve_scaled(sdata, sc, settings, cone, warm)


def solve_prepared(
    data: QPData, settings: Settings = Settings(),
    scaling: Optional[Scaling] = None, warm=None,
) -> Result:
    """Functional solve of a prepared problem. jit/vmap-compatible building
    block (use `_solve_fresh` pieces directly for full control).

    ``warm``: previous ``Result`` (or ``BasicVars``) of a nearby problem to
    warm-start from (solver._warm_vars; works for every backend incl.
    multistage — the iterates share the data representation's layout)."""
    data = _route_backend(data, settings)
    cone = has_cone(data)
    if warm is not None and isinstance(warm, Result):
        warm = BasicVars(x=warm.x, y=warm.y, z_l=warm.z_l, z_u=warm.z_u,
                         z_bl=warm.z_bl, z_bu=warm.z_bu)
    if scaling is not None:
        return _solve_reuse(data, scaling, settings, cone, warm)
    result, _ = _solve_fresh(data, settings, cone, warm)
    return result


def solve_dense(
    P, c, A=None, b=None, G=None, h_l=None, h_u=None, x_l=None, x_u=None,
    settings: Settings = Settings(),
) -> Result:
    """One-shot dense QP solve (functional analog of
    DenseSolver::setup+solve)."""
    data = prepare_data(
        P, c, A, b, G, h_l, h_u, x_l, x_u, dtype=settings.jnp_dtype
    )
    return solve_prepared(data, settings)


class _SettingsView:
    """Attribute-mutable view over a solver's frozen Settings — reference
    Python API parity (``solver.settings.eps_abs = 1e-9``,
    piqp_python.cpp:86-128 exposes mutable settings fields).  Settings
    itself stays frozen/hashable (it is the jit static key); every
    attribute set swaps a new frozen instance into the owning solver, so
    the next solve uses — and retraces for — the new values."""

    __slots__ = ("_solver",)

    def __init__(self, solver):
        object.__setattr__(self, "_solver", solver)

    def unwrap(self) -> Settings:
        return self._solver._settings

    def __getattr__(self, name):
        return getattr(self._solver._settings, name)

    def __setattr__(self, name, value):
        import dataclasses

        cur = self._solver._settings
        if not hasattr(cur, name):
            raise AttributeError(f"Settings has no field {name!r}")
        self._solver._settings = dataclasses.replace(cur, **{name: value})

    def __repr__(self):
        return repr(self._solver._settings)

    def __eq__(self, other):
        if isinstance(other, _SettingsView):
            other = other.unwrap()
        return self._solver._settings == other

    def __hash__(self):
        return hash(self._solver._settings)


class _SettingsProperty:
    """Shared ``settings`` descriptor for the stateful solvers."""

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return _SettingsView(obj)

    def __set__(self, obj, value):
        if isinstance(value, _SettingsView):
            value = value.unwrap()
        if not isinstance(value, Settings):
            raise TypeError(f"expected Settings, got {type(value).__name__}")
        obj._settings = value


class DenseSolver:
    """Stateful solver mirroring piqp::DenseSolver (solver.hpp:1262-1291).

    Usage:
        solver = DenseSolver()
        solver.settings = Settings(eps_abs=1e-9)
        solver.settings.verbose = True             # attribute mutation too
        solver.setup(P, c, A, b, G, h_l, h_u, x_l, x_u)
        status = solver.solve()
        x = solver.result.x
        solver.update(P=P2, h_u=h_u2)
        status = solver.solve()
    """

    settings = _SettingsProperty()

    def __init__(self, settings: Settings = Settings()):
        self._settings = settings
        self._raw: dict = {}
        self._data: Optional[QPData] = None
        self._scaling: Optional[Scaling] = None
        self._result: Optional[Result] = None
        self._cone = True
        self._first_run = True
        self._setup_time = 0.0
        self._update_time = 0.0

    # -- setup / update -----------------------------------------------------

    def setup(self, P, c, A=None, b=None, G=None, h_l=None, h_u=None,
              x_l=None, x_u=None) -> None:
        t0 = time.perf_counter()
        self._raw = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                         x_l=x_l, x_u=x_u)
        self._data = prepare_data(
            P, c, A, b, G, h_l, h_u, x_l, x_u, dtype=self._settings.jnp_dtype
        )
        # cone dispatch flag computed once here (setup is analysis time);
        # the warm solve path must not pay a device->host sync per call
        self._cone = has_cone(self._data)
        # dead-row pattern (disable_inf_constraints) cached for the
        # selective update path
        np_dtype = np.dtype(self._settings.jnp_dtype.name)
        m = self._data.m
        hl = _as_1d(h_l, m, np_dtype, -np.inf)
        hu = _as_1d(h_u, m, np_dtype, np.inf)
        self._dead = ~(hl > -PIQP_INF) & ~(hu < PIQP_INF)
        self._scaling = None
        self._first_run = True
        self._setup_time = time.perf_counter() - t0

    def update(self, P=None, c=None, A=None, b=None, G=None, h_l=None,
               h_u=None, x_l=None, x_u=None) -> None:
        """Update problem data in place (solver.hpp:218-359).  Shapes must
        match the setup call; the compiled solve is reused without
        retracing, and ONLY the changed leaves are canonicalized and
        re-uploaded:

        - vector-only updates (c/b/h_l/h_u/x_l/x_u) replace just those
          device vectors — the O(n^2) matrices stay resident on device
          (the analog of the reference's matrices-unchanged fast path);
        - matrix updates canonicalize and upload only the named matrices.

        Replaced leaves drop their last reference here, so the old device
        buffers are freed immediately (the allocation story of
        solver.hpp:218-308: update never grows the footprint).
        """
        if self._data is None:
            raise RuntimeError("Solver not setup yet")
        t0 = time.perf_counter()
        updates = dict(P=P, c=c, A=A, b=b, G=G, h_l=h_l, h_u=h_u,
                       x_l=x_l, x_u=x_u)
        for k, v in updates.items():
            if v is not None:
                self._raw[k] = v

        d = self._data
        np_dtype = np.dtype(self._settings.jnp_dtype.name)
        n, p, m = d.n, d.p, d.m
        new = {}

        bounds_changed = any(
            updates[k] is not None for k in ("h_l", "h_u", "x_l", "x_u")
        )
        if bounds_changed or updates["G"] is not None:
            hl = _as_1d(self._raw.get("h_l"), m, np_dtype, -np.inf)
            hu = _as_1d(self._raw.get("h_u"), m, np_dtype, np.inf)
            xl = _as_1d(self._raw.get("x_l"), n, np_dtype, -np.inf)
            xu = _as_1d(self._raw.get("x_u"), n, np_dtype, np.inf)
            hl, hu, xl, xu, hl_m, hu_m, xl_m, xu_m, dead = _canon_bounds(
                hl, hu, xl, xu
            )
            old_dead = getattr(self, "_dead", None)
            self._dead = dead
            new.update(
                h_l=jnp.asarray(hl), h_u=jnp.asarray(hu),
                x_l=jnp.asarray(xl), x_u=jnp.asarray(xu),
                hl_mask=jnp.asarray(hl_m), hu_mask=jnp.asarray(hu_m),
                xl_mask=jnp.asarray(xl_m), xu_mask=jnp.asarray(xu_m),
            )
            if updates["G"] is None and (
                old_dead is None or not np.array_equal(dead, old_dead)
            ):
                # the bound update changed the dead-row pattern: the
                # resident G's zeroed rows are stale -> re-canonicalize G
                updates["G"] = self._raw.get("G")

        if updates["P"] is not None:
            Pm = np.asarray(updates["P"], dtype=np_dtype)
            if Pm.shape != (n, n):
                raise ValueError(f"expected shape {(n, n)}, got {Pm.shape}")
            new["P"] = jnp.asarray(np.triu(Pm) + np.triu(Pm, 1).T)
        if updates["A"] is not None:
            new["A"] = jnp.asarray(_as_2d(updates["A"], p, n, np_dtype))
        if updates["G"] is not None:
            Gm = _as_2d(updates["G"], m, n, np_dtype)
            dead = getattr(self, "_dead", None)
            if dead is not None and dead.any():
                Gm = Gm.copy()
                Gm[dead, :] = 0.0
            new["G"] = jnp.asarray(Gm)
        if updates["c"] is not None:
            new["c"] = jnp.asarray(_as_1d(updates["c"], n, np_dtype, 0.0))
        if updates["b"] is not None:
            new["b"] = jnp.asarray(_as_1d(updates["b"], p, np_dtype, 0.0))

        self._data = d.replace(**new)
        if bounds_changed:
            self._cone = has_cone(self._data)
        matrices_changed = any(updates[k] is not None for k in ("P", "A", "G"))
        if not (self._settings.preconditioner_reuse_on_update or not matrices_changed):
            self._scaling = None  # recompute Ruiz on next solve
        self._update_time = time.perf_counter() - t0

    # -- solve --------------------------------------------------------------

    def solve(self, warm_start: bool = False) -> Status:
        """Solve the current problem.  ``warm_start=True`` seeds the IPM
        from the previous solve's iterates (x, y, z_*) — the MPC/SQP
        re-solve pattern after ``update()``; typically cuts the iteration
        count several-fold when the data moved a little.  No reference
        analog (the reference always cold-starts, solver.hpp:398-577)."""
        if self._data is None:
            raise RuntimeError("Solver not setup yet")
        if not self._settings.verify():
            dummy = jax.tree.map(jnp.asarray, _invalid_info(self._settings))
            self._result = dummy
            return Status.INVALID_SETTINGS

        if self._settings.verbose:
            self._print_header()

        warm = None
        if warm_start and self._result is not None and hasattr(self._result, "x"):
            r = self._result
            warm = BasicVars(x=r.x, y=r.y, z_l=r.z_l, z_u=r.z_u,
                             z_bl=r.z_bl, z_bu=r.z_bu)

        data = _route_backend(self._data, self._settings)
        cone = self._cone
        t0 = time.perf_counter()
        if self._scaling is None or not self._settings.preconditioner_reuse_on_update:
            result, sc = _solve_fresh(data, self._settings, cone, warm)
            self._scaling = sc
        else:
            result = _solve_reuse(data, self._scaling, self._settings, cone, warm)
        result = jax.block_until_ready(result)
        solve_time = time.perf_counter() - t0

        self._solve_time = solve_time
        if self._settings.compute_timings:
            # fill the timing leaves of Info (results.hpp:83-88) host-side;
            # kkt_factor_time / kkt_solve_time are estimated from separately
            # timed warm dispatches scaled by dispatch counts.
            t_factor, t_solve = _measure_kkt_times(
                data, self._settings,
                int(result.info.iter), int(result.info.factor_retires),
            )
            f = lambda v: jnp.asarray(v, result.info.rho.dtype)
            result = result.replace(info=result.info.replace(
                setup_time=f(self._setup_time),
                update_time=f(self._update_time),
                solve_time=f(solve_time),
                kkt_factor_time=f(t_factor),
                kkt_solve_time=f(t_solve),
                run_time=f(
                    (self._setup_time if self._first_run else self._update_time)
                    + solve_time
                ),
            ))
        self._result = result
        self._first_run = False
        status = Status(int(result.info.status))
        if self._settings.verbose:
            print(f"\nstatus:               {status.name.lower()}")
            print(f"number of iterations: {int(result.info.iter)}")
            print(f"objective:            {float(result.info.primal_obj):.5e}")
        return status

    def _print_header(self):
        from . import __version__

        print("----------------------------------------------------------")
        print(f"                   piqp_tpu v{__version__}                 ")
        print("----------------------------------------------------------")
        d = self._data
        print(f"variables n = {d.n}, equality constraints p = {d.p}, "
              f"inequality constraints m = {d.m}")
        print()
        print("iter  prim_obj       dual_obj       duality_gap   prim_res"
              "      dual_res      rho         delta       mu          "
              "p_step   d_step")

    @property
    def result(self) -> Result:
        if self._result is None:
            raise RuntimeError("No solve has been performed yet")
        return self._result


@partial(jax.jit, static_argnames=("settings", "mixed"))
def _probe_factored_state(data, settings: Settings, mixed: bool):
    """Build a representative KKTState (cold-start scalings) and factor it
    once — the untimed setup for the timing probes below."""
    from . import ops
    from .types import Vars

    dt = data.c.dtype
    masked_one = lambda mask: jnp.where(mask, 1.0, 0.0).astype(dt)
    v = Vars(
        x=jnp.zeros(data.n, dt), y=jnp.zeros(data.p, dt),
        z_l=masked_one(data.hl_mask), z_u=masked_one(data.hu_mask),
        z_bl=masked_one(data.xl_mask), z_bu=masked_one(data.xu_mask),
        s_l=masked_one(data.hl_mask), s_u=masked_one(data.hu_mask),
        s_bl=masked_one(data.xl_mask), s_bu=masked_one(data.xu_mask),
    )
    with jax.default_matmul_precision("highest"):
        ks = kkt.compute_scalings(
            data, settings, v,
            jnp.asarray(settings.rho_init, dt),
            jnp.asarray(settings.delta_init, dt),
            jnp.asarray(False),
            ops.P_diag(data),
        )
        pre = kkt.precompute(data)
        ks, _ = kkt.factor(data, ks, mixed, pre)
    return ks, v


@partial(jax.jit, static_argnames=("settings", "mixed"))
def _probe_factor(data, settings: Settings, ks, mixed: bool):
    with jax.default_matmul_precision("highest"):
        pre = kkt.precompute(data)
        ks2, ok = kkt.factor(data, ks, mixed, pre)
    return jnp.sum(jax.tree.leaves(ks2.L)[0][..., 0])


@partial(jax.jit, static_argnames=("settings",))
def _probe_solve(data, settings: Settings, ks, rhs):
    with jax.default_matmul_precision("highest"):
        lhs, ok = kkt.solve(data, settings, ks, rhs)
    return jnp.sum(lhs.x)


def _measure_kkt_times(data, settings: Settings, iters: int, retries: int):
    """Estimate cumulative KKT factor/solve device time (results.hpp:87-88)
    by timing one warm dispatch of each phase and scaling by the dispatch
    counts of the IPM run: iters+1+retries factorizations, 2*iters+1 KKT
    solves (init + predictor + corrector).  Timing uses a host readback as
    the completion barrier (block_until_ready under-reports on some remote
    runtimes).

    These are ESTIMATES, not measurements of the real solve executable:
    the IPM loop is one fused XLA executable, and the compiler may fuse
    factor/solve work differently in context than in the standalone probe
    ops timed here, so the reported split is approximate and the two
    values need not sum to solve_time (docs/performance.md)."""
    mixed = bool(settings.mixed_precision)
    try:
        ks, rhs = _probe_factored_state(data, settings, mixed)
        # warmup (compile) then timed dispatch, per phase
        np.asarray(_probe_factor(data, settings, ks, mixed))
        t0 = time.perf_counter()
        np.asarray(_probe_factor(data, settings, ks, mixed))
        t_factor = time.perf_counter() - t0
        np.asarray(_probe_solve(data, settings, ks, rhs))
        t0 = time.perf_counter()
        np.asarray(_probe_solve(data, settings, ks, rhs))
        t_solve = time.perf_counter() - t0
    except (NotImplementedError, TypeError):
        return 0.0, 0.0
    return t_factor * (iters + 1 + retries), t_solve * (2 * iters + 1)


def _invalid_info(settings: Settings):
    from .types import init_info, zero_vars

    # placeholder result carrying only the status
    info = init_info(settings, settings.jnp_dtype)
    info = info.replace(
        status=jnp.asarray(int(Status.INVALID_SETTINGS), jnp.int32)
    )
    v = zero_vars(0, 0, 0, settings.jnp_dtype)
    return Result(
        x=v.x, y=v.y, z_l=v.z_l, z_u=v.z_u, z_bl=v.z_bl, z_bu=v.z_bu,
        s_l=v.s_l, s_u=v.s_u, s_bl=v.s_bl, s_bu=v.s_bu, info=info,
    )
