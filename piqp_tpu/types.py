"""Core types for the solver.

Accelerator-first re-design of the reference PIQP data layer
(/root/reference/include/piqp/{typedefs,settings,variables,results}.hpp,
/root/reference/include/piqp/dense/data.hpp).

Key design deltas vs the reference (deliberate, accelerator-first):

- The reference compresses finite bounds into dynamically-sized index sets
  (``h_l_idx``/``x_l_idx``, dense/data.hpp:40-49).  Dynamic sizes are hostile
  to XLA; we instead carry *fixed-shape boolean masks* and keep every
  per-bound vector full-length and index-aligned with its constraint/variable
  axis.  Inactive entries are kept at exactly 0 and every computation is
  gated with ``jnp.where``; this reproduces the reference semantics in which
  inactive bounds contribute nothing to residuals, scalings or dot products
  (solver.hpp:410-419, kkt_system.hpp:161-193).

- Box duals/slacks (``z_bl``/``s_bl``/...) are full length-n vectors aligned
  with x instead of compressed heads; the reference's ``restore_dual``
  re-inflation (solver.hpp:1229-1259) becomes a trivial masked fill.

- Everything is a registered pytree so the whole solver is jit/vmap/pjit
  compatible; a batch of QPs is just a leading axis on every leaf.
"""

from __future__ import annotations

import dataclasses
import enum
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp

# Values greater or equal in magnitude are treated as infinite
# (mirrors PIQP_INF = 1e30, fwd.hpp:54).
PIQP_INF = 1e30

# Farkas-certificate validation tolerances, shared by the device
# (solver.py) and host (hostsparse.py) backends.  Calibrated on the
# Netlib infeasible corpus (see docs/corpus.md): genuinely infeasible
# instances certify with eq_rel <= 2.6e-6, neg <= 0.30,
# sup_rel <= -0.026, while pilotnov's spurious ray showed neg = 1.0,
# sup_rel = -3.9e-4.
CERT_EQ_TOL = 1e-4
CERT_NEG_TOL = 0.5
CERT_SUP_TOL = 1e-2


class Status(enum.IntEnum):
    """Solver status codes (mirrors results.hpp:18-27)."""

    SOLVED = 1
    MAX_ITER_REACHED = -1
    PRIMAL_INFEASIBLE = -2
    DUAL_INFEASIBLE = -3
    NUMERICS = -8
    UNSOLVED = -9
    INVALID_SETTINGS = -10
    # Internal sentinel: the jitted loop is still running (never escapes).
    RUNNING = 0


def status_to_string(status: int) -> str:
    try:
        s = Status(int(status))
    except ValueError:
        return "unknown"
    return {
        Status.SOLVED: "solved",
        Status.MAX_ITER_REACHED: "max iterations reached",
        Status.PRIMAL_INFEASIBLE: "primal infeasible",
        Status.DUAL_INFEASIBLE: "dual infeasible",
        Status.NUMERICS: "numerics issue",
        Status.UNSOLVED: "unsolved",
        Status.INVALID_SETTINGS: "invalid settings",
        Status.RUNNING: "running",
    }[s]


class KKTBackend(enum.Enum):
    """KKT solver backends (analog of settings.hpp:18-26).

    The device build condenses everything onto dense/structured device math:
      - ``dense_cholesky``: fully condensed n-by-n system + Cholesky.
      - ``dense_lu``: full 3-block (n+p+m) dense KKT + pivoted LU.
        The condensed form squares the KKT condition number; on
        ill-conditioned problems (tight SQP subproblems) the full form
        keeps factorizations healthy at the cost of a bigger matrix —
        the device analog of the reference's KKT_FULL sparse mode.
      - ``dense_ldlt``: full 3-block KKT + blocked signed Cholesky
        (LDL^T without pivoting, ops/ldlt.py) — the quasi-definite
        analog of the reference's dense::LDLTNoPivot
        (dense/ldlt_no_pivot.hpp:279-354).  Same conditioning benefits
        as ``dense_lu`` at Cholesky cost.
      - ``multistage``: block-tridiagonal + arrow Cholesky over stages.
      - ``sparse_host``: full 3-block sparse KKT factored host-side
        (hostsparse.py) — the routing target for large general sparse
        problems with no block structure (SURVEY.md §7 routing rule).
    Sparse problems are routed through one of these after host-side analysis.
    """

    dense_cholesky = "dense_cholesky"
    dense_lu = "dense_lu"
    dense_ldlt = "dense_ldlt"
    multistage = "multistage"
    sparse_host = "sparse_host"

    @classmethod
    def from_piqp(cls, name: str) -> "KKTBackend":
        """Map a reference KKTSolver name (settings.hpp:18-26) onto the
        equivalent device backend, so ported PIQP configurations keep working:

        - dense_cholesky -> dense_cholesky
        - sparse_ldlt (KKT_FULL) -> sparse_host (full 3-block KKT)
        - sparse_ldlt_eq_cond / sparse_ldlt_ineq_cond / sparse_ldlt_cond
          -> dense_cholesky (every elimination level condenses onto the
          same n-by-n device system here; partial eliminations exist in
          the reference only to trade sparsity patterns, which the dense
          device path does not have)
        - sparse_multistage -> multistage
        """
        aliases = {
            "dense_cholesky": cls.dense_cholesky,
            "sparse_ldlt": cls.sparse_host,
            "sparse_ldlt_eq_cond": cls.dense_cholesky,
            "sparse_ldlt_ineq_cond": cls.dense_cholesky,
            "sparse_ldlt_cond": cls.dense_cholesky,
            "sparse_multistage": cls.multistage,
        }
        try:
            return cls(name)
        except ValueError:
            if name in aliases:
                return aliases[name]
            raise


@dataclasses.dataclass(frozen=True)
class Settings:
    """Solver settings (mirrors settings.hpp:42-107 field-for-field).

    This is a hashable, frozen dataclass passed as a *static* argument to the
    jitted solver: settings changes recompile, data changes do not.
    """

    rho_init: float = 1e-6
    delta_init: float = 1e-4

    eps_abs: float = 1e-8
    eps_rel: float = 1e-9

    check_duality_gap: bool = True
    eps_duality_gap_abs: float = 1e-8
    eps_duality_gap_rel: float = 1e-9

    infeasibility_threshold: float = 0.9

    reg_lower_limit: float = 1e-10
    reg_finetune_lower_limit: float = 1e-13
    reg_finetune_primal_update_threshold: int = 7
    reg_finetune_dual_update_threshold: int = 7

    max_iter: int = 250
    max_factor_retires: int = 10

    preconditioner_scale_cost: bool = False
    preconditioner_reuse_on_update: bool = False
    preconditioner_iter: int = 10

    tau: float = 0.99

    kkt_solver: KKTBackend = KKTBackend.dense_cholesky

    iterative_refinement_always_enabled: bool = False
    iterative_refinement_eps_abs: float = 1e-12
    iterative_refinement_eps_rel: float = 1e-12
    iterative_refinement_max_iter: int = 10
    iterative_refinement_min_improvement_rate: float = 5.0
    iterative_refinement_static_regularization_eps: float = 1e-8
    iterative_refinement_static_regularization_rel: Optional[float] = None
    # None -> eps(dtype)**2 at trace time (settings.hpp:79).

    verbose: bool = False
    compute_timings: bool = False

    # --- accelerator extensions (no reference analog) ---
    # Compute dtype for the solver; float64 gives reference parity,
    # float32 + iterative refinement is the fast path.
    dtype: str = "float64"
    # Mixed precision: assemble + Cholesky-factor the condensed KKT system
    # in float32 while the IPM iterates and refines in
    # the solver dtype.  Iterative refinement is forced on — it is exactly
    # the reference's accuracy-recovery mechanism (kkt_system.hpp:256-301)
    # and recovers float64-grade solutions from float32 factors.  Two-phase:
    # float32 factors while mu > mixed_precision_mu_switch, float64 after
    # (late-IPM condensed systems exceed float32's conditioning range).
    mixed_precision: bool = False
    mixed_precision_mu_switch: float = 1e-5
    # Phase-A stall exit: leave the float32 phase early (fall to the f64
    # endgame) when neither primal nor dual residual has progressed for
    # this many consecutive iterations (the no_*_update counters,
    # solver.hpp:641-681 semantics) — ill-conditioned problems can plateau
    # above mu_switch because f32-quality steps stop improving them, and
    # in a lockstep batch one such problem pins the whole chunk in phase A
    # (the guard restores the f64 trajectory for exactly those).  Chosen
    # above the finetune thresholds (7) so regularization fine-tuning gets
    # its chance first.  0 disables.
    mixed_phase_a_patience: int = 12
    # Factor representation (ops/pallas_chol.py).  True keeps each
    # Cholesky factor together with its triangular inverse, so every solve
    # is a pair of GEMVs: the condensed dense backend, the multistage
    # cyclic-reduction levels and the dense_ldlt backend all switch.  False
    # (default) keeps the plain factor and solves by substitution: it won
    # the warm-fleet comparison on the GPU (PERF.md).  The name is
    # historical; no Pallas kernel is involved.
    pallas_kernels: bool = False
    # SparseSolver routing cap: sparse problems with n above this stay on
    # the host sparse backend instead of densifying onto the device
    # (SURVEY.md section 7 design delta 3 routing rule).  None = the
    # default (SparseSolver.DENSE_ROUTING_MAX_N, 512;
    # benchmarks/routing_crossover.py measures the crossover on a device).
    dense_routing_max_n: Optional[int] = None
    # Inexact-IPM refinement tolerance (no reference analog; the reference's
    # f64 factors reach the fixed 1e-12 refinement tolerance in <=1 pass, so
    # it never needed one).  When > 0, every in-loop KKT solve refines only
    # until the residual error drops below refine_mu_factor * mu: Newton
    # systems early in the IPM are solved to an accuracy proportional to the
    # barrier parameter (the standard inexact-interior-point rule), which is
    # what makes float32 factors cheap — a fixed 1e-12 tolerance forces
    # several refinement passes per solve against an f32 factor for
    # accuracy the early iterations cannot use.  Termination still checks the true unregularized residuals, so
    # final solution accuracy is unchanged (validated by the corpus suite).
    # 0 disables (fixed-tolerance refinement, the round-3 behavior).
    refine_mu_factor: float = 1e-2
    # Statically unrolled refinement for the f32 phase A of mixed
    # precision (requires refine_mu_factor > 0): exactly this many
    # correction passes, with no error norms, improvement-rate logic or
    # while_loop — the adaptive loop's lockstep machinery (masked norm
    # reductions, batched loop conditions) can cost more than its
    # arithmetic.  Accuracy is safe by the same
    # inexact-IPM argument as refine_mu_factor: phase A only needs
    # mu-proportional solve accuracy, the f64 endgame still refines
    # adaptively, and termination checks true unregularized residuals.
    # -1 disables (adaptive refinement everywhere, the round-4 behavior).
    refine_static_passes: int = 1
    # Validate Farkas certificates before returning PRIMAL/DUAL_INFEASIBLE
    # (no reference analog — the reference certifies from stall counters
    # alone, solver.hpp:616-630, which is trajectory-sensitive).  A failed
    # validation relaxes the regularization floor and keeps iterating; at
    # max_iter a post-hoc certificate search (proximal drift, violation
    # residuals, phase-1 feasibility QP) can still certify infeasibility.
    verify_certificates: bool = True
    # Barrier floor for warm-started solves (no reference analog — the
    # reference always cold-starts, solver.hpp:398-577).  A converged warm
    # point has near-zero complementarity; recentering it at exactly that mu
    # makes the first warm iteration too aggressive when the problem data
    # moved.  sqrt(warm_start_mu) is roughly the distance the point is
    # pushed off the boundary.
    warm_start_mu: float = 1e-7
    # Gondzio multiple centrality correctors (no reference analog — the
    # reference does one Mehrotra corrector).  After the standard corrector,
    # up to this many extra correction solves re-center outlier
    # complementarity products toward [0.1, 10] x sigma*mu at an enlarged
    # trial step; a round is kept only if it lengthens the step.  Each round
    # costs one backend solve — cheap next to the factorization the longer
    # steps save.  0 (default) leaves the trace identical to the reference
    # algorithm.
    centrality_correctors: int = 0

    def verify(self) -> bool:
        """Mirror of Settings::verify_settings (settings.hpp:84-106)."""
        return (
            self.rho_init > 0
            and self.delta_init > 0
            and self.eps_abs > 0
            and self.eps_rel >= 0
            and self.eps_duality_gap_abs > 0
            and self.eps_duality_gap_rel >= 0
            and self.infeasibility_threshold >= 0
            and self.reg_lower_limit > 0
            and self.reg_finetune_primal_update_threshold >= 0
            and self.reg_finetune_dual_update_threshold >= 0
            and self.max_iter > 0
            and self.max_factor_retires > 0
            and self.preconditioner_iter >= 0
            and self.tau > 0
            and self.tau <= 1
            and self.mixed_precision_mu_switch > 0
            and self.mixed_phase_a_patience >= 0
            and self.refine_mu_factor >= 0
            and self.refine_static_passes >= -1
            and (
                self.dense_routing_max_n is None
                or self.dense_routing_max_n >= 0
            )
            and self.warm_start_mu > 0
            and 0 <= self.centrality_correctors <= 10
            and self.iterative_refinement_eps_abs > 0
            and self.iterative_refinement_eps_rel >= 0
            and self.iterative_refinement_max_iter >= 0
            and self.iterative_refinement_min_improvement_rate >= 1.0
            and self.iterative_refinement_static_regularization_eps > 0
            and (
                self.iterative_refinement_static_regularization_rel is None
                or self.iterative_refinement_static_regularization_rel >= 0
            )
        )

    @property
    def jnp_dtype(self):
        return jnp.dtype(self.dtype)

    def static_reg_rel(self) -> float:
        if self.iterative_refinement_static_regularization_rel is not None:
            return self.iterative_refinement_static_regularization_rel
        eps = float(jnp.finfo(self.jnp_dtype).eps)
        return eps * eps


def use_pallas(settings: "Settings | None") -> bool:
    """Whether ``Settings.pallas_kernels`` selects the factor-with-inverse
    representation (``settings`` may be None: the plain factor)."""
    return settings is not None and bool(settings.pallas_kernels)


def _pytree_dataclass(cls):
    """Register a dataclass whose fields are all array leaves as a pytree."""
    cls = dataclasses.dataclass(cls)
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_dataclass(cls, data_fields=fields, meta_fields=[])
    cls.replace = dataclasses.replace
    return cls


@_pytree_dataclass
class QPData:
    """Canonical (dense, device-resident) problem data.

    min 0.5 x'Px + c'x  s.t.  Ax = b,  h_l <= Gx <= h_u,
                              x_l <= x_b_scaling * x <= x_u

    Mirrors dense::Data (dense/data.hpp:22-217) with these deltas:
      - P is stored as the *full symmetric* matrix (the reference stores the
        upper triangle; full storage feeds the matrix units directly).
      - bounds are full-length with explicit masks; inactive entries are 0.
      - rows of G whose bounds are both infinite have already been zeroed and
        given the fake bounds [-1, 1] (both active), replicating
        ``disable_inf_constraints`` (dense/data.hpp:144-169).
    """

    P: jax.Array  # (n, n) full symmetric
    c: jax.Array  # (n,)
    A: jax.Array  # (p, n)
    b: jax.Array  # (p,)
    G: jax.Array  # (m, n)
    h_l: jax.Array  # (m,), 0 where ~hl_mask
    h_u: jax.Array  # (m,), 0 where ~hu_mask
    x_l: jax.Array  # (n,), 0 where ~xl_mask
    x_u: jax.Array  # (n,), 0 where ~xu_mask
    x_b_scaling: jax.Array  # (n,)
    hl_mask: jax.Array  # (m,) bool
    hu_mask: jax.Array  # (m,) bool
    xl_mask: jax.Array  # (n,) bool
    xu_mask: jax.Array  # (n,) bool

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def p(self) -> int:
        return self.A.shape[-2]

    @property
    def m(self) -> int:
        return self.G.shape[-2]


@dataclasses.dataclass
class FullKKTQPData(QPData):
    """QPData marker subclass routing the KKT layer to the full 3-block
    dense LU backend (``KKTBackend.dense_lu``).  Identical fields; the
    representation type IS the backend selector (singledispatch)."""


jax.tree_util.register_dataclass(
    FullKKTQPData,
    data_fields=[f.name for f in dataclasses.fields(QPData)],
    meta_fields=[],
)
FullKKTQPData.replace = dataclasses.replace


@dataclasses.dataclass
class LDLTKKTQPData(QPData):
    """QPData marker subclass routing the KKT layer to the full 3-block
    signed-Cholesky backend (``KKTBackend.dense_ldlt``, ops/ldlt.py)."""


jax.tree_util.register_dataclass(
    LDLTKKTQPData,
    data_fields=[f.name for f in dataclasses.fields(QPData)],
    meta_fields=[],
)
LDLTKKTQPData.replace = dataclasses.replace


@_pytree_dataclass
class BasicVars:
    """(x, y, z_l, z_u, z_bl, z_bu) — mirrors BasicVariables (variables.hpp:16-62).

    z_bl/z_bu are full length n (masked), unlike the reference's compressed
    heads.
    """

    x: jax.Array  # (n,)
    y: jax.Array  # (p,)
    z_l: jax.Array  # (m,)
    z_u: jax.Array  # (m,)
    z_bl: jax.Array  # (n,)
    z_bu: jax.Array  # (n,)


@_pytree_dataclass
class Vars:
    """Full variables incl. slacks — mirrors Variables (variables.hpp:64-105)."""

    x: jax.Array
    y: jax.Array
    z_l: jax.Array
    z_u: jax.Array
    z_bl: jax.Array
    z_bu: jax.Array
    s_l: jax.Array
    s_u: jax.Array
    s_bl: jax.Array
    s_bu: jax.Array

    def basic(self) -> BasicVars:
        return BasicVars(self.x, self.y, self.z_l, self.z_u, self.z_bl, self.z_bu)


def zero_basic_vars(n: int, p: int, m: int, dtype) -> BasicVars:
    z = partial(jnp.zeros, dtype=dtype)
    return BasicVars(z(n), z(p), z(m), z(m), z(n), z(n))


def zero_vars(n: int, p: int, m: int, dtype) -> Vars:
    z = partial(jnp.zeros, dtype=dtype)
    return Vars(z(n), z(p), z(m), z(m), z(n), z(n), z(m), z(m), z(n), z(n))


@_pytree_dataclass
class Info:
    """Per-solve metrics, mirrors Info (results.hpp:44-89).

    All fields are scalars (possibly batched under vmap).  Timing fields are
    filled host-side by the API wrapper.
    """

    status: jax.Array  # int32
    iter: jax.Array  # int32
    rho: jax.Array
    delta: jax.Array
    mu: jax.Array
    sigma: jax.Array
    primal_step: jax.Array
    dual_step: jax.Array
    primal_res: jax.Array
    primal_res_rel: jax.Array
    dual_res: jax.Array
    dual_res_rel: jax.Array
    primal_res_reg: jax.Array
    primal_res_reg_rel: jax.Array
    dual_res_reg: jax.Array
    dual_res_reg_rel: jax.Array
    primal_prox_inf: jax.Array
    dual_prox_inf: jax.Array
    prev_primal_res: jax.Array
    prev_dual_res: jax.Array
    primal_obj: jax.Array
    dual_obj: jax.Array
    duality_gap: jax.Array
    duality_gap_rel: jax.Array
    factor_retires: jax.Array  # int32
    reg_limit: jax.Array
    no_primal_update: jax.Array  # int32
    no_dual_update: jax.Array  # int32

    # wall-time metrics (results.hpp:83-88), real pytree leaves so they
    # survive jax.tree.map/vmap; filled host-side by the API wrapper when
    # settings.compute_timings (zeros inside jit).  kkt_factor_time /
    # kkt_solve_time on device backends are ESTIMATES: separately timed
    # probe dispatches scaled by the IPM's dispatch counts (see
    # api._measure_kkt_times) — under XLA fusion the true split inside the
    # fused solve executable can differ, and the two need not sum to
    # solve_time.  Only the host sparse backend reports directly measured
    # factor/solve times.
    setup_time: jax.Array
    update_time: jax.Array
    solve_time: jax.Array
    kkt_factor_time: jax.Array
    kkt_solve_time: jax.Array
    run_time: jax.Array


def init_info(settings: Settings, dtype) -> Info:
    f = lambda v: jnp.asarray(v, dtype=dtype)
    i = lambda v: jnp.asarray(v, dtype=jnp.int32)
    return Info(
        status=i(Status.RUNNING),
        iter=i(0),
        rho=f(settings.rho_init),
        delta=f(settings.delta_init),
        mu=f(0.0),
        sigma=f(0.0),
        primal_step=f(0.0),
        dual_step=f(0.0),
        primal_res=f(jnp.inf),
        primal_res_rel=f(jnp.inf),
        dual_res=f(jnp.inf),
        dual_res_rel=f(jnp.inf),
        primal_res_reg=f(jnp.inf),
        primal_res_reg_rel=f(jnp.inf),
        dual_res_reg=f(jnp.inf),
        dual_res_reg_rel=f(jnp.inf),
        primal_prox_inf=f(0.0),
        dual_prox_inf=f(0.0),
        prev_primal_res=f(jnp.inf),
        prev_dual_res=f(jnp.inf),
        primal_obj=f(0.0),
        dual_obj=f(0.0),
        duality_gap=f(jnp.inf),
        duality_gap_rel=f(jnp.inf),
        factor_retires=i(0),
        reg_limit=f(settings.reg_lower_limit),
        no_primal_update=i(0),
        no_dual_update=i(0),
        setup_time=f(0.0),
        update_time=f(0.0),
        solve_time=f(0.0),
        kkt_factor_time=f(0.0),
        kkt_solve_time=f(0.0),
        run_time=f(0.0),
    )


@_pytree_dataclass
class Result:
    """Solution + info, mirrors Result (results.hpp:91-95)."""

    x: jax.Array
    y: jax.Array
    z_l: jax.Array
    z_u: jax.Array
    z_bl: jax.Array
    z_bu: jax.Array
    s_l: jax.Array
    s_u: jax.Array
    s_bl: jax.Array
    s_bu: jax.Array
    info: Info


@_pytree_dataclass
class Scaling:
    """Ruiz equilibration state (analog of dense::RuizEquilibration's
    c/delta/delta_b, dense/preconditioner.hpp:36-42).

    d_x/d_y/d_z are the head(n)/segment(n,p)/tail(m) pieces of the
    reference's single ``delta`` vector; d_b is ``delta_b``.
    """

    c: jax.Array  # scalar cost scaling
    d_x: jax.Array  # (n,)
    d_y: jax.Array  # (p,)
    d_z: jax.Array  # (m,)
    d_b: jax.Array  # (n,)


def identity_scaling(n: int, p: int, m: int, dtype) -> Scaling:
    o = partial(jnp.ones, dtype=dtype)
    return Scaling(jnp.asarray(1.0, dtype=dtype), o(n), o(p), o(m), o(n))
