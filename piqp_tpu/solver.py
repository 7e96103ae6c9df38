"""The proximal interior-point method (IPM) core.

Accelerator-first re-design of SolverBase::solve_impl and friends
(/root/reference/include/piqp/solver.hpp:379-1259):

- the main iteration is a single ``lax.while_loop`` over a solver-state
  pytree; PIQP's factorization-retry ladder (solver.hpp:446-465, 687-708)
  is an inner while_loop whose state transitions mirror the reference's
  enable-refinement -> boost-regularization -> fail sequence;
- all index-set loops become masked vector ops (see types.py);
- everything is pure w.r.t. (QPData, Scaling) so the whole solve is
  jit-able, vmap-able (batched QPs) and pjit-shardable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from . import kkt, ops
from .types import (
    PIQP_INF,
    BasicVars,
    Info,
    QPData,
    Result,
    Scaling,
    Settings,
    Status,
    Vars,
    init_info,
    zero_vars,
    _pytree_dataclass,
)


@_pytree_dataclass
class IPMState:
    vars: Vars
    prox: BasicVars  # proximal center (xi, lambda, nu) (solver.hpp:53)
    res_nr: BasicVars  # non-regularized residuals
    res: Vars  # regularized residuals / KKT RHS workspace
    ks: kkt.KKTState
    info: Info
    use_ir: jax.Array  # bool: iterative refinement enabled
    P_diag: jax.Array


def _inf_norm(v: jax.Array) -> jax.Array:
    return jnp.max(jnp.abs(v), initial=0.0)


def _masked_signed_max(v: jax.Array, mask: jax.Array) -> jax.Array:
    """max over active entries of the *signed* value, 0 if none.

    The reference takes raw (un-absed) per-index values for the box and
    active-inequality contributions to the relative norms
    (solver.hpp:1047,1066,1081,1139-1143); this mirrors that exactly.
    """
    return jnp.max(jnp.where(mask, v, 0.0), initial=0.0)


# ---------------------------------------------------------------------------
# residuals
# ---------------------------------------------------------------------------

def residuals_nr(
    data: QPData, sc: Scaling, vars: Vars, info: Info, mat32=None
) -> tuple[BasicVars, Info]:
    """Non-regularized residuals, objectives and relative norms
    (solver.hpp:960-1105).

    All P/A/G matvecs ride the fused ``ops.PAG_x``/``ops.add_AtGt`` passes
    and the per-bound masked maxima are stacked into one reduction per
    vector length — max is order-free, so the values are bitwise identical
    to the per-term formulation; only the op count changes.

    ``mat32``: optional f32-matrix copy (kkt.precompute's data32) — the
    matvecs then run in f32 (mixed phase A: residual accuracy ~1e-6
    relative, plenty while mu > mixed_precision_mu_switch; every phase-B
    iteration recomputes in f64, so termination and certificates always
    see full-precision residuals).  Outputs are cast back to the solver
    dtype for loop-carry type stability."""
    x, y = vars.x, vars.y
    dt = x.dtype

    if mat32 is not None:
        f32 = jnp.float32
        Px, Ax, Gx = ops.PAG_x(mat32, x.astype(f32))
        Px, Ax, Gx = Px.astype(dt), Ax.astype(dt), Gx.astype(dt)
    else:
        Px, Ax, Gx = ops.PAG_x(data, x)
    if data.p == 0:
        Ax = jnp.zeros_like(vars.y)
    if data.m == 0:
        Gx = jnp.zeros_like(vars.z_l)
    dz = vars.z_u - vars.z_l

    c_inv = 1.0 / sc.c
    ud_x = sc.d_x * c_inv  # unscale_dual_res factor (preconditioner.hpp:414-417)

    dual_rel = _inf_norm(Px * ud_x)

    # objectives & duality gap (solver.hpp:987-1016)
    xPx = x @ Px
    cx = data.c @ x
    by = data.b @ y if data.p > 0 else jnp.asarray(0.0, x.dtype)
    hlzl = data.h_l @ vars.z_l if data.m > 0 else jnp.asarray(0.0, x.dtype)
    huzu = data.h_u @ vars.z_u if data.m > 0 else jnp.asarray(0.0, x.dtype)
    xlzbl = data.x_l @ vars.z_bl
    xuzbu = data.x_u @ vars.z_bu

    primal_obj = 0.5 * xPx + cx
    dual_obj = -0.5 * xPx - by + hlzl - huzu + xlzbl - xuzbu
    gap_rel_norm = c_inv * jnp.max(
        jnp.stack(
            [jnp.abs(xPx), jnp.abs(cx), jnp.abs(by), jnp.abs(hlzl),
             jnp.abs(huzu), jnp.abs(xlzbl), jnp.abs(xuzbu)]
        )
    )
    duality_gap = jnp.abs(primal_obj - dual_obj) * c_inv
    primal_obj = primal_obj * c_inv
    dual_obj = dual_obj * c_inv
    duality_gap_rel = duality_gap / jnp.maximum(1.0, gap_rel_norm)

    # dual residual (solver.hpp:1018-1032)
    work_x = (
        jnp.where(data.xu_mask, data.x_b_scaling * vars.z_bu, 0.0)
        - jnp.where(data.xl_mask, data.x_b_scaling * vars.z_bl, 0.0)
    )
    if mat32 is not None:
        f32 = jnp.float32
        work_x = ops.add_AtGt(
            mat32, work_x.astype(f32), y.astype(f32), dz.astype(f32)
        ).astype(dt)
    else:
        work_x = ops.add_AtGt(data, work_x, y, dz)
    dual_rel = jnp.maximum(dual_rel, _inf_norm(data.c * ud_x))
    dual_rel = jnp.maximum(dual_rel, _inf_norm(work_x * ud_x))
    res_x = -Px - data.c - work_x

    # primal residuals (solver.hpp:1034-1095): the 12 masked signed maxima
    # collapse to one stacked reduction per vector length
    d_y_inv = 1.0 / sc.d_y
    d_z_inv = 1.0 / sc.d_z
    d_b_inv = 1.0 / sc.d_b

    primal_rel = jnp.maximum(_inf_norm(Ax * d_y_inv), _inf_norm(data.b * d_y_inv))
    res_y = data.b - Ax

    res_z_l = jnp.where(data.hl_mask, Gx - data.h_l - vars.s_l, 0.0)
    res_z_u = jnp.where(data.hu_mask, -Gx + data.h_u - vars.s_u, 0.0)
    m_rows = jnp.stack(
        [Gx, data.h_l, vars.s_l, -Gx, data.h_u, vars.s_u]
    ) * d_z_inv
    m_mask = jnp.stack([data.hl_mask] * 3 + [data.hu_mask] * 3)
    primal_rel = jnp.maximum(
        primal_rel, jnp.max(jnp.where(m_mask, m_rows, 0.0), initial=0.0)
    )

    bx = data.x_b_scaling * x
    res_z_bl = jnp.where(data.xl_mask, bx - data.x_l - vars.s_bl, 0.0)
    res_z_bu = jnp.where(data.xu_mask, -bx + data.x_u - vars.s_bu, 0.0)
    n_rows = jnp.stack(
        [bx, data.x_l, vars.s_bl, -bx, data.x_u, vars.s_bu]
    ) * d_b_inv
    n_mask = jnp.stack([data.xl_mask] * 3 + [data.xu_mask] * 3)
    primal_rel = jnp.maximum(
        primal_rel, jnp.max(jnp.where(n_mask, n_rows, 0.0), initial=0.0)
    )

    res_nr = BasicVars(res_x, res_y, res_z_l, res_z_u, res_z_bl, res_z_bu)

    primal_res = _primal_res_norm(data, sc, res_nr)
    dual_res = _inf_norm(res_x * ud_x)

    info = info.replace(
        prev_primal_res=info.primal_res,
        prev_dual_res=info.dual_res,
        primal_res=primal_res,
        primal_res_rel=primal_res / jnp.maximum(1.0, primal_rel),
        dual_res=dual_res,
        dual_res_rel=dual_res / jnp.maximum(1.0, dual_rel),
        primal_obj=primal_obj,
        dual_obj=dual_obj,
        duality_gap=duality_gap,
        duality_gap_rel=duality_gap_rel,
    )
    return res_nr, info


def _primal_res_norm(data: QPData, sc: Scaling, r) -> jax.Array:
    """Infinity norm of the unscaled primal residual (solver.hpp:1130-1146).

    Box contributions are signed per-index maxima, mirroring the reference.
    Stacked reductions: max is order-free, values bitwise identical.
    """
    inf = _inf_norm(r.y / sc.d_y)
    zm = jnp.abs(jnp.stack([r.z_l, r.z_u])) / sc.d_z
    inf = jnp.maximum(inf, jnp.max(zm, initial=0.0))
    zb = jnp.stack([r.z_bl, r.z_bu]) / sc.d_b
    zb_mask = jnp.stack([data.xl_mask, data.xu_mask])
    inf = jnp.maximum(inf, jnp.max(jnp.where(zb_mask, zb, 0.0), initial=0.0))
    return inf


def residuals_r(
    data: QPData, sc: Scaling, vars: Vars, prox: BasicVars,
    res_nr: BasicVars, res: Vars, info: Info,
) -> tuple[Vars, Info]:
    """Regularized residuals + proximal infeasibility measures
    (solver.hpp:1107-1128)."""
    rho, delta = info.rho, info.delta
    res = res.replace(
        x=res_nr.x - rho * (vars.x - prox.x),
        y=res_nr.y - delta * (prox.y - vars.y),
        z_l=res_nr.z_l - delta * (prox.z_l - vars.z_l),
        z_u=res_nr.z_u - delta * (prox.z_u - vars.z_u),
        z_bl=res_nr.z_bl - delta * (prox.z_bl - vars.z_bl),
        z_bu=res_nr.z_bu - delta * (prox.z_bu - vars.z_bu),
    )

    primal_rel_scaling = jnp.where(
        info.primal_res_rel > 0, info.primal_res / info.primal_res_rel, 1.0
    )
    dual_rel_scaling = jnp.where(
        info.dual_res_rel > 0, info.dual_res / info.dual_res_rel, 1.0
    )

    c_inv = 1.0 / sc.c
    primal_res_reg = _primal_res_norm(data, sc, res)
    dual_res_reg = _inf_norm(res.x * sc.d_x * c_inv)

    # primal_prox_inf (solver.hpp:1166-1182): dual-variable drift from the
    # proximal center, in unscaled dual units.
    ppi = _inf_norm((prox.y - vars.y) * sc.d_y * c_inv)
    ppi = jnp.maximum(ppi, _inf_norm((prox.z_l - vars.z_l) * sc.d_z * c_inv))
    ppi = jnp.maximum(ppi, _inf_norm((prox.z_u - vars.z_u) * sc.d_z * c_inv))
    ppi = jnp.maximum(
        ppi, _masked_signed_max((prox.z_bl - vars.z_bl) * sc.d_b * c_inv, data.xl_mask)
    )
    ppi = jnp.maximum(
        ppi, _masked_signed_max((prox.z_bu - vars.z_bu) * sc.d_b * c_inv, data.xu_mask)
    )

    dpi = _inf_norm((vars.x - prox.x) * sc.d_x)

    info = info.replace(
        primal_res_reg=primal_res_reg,
        primal_res_reg_rel=primal_res_reg / primal_rel_scaling,
        dual_res_reg=dual_res_reg,
        dual_res_reg_rel=dual_res_reg / dual_rel_scaling,
        primal_prox_inf=ppi * info.delta,
        dual_prox_inf=dpi * info.rho,
    )
    return res, info


# ---------------------------------------------------------------------------
# Farkas certificate validation (no reference analog; mirrors
# hostsparse._primal_ray_quality / _farkas_dual_quality — see the
# calibration notes there)
# ---------------------------------------------------------------------------

from .types import (  # noqa: E402  (grouped with the certificate code)
    CERT_EQ_TOL as _CERT_EQ_TOL,
    CERT_NEG_TOL as _CERT_NEG_TOL,
    CERT_SUP_TOL as _CERT_SUP_TOL,
)

_TINY = 1e-30


def _certificate_qualities(data, sc, vars: Vars, prox: BasicVars):
    """Score the proximal drift as unscaled Farkas certificates.

    Returns (p_eq, p_neg, p_sup, d_eq, d_cone, d_obj): for the primal
    certificate (dual-variable drift) the relative stationarity-ray
    residual, worst cone-sign violation relative to the ray norm, and
    normalized support value; for the dual certificate (primal drift) the
    relative P/A-ray residual, worst cone violation, and normalized
    objective slope.  Valid certificates have eq ~ 0, neg/cone ~ 0 and a
    clearly negative sup/obj.  All ratios are computed from scaled
    quantities with the same elementwise unscale factors the residual
    norms use (solver.hpp:1130-1203), so they equal the unscaled-ray
    qualities; ratio quantities are normalization-invariant.
    """
    adata = ops.abs_data(data)
    c_inv = 1.0 / sc.c
    ud_x = sc.d_x * c_inv

    # ---- primal certificate: drift of (y, z_l, z_u, z_bl, z_bu)
    dy = vars.y - prox.y
    dz_l = jnp.where(data.hl_mask, vars.z_l - prox.z_l, 0.0)
    dz_u = jnp.where(data.hu_mask, vars.z_u - prox.z_u, 0.0)
    dz_bl = jnp.where(data.xl_mask, vars.z_bl - prox.z_bl, 0.0)
    dz_bu = jnp.where(data.xu_mask, vars.z_bu - prox.z_bu, 0.0)

    # unscaled ray norm (for the sign-violation ratio)
    norms = jnp.stack([
        _inf_norm(dy * sc.d_y * c_inv),
        _inf_norm(dz_l * sc.d_z * c_inv), _inf_norm(dz_u * sc.d_z * c_inv),
        _inf_norm(jnp.where(data.xl_mask, dz_bl * sc.d_b * c_inv, 0.0)),
        _inf_norm(jnp.where(data.xu_mask, dz_bu * sc.d_b * c_inv, 0.0)),
    ])
    p_norm = jnp.max(norms)
    negs = jnp.stack([
        -jnp.min(dz_l * sc.d_z * c_inv, initial=0.0),
        -jnp.min(dz_u * sc.d_z * c_inv, initial=0.0),
        -jnp.min(jnp.where(data.xl_mask, dz_bl * sc.d_b * c_inv, 0.0), initial=0.0),
        -jnp.min(jnp.where(data.xu_mask, dz_bu * sc.d_b * c_inv, 0.0), initial=0.0),
    ])
    p_neg = jnp.max(negs) / jnp.maximum(p_norm, _TINY)

    xb = data.x_b_scaling
    t = ops.AT_y(data, dy) if data.p > 0 else jnp.zeros_like(vars.x)
    den = ops.AT_y(adata, jnp.abs(dy)) if data.p > 0 else jnp.zeros_like(vars.x)
    if data.m > 0:
        t = t + ops.GT_z(data, dz_u - dz_l)
        den = den + ops.GT_z(adata, jnp.abs(dz_u) + jnp.abs(dz_l))
    t = t - jnp.where(data.xl_mask, xb * dz_bl, 0.0)
    t = t + jnp.where(data.xu_mask, xb * dz_bu, 0.0)
    den = den + jnp.where(data.xl_mask, xb * jnp.abs(dz_bl), 0.0)
    den = den + jnp.where(data.xu_mask, xb * jnp.abs(dz_bu), 0.0)
    p_eq = _inf_norm(t * ud_x) / jnp.maximum(
        jnp.max(den * ud_x, initial=0.0), _TINY
    )

    sup = data.x_u @ dz_bu - data.x_l @ dz_bl
    sup_den = jnp.abs(data.x_u) @ jnp.abs(dz_bu) + jnp.abs(data.x_l) @ jnp.abs(dz_bl)
    if data.p > 0:
        sup = sup + data.b @ dy
        sup_den = sup_den + jnp.abs(data.b) @ jnp.abs(dy)
    if data.m > 0:
        sup = sup + data.h_u @ dz_u - data.h_l @ dz_l
        sup_den = sup_den + jnp.abs(data.h_u) @ jnp.abs(dz_u)
        sup_den = sup_den + jnp.abs(data.h_l) @ jnp.abs(dz_l)
    p_sup = sup / jnp.maximum(sup_den, _TINY)
    # an empty ray is not a certificate
    p_eq = jnp.where(p_norm > 0, p_eq, jnp.inf)

    # ---- dual certificate: drift of x
    dx = vars.x - prox.x
    d_norm = _inf_norm(dx * sc.d_x)
    t1 = ops.P_x(data, dx) * ud_x
    den1 = ops.P_x(adata, jnp.abs(dx)) * ud_x
    d_eq_t = _inf_norm(t1)
    d_eq_den = jnp.max(den1, initial=0.0)
    if data.p > 0:
        t2 = ops.A_x(data, dx) / sc.d_y
        den2 = ops.A_x(adata, jnp.abs(dx)) / sc.d_y
        d_eq_t = jnp.maximum(d_eq_t, _inf_norm(t2))
        d_eq_den = jnp.maximum(d_eq_den, jnp.max(den2, initial=0.0))
    d_eq = d_eq_t / jnp.maximum(d_eq_den, _TINY)
    d_eq = jnp.where(d_norm > 0, d_eq, jnp.inf)

    cone = jnp.asarray(0.0, dx.dtype)
    if data.m > 0:
        gdx = ops.G_x(data, dx) / sc.d_z
        gden = jnp.maximum(ops.G_x(adata, jnp.abs(dx)) / sc.d_z, _TINY)
        cone = jnp.maximum(
            _masked_signed_max(gdx / gden, data.hu_mask),
            _masked_signed_max(-gdx / gden, data.hl_mask),
        )
    bdx = xb * dx / sc.d_b / jnp.maximum(d_norm, _TINY)
    cone = jnp.maximum(cone, _masked_signed_max(bdx, data.xu_mask))
    d_cone = jnp.maximum(cone, _masked_signed_max(-bdx, data.xl_mask))

    d_obj = (data.c @ dx) / jnp.maximum(jnp.abs(data.c) @ jnp.abs(dx), _TINY)
    return p_eq, p_neg, p_sup, d_eq, d_cone, d_obj


def _violation_certificate(data, sc, vars: Vars):
    """Unscaled Farkas ray candidate from the constraint violations of the
    final iterate (mirrors hostsparse._violation_primal_ray), plus its
    (eq_rel, sup_rel) quality.  Sign violations are structurally zero."""
    adata = ops.abs_data(data)
    x = vars.x
    dtype = x.dtype

    dy = (ops.A_x(data, x) - data.b) / sc.d_y if data.p > 0 else jnp.zeros_like(vars.y)
    if data.m > 0:
        gx = ops.G_x(data, x) / sc.d_z
        dz_u = jnp.where(data.hu_mask, jnp.maximum(gx - data.h_u / sc.d_z, 0.0), 0.0)
        dz_l = jnp.where(data.hl_mask, jnp.maximum(data.h_l / sc.d_z - gx, 0.0), 0.0)
    else:
        dz_u = dz_l = jnp.zeros_like(vars.z_l)
    bx = data.x_b_scaling * x / sc.d_b
    dz_bu = jnp.where(data.xu_mask, jnp.maximum(bx - data.x_u / sc.d_b, 0.0), 0.0)
    dz_bl = jnp.where(data.xl_mask, jnp.maximum(data.x_l / sc.d_b - bx, 0.0), 0.0)

    # unscaled-matvec identities: A_s = D_y A D_x  =>  A' w = [A_s' (w/d_y)] / d_x
    t = ops.AT_y(data, dy / sc.d_y) / sc.d_x if data.p > 0 else jnp.zeros_like(x)
    den = ops.AT_y(adata, jnp.abs(dy) / sc.d_y) / sc.d_x if data.p > 0 else jnp.zeros_like(x)
    if data.m > 0:
        t = t + ops.GT_z(data, (dz_u - dz_l) / sc.d_z) / sc.d_x
        den = den + ops.GT_z(adata, (dz_u + dz_l) / sc.d_z) / sc.d_x
    t = t + dz_bu - dz_bl
    den = den + dz_bu + dz_bl
    eq_rel = _inf_norm(t) / jnp.maximum(jnp.max(den, initial=0.0), _TINY)

    b_u = data.b / sc.d_y if data.p > 0 else vars.y
    hu_u = data.h_u / sc.d_z
    hl_u = data.h_l / sc.d_z
    xu_u = data.x_u / sc.d_b
    xl_u = data.x_l / sc.d_b
    sup = b_u @ dy + hu_u @ dz_u - hl_u @ dz_l + xu_u @ dz_bu - xl_u @ dz_bl
    sup_den = (
        jnp.abs(b_u) @ jnp.abs(dy) + jnp.abs(hu_u) @ dz_u + jnp.abs(hl_u) @ dz_l
        + jnp.abs(xu_u) @ dz_bu + jnp.abs(xl_u) @ dz_bl
    )
    sup_rel = sup / jnp.maximum(sup_den, _TINY)

    norm = jnp.max(jnp.stack([
        _inf_norm(dy), _inf_norm(dz_l), _inf_norm(dz_u),
        _inf_norm(dz_bl), _inf_norm(dz_bu),
    ]))
    eq_rel = jnp.where(norm > 0, eq_rel, jnp.asarray(jnp.inf, dtype))
    return (dy, dz_l, dz_u, dz_bl, dz_bu), eq_rel, sup_rel, norm


def _posthoc_certificates(data, sc, settings, state: IPMState, result: Result):
    """Post-hoc certificate search at max_iter (mirrors the host chain in
    hostsparse.solve_host — same order: drift-primal, drift-dual,
    violation ray — minus the phase-1 QP which stays host-side): an
    infeasible problem can freeze at a proximal equilibrium where the
    stall counters never trip; certify from a *validated* ray instead.
    The whole search runs under lax.cond so converged solves pay nothing.
    """

    def search(result):
        vars, prox = state.vars, state.prox
        p_eq, p_neg, p_sup, d_eq, d_cone, d_obj = _certificate_qualities(
            data, sc, vars, prox
        )
        drift_p = (
            (p_eq <= _CERT_EQ_TOL) & (p_neg <= _CERT_NEG_TOL)
            & (p_sup <= -_CERT_SUP_TOL)
        )
        drift_d = (
            (d_eq <= _CERT_EQ_TOL) & (d_cone <= _CERT_NEG_TOL)
            & (d_obj <= -_CERT_SUP_TOL)
        )
        vray, v_eq, v_sup, v_norm = _violation_certificate(data, sc, vars)
        viol_p = (v_eq <= _CERT_EQ_TOL) & (v_sup <= -_CERT_SUP_TOL)

        # host-chain order: drift-primal, then drift-dual, then violation
        cert_p_drift = drift_p
        cert_d = ~drift_p & drift_d
        cert_p_viol = ~drift_p & ~drift_d & viol_p

        status = jnp.where(
            cert_p_drift | cert_p_viol,
            int(Status.PRIMAL_INFEASIBLE),
            jnp.where(cert_d, int(Status.DUAL_INFEASIBLE), result.info.status),
        ).astype(jnp.int32)

        # return the validated ray (unscaled, unit inf-norm) as the
        # certificate, exactly like the host backend
        c_inv = 1.0 / sc.c
        dray = (
            (vars.y - prox.y) * sc.d_y * c_inv,
            jnp.where(data.hl_mask, (vars.z_l - prox.z_l) * sc.d_z * c_inv, 0.0),
            jnp.where(data.hu_mask, (vars.z_u - prox.z_u) * sc.d_z * c_inv, 0.0),
            jnp.where(data.xl_mask, (vars.z_bl - prox.z_bl) * sc.d_b * c_inv, 0.0),
            jnp.where(data.xu_mask, (vars.z_bu - prox.z_bu) * sc.d_b * c_inv, 0.0),
        )
        d_norm = jnp.maximum(jnp.max(jnp.stack([_inf_norm(r) for r in dray])), _TINY)
        v_nrm = jnp.maximum(v_norm, _TINY)

        def pick(drift_c, viol_c, old):
            return jnp.where(
                cert_p_drift, drift_c / d_norm,
                jnp.where(cert_p_viol, viol_c / v_nrm, old),
            )

        return result.replace(
            y=pick(dray[0], vray[0], result.y),
            z_l=pick(dray[1], vray[1], result.z_l),
            z_u=pick(dray[2], vray[2], result.z_u),
            z_bl=pick(dray[3], vray[3], result.z_bl),
            z_bu=pick(dray[4], vray[4], result.z_bu),
            info=result.info.replace(status=status),
        )

    return lax.cond(
        result.info.status == int(Status.MAX_ITER_REACHED),
        search, lambda r: r, result,
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _bound_count(data: QPData):
    return (
        jnp.sum(data.hl_mask)
        + jnp.sum(data.hu_mask)
        + jnp.sum(data.xl_mask)
        + jnp.sum(data.xu_mask)
    ).astype(data.c.dtype)


def calculate_mu(data: QPData, v: Vars) -> jax.Array:
    """Complementarity measure (solver.hpp:884-891).  Inactive entries hold
    exact zeros, so the plain dot products match the reference's
    index-compressed ones."""
    total = v.s_l @ v.z_l + v.s_u @ v.z_u + v.s_bl @ v.z_bl + v.s_bu @ v.z_bu
    return total / _bound_count(data)


def calculate_step(v: Vars, step: Vars, data: QPData):
    """Fraction-to-the-boundary min-ratio test (solver.hpp:893-958), as four
    stacked masked reductions (the reference parallelizes this loop with
    OpenMP; here each is a single fused pass — min is order-free, so
    stacking the slack/dual pairs is bitwise identical)."""

    def ratio(val, stp, mask):
        neg = jnp.logical_and(mask, stp < 0)
        return jnp.min(
            jnp.where(neg, -val / jnp.where(neg, stp, -1.0), 1.0), initial=1.0
        )

    m_mask = jnp.stack([data.hl_mask, data.hu_mask])
    n_mask = jnp.stack([data.xl_mask, data.xu_mask])
    alpha_s = jnp.minimum(
        ratio(jnp.stack([v.s_l, v.s_u]), jnp.stack([step.s_l, step.s_u]),
              m_mask),
        ratio(jnp.stack([v.s_bl, v.s_bu]), jnp.stack([step.s_bl, step.s_bu]),
              n_mask),
    )
    alpha_z = jnp.minimum(
        ratio(jnp.stack([v.z_l, v.z_u]), jnp.stack([step.z_l, step.z_u]),
              m_mask),
        ratio(jnp.stack([v.z_bl, v.z_bu]), jnp.stack([step.z_bl, step.z_bu]),
              n_mask),
    )
    return alpha_s, alpha_z


def factor_ladder(
    data: QPData, settings: Settings, P_diag, vars: Vars, info: Info, use_ir,
    mixed: bool = False, pre=None,
):
    """Factor with the numerics-recovery ladder (solver.hpp:446-465, 687-708):
    on failure first enable iterative refinement, then boost rho/delta x100 up
    to max_factor_retires times, else give up (-> NUMERICS).

    ``mixed`` selects a float32 factorization (iterative refinement against
    the float64 target recovers accuracy; the factor is only a
    preconditioner).  Returns (ks, info, use_ir, failed).
    """

    def attempt(rho, delta, ir):
        ks = kkt.compute_scalings(data, settings, vars, rho, delta, ir, P_diag)
        return kkt.factor(data, ks, mixed, pre)

    ks, ok = attempt(info.rho, info.delta, use_ir)
    carry = (info.rho, info.delta, info.factor_retires, info.reg_limit,
             use_ir, ks, ok, jnp.asarray(False))

    def cond(c):
        ok, failed = c[6], c[7]
        return jnp.logical_and(~ok, ~failed)

    def body(c):
        rho, delta, retries, reg_limit, ir, ks, ok, failed = c
        can_boost = retries < settings.max_factor_retires
        boost = jnp.logical_and(ir, can_boost)
        failed = jnp.logical_and(ir, ~can_boost)
        rho = jnp.where(boost, rho * 100.0, rho)
        delta = jnp.where(boost, delta * 100.0, delta)
        reg_limit = jnp.where(
            boost, jnp.minimum(10.0 * reg_limit, settings.eps_abs), reg_limit
        )
        retries = jnp.where(boost, retries + 1, retries)
        ir_new = jnp.asarray(True)

        def refactor(_):
            return attempt(rho, delta, ir_new)

        ks, ok = lax.cond(failed, lambda _: (ks, ok), refactor, None)
        return (rho, delta, retries, reg_limit, ir_new, ks, ok, failed)

    rho, delta, retries, reg_limit, use_ir, ks, ok, failed = lax.while_loop(
        cond, body, carry
    )
    info = info.replace(
        rho=rho,
        delta=delta,
        # reference resets the retry counter after success (solver.hpp:466,709)
        factor_retires=jnp.where(failed, retries, jnp.zeros_like(retries)),
        reg_limit=reg_limit,
    )
    return ks, info, use_ir, failed


# ---------------------------------------------------------------------------
# init (solver.hpp:398-577)
# ---------------------------------------------------------------------------

def _warm_vars(data: QPData, sc: Scaling, warm: BasicVars) -> Vars:
    """Scale a user-space warm-start point (x, y, z_*) into the equilibrated
    IPM space (inverse of ``_finalize``) and derive the primal slacks from
    the constraint values.  Negative duals are clipped to the cone; slacks
    may come out negative here — ``_init_state``'s shift/recenter pushes the
    whole point strictly into the interior.

    The reference has no warm-start API (its ``solve()`` always cold-starts,
    solver.hpp:398-577); this is an addition serving the batched
    MPC/SQP regime, where re-solves after small parameter updates dominate.
    """
    x = warm.x / sc.d_x
    y = warm.y * sc.c / sc.d_y

    def cone_dual(z, d, mask):
        return jnp.where(mask, jnp.maximum(z * sc.c / d, 0.0), 0.0)

    z_l = cone_dual(warm.z_l, sc.d_z, data.hl_mask)
    z_u = cone_dual(warm.z_u, sc.d_z, data.hu_mask)
    z_bl = cone_dual(warm.z_bl, sc.d_b, data.xl_mask)
    z_bu = cone_dual(warm.z_bu, sc.d_b, data.xu_mask)

    Gx = ops.G_x(data, x) if data.m > 0 else jnp.zeros_like(z_l)
    bx = data.x_b_scaling * x
    s_l = jnp.where(data.hl_mask, Gx - data.h_l, 0.0)
    s_u = jnp.where(data.hu_mask, data.h_u - Gx, 0.0)
    s_bl = jnp.where(data.xl_mask, bx - data.x_l, 0.0)
    s_bu = jnp.where(data.xu_mask, data.x_u - bx, 0.0)
    return Vars(
        x=x, y=y, z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu,
        s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu,
    )


def _init_state(
    data: QPData, sc: Scaling, settings: Settings, has_cone: bool,
    mixed: bool = False, pre=None, warm: BasicVars | None = None,
) -> tuple[IPMState, jax.Array]:
    dtype = data.c.dtype
    n, p, m = data.n, data.p, data.m

    info = init_info(settings, dtype)
    P_diag = ops.P_diag(data)

    one_m_l = jnp.where(data.hl_mask, 1.0, 0.0).astype(dtype)
    one_m_u = jnp.where(data.hu_mask, 1.0, 0.0).astype(dtype)
    one_n_l = jnp.where(data.xl_mask, 1.0, 0.0).astype(dtype)
    one_n_u = jnp.where(data.xu_mask, 1.0, 0.0).astype(dtype)

    vars0 = Vars(
        x=jnp.zeros(n, dtype), y=jnp.zeros(p, dtype),
        z_l=one_m_l, z_u=one_m_u, z_bl=one_n_l, z_bu=one_n_u,
        s_l=one_m_l, s_u=one_m_u, s_bl=one_n_l, s_bu=one_n_u,
    )
    if warm is not None:
        vars0 = _warm_vars(data, sc, warm)
        if has_cone:
            # warm interior push BEFORE the factorization: negative or zero
            # warm slacks must not reach the KKT scalings.  Elementwise
            # sqrt(mu_ws) clamp PRESERVES the warm primal slacks and duals
            # (the cold recenter below rebuilds s from z with s*z = mu,
            # which would discard the warm primal information and start
            # with huge primal residuals on inactive constraints).
            eps_ws = jnp.sqrt(jnp.asarray(settings.warm_start_mu, dtype))

            def push(v, mask):
                return jnp.where(mask, jnp.maximum(v, eps_ws), 0.0)

            vars0 = vars0.replace(
                s_l=push(vars0.s_l, data.hl_mask),
                s_u=push(vars0.s_u, data.hu_mask),
                s_bl=push(vars0.s_bl, data.xl_mask),
                s_bu=push(vars0.s_bu, data.xu_mask),
                z_l=push(vars0.z_l, data.hl_mask),
                z_u=push(vars0.z_u, data.hu_mask),
                z_bl=push(vars0.z_bl, data.xl_mask),
                z_bu=push(vars0.z_bu, data.xu_mask),
            )

    use_ir = jnp.asarray(
        settings.iterative_refinement_always_enabled or settings.mixed_precision
    )
    if warm is not None:
        # warm start performs no init KKT solve, and the first iteration
        # refactors before its first solve — so the init factorization is
        # dead work.  Build the KKT state with a placeholder factor
        # instead.
        ks = kkt.compute_scalings(
            data, settings, vars0, info.rho, info.delta, use_ir, P_diag
        )  # leaves L as the empty_factor placeholder
        failed = jnp.asarray(False)
    else:
        ks, info, use_ir, failed = factor_ladder(
            data, settings, P_diag, vars0, info, use_ir, mixed, pre
        )

    if warm is not None:
        # warm start: the iterates ARE the init point; no init KKT solve
        vars = vars0
        res = jax.tree.map(jnp.zeros_like, Vars(
            x=vars0.x, y=vars0.y,
            z_l=vars0.z_l, z_u=vars0.z_u, z_bl=vars0.z_bl, z_bu=vars0.z_bu,
            s_l=vars0.s_l, s_u=vars0.s_u, s_bl=vars0.s_bl, s_bu=vars0.s_bu,
        ))
    else:
        # first KKT solve from the raw problem vectors (solver.hpp:473-492)
        res = Vars(
            x=-data.c,
            y=data.b,
            z_l=jnp.where(data.hl_mask, -data.h_l, 0.0),
            z_u=jnp.where(data.hu_mask, data.h_u, 0.0),
            z_bl=jnp.where(data.xl_mask, -data.x_l, 0.0),
            z_bu=jnp.where(data.xu_mask, data.x_u, 0.0),
            s_l=jnp.zeros(m, dtype), s_u=jnp.zeros(m, dtype),
            s_bl=jnp.zeros(n, dtype), s_bu=jnp.zeros(n, dtype),
        )
        vars, _ = kkt.solve(data, settings, ks, res)

    if has_cone and warm is not None:
        # interior push already applied to vars0 above (pre-factorization)
        info = info.replace(mu=calculate_mu(data, vars))
    elif has_cone:
        # shift slacks/duals strictly positive and mu-recenter
        # (solver.hpp:504-570)
        neg_mins = jnp.stack([
            -jnp.min(vars.s_l, initial=0.0), -jnp.min(vars.s_u, initial=0.0),
            -jnp.min(vars.s_bl, initial=0.0), -jnp.min(vars.s_bu, initial=0.0),
        ])
        delta_s = jnp.maximum(0.0, jnp.max(neg_mins))
        neg_mins_z = jnp.stack([
            -jnp.min(vars.z_l, initial=0.0), -jnp.min(vars.z_u, initial=0.0),
            -jnp.min(vars.z_bl, initial=0.0), -jnp.min(vars.z_bu, initial=0.0),
        ])
        delta_z = jnp.maximum(0.0, jnp.max(neg_mins_z))

        def shift(v, d, mask):
            return jnp.where(mask, v + d, 0.0)

        vars = vars.replace(
            s_l=shift(vars.s_l, delta_s, data.hl_mask),
            s_u=shift(vars.s_u, delta_s, data.hu_mask),
            s_bl=shift(vars.s_bl, delta_s, data.xl_mask),
            s_bu=shift(vars.s_bu, delta_s, data.xu_mask),
            z_l=shift(vars.z_l, delta_z, data.hl_mask),
            z_u=shift(vars.z_u, delta_z, data.hu_mask),
            z_bl=shift(vars.z_bl, delta_z, data.xl_mask),
            z_bu=shift(vars.z_bu, delta_z, data.xu_mask),
        )

        mu = jnp.maximum(calculate_mu(data, vars), 1e-10)

        def recenter(z, mask):
            c0 = z - delta_z
            z_new = 0.5 * (c0 + jnp.sqrt(c0 * c0 + 4.0 * mu))
            return jnp.where(mask, z_new, 0.0), jnp.where(mask, z_new - c0, 0.0)

        z_l, s_l = recenter(vars.z_l, data.hl_mask)
        z_u, s_u = recenter(vars.z_u, data.hu_mask)
        z_bl, s_bl = recenter(vars.z_bl, data.xl_mask)
        z_bu, s_bu = recenter(vars.z_bu, data.xu_mask)
        vars = vars.replace(
            z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu,
            s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu,
        )
        info = info.replace(mu=calculate_mu(data, vars))

    prox = BasicVars(
        x=vars.x, y=vars.y, z_l=vars.z_l, z_u=vars.z_u,
        z_bl=vars.z_bl, z_bu=vars.z_bu,
    )

    res_nr, info = residuals_nr(data, sc, vars, info)
    # iter == 0 bootstrap of prev residuals (solver.hpp:581-586)
    info = info.replace(
        prev_primal_res=info.primal_res, prev_dual_res=info.dual_res
    )

    info = info.replace(
        status=jnp.where(
            failed, jnp.asarray(int(Status.NUMERICS), jnp.int32), info.status
        )
    )

    if mixed:
        # the init factor/solve ran in f32; hand back a solver-dtype
        # factor so every loop carry in solve_scaled is type-stable
        ks = ks.replace(L=jax.tree.map(
            lambda a: a.astype(dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a,
            ks.L,
        ))
    state = IPMState(
        vars=vars, prox=prox, res_nr=res_nr, res=res, ks=ks, info=info,
        use_ir=use_ir, P_diag=P_diag,
    )
    return state, failed


# ---------------------------------------------------------------------------
# one IPM iteration (solver.hpp:579-878)
# ---------------------------------------------------------------------------

def _check_termination(data, sc, settings, st: IPMState) -> IPMState:
    info = st.info
    converged = jnp.logical_and(
        jnp.logical_or(
            info.primal_res < settings.eps_abs,
            info.primal_res_rel < settings.eps_rel,
        ),
        jnp.logical_or(
            info.dual_res < settings.eps_abs, info.dual_res_rel < settings.eps_rel
        ),
    )
    if settings.check_duality_gap:
        converged = jnp.logical_and(
            converged,
            jnp.logical_or(
                info.duality_gap < settings.eps_duality_gap_abs,
                info.duality_gap_rel < settings.eps_duality_gap_rel,
            ),
        )

    res, info = residuals_r(data, sc, st.vars, st.prox, st.res_nr, st.res, info)

    primal_inf = jnp.logical_and(
        info.no_dual_update
        > min(5, settings.reg_finetune_dual_update_threshold),
        jnp.logical_and(
            info.primal_prox_inf > settings.infeasibility_threshold,
            jnp.logical_or(
                info.primal_res_reg < settings.eps_abs,
                info.primal_res_reg_rel < settings.eps_rel,
            ),
        ),
    )
    dual_inf = jnp.logical_and(
        info.no_primal_update
        > min(5, settings.reg_finetune_primal_update_threshold),
        jnp.logical_and(
            info.dual_prox_inf > settings.infeasibility_threshold,
            jnp.logical_or(
                info.dual_res_reg < settings.eps_abs,
                info.dual_res_reg_rel < settings.eps_rel,
            ),
        ),
    )

    status = jnp.where(
        converged,
        int(Status.SOLVED),
        jnp.where(
            primal_inf,
            int(Status.PRIMAL_INFEASIBLE),
            jnp.where(dual_inf, int(Status.DUAL_INFEASIBLE), int(Status.RUNNING)),
        ),
    ).astype(jnp.int32)
    return st.replace(res=res, info=info.replace(status=status))


def _iteration(
    data, sc, settings, has_cone, st: IPMState, mixed: bool = False, pre=None
) -> IPMState:
    # f32 matrix copies for the phase-A matvecs (hoisted by precompute)
    mat32 = pre.get("data32") if (mixed and isinstance(pre, dict)) else None
    info = st.info.replace(iter=st.info.iter + 1)
    vars = st.vars
    eps = float(jnp.finfo(data.c.dtype).eps)

    # boundary guard (solver.hpp:634-666): per-entry shift for inequality
    # duals, whole-vector shift for box duals.
    if has_cone:
        shifted_l = jnp.logical_and(data.hl_mask, vars.z_l < eps)
        shifted_u = jnp.logical_and(data.hu_mask, vars.z_u < eps)
        z_l = jnp.where(shifted_l, vars.z_l + eps, vars.z_l)
        z_u = jnp.where(shifted_u, vars.z_u + eps, vars.z_u)
        bl_any = jnp.any(jnp.logical_and(data.xl_mask, vars.z_bl < eps))
        bu_any = jnp.any(jnp.logical_and(data.xu_mask, vars.z_bu < eps))
        z_bl = jnp.where(
            jnp.logical_and(bl_any, data.xl_mask), vars.z_bl + eps, vars.z_bl
        )
        z_bu = jnp.where(
            jnp.logical_and(bu_any, data.xu_mask), vars.z_bu + eps, vars.z_bu
        )
        any_shift = jnp.any(shifted_l) | jnp.any(shifted_u) | bl_any | bu_any
        vars = vars.replace(z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu)
        info = info.replace(
            mu=jnp.where(any_shift, calculate_mu(data, vars), info.mu)
        )

    # regularization fine-tuning (solver.hpp:668-681)
    finetune_trigger = jnp.logical_or(
        jnp.logical_and(
            info.no_primal_update > settings.reg_finetune_primal_update_threshold,
            jnp.logical_and(
                info.rho == info.reg_limit,
                info.reg_limit != settings.reg_finetune_lower_limit,
            ),
        ),
        jnp.logical_and(
            info.no_dual_update > settings.reg_finetune_dual_update_threshold,
            jnp.logical_and(
                info.delta == info.reg_limit,
                info.reg_limit != settings.reg_finetune_lower_limit,
            ),
        ),
    )
    finetune = jnp.logical_and(
        finetune_trigger,
        jnp.logical_and(
            info.dual_prox_inf < settings.infeasibility_threshold,
            info.primal_prox_inf < settings.infeasibility_threshold,
        ),
    )
    info = info.replace(
        reg_limit=jnp.where(
            finetune, settings.reg_finetune_lower_limit, info.reg_limit
        ),
        no_primal_update=jnp.where(finetune, 0, info.no_primal_update),
        no_dual_update=jnp.where(finetune, 0, info.no_dual_update),
    )

    # factorization with recovery ladder
    ks, info, use_ir, failed = factor_ladder(
        data, settings, st.P_diag, vars, info, st.use_ir, mixed, pre
    )
    st = st.replace(vars=vars, ks=ks, info=info, use_ir=use_ir)

    def numerics(st):
        return st.replace(
            info=st.info.replace(
                status=jnp.asarray(int(Status.NUMERICS), jnp.int32)
            )
        )

    def proceed(st):
        # recompute regularized residuals with the (possibly boosted)
        # rho/delta (solver.hpp:716-718); also refreshes them after the
        # boundary shift above.
        res, info = residuals_r(
            data, sc, st.vars, st.prox, st.res_nr, st.res, st.info
        )
        st = st.replace(res=res, info=info)
        if has_cone:
            return _centering_step(data, sc, settings, st, mat32)
        return _equality_only_step(data, sc, settings, st, mat32)

    return lax.cond(failed, numerics, proceed, st)


def _centering_step(data, sc, settings, st: IPMState, mat32=None) -> IPMState:
    """Mehrotra predictor-corrector step (solver.hpp:720-829)."""
    vars, res, info, ks = st.vars, st.res, st.info, st.ks

    # ---- predictor (solver.hpp:722-737)
    res = res.replace(
        s_l=-vars.s_l * vars.z_l,
        s_u=-vars.s_u * vars.z_u,
        s_bl=-vars.s_bl * vars.z_bl,
        s_bu=-vars.s_bu * vars.z_bu,
    )
    step, _ = kkt.solve(data, settings, ks, res, info.mu, mat32)

    alpha_s, alpha_z = calculate_step(vars, step, data)
    alpha_s = alpha_s * settings.tau
    alpha_z = alpha_z * settings.tau

    # centering parameter sigma (solver.hpp:747-753)
    sigma = (vars.s_l + alpha_s * step.s_l) @ (vars.z_l + alpha_z * step.z_l)
    sigma += (vars.s_u + alpha_s * step.s_u) @ (vars.z_u + alpha_z * step.z_u)
    sigma += (vars.s_bl + alpha_s * step.s_bl) @ (vars.z_bl + alpha_z * step.z_bl)
    sigma += (vars.s_bu + alpha_s * step.s_bu) @ (vars.z_bu + alpha_z * step.z_bu)
    sigma = sigma / (info.mu * _bound_count(data))
    sigma = jnp.clip(sigma, 0.0, 1.0) ** 3

    # ---- corrector (solver.hpp:755-769)
    sm = sigma * info.mu
    res = res.replace(
        s_l=res.s_l + jnp.where(data.hl_mask, -step.s_l * step.z_l + sm, 0.0),
        s_u=res.s_u + jnp.where(data.hu_mask, -step.s_u * step.z_u + sm, 0.0),
        s_bl=res.s_bl + jnp.where(data.xl_mask, -step.s_bl * step.z_bl + sm, 0.0),
        s_bu=res.s_bu + jnp.where(data.xu_mask, -step.s_bu * step.z_bu + sm, 0.0),
    )
    step, _ = kkt.solve(data, settings, ks, res, info.mu, mat32)

    alpha_s, alpha_z = calculate_step(vars, step, data)

    # ---- Gondzio multiple centrality correctors (opt-in; no reference
    # analog).  Each round aims the outlier complementarity products of an
    # enlarged trial step back into [beta_min, beta_max] x sigma*mu and
    # re-solves with the SAME factorization; the round is kept only if it
    # lengthens the step (monotone by construction).  Static count, so
    # centrality_correctors=0 traces byte-identically to the reference
    # algorithm (Gondzio 1996, "Multiple centrality corrections in a
    # primal-dual method").
    if settings.centrality_correctors > 0:
        _DA, _BMIN, _BMAX, _GAMMA = 0.1, 0.1, 10.0, 0.01
        mu_g = sigma * info.mu

        def _gondzio_round(carry):
            step, alpha_s, alpha_z, res = carry
            a_s_t = jnp.minimum(alpha_s + _DA, 1.0)
            a_z_t = jnp.minimum(alpha_z + _DA, 1.0)

            def corr(s, z, ds, dz, mask):
                v = (s + a_s_t * ds) * (z + a_z_t * dz)
                t = jnp.clip(v, _BMIN * mu_g, _BMAX * mu_g)
                return jnp.where(mask, t - v, 0.0)

            res_t = res.replace(
                s_l=res.s_l + corr(vars.s_l, vars.z_l, step.s_l, step.z_l,
                                   data.hl_mask),
                s_u=res.s_u + corr(vars.s_u, vars.z_u, step.s_u, step.z_u,
                                   data.hu_mask),
                s_bl=res.s_bl + corr(vars.s_bl, vars.z_bl, step.s_bl,
                                     step.z_bl, data.xl_mask),
                s_bu=res.s_bu + corr(vars.s_bu, vars.z_bu, step.s_bu,
                                     step.z_bu, data.xu_mask),
            )
            step_t, _ = kkt.solve(data, settings, ks, res_t, info.mu, mat32)
            a_s2, a_z2 = calculate_step(vars, step_t, data)
            accept = jnp.logical_and(
                jnp.logical_and(a_s2 >= alpha_s, a_z2 >= alpha_z),
                a_s2 + a_z2 > alpha_s + alpha_z + _GAMMA * _DA,
            )
            pick = lambda n, o: jnp.where(accept, n, o)
            step = jax.tree.map(pick, step_t, step)
            res = jax.tree.map(pick, res_t, res)
            return (step, pick(a_s2, alpha_s), pick(a_z2, alpha_z), res)

        carry = (step, alpha_s, alpha_z, res)
        for _ in range(settings.centrality_correctors):
            carry = _gondzio_round(carry)
        step, alpha_s, alpha_z, res = carry

    primal_step = alpha_s * settings.tau
    dual_step = alpha_z * settings.tau

    # ---- update (solver.hpp:778-792)
    vars = Vars(
        x=vars.x + primal_step * step.x,
        y=vars.y + dual_step * step.y,
        z_l=vars.z_l + dual_step * step.z_l,
        z_u=vars.z_u + dual_step * step.z_u,
        z_bl=vars.z_bl + dual_step * step.z_bl,
        z_bu=vars.z_bu + dual_step * step.z_bu,
        s_l=vars.s_l + primal_step * step.s_l,
        s_u=vars.s_u + primal_step * step.s_u,
        s_bl=vars.s_bl + primal_step * step.s_bl,
        s_bu=vars.s_bu + primal_step * step.s_bu,
    )

    mu_prev = info.mu
    mu = calculate_mu(data, vars)
    mu_rate = jnp.maximum(0.0, (mu_prev - mu) / mu_prev)
    info = info.replace(
        mu=mu, sigma=sigma, primal_step=primal_step, dual_step=dual_step
    )

    res_nr, info = residuals_nr(data, sc, vars, info, mat32)

    # ---- proximal parameter updates (solver.hpp:794-829)
    prox = st.prox
    dual_progress = jnp.logical_or(
        info.dual_res < 0.95 * info.prev_dual_res,
        jnp.logical_or(
            jnp.logical_or(
                info.dual_res < settings.eps_abs,
                info.dual_res_rel < settings.eps_rel,
            ),
            jnp.logical_and(
                info.rho == settings.reg_finetune_lower_limit,
                info.dual_prox_inf < settings.infeasibility_threshold,
            ),
        ),
    )
    new_prox_x = jnp.where(dual_progress, vars.x, prox.x)
    rho_fast = jnp.maximum(info.reg_limit, (1.0 - mu_rate) * info.rho)
    rho_slow_ok = jnp.logical_or(
        info.iter < 5, info.dual_prox_inf < settings.infeasibility_threshold
    )
    rho_slow = jnp.where(
        rho_slow_ok,
        jnp.maximum(info.reg_limit, (1.0 - 0.666 * mu_rate) * info.rho),
        info.rho,
    )
    info = info.replace(
        rho=jnp.where(dual_progress, rho_fast, rho_slow),
        no_primal_update=jnp.where(
            dual_progress, info.no_primal_update, info.no_primal_update + 1
        ),
    )

    primal_progress = jnp.logical_or(
        info.primal_res < 0.95 * info.prev_primal_res,
        jnp.logical_or(
            jnp.logical_or(
                info.primal_res < settings.eps_abs,
                info.primal_res_rel < settings.eps_rel,
            ),
            jnp.logical_and(
                info.delta == settings.reg_finetune_lower_limit,
                info.primal_prox_inf < settings.infeasibility_threshold,
            ),
        ),
    )

    def upd(new, old):
        return jnp.where(primal_progress, new, old)

    prox = prox.replace(
        x=new_prox_x,
        y=upd(vars.y, prox.y),
        z_l=upd(vars.z_l, prox.z_l),
        z_u=upd(vars.z_u, prox.z_u),
        z_bl=upd(vars.z_bl, prox.z_bl),
        z_bu=upd(vars.z_bu, prox.z_bu),
    )
    delta_fast = jnp.maximum(info.reg_limit, (1.0 - mu_rate) * info.delta)
    delta_slow_ok = jnp.logical_or(
        info.iter < 5, info.primal_prox_inf < settings.infeasibility_threshold
    )
    delta_slow = jnp.where(
        delta_slow_ok,
        jnp.maximum(info.reg_limit, (1.0 - 0.666 * mu_rate) * info.delta),
        info.delta,
    )
    info = info.replace(
        delta=jnp.where(primal_progress, delta_fast, delta_slow),
        no_dual_update=jnp.where(
            primal_progress, info.no_dual_update, info.no_dual_update + 1
        ),
    )

    return st.replace(vars=vars, prox=prox, res_nr=res_nr, res=res, info=info)


def _equality_only_step(data, sc, settings, st: IPMState, mat32=None) -> IPMState:
    """Full-step path when there are no inequalities or bounds
    (solver.hpp:831-877)."""
    vars, res, info, ks = st.vars, st.res, st.info, st.ks

    step, _ = kkt.solve(data, settings, ks, res, None, mat32)
    vars = vars.replace(x=vars.x + step.x, y=vars.y + step.y)
    info = info.replace(primal_step=jnp.asarray(1.0, vars.x.dtype),
                        dual_step=jnp.asarray(1.0, vars.x.dtype))

    res_nr, info = residuals_nr(data, sc, vars, info, mat32)

    prox = st.prox
    dual_progress = jnp.logical_or(
        info.dual_res < 0.95 * info.prev_dual_res,
        jnp.logical_or(
            info.dual_res < settings.eps_abs,
            info.dual_res_rel < settings.eps_rel,
        ),
    )
    rho_slow_ok = jnp.logical_or(
        info.iter < 5, info.dual_prox_inf < settings.infeasibility_threshold
    )
    info = info.replace(
        rho=jnp.where(
            dual_progress,
            jnp.maximum(info.reg_limit, 0.1 * info.rho),
            jnp.where(
                rho_slow_ok,
                jnp.maximum(info.reg_limit, 0.5 * info.rho),
                info.rho,
            ),
        ),
        no_primal_update=jnp.where(
            dual_progress, info.no_primal_update, info.no_primal_update + 1
        ),
    )
    prox = prox.replace(x=jnp.where(dual_progress, vars.x, prox.x))

    primal_progress = jnp.logical_or(
        info.primal_res < 0.95 * info.prev_primal_res,
        jnp.logical_or(
            info.primal_res < settings.eps_abs,
            info.primal_res_rel < settings.eps_rel,
        ),
    )
    delta_slow_ok = jnp.logical_or(
        info.iter < 5, info.primal_prox_inf < settings.infeasibility_threshold
    )
    info = info.replace(
        delta=jnp.where(
            primal_progress,
            jnp.maximum(info.reg_limit, 0.1 * info.delta),
            jnp.where(
                delta_slow_ok,
                jnp.maximum(info.reg_limit, 0.5 * info.delta),
                info.delta,
            ),
        ),
        no_dual_update=jnp.where(
            primal_progress, info.no_dual_update, info.no_dual_update + 1
        ),
    )
    prox = prox.replace(y=jnp.where(primal_progress, vars.y, prox.y))

    return st.replace(vars=vars, prox=prox, res_nr=res_nr, res=res, info=info)


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _validate_exit(data, sc, settings, st: IPMState) -> IPMState:
    """Gate an infeasibility exit on the Farkas certificate itself.  A
    rejected certificate relaxes the regularization floor, resets the
    stall counters, tightens the corresponding proximal penalty (the
    outer proximal-method-of-multipliers update) and sets the status back
    to RUNNING so the IPM loop resumes — mirrors
    hostsparse.solve_host._reject_certificate.  Runs *outside* the hot
    loop: the certificate matvecs are paid only at candidate exits."""
    info = st.info
    is_p = info.status == int(Status.PRIMAL_INFEASIBLE)
    is_d = info.status == int(Status.DUAL_INFEASIBLE)

    def validate(st):
        info = st.info
        p_eq, p_neg, p_sup, d_eq, d_cone, d_obj = _certificate_qualities(
            data, sc, st.vars, st.prox
        )
        p_valid = (
            (p_eq <= _CERT_EQ_TOL) & (p_neg <= _CERT_NEG_TOL)
            & (p_sup <= -_CERT_SUP_TOL)
        )
        d_valid = (
            (d_eq <= _CERT_EQ_TOL) & (d_cone <= _CERT_NEG_TOL)
            & (d_obj <= -_CERT_SUP_TOL)
        )
        p_reject = is_p & ~p_valid
        d_reject = is_d & ~d_valid
        reject = p_reject | d_reject
        reg_limit = jnp.where(
            reject, settings.reg_finetune_lower_limit, info.reg_limit
        )
        info = info.replace(
            status=jnp.where(
                reject, jnp.asarray(int(Status.RUNNING), jnp.int32), info.status
            ),
            reg_limit=reg_limit,
            no_primal_update=jnp.where(reject, 0, info.no_primal_update),
            no_dual_update=jnp.where(reject, 0, info.no_dual_update),
            delta=jnp.where(
                p_reject, jnp.maximum(reg_limit, 0.1 * info.delta), info.delta
            ),
            rho=jnp.where(
                d_reject, jnp.maximum(reg_limit, 0.1 * info.rho), info.rho
            ),
        )
        return st.replace(info=info)

    return lax.cond(is_p | is_d, validate, lambda s: s, st)


def solve_scaled(
    data: QPData, sc: Scaling, settings: Settings, has_cone: bool,
    warm: BasicVars | None = None,
) -> Result:
    """Run the IPM on already-equilibrated data; returns the *unscaled*
    result (solver.hpp:109-112: solve_impl + unscale_results + restore_dual).

    ``warm``: optional user-space (unscaled) iterates (x, y, z_*) from a
    previous solve of a nearby problem; see ``_warm_vars``.
    """
    pre = kkt.precompute(data, settings.mixed_precision)
    state, failed = _init_state(
        data, sc, settings, has_cone, settings.mixed_precision, pre, warm
    )

    def cond(st):
        return jnp.logical_and(
            st.info.status == int(Status.RUNNING),
            st.info.iter < settings.max_iter,
        )

    def make_body(mixed):
        def body(st):
            if settings.verbose:
                # per-iteration table (solver.hpp:588-604)
                i = st.info
                jax.debug.print(
                    "{:3d}   {: .5e}   {: .5e}   {:.5e}   {:.5e}   {:.5e}   "
                    "{:.3e}   {:.3e}   {:.3e}   {:.4f}   {:.4f}",
                    i.iter, i.primal_obj, i.dual_obj, i.duality_gap,
                    i.primal_res, i.dual_res, i.rho, i.delta, i.mu,
                    i.primal_step, i.dual_step,
                )
            st = _check_termination(data, sc, settings, st)
            return lax.cond(
                st.info.status == int(Status.RUNNING),
                lambda s: _iteration(data, sc, settings, has_cone, s, mixed, pre),
                lambda s: s,
                st,
            )
        return body

    def _cast_L(st, dtype):
        # loop carries must be type-stable: the factor lives in f32 during
        # phase A and in the solver dtype elsewhere; each phase refactors
        # before its first KKT solve, so only the types matter here
        return st.replace(ks=st.ks.replace(L=jax.tree.map(
            lambda a: a.astype(dtype)
            if jnp.issubdtype(a.dtype, jnp.floating) else a,
            st.ks.L,
        )))

    def run_ipm(st):
        if settings.mixed_precision:
            # two-phase mixed precision: float32 factors while the
            # barrier is loose, float64 factors for the
            # endgame.  A single-phase f32-everywhere mode inflates the
            # iteration tail badly once cond(K) exceeds f32 range (a
            # 5x-slower tail problem stalls the whole lockstep vmapped
            # batch); switching on mu keeps both phases on their fast
            # path.
            def cond_a(s):
                in_a = s.info.mu > settings.mixed_precision_mu_switch
                if settings.mixed_phase_a_patience > 0:
                    # stall exit (types.Settings.mixed_phase_a_patience):
                    # a plateaued problem gains nothing from more f32
                    # iterations — hand it to the f64 endgame, which both
                    # unsticks it and releases its lockstep chunk
                    stalled = jnp.maximum(
                        s.info.no_primal_update, s.info.no_dual_update
                    ) >= settings.mixed_phase_a_patience
                    backstop = s.info.iter >= settings.max_iter // 2
                    in_a = jnp.logical_and(
                        in_a, ~jnp.logical_or(stalled, backstop)
                    )
                return jnp.logical_and(cond(s), in_a)

            st = _cast_L(st, jnp.float32)
            st = lax.while_loop(cond_a, make_body(True), st)
            st = _cast_L(st, data.c.dtype)
        return lax.while_loop(cond, make_body(False), st)

    if settings.verify_certificates:
        # outer loop re-enters the IPM after a rejected certificate; the
        # inner loops are the unmodified reference hot path
        def outer_body(st):
            st = run_ipm(st)
            return _validate_exit(data, sc, settings, st)

        state = lax.while_loop(cond, outer_body, state)
    else:
        state = run_ipm(state)

    info = state.info
    info = info.replace(
        status=jnp.where(
            info.status == int(Status.RUNNING),
            jnp.asarray(int(Status.MAX_ITER_REACHED), jnp.int32),
            info.status,
        )
    )

    result = _finalize(data, sc, state.vars, info)
    if settings.verify_certificates:
        result = _posthoc_certificates(data, sc, settings, state, result)
    return result


def _finalize(data: QPData, sc: Scaling, v: Vars, info: Info) -> Result:
    """Unscale and restore the user-facing solution
    (solver.hpp:1205-1259)."""
    c_inv = 1.0 / sc.c
    x = v.x * sc.d_x
    y = v.y * sc.d_y * c_inv
    z_l = v.z_l * sc.d_z * c_inv
    z_u = v.z_u * sc.d_z * c_inv
    s_l = v.s_l / sc.d_z
    s_u = v.s_u / sc.d_z
    z_bl = jnp.where(data.xl_mask, v.z_bl * sc.d_b * c_inv, 0.0)
    z_bu = jnp.where(data.xu_mask, v.z_bu * sc.d_b * c_inv, 0.0)
    s_bl = jnp.where(data.xl_mask, v.s_bl / sc.d_b, PIQP_INF)
    s_bu = jnp.where(data.xu_mask, v.s_bu / sc.d_b, PIQP_INF)

    # restore_dual (solver.hpp:1229-1241): inactive constraints report
    # infinite slack.
    s_l = jnp.where(z_l == 0, PIQP_INF, s_l)
    s_u = jnp.where(z_u == 0, PIQP_INF, s_u)

    return Result(
        x=x, y=y, z_l=z_l, z_u=z_u, z_bl=z_bl, z_bu=z_bu,
        s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu, info=info,
    )
