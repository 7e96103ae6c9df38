"""Differentiable QP solve — implicit differentiation through the KKT
conditions.

A capability the C++ reference cannot offer: ``solve_qp_diff`` is a
``jax.custom_vjp`` around the IPM solve, so QP solutions compose with
``jax.grad`` / ``jax.vmap`` / ``jax.jit`` — learned MPC cost tuning,
hyperparameter fitting through a control loop, OptNet-style QP layers in
neural networks, end-to-end on the device.  It is representation-generic: the
same entry point differentiates dense ``QPData`` problems AND structured
``multistage.StageQPData`` problems (gradients land on the stage blocks
Pd/Psub/Pa/..., and the adjoint solve reuses the block-tridiagonal+arrow
factorization — differentiable MPC with cost linear in the horizon).

Math (implicit function theorem on the stationary KKT map).  Let
w = (x, y, z_l, z_u, z_bl, z_bu) and θ = the problem-data fields.  At a
solution, F(θ, w) = 0 where F stacks (notation of types.QPData;
B = diag(x_b_scaling), M* the finite-bound masks):

    F1  = Px + c + A'y + G'(z_u - z_l) + B(Mu∘z_bu - Ml∘z_bl)      [n]
    F2  = Ax - b                                                    [p]
    F3l = Ml_h ? z_l ∘ (Gx - h_l)  : z_l                            [m]
    F3u = Mu_h ? z_u ∘ (h_u - Gx)  : z_u                            [m]
    F4l = Ml   ? z_bl ∘ (Bx - x_l) : z_bl                           [n]
    F4u = Mu   ? z_bu ∘ (x_u - Bx) : z_bu                           [n]

Then dw = -(∂F/∂w)⁻¹ (∂F/∂θ) dθ, so the VJP of w̄ is
θ̄ = -(∂F/∂θ)' u with (∂F/∂w)' u = w̄.  Eliminating the complementarity
rows reduces the transpose solve to the familiar condensed saddle system

    [ H   A' ] [u1]   [ r1  ]        H = P + G' D_g G + B D_b B
    [ A   0  ] [u2] = [ w̄_y ]        D_g = diag(z_l/s_l + z_u/s_u)
                                      D_b = diag(z_bl/s_bl + z_bu/s_bu)

— the same quasi-definite structure the IPM factors each iteration
(kkt_system.hpp:161-193 with ρ = δ = 0).  The dense representations
factor the saddle directly with the f64 signed-Cholesky kernel
(ops/ldlt.py); StageQPData goes through ``kkt.factor``'s multistage
dispatch (the adjoint weights ARE a KKTState, built by
``kkt.compute_scalings`` from the solution's slacks/duals with tiny
ρ, δ), plus iterative refinement against the exact saddle operator.
∂F/∂θ is never formed: θ̄ comes from one ``jax.vjp`` of F in θ.

Weak/degenerate active constraints (z ≈ s ≈ 0) are genuinely
non-differentiable points of the solution map; the slack floor below picks
a subgradient there, as all implicit-diff QP layers do (OptNet, Amos &
Kolter 2017).
"""

from __future__ import annotations

from functools import partial, singledispatch

import jax
import jax.numpy as jnp

from . import ops
from .ops import ldlt
from .types import BasicVars, QPData, Settings, Vars

# Active slacks are clamped below at this floor before forming z/s weights.
# At a tightly active constraint the IPM leaves s ~ mu/z (1e-18 scale), whose
# true weight z/s would overflow f64 conditioning; flooring at 1e-8 caps the
# weight at ~1e8 z — "infinite enough" that the active constraint behaves as
# an equality in the derivative to O(1e-8), while the saddle factorization
# stays well inside f64.  The same clamp appears in every implicit-diff QP
# layer (OptNet et al.); weakly-active points are non-differentiable anyway.
SLACK_FLOOR = 1e-8

# adjoint saddle regularization (corrected by refinement).  The condensed
# preconditioner's weights are W = 1/(s/z + delta) ~ (z/s)(1 - delta z/s):
# ~9% low on floored active rows at delta=1e-9, so refinement against the
# exact z/s-weighted operator contracts at ~0.1/round; 4 rounds leave
# O(1e-5) relative error, well under the FD test tolerances.
_ADJ_RHO = 1e-11
_ADJ_DELTA = 1e-9
_ADJ_REFINE = 4


def _kkt_residual(data, x, y, z_l, z_u, z_bl, z_bu):
    """The stationary KKT map F(θ, w) (module docstring), written with the
    dispatched structure-aware matvecs so ``jax.vjp`` in θ yields cotangents
    for every parameter field of ANY data representation (dense QPData and
    multistage StageQPData alike)."""
    dt = x.dtype
    zero = jnp.zeros((), dt)
    B = data.x_b_scaling
    F1 = ops.P_x(data, x) + data.c + (
        B * (jnp.where(data.xu_mask, z_bu, zero)
             - jnp.where(data.xl_mask, z_bl, zero))
    )
    if data.p > 0:
        F1 = F1 + ops.AT_y(data, y)
        F2 = ops.A_x(data, x) - data.b
    else:
        F2 = jnp.zeros_like(y)
    if data.m > 0:
        F1 = F1 + ops.GT_z(data, z_u - z_l)
        Gx = ops.G_x(data, x)
        F3l = jnp.where(data.hl_mask, z_l * (Gx - data.h_l), z_l)
        F3u = jnp.where(data.hu_mask, z_u * (data.h_u - Gx), z_u)
    else:
        F3l, F3u = jnp.zeros_like(z_l), jnp.zeros_like(z_u)
    Bx = B * x
    F4l = jnp.where(data.xl_mask, z_bl * (Bx - data.x_l), z_bl)
    F4u = jnp.where(data.xu_mask, z_bu * (data.x_u - Bx), z_bu)
    return F1, F2, F3l, F3u, F4l, F4u


def _clamped_slacks(data, x):
    """Recompute primal slacks from x, masked to 1 at inactive bounds and
    floored for the z/s weights."""
    dt = x.dtype
    one = jnp.ones((), dt)
    Bx = data.x_b_scaling * x
    floor = jnp.asarray(SLACK_FLOOR, dt)
    cl = lambda v: jnp.maximum(v, floor)
    if data.m > 0:
        Gx = ops.G_x(data, x)
        s_l = jnp.where(data.hl_mask, cl(Gx - data.h_l), one)
        s_u = jnp.where(data.hu_mask, cl(data.h_u - Gx), one)
    else:
        s_l = jnp.ones((data.m,), dt)
        s_u = jnp.ones((data.m,), dt)
    s_bl = jnp.where(data.xl_mask, cl(Bx - data.x_l), one)
    s_bu = jnp.where(data.xu_mask, cl(data.x_u - Bx), one)
    return s_l, s_u, s_bl, s_bu


def _weights(data, w: BasicVars, slacks):
    s_l, s_u, s_bl, s_bu = slacks
    zero = jnp.zeros((), w.x.dtype)
    w_l = jnp.where(data.hl_mask, w.z_l / s_l, zero)
    w_u = jnp.where(data.hu_mask, w.z_u / s_u, zero)
    w_bl = jnp.where(data.xl_mask, w.z_bl / s_bl, zero)
    w_bu = jnp.where(data.xu_mask, w.z_bu / s_bu, zero)
    return w_l, w_u, w_bl, w_bu


# ---------------------------------------------------------------------------
# adjoint saddle solve, dispatched on the data representation
# ---------------------------------------------------------------------------

def _saddle_dense(H, A, r1, r2, refine: int = 2):
    """Direct dense solve of [H A'; A 0][u1;u2] = [r1;r2] via the
    signed-Cholesky kernel on the (tiny-)regularized quasi-definite matrix,
    with refinement against the exact unregularized operator."""
    n = H.shape[-1]
    p = A.shape[-2]
    dt = H.dtype
    N = n + p
    K0 = jnp.concatenate(
        [
            jnp.concatenate([H, A.T], axis=1),
            jnp.concatenate([A, jnp.zeros((p, p), dt)], axis=1),
        ],
        axis=0,
    )
    Np = ldlt.padded_dim(N)
    signs = ldlt.kkt_signs(n, p, 0, Np, dt)
    # scale the static regularization by the PROBLEM's magnitude, not by
    # max|H|: H carries the ~1e8 active-constraint weights, and a reg
    # proportional to those would drown the O(1) blocks it must protect.
    scale = 1.0 + jnp.max(jnp.abs(A)) if p > 0 else jnp.asarray(1.0, dt)
    reg = jnp.asarray(1e-11, dt) * scale
    Kp = ldlt.pad_quasidef(K0, Np) + jnp.diag(reg * signs)
    L, Linvs = ldlt.signed_cholesky(Kp, signs)

    rhs = jnp.concatenate([r1, r2])
    rhs_p = jnp.concatenate([rhs, jnp.zeros((Np - N,), dt)])
    K0p = ldlt.pad_quasidef(K0, Np)
    u = ldlt.signed_solve(L, Linvs, signs, rhs_p)
    for _ in range(refine):
        r = rhs_p - K0p @ u
        u = u + ldlt.signed_solve(L, Linvs, signs, r)
    return u[:n], u[n:N]


@singledispatch
def _solve_adjoint(data, settings, w: BasicVars, slacks, weights, r1, r2):
    """Solve the adjoint saddle system [H A'; A 0][u1;u2] = [r1;r2].

    Default (dense QPData family): materialize H and factor the saddle
    directly (quasi-definite signed Cholesky).  Structured representations
    register backends that reuse their condensed factorization.
    """
    w_l, w_u, w_bl, w_bu = weights
    B = data.x_b_scaling
    H = data.P + jnp.diag(B * B * (w_bl + w_bu))
    if data.m > 0:
        H = H + data.G.T @ (data.G * (w_l + w_u)[:, None])
    return _saddle_dense(H, data.A, r1, r2)


def _solve_adjoint_condensed(data, settings, w, slacks, weights, r1, r2):
    """Adjoint solve through the backend's own condensed factorization
    (kkt.factor dispatch) — for StageQPData this is the block-tridiagonal+
    arrow multistage factorization, so the backward pass inherits the
    forward pass's O(T) structure.

    The adjoint weights are exactly a KKTState: compute_scalings with the
    solution's duals, the clamped slacks, and tiny (ρ, δ) gives
    W_inv = 1/(s/z + δ) ≈ z/s.  The δ-softening and the saddle's
    δ-regularized y-elimination are corrected by refinement against the
    exact operator built from the z/s weights.
    """
    from . import kkt as kkt_mod

    s_l, s_u, s_bl, s_bu = slacks
    w_l, w_u, w_bl, w_bu = weights
    vars_adj = Vars(
        x=w.x, y=w.y, z_l=w.z_l, z_u=w.z_u, z_bl=w.z_bl, z_bu=w.z_bu,
        s_l=s_l, s_u=s_u, s_bl=s_bl, s_bu=s_bu,
    )
    n = w.x.shape[-1]
    ks = kkt_mod.compute_scalings(
        data,
        settings,
        vars_adj,
        rho=jnp.asarray(_ADJ_RHO, w.x.dtype),
        delta=jnp.asarray(_ADJ_DELTA, w.x.dtype),
        use_ir=jnp.asarray(False),
        P_diag=jnp.zeros((n,), w.x.dtype),
    )
    ks, _ok = kkt_mod.factor(data, ks, mixed=False, pre=kkt_mod.precompute(data))

    B = data.x_b_scaling
    xw = B * B * (w_bl + w_bu)

    def Hmul(u):
        out = ops.P_x(data, u) + xw * u
        if data.m > 0:
            out = out + ops.GT_z(data, (w_l + w_u) * ops.G_x(data, u))
        return out

    zeros_z = jnp.zeros((data.m,), w.x.dtype)
    u1, u2, _ = kkt_mod._backend_solve(data, ks, r1, r2, zeros_z)
    for _ in range(_ADJ_REFINE):
        res1 = r1 - Hmul(u1)
        if data.p > 0:
            res1 = res1 - ops.AT_y(data, u2)
            res2 = r2 - ops.A_x(data, u1)
        else:
            res2 = jnp.zeros_like(r2)
        d1, d2, _ = kkt_mod._backend_solve(data, ks, res1, res2, zeros_z)
        u1 = u1 + d1
        u2 = u2 + d2
    return u1, u2


def _register_stage_adjoint():
    # deferred: multistage imports kkt/ruiz at module load; registering here
    # avoids a hard import cycle at package init
    from .multistage import StageQPData

    if StageQPData not in _solve_adjoint.registry:
        _solve_adjoint.register(StageQPData)(_solve_adjoint_condensed)


# ---------------------------------------------------------------------------
# the custom-VJP solve
# ---------------------------------------------------------------------------

@partial(jax.custom_vjp, nondiff_argnums=(1, 2))
def solve_qp_diff(
    data, settings: Settings = Settings(), cone: bool = True
) -> BasicVars:
    """Solve the QP and return (x, y, z_l, z_u, z_bl, z_bu) with a custom
    VJP: gradients w.r.t. every data field flow through the solution by
    implicit differentiation of the KKT conditions.

    ``data`` is a canonicalized QPData (api.prepare_data) or a multistage
    StageQPData (gradients land on the stage blocks; the adjoint reuses
    the block factorization).  ``settings`` is static.  ``cone`` mirrors
    api.has_cone — pass False only for equality-constrained problems (it
    cannot be derived from traced masks).  Composes with jit / vmap /
    grad.  Solve to tight tolerances (eps_abs <= 1e-10) for accurate
    gradients: the implicit-diff error is O(solve tolerance).
    """
    return _diff_fwd(data, settings, cone)[0]


def _diff_fwd(data, settings: Settings, cone: bool):
    import dataclasses

    from . import ruiz, solver

    # exact in-loop KKT solves for the differentiable path: the implicit
    # function theorem differentiates THE KKT point, and the inexact-IPM
    # refinement rule (Settings.refine_mu_factor) adds iterate-path noise
    # of the order of the relaxed tolerance — harmless for optimization,
    # but it lands exactly where finite-difference/gradient users look.
    if settings.refine_mu_factor:
        settings = dataclasses.replace(settings, refine_mu_factor=0.0)

    _register_stage_adjoint()
    with jax.default_matmul_precision("highest"):
        sdata, sc = ruiz.equilibrate(
            data,
            max_iter=settings.preconditioner_iter,
            scale_cost=settings.preconditioner_scale_cost,
        )
        res = solver.solve_scaled(sdata, sc, settings, cone)
    out = BasicVars(res.x, res.y, res.z_l, res.z_u, res.z_bl, res.z_bu)
    return out, (data, out)


def _diff_bwd(settings: Settings, cone: bool, saved, wbar: BasicVars):
    data, w = saved
    _register_stage_adjoint()
    x = w.x
    B = data.x_b_scaling
    slacks = _clamped_slacks(data, x)
    weights = _weights(data, w, slacks)
    w_l, w_u, w_bl, w_bu = weights
    s_l, s_u, s_bl, s_bu = slacks

    # move the w̄_z parts of the eliminated complementarity rows to the RHS
    r1 = wbar.x - B * (w_bl * wbar.z_bl) + B * (w_bu * wbar.z_bu)
    if data.m > 0:
        r1 = r1 - ops.GT_z(data, w_l * wbar.z_l - w_u * wbar.z_u)
    u1, u2 = _solve_adjoint(data, settings, w, slacks, weights, r1, wbar.y)

    Bu1 = B * u1
    if data.m > 0:
        Gu1 = ops.G_x(data, u1)
        u3l = jnp.where(data.hl_mask, (wbar.z_l + Gu1) / s_l, wbar.z_l)
        u3u = jnp.where(data.hu_mask, (wbar.z_u - Gu1) / s_u, wbar.z_u)
    else:
        u3l, u3u = wbar.z_l, wbar.z_u
    u4l = jnp.where(data.xl_mask, (wbar.z_bl + Bu1) / s_bl, wbar.z_bl)
    u4u = jnp.where(data.xu_mask, (wbar.z_bu - Bu1) / s_bu, wbar.z_bu)

    _, vjp_theta = jax.vjp(
        lambda d: _kkt_residual(d, x, w.y, w.z_l, w.z_u, w.z_bl, w.z_bu),
        data,
    )
    (data_bar,) = vjp_theta((-u1, -u2, -u3l, -u3u, -u4l, -u4u))
    return (data_bar,)


solve_qp_diff.defvjp(_diff_fwd, _diff_bwd)


def qp_layer(
    P,
    c,
    A=None,
    b=None,
    G=None,
    h_l=None,
    h_u=None,
    x_l=None,
    x_u=None,
    settings: Settings | None = None,
):
    """Convenience OptNet-style layer: canonicalize once (host side), return
    a differentiable ``solve(data) -> x`` plus the prepared QPData pytree.

    >>> solve, data = qp_layer(P, c, G=G, h_u=h)
    >>> grads = jax.grad(lambda d: solve(d).sum(), allow_int=True)(data)

    (``allow_int=True`` because QPData carries bool mask leaves; their
    cotangents are float0.)  Alternatively differentiate w.r.t. individual
    fields via ``dataclasses.replace(data, c=...)``.
    """
    from .api import has_cone, prepare_data

    settings = settings or Settings()
    data = prepare_data(P, c, A, b, G, h_l, h_u, x_l, x_u, dtype=settings.dtype)
    cone = has_cone(data)

    def solve(d: QPData):
        return solve_qp_diff(d, settings, cone).x

    return solve, data
