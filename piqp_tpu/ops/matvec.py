"""Problem-structure matvecs (the backend's eval_* surface,
/root/reference/include/piqp/kkt_solver_base.hpp:21-44).

Single-dispatch on the data representation so block-structured backends
(multistage) provide linear-in-horizon implementations while the dense
backend uses plain GEMVs.  Dispatch happens at trace time (zero runtime
cost under jit).  The reference fuses A*xn with A'*xt for BLASFEO's gemv_nt;
XLA fuses on its own, so the ops are kept separate and composable.
"""

from __future__ import annotations

from functools import singledispatch

import jax.numpy as jnp

from ..types import QPData


@singledispatch
def P_x(data, x):
    """P @ x."""
    raise NotImplementedError(type(data))


@singledispatch
def P_diag(data):
    """Diagonal of P (static-regularization sizing, kkt_system.hpp:195-207)."""
    raise NotImplementedError(type(data))


@singledispatch
def A_x(data, x):
    """A @ x -> (p,)."""
    raise NotImplementedError(type(data))


@singledispatch
def AT_y(data, y):
    """A.T @ y -> (n,)."""
    raise NotImplementedError(type(data))


@singledispatch
def G_x(data, x):
    """G @ x -> (m,)."""
    raise NotImplementedError(type(data))


@singledispatch
def GT_z(data, z):
    """G.T @ z -> (n,)."""
    raise NotImplementedError(type(data))


@singledispatch
def PAG_x(data, x):
    """(P@x, A@x, G@x) in as few passes as the representation allows.

    The default composes the dispatched matvecs (structured backends keep
    their linear-in-horizon evaluations).  Dense representations override
    with ONE stacked GEMV: the [P; A; G] constant is loop-invariant, so XLA
    hoists the concatenation out of the IPM while_loop, and one GEMV
    launches one kernel where three would launch three.
    """
    Px = P_x(data, x)
    Ax = A_x(data, x) if data.p else jnp.zeros((0,), x.dtype)
    Gx = G_x(data, x) if data.m else jnp.zeros((0,), x.dtype)
    return Px, Ax, Gx


@singledispatch
def AG_x(data, x):
    """(A@x, G@x) fused where possible (see ``PAG_x``)."""
    Ax = A_x(data, x) if data.p else jnp.zeros((0,), x.dtype)
    Gx = G_x(data, x) if data.m else jnp.zeros((0,), x.dtype)
    return Ax, Gx


@singledispatch
def add_AtGt(data, rx, y, z):
    """rx + A.T@y + G.T@z fused where possible (see ``PAG_x``)."""
    if data.p:
        rx = rx + AT_y(data, y)
    if data.m:
        rx = rx + GT_z(data, z)
    return rx


@singledispatch
def abs_data(data):
    """Same data object with the matrix blocks replaced by their absolute
    values.  Running the eval_* matvecs on it with |v| gives the
    cancellation denominators for Farkas-certificate validation
    (solver._certificate_qualities).  XLA hoists the abs() of the constant
    problem data out of the IPM while_loop."""
    raise NotImplementedError(type(data))


# --- dense implementations -------------------------------------------------

@P_x.register
def _(data: QPData, x):
    return data.P @ x


@P_diag.register
def _(data: QPData):
    return jnp.diagonal(data.P)


@A_x.register
def _(data: QPData, x):
    return data.A @ x


@AT_y.register
def _(data: QPData, y):
    return data.A.T @ y


@G_x.register
def _(data: QPData, x):
    return data.G @ x


@GT_z.register
def _(data: QPData, z):
    return data.G.T @ z


@PAG_x.register
def _(data: QPData, x):
    if data.p == 0 and data.m == 0:
        z = jnp.zeros((0,), x.dtype)
        return data.P @ x, z, z
    y = jnp.concatenate([data.P, data.A, data.G], axis=0) @ x
    n, p = data.n, data.p
    return y[:n], y[n:n + p], y[n + p:]


@AG_x.register
def _(data: QPData, x):
    if data.p == 0 and data.m == 0:
        z = jnp.zeros((0,), x.dtype)
        return z, z
    if data.p == 0:
        return jnp.zeros((0,), x.dtype), data.G @ x
    if data.m == 0:
        return data.A @ x, jnp.zeros((0,), x.dtype)
    y = jnp.concatenate([data.A, data.G], axis=0) @ x
    return y[:data.p], y[data.p:]


@add_AtGt.register
def _(data: QPData, rx, y, z):
    if data.p == 0 and data.m == 0:
        return rx
    if data.p == 0:
        return rx + data.G.T @ z
    if data.m == 0:
        return rx + data.A.T @ y
    S = jnp.concatenate([data.A, data.G], axis=0)
    return rx + S.T @ jnp.concatenate([y, z])


@abs_data.register
def _(data: QPData):
    return data.replace(
        P=jnp.abs(data.P), A=jnp.abs(data.A), G=jnp.abs(data.G)
    )
