"""Independent (numpy-only) KKT optimality checker.

The strongest oracle available without a second QP solver: verify primal
feasibility, stationarity, dual feasibility and the duality gap of a
returned solution directly against the *original unscaled* problem data.
This is the same optimality system PIQP's residuals measure
(/root/reference/include/piqp/solver.hpp:960-1105).

P, A and G may be dense arrays or scipy.sparse matrices.
"""

import numpy as np
import scipy.sparse as sp

INF = 1e30


def _mat(M, n):
    if M is None:
        return np.zeros((0, n))
    return M.tocsr() if sp.issparse(M) else np.asarray(M)


def check_optimality(prob: dict, res, tol: float = 1e-6) -> None:
    P = prob["P"]
    if sp.issparse(P):
        P = sp.triu(P, format="csr") + sp.triu(P, 1, format="csr").T
    else:
        P = np.asarray(P)
        P = np.triu(P) + np.triu(P, 1).T
    c = np.asarray(prob["c"])
    A = _mat(prob.get("A"), P.shape[0])
    b = np.asarray(prob.get("b")) if prob.get("b") is not None else np.zeros(0)
    G = _mat(prob.get("G"), P.shape[0])
    m, n = G.shape
    h_l = np.asarray(prob.get("h_l")) if prob.get("h_l") is not None else np.full(m, -np.inf)
    h_u = np.asarray(prob.get("h_u")) if prob.get("h_u") is not None else np.full(m, np.inf)
    x_l = np.asarray(prob.get("x_l")) if prob.get("x_l") is not None else np.full(n, -np.inf)
    x_u = np.asarray(prob.get("x_u")) if prob.get("x_u") is not None else np.full(n, np.inf)

    x = np.asarray(res.x)
    y = np.asarray(res.y)
    z_l = np.asarray(res.z_l)
    z_u = np.asarray(res.z_u)
    z_bl = np.asarray(res.z_bl)
    z_bu = np.asarray(res.z_bu)

    hl_mask = h_l > -INF
    hu_mask = h_u < INF
    xl_mask = x_l > -INF
    xu_mask = x_u < INF
    # rows with no finite bounds are disabled by the solver
    dead = ~hl_mask & ~hu_mask
    if sp.issparse(G):
        G = sp.diags((~dead).astype(float)) @ G
    else:
        G = G.copy()
        G[dead] = 0.0

    scale = max(1.0, np.abs(x).max(initial=0.0))

    # primal feasibility
    if A.shape[0]:
        assert np.abs(A @ x - b).max() < tol * scale, "equality violation"
    if m:
        Gx = G @ x
        assert np.all(Gx[hu_mask] <= h_u[hu_mask] + tol * scale), "h_u violation"
        assert np.all(Gx[hl_mask] >= h_l[hl_mask] - tol * scale), "h_l violation"
    assert np.all(x[xu_mask] <= x_u[xu_mask] + tol * scale), "x_u violation"
    assert np.all(x[xl_mask] >= x_l[xl_mask] - tol * scale), "x_l violation"

    # dual feasibility
    assert np.all(z_l >= -tol) and np.all(z_u >= -tol), "negative ineq duals"
    assert np.all(z_bl >= -tol) and np.all(z_bu >= -tol), "negative bound duals"

    # stationarity: Px + c + A'y + G'(z_u - z_l) + (z_bu - z_bl) = 0
    grad = P @ x + c
    if A.shape[0]:
        grad = grad + A.T @ y
    if m:
        grad = grad + G.T @ (z_u - z_l)
    grad = grad + z_bu - z_bl
    gscale = max(
        1.0,
        np.abs(P @ x).max(initial=0.0),
        np.abs(c).max(initial=0.0),
    )
    assert np.abs(grad).max() < tol * gscale, (
        f"stationarity violation {np.abs(grad).max():.2e}"
    )

    # duality gap
    primal_obj = 0.5 * x @ P @ x + c @ x
    dual_obj = -0.5 * x @ P @ x
    if A.shape[0]:
        dual_obj -= b @ y
    if m:
        dual_obj += np.where(hl_mask, h_l, 0.0) @ z_l - np.where(hu_mask, h_u, 0.0) @ z_u
    dual_obj += np.where(xl_mask, x_l, 0.0) @ z_bl - np.where(xu_mask, x_u, 0.0) @ z_bu
    gap = abs(primal_obj - dual_obj)
    assert gap < tol * max(1.0, abs(primal_obj)), f"duality gap {gap:.2e}"
