"""Warm-started re-solves (no reference analog: the reference cold-starts
every solve, solver.hpp:398-577; warm starting is an addition
serving the batched MPC/SQP regime — see solver._warm_vars).

Covers: iteration-count reduction and solution agreement after small data
updates, robustness to large perturbations, infeasibility detection from a
warm point, the batched warm path, and mixed-precision composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import piqp_tpu
from piqp_tpu import DenseSolver, Settings, Status
from piqp_tpu.batch import prepare_batch, solve_batch, warm_from_result
from piqp_tpu.utils.random import dense_strongly_convex_qp


def _cold_and_warm(prob, update, settings=Settings(), **solve_kw):
    """Solve, apply ``update``, re-solve cold and warm; return both
    (status, iters, x)."""
    s = DenseSolver(settings)
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    s.update(**update)
    st_c = s.solve()
    it_c, x_c = int(s.result.info.iter), np.asarray(s.result.x).copy()

    s2 = DenseSolver(settings)
    s2.setup(**prob)
    assert s2.solve() == Status.SOLVED
    s2.update(**update)
    st_w = s2.solve(warm_start=True, **solve_kw)
    it_w, x_w = int(s2.result.info.iter), np.asarray(s2.result.x)
    return (st_c, it_c, x_c), (st_w, it_w, x_w)


@pytest.mark.parametrize("seed", [1000, 1003, 1017])
def test_warm_resolve_fewer_iters_same_solution(seed):
    prob = dense_strongly_convex_qp(64, 32, 32, seed=seed)
    (st_c, it_c, x_c), (st_w, it_w, x_w) = _cold_and_warm(
        prob, dict(c=prob["c"] * 1.01)
    )
    assert st_c == Status.SOLVED and st_w == Status.SOLVED
    assert it_w < it_c  # typically ~3 vs ~9
    np.testing.assert_allclose(x_w, x_c, rtol=1e-6, atol=1e-7)


def test_warm_resolve_large_perturbation_still_solves():
    prob = dense_strongly_convex_qp(48, 24, 24, seed=7)
    (st_c, _, x_c), (st_w, _, x_w) = _cold_and_warm(
        prob, dict(c=prob["c"] * 2.0 + 1.0)
    )
    assert st_c == Status.SOLVED and st_w == Status.SOLVED
    np.testing.assert_allclose(x_w, x_c, rtol=1e-6, atol=1e-7)


def test_warm_resolve_matrix_update():
    prob = dense_strongly_convex_qp(32, 16, 16, seed=11)
    P2 = prob["P"] + 0.1 * np.eye(32)
    (st_c, _, x_c), (st_w, it_w, x_w) = _cold_and_warm(prob, dict(P=P2))
    assert st_c == Status.SOLVED and st_w == Status.SOLVED
    np.testing.assert_allclose(x_w, x_c, rtol=1e-6, atol=1e-7)


def test_warm_start_does_not_mask_infeasibility():
    prob = dense_strongly_convex_qp(16, 4, 8, seed=3)
    s = DenseSolver()
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    # make the box empty-ish: x_l > x_u is rejected at canonicalization, so
    # instead send the equality rhs out of reach of the (tight) box
    n = 16
    s.update(x_l=-1e-3 * np.ones(n), x_u=1e-3 * np.ones(n),
             b=1e3 * np.ones(4))
    st = s.solve(warm_start=True)
    assert st == Status.PRIMAL_INFEASIBLE


def test_warm_start_first_solve_is_cold():
    # warm_start=True on the first solve must behave like a cold solve
    prob = dense_strongly_convex_qp(24, 12, 12, seed=5)
    s = DenseSolver()
    s.setup(**prob)
    assert s.solve(warm_start=True) == Status.SOLVED


def test_warm_start_equality_only():
    prob = dense_strongly_convex_qp(24, 12, 0, seed=9)
    prob = {k: v for k, v in prob.items() if k not in
            ("G", "h_l", "h_u", "x_l", "x_u")}
    s = DenseSolver()
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    s.update(c=prob["c"] * 1.05)
    assert s.solve(warm_start=True) == Status.SOLVED


def test_batch_warm_resolve():
    B, n = 8, 32
    probs = [dense_strongly_convex_qp(n, 16, 16, seed=100 + i)
             for i in range(B)]
    data = prepare_batch(probs)
    cold = solve_batch(data)
    assert int(jnp.sum(cold.info.status == 1)) == B

    data2 = data.replace(c=data.c * 1.01)
    ref = solve_batch(data2)
    warm = solve_batch(data2, warm=cold)
    assert int(jnp.sum(warm.info.status == 1)) == B
    assert int(jnp.max(warm.info.iter)) < int(jnp.max(ref.info.iter))
    np.testing.assert_allclose(
        np.asarray(warm.x), np.asarray(ref.x), rtol=1e-6, atol=1e-7
    )
    # warm_from_result round-trip is the documented entry point
    warm2 = solve_batch(data2, warm=warm_from_result(cold))
    np.testing.assert_allclose(
        np.asarray(warm2.x), np.asarray(warm.x), rtol=1e-12, atol=0
    )


def test_warm_resolve_mixed_precision():
    settings = Settings(mixed_precision=True)
    prob = dense_strongly_convex_qp(64, 32, 32, seed=1000)
    (st_c, it_c, x_c), (st_w, it_w, x_w) = _cold_and_warm(
        prob, dict(c=prob["c"] * 1.01), settings=settings
    )
    assert st_c == Status.SOLVED and st_w == Status.SOLVED
    assert it_w <= it_c
    np.testing.assert_allclose(x_w, x_c, rtol=1e-6, atol=1e-7)


def test_multistage_warm_resolve():
    from piqp_tpu import multistage as ms
    from piqp_tpu.api import solve_prepared

    sdata = ms.random_multistage_qp(T=32, D=4, Da=2, ra=2, rg=2, seed=31)
    cold = solve_prepared(sdata)
    assert int(cold.info.status) == Status.SOLVED
    sdata2 = sdata.replace(c=sdata.c * 1.01)
    ref = solve_prepared(sdata2)
    warm = solve_prepared(sdata2, warm=cold)
    assert int(warm.info.status) == Status.SOLVED
    assert int(warm.info.iter) < int(ref.info.iter)
    np.testing.assert_allclose(
        np.asarray(warm.x), np.asarray(ref.x), rtol=1e-4, atol=1e-5
    )


def test_sparse_solver_warm_resolve():
    import scipy.sparse as sp
    from piqp_tpu import SparseSolver
    from piqp_tpu.utils.random import sparse_strongly_convex_qp

    prob = sparse_strongly_convex_qp(40, 10, 20, seed=13)
    s = SparseSolver()
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    s.update(c=np.asarray(prob["c"]) * 1.01)
    assert s.solve(warm_start=True) == Status.SOLVED


def test_host_warm_resolve():
    from piqp_tpu.hostsparse import solve_sparse_host

    prob = dense_strongly_convex_qp(40, 10, 20, seed=17)
    cold = solve_sparse_host(**prob)
    assert int(cold.info.status) == Status.SOLVED
    prob2 = dict(prob)
    prob2["c"] = np.asarray(prob["c"]) * 1.01
    ref = solve_sparse_host(**prob2)
    warm = solve_sparse_host(**prob2, warm=cold)
    assert int(warm.info.status) == Status.SOLVED
    assert warm.info.iter < ref.info.iter
    np.testing.assert_allclose(warm.x, ref.x, rtol=1e-5, atol=1e-6)
