"""Factor-with-inverse representation (ops/pallas_chol.py) — equivalence
with numpy's f64 Cholesky and inverse, the NaN failure signal, and
end-to-end IPM runs with Settings(pallas_kernels=True).

Mirrors the reference's kernel-test layer for the blocked dense
factorization (tests/src/dense/ldlt_test.cpp; kernel being replaced:
dense/ldlt_no_pivot.hpp:279-354).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from piqp_tpu import DenseSolver, Settings, Status
from piqp_tpu.batch import prepare_batch, solve_batch
from piqp_tpu.ops.pallas_chol import (
    cholesky_inverse_apply,
    cholesky_with_inverse,
    inv_solve,
)
from piqp_tpu.utils.random import dense_strongly_convex_qp

from helpers import check_optimality


def _spd_batch(B, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    Q = rng.uniform(-1, 1, (B, n, n))
    K = Q @ np.swapaxes(Q, 1, 2) + n * np.eye(n)
    return jnp.asarray(K, dtype)


def _check_factor(K, L, Linv, tol):
    Kn = np.asarray(K, np.float64)
    L_ref = np.linalg.cholesky(Kn)
    np.testing.assert_allclose(np.asarray(L), L_ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(
        np.asarray(Linv), np.linalg.inv(L_ref), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("n", [8, 32, 100, 128, 256])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_kernel_matches_xla_cholesky(n, dtype):
    """The batched factor-with-inverse against numpy's f64 Cholesky and
    inverse."""
    B = 5
    K = _spd_batch(B, n, dtype, seed=n)
    L, Linv = jax.vmap(cholesky_with_inverse)(K)
    _check_factor(K, L, Linv, 5e-5 if dtype == jnp.float32 else 1e-11)


@pytest.mark.parametrize("batched", [False, True])
def test_nonpositive_pivot_is_nan(batched):
    """A failed factorization surfaces as NaN, also under vmap inside a
    while_loop: the retry ladder's failure signal (kkt._factor_dense)."""
    K = _spd_batch(2, 16, jnp.float64, seed=2)
    K = K.at[1, 3, 3].set(-1.0)

    def factor_in_loop(k):
        def body(c):
            i, _ = c
            return i + 1, cholesky_with_inverse(k)[0]
        return jax.lax.while_loop(lambda c: c[0] < 2, body,
                                  (0, jnp.zeros_like(k)))[1]

    L = (jax.jit(jax.vmap(factor_in_loop))(K) if batched
         else jnp.stack([jax.jit(factor_in_loop)(k) for k in K]))
    assert np.all(np.isfinite(np.asarray(L[0])))
    assert not np.all(np.isfinite(np.asarray(L[1])))


def test_inv_solve_roundtrip():
    B, n = 4, 64
    K = _spd_batch(B, n, jnp.float64, seed=3)
    L, Linv = jax.vmap(cholesky_with_inverse)(K)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.standard_normal((B, n)))
    x = inv_solve(Linv, v)
    np.testing.assert_allclose(
        np.asarray(jnp.einsum("bij,bj->bi", K, x)), np.asarray(v), atol=1e-9
    )


def test_custom_vmap_dispatch():
    """Unbatched and vmapped calls agree."""
    n = 48
    K = _spd_batch(6, n, jnp.float64, seed=1)
    L1, I1 = jax.vmap(cholesky_with_inverse)(K)
    L0, I0 = cholesky_with_inverse(K[0])
    np.testing.assert_allclose(np.asarray(L1[0]), np.asarray(L0), atol=1e-10)
    np.testing.assert_allclose(np.asarray(I1[0]), np.asarray(I0), atol=1e-9)


def test_dense_solver_pallas_end_to_end():
    prob = dense_strongly_convex_qp(24, 6, 12, seed=11)
    s = DenseSolver(Settings(pallas_kernels=True))
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    check_optimality(prob, s.result, tol=1e-6)
    # same solution as the plain factor
    s2 = DenseSolver(Settings())
    s2.setup(**prob)
    assert s2.solve() == Status.SOLVED
    np.testing.assert_allclose(
        np.asarray(s.result.x), np.asarray(s2.result.x), atol=1e-7
    )


@pytest.mark.parametrize("mixed", [False, True])
def test_batched_solve_pallas(mixed):
    B, n = 12, 32
    problems = [
        dense_strongly_convex_qp(n, n // 4, n // 2, seed=100 + i)
        for i in range(B)
    ]
    data = prepare_batch(problems)
    res = solve_batch(
        data, Settings(pallas_kernels=True, mixed_precision=mixed)
    )
    assert np.all(np.asarray(res.info.status) == int(Status.SOLVED))
    for i in range(B):
        one = jax.tree.map(lambda x: x[i], res)
        check_optimality(problems[i], one, tol=1e-6)


@pytest.mark.parametrize("T", [17, 32])
def test_multistage_cr_pallas(T):
    """CR scheme with the factor-with-inverse levels (5-tuples) matches the
    plain route and solves to optimality."""
    from piqp_tpu import multistage as ms
    from piqp_tpu.api import solve_prepared

    sdata = ms.random_multistage_qp(T=T, D=4, Da=2, ra=2, rg=2, seed=31)
    res_p = solve_prepared(sdata, Settings(pallas_kernels=True))
    res_x = solve_prepared(sdata, Settings())
    assert int(res_p.info.status) == int(Status.SOLVED)
    assert int(res_x.info.status) == int(Status.SOLVED)
    np.testing.assert_allclose(
        np.asarray(res_p.x), np.asarray(res_x.x), atol=1e-7, rtol=1e-6
    )


def test_multistage_cr_pallas_mixed():
    from piqp_tpu import multistage as ms
    from piqp_tpu.api import solve_prepared

    sdata = ms.random_multistage_qp(T=32, D=4, Da=2, ra=2, rg=2, seed=33)
    res_p = solve_prepared(
        sdata, Settings(pallas_kernels=True, mixed_precision=True)
    )
    res_x = solve_prepared(sdata, Settings())
    assert int(res_p.info.status) == int(Status.SOLVED)
    np.testing.assert_allclose(
        np.asarray(res_p.x), np.asarray(res_x.x), atol=1e-6, rtol=1e-5
    )


@pytest.mark.parametrize("n,r", [(8, 18), (32, 80), (64, 144)])
def test_chol_inv_apply_fused(n, r):
    """The batched factor+inverse+apply (the CR chain step) matches a
    plain solve: Y == K^-1 RHS, L == chol(K)."""
    B = 5
    K = _spd_batch(B, n, jnp.float64, seed=n + r)
    rng = np.random.default_rng(r)
    RHS = jnp.asarray(rng.standard_normal((B, n, r)))
    L, Linv, Y = jax.vmap(cholesky_inverse_apply)(K, RHS)
    np.testing.assert_allclose(
        np.asarray(L), np.asarray(jnp.linalg.cholesky(K)), atol=1e-11,
        rtol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(K @ Y), np.asarray(RHS), atol=1e-8, rtol=1e-9
    )


def test_chol_inv_apply_custom_vmap():
    """vmapped cholesky_inverse_apply agrees with unbatched calls."""
    B, n, r = 4, 24, 52
    K = _spd_batch(B, n, jnp.float64, seed=7)
    rng = np.random.default_rng(9)
    RHS = jnp.asarray(rng.standard_normal((B, n, r)))
    Lb, Linvb, Yb = jax.vmap(cholesky_inverse_apply)(K, RHS)
    for i in range(B):
        L1, Linv1, Y1 = cholesky_inverse_apply(K[i], RHS[i])
        np.testing.assert_allclose(np.asarray(Lb[i]), np.asarray(L1),
                                   atol=1e-10, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(Yb[i]), np.asarray(Y1),
                                   atol=1e-8, rtol=1e-8)
