"""Signed-Cholesky (LDL^T no-pivot) kernel and dense_ldlt backend tests.

Mirrors the reference's dense LDLT kernel tests
(/root/reference/tests/src/dense/ldlt_test.cpp: factor + solve against
known solutions) plus the backend-equivalence oracle pattern
(solver_test.cpp parameterized over backends): the dense_ldlt full-KKT
backend must reproduce the dense_cholesky solution on random QPs and
solve the ill-conditioned robot_arm fixtures the condensed form cannot.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from piqp_tpu import Settings, solve_dense
from piqp_tpu.ops import ldlt
from piqp_tpu.types import KKTBackend, Status
from piqp_tpu.utils.random import dense_strongly_convex_qp


def _random_quasidef(N, npos, seed, dtype=np.float64):
    """Random quasi-definite matrix: SPD on the leading npos rows,
    negative definite on the trailing, arbitrary coupling."""
    rng = np.random.default_rng(seed)
    nneg = N - npos
    Mp = rng.standard_normal((npos, npos))
    Pp = Mp @ Mp.T + npos * np.eye(npos)
    Mn = rng.standard_normal((nneg, nneg))
    Pn = Mn @ Mn.T + nneg * np.eye(nneg)
    B = rng.standard_normal((nneg, npos))
    K = np.block([[Pp, B.T], [B, -Pn]])
    s = np.concatenate([np.ones(npos), -np.ones(nneg)])
    return K.astype(dtype), s.astype(dtype)


@pytest.mark.parametrize("N,npos", [(64, 40), (128, 64), (192, 100)])
def test_signed_cholesky_reconstructs(N, npos):
    K, s = _random_quasidef(N, npos, seed=N + npos)
    L, Linvs = jax.jit(ldlt.signed_cholesky)(jnp.asarray(K), jnp.asarray(s))
    L = np.asarray(L)
    rec = (L * s[None, :]) @ L.T
    assert np.allclose(rec, K, atol=1e-8 * np.abs(K).max())
    # stored block inverses really invert the diagonal blocks
    bs = ldlt.DEFAULT_BLOCK
    for k in range(N // bs):
        blk = L[k * bs:(k + 1) * bs, k * bs:(k + 1) * bs]
        assert np.allclose(np.asarray(Linvs[k]) @ blk, np.eye(bs), atol=1e-8)


@pytest.mark.parametrize("N,npos", [(64, 30), (128, 90)])
def test_signed_solve_matches_dense_solve(N, npos):
    K, s = _random_quasidef(N, npos, seed=7 * N)
    b = np.random.default_rng(3).standard_normal(N)
    L, Linvs = ldlt.signed_cholesky(jnp.asarray(K), jnp.asarray(s))
    x = np.asarray(
        jax.jit(ldlt.signed_solve)(L, Linvs, jnp.asarray(s), jnp.asarray(b))
    )
    x_ref = np.linalg.solve(K, b)
    assert np.allclose(x, x_ref, atol=1e-8 * max(1.0, np.abs(x_ref).max()))


def test_signed_cholesky_vmaps():
    Ks, bs = [], []
    N, npos = 64, 40
    for seed in range(4):
        K, s = _random_quasidef(N, npos, seed=seed)
        Ks.append(K)
        bs.append(np.random.default_rng(seed).standard_normal(N))
    Ks = jnp.asarray(np.stack(Ks))
    bvec = jnp.asarray(np.stack(bs))
    s = jnp.asarray(np.concatenate([np.ones(npos), -np.ones(N - npos)]))

    fac = jax.vmap(lambda K: ldlt.signed_cholesky(K, s))
    L, Linvs = fac(Ks)
    sol = jax.vmap(lambda l, li, b: ldlt.signed_solve(l, li, s, b))(
        L, Linvs, bvec
    )
    for i in range(4):
        x_ref = np.linalg.solve(np.asarray(Ks[i]), np.asarray(bvec[i]))
        assert np.allclose(np.asarray(sol[i]), x_ref, atol=1e-7)


def test_indefinite_pivot_flags_nonfinite():
    """A matrix violating the declared sign pattern must produce NaN (the
    ok=False signal the solver's regularization ladder consumes) — mirrors
    LDLTNoPivot reporting NumericalIssue (ldlt_no_pivot.hpp:367-378)."""
    N = 64
    K = -np.eye(N)  # negative definite, but signs claim +1
    s = np.ones(N)
    L, _ = ldlt.signed_cholesky(jnp.asarray(K), jnp.asarray(s))
    assert not bool(jnp.all(jnp.isfinite(L)))


@pytest.mark.parametrize("dims", [(10, 4, 6), (16, 0, 10), (12, 5, 0), (40, 11, 23)])
def test_dense_ldlt_backend_matches_cholesky(dims):
    n, p, m = dims
    prob = dense_strongly_convex_qp(n, p, m, seed=sum(dims))
    r_chol = solve_dense(**prob, settings=Settings())
    r_ldlt = solve_dense(
        **prob, settings=Settings(kkt_solver=KKTBackend.dense_ldlt)
    )
    assert int(r_ldlt.info.status) == int(Status.SOLVED)
    np.testing.assert_allclose(
        np.asarray(r_ldlt.x), np.asarray(r_chol.x), atol=1e-7, rtol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(r_ldlt.y), np.asarray(r_chol.y), atol=1e-6, rtol=1e-6
    )


@pytest.mark.corpus
def test_dense_ldlt_solves_robot_arm():
    """The done-criterion the dense_lu backend owns (test_fixtures.py:
    robot_arm needs the full-KKT form), also met by the signed-Cholesky
    full-KKT backend."""
    import os

    from piqp_tpu.utils.io import load_mat

    prob = load_mat("/root/reference/tests/data/robot_arm_sqp.mat")
    res = solve_dense(
        **prob, settings=Settings(kkt_solver=KKTBackend.dense_ldlt)
    )
    assert int(res.info.status) == int(Status.SOLVED)


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_dense_lu_routes_to_full_kkt(platform, monkeypatch):
    """dense_lu keeps its pivoted-LU full-KKT representation in f64 on
    every backend (cuSOLVER factors it on the GPU), with no warning."""
    import warnings

    from piqp_tpu.api import _route_backend, prepare_data
    from piqp_tpu.types import FullKKTQPData

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    data = prepare_data(**dense_strongly_convex_qp(8, 3, 4, seed=5))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        routed = _route_backend(data, Settings(kkt_solver=KKTBackend.dense_lu))
    assert type(routed) is FullKKTQPData
    assert routed.P.dtype == jnp.float64


def test_signed_pallas_kernel_matches_blocked():
    """The vmapped signed factor-with-inverse agrees with the blocked
    kernel and with dense solves."""
    from piqp_tpu.ops.pallas_chol import (
        signed_cholesky_with_inverse,
        signed_inv_solve,
    )

    N, npos = 128, 80
    s = np.concatenate([np.ones(npos), -np.ones(N - npos)])
    Ks, rhs = [], []
    for seed in range(5):
        K, _ = _random_quasidef(N, npos, seed=seed + 50)
        Ks.append(K)
        rhs.append(np.random.default_rng(seed).standard_normal(N))
    Ks = jnp.asarray(np.stack(Ks))
    rhs = jnp.asarray(np.stack(rhs))
    sj = jnp.asarray(s)

    L, Linv = jax.vmap(lambda K: signed_cholesky_with_inverse(K, sj))(Ks)
    x = jax.vmap(lambda li, b: signed_inv_solve(li, sj, b))(Linv, rhs)
    for i in range(5):
        Ki = np.asarray(Ks[i])
        Li = np.asarray(L[i])
        rec = (Li * s[None, :]) @ Li.T
        assert np.allclose(rec, Ki, atol=1e-8 * np.abs(Ki).max())
        assert np.allclose(np.asarray(Linv[i]) @ Li, np.eye(N), atol=1e-7)
        x_ref = np.linalg.solve(Ki, np.asarray(rhs[i]))
        assert np.allclose(np.asarray(x[i]), x_ref, atol=1e-7)


def test_signed_inv_unbatched_fallback():
    from piqp_tpu.ops.pallas_chol import signed_cholesky_with_inverse

    K, s = _random_quasidef(128, 70, seed=77)
    L, Linv = signed_cholesky_with_inverse(jnp.asarray(K), jnp.asarray(s))
    assert np.allclose(np.asarray(Linv) @ np.asarray(L), np.eye(128), atol=1e-8)


def test_batch_dense_ldlt_pallas_backend():
    """End-to-end: vmapped fleet through the dense_ldlt backend with
    settings.pallas_kernels=True matches the default condensed backend."""
    from piqp_tpu import prepare_batch, solve_batch

    probs = [dense_strongly_convex_qp(12, 4, 6, seed=100 + i) for i in range(4)]
    data = prepare_batch(probs)
    r_ldlt = solve_batch(
        data,
        Settings(kkt_solver=KKTBackend.dense_ldlt, pallas_kernels=True),
    )
    r_ref = solve_batch(data, Settings())
    assert np.all(np.asarray(r_ldlt.info.status) == int(Status.SOLVED))
    np.testing.assert_allclose(
        np.asarray(r_ldlt.x), np.asarray(r_ref.x), atol=1e-6, rtol=1e-6
    )


@pytest.mark.corpus
@pytest.mark.parametrize(
    "name", ["HS21", "HS35", "HS51", "HS52", "HS76", "ZECEVIC2", "LOTSCHD",
             "DUAL1", "DUAL4", "QPCBLEND"]
)
def test_dense_ldlt_small_corpus(name):
    """Maros-Meszaros small subset through the dense_ldlt full-KKT device
    backend (the robustness route's accuracy gate, mirroring the corpus
    runs of the other backends in test_corpus.py)."""
    import os

    from piqp_tpu.utils.io import load_mat

    prob = load_mat(
        os.path.join("/root/reference/tests/data/maros_meszaros", name + ".mat")
    )
    res = solve_dense(
        **prob, settings=Settings(kkt_solver=KKTBackend.dense_ldlt)
    )
    assert int(res.info.status) == int(Status.SOLVED), (
        f"{name}: {int(res.info.status)} after {int(res.info.iter)} iters"
    )
