"""API behavior tests: warm-path compile stability (the analog of the
reference's allocation-free solve/update assertions, solver_test.cpp:62-94 —
here the resource that must not leak is XLA compilations), settings
verification, and reference-name compatibility.
"""

import jax
import numpy as np
import pytest

from piqp_tpu import (
    DenseSolver,
    KKTBackend,
    Settings,
    Status,
)
from piqp_tpu.utils.random import dense_strongly_convex_qp


def test_update_resolve_does_not_retrace():
    """update() + solve() must reuse the compiled executable — the JAX
    analog of PIQP's allocation-free update path (solver.hpp:218-308,
    asserted via the Eigen malloc guard in the reference tests)."""
    prob = dense_strongly_convex_qp(16, 4, 8, seed=0)
    s = DenseSolver()
    s.setup(**prob)
    assert s.solve() == Status.SOLVED

    from piqp_tpu.api import _solve_fresh

    compiles_before = _solve_fresh._cache_size()
    rng = np.random.default_rng(1)
    for k in range(3):
        s.update(c=prob["c"] + 1e-3 * rng.standard_normal(16))
        assert s.solve() == Status.SOLVED
    assert _solve_fresh._cache_size() == compiles_before, "solve retraced"


def test_invalid_settings_rejected():
    prob = dense_strongly_convex_qp(8, 2, 4, seed=0)
    s = DenseSolver(Settings(max_iter=-1))
    s.setup(**prob)
    assert s.solve() == Status.INVALID_SETTINGS


def test_piqp_backend_name_aliases():
    assert KKTBackend.from_piqp("sparse_ldlt") == KKTBackend.sparse_host
    assert KKTBackend.from_piqp("sparse_ldlt_cond") == KKTBackend.dense_cholesky
    assert KKTBackend.from_piqp("sparse_multistage") == KKTBackend.multistage
    assert KKTBackend.from_piqp("dense_cholesky") == KKTBackend.dense_cholesky
    assert KKTBackend.from_piqp("dense_lu") == KKTBackend.dense_lu
    with pytest.raises(ValueError):
        KKTBackend.from_piqp("nope")


def test_status_to_string():
    from piqp_tpu import status_to_string

    assert status_to_string(1) == "solved"
    assert status_to_string(-2) == "primal infeasible"
    assert status_to_string(12345) == "unknown"


def test_info_timings_are_pytree_leaves():
    """The six timing fields (results.hpp:83-88) are real Info leaves:
    filled under compute_timings, surviving jax.tree.map (they were dynamic
    attributes dropped by any tree op before round 2)."""
    import jax

    prob = dense_strongly_convex_qp(12, 3, 6, seed=7)
    s = DenseSolver(Settings(compute_timings=True))
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    info = s.result.info
    assert float(info.solve_time) > 0.0
    assert float(info.setup_time) > 0.0
    assert float(info.run_time) >= float(info.solve_time)
    assert float(info.kkt_factor_time) > 0.0
    assert float(info.kkt_solve_time) > 0.0
    # survives tree ops
    mapped = jax.tree.map(lambda x: x, s.result)
    assert float(mapped.info.solve_time) == float(info.solve_time)

    # host sparse path fills exact cumulative factor/solve timers
    import scipy.sparse as sp
    from piqp_tpu.hostsparse import solve_sparse_host

    res = solve_sparse_host(
        sp.csc_matrix(prob["P"]), prob["c"], sp.csc_matrix(prob["A"]),
        prob["b"], sp.csc_matrix(prob["G"]), prob["h_l"], prob["h_u"],
        prob["x_l"], prob["x_u"],
    )
    assert res.info.solve_time > 0.0
    assert 0.0 < res.info.kkt_factor_time < res.info.solve_time
    assert 0.0 < res.info.kkt_solve_time < res.info.solve_time


def test_update_selective_transfer():
    """SQP-loop data-movement contract (VERDICT round-1 item 3, mirroring
    solver.hpp:218-359): a vector-only update must NOT re-upload the O(n^2)
    matrices — the device leaves stay the *same buffers* — while named
    matrix updates replace exactly the named leaves."""
    prob = dense_strongly_convex_qp(20, 5, 10, seed=2)
    s = DenseSolver()
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    d0 = s._data

    # vector-only update: matrices must be identical device objects
    s.update(c=prob["c"] * 1.1, b=prob["b"] * 0.9)
    d1 = s._data
    assert d1.P is d0.P and d1.A is d0.A and d1.G is d0.G
    assert d1.c is not d0.c and d1.b is not d0.b
    assert d1.h_l is d0.h_l and d1.x_u is d0.x_u
    assert s.solve() == Status.SOLVED

    # bound update with unchanged dead-row pattern: G stays resident
    s.update(h_u=prob["h_u"] + 0.5)
    d2 = s._data
    assert d2.G is d1.G and d2.P is d1.P
    assert s.solve() == Status.SOLVED

    # matrix update replaces only the named matrix
    P2 = prob["P"] + 0.1 * np.eye(20)
    s.update(P=P2)
    d3 = s._data
    assert d3.P is not d2.P
    assert d3.A is d2.A and d3.G is d2.G
    assert s.solve() == Status.SOLVED
    # solution reflects the accumulated updates
    from helpers import check_optimality

    prob2 = dict(
        prob, P=P2, c=prob["c"] * 1.1, b=prob["b"] * 0.9,
        h_u=prob["h_u"] + 0.5,
    )
    check_optimality(prob2, s.result, tol=1e-6)


def test_update_dead_row_pattern_change():
    """Turning both bounds of a G row infinite after setup must re-zero the
    resident G row (disable_inf_constraints semantics on the update path,
    dense/data.hpp:144-169)."""
    prob = dense_strongly_convex_qp(12, 3, 6, seed=4)
    s = DenseSolver()
    s.setup(**prob)
    assert s.solve() == Status.SOLVED
    x_ref = np.asarray(s.result.x)

    # kill row 0 entirely
    h_l2 = prob["h_l"].copy(); h_l2[0] = -np.inf
    h_u2 = prob["h_u"].copy(); h_u2[0] = np.inf
    s.update(h_l=h_l2, h_u=h_u2)
    assert np.all(np.asarray(s._data.G)[0] == 0.0)
    assert s.solve() == Status.SOLVED

    # resurrect it -> G row restored from the raw data
    s.update(h_l=prob["h_l"], h_u=prob["h_u"])
    assert np.any(np.asarray(s._data.G)[0] != 0.0)
    assert s.solve() == Status.SOLVED
    np.testing.assert_allclose(np.asarray(s.result.x), x_ref, atol=1e-7)


def test_settings_attribute_mutation():
    """Reference Python API parity: solver.settings.field = value works
    (piqp_python.cpp exposes mutable settings); Settings stays frozen
    underneath and the next solve honors the new values."""
    import numpy as np
    import pytest as _pytest

    from piqp_tpu import DenseSolver, Settings, Status

    P = np.array([[6.0, 0.0], [0.0, 4.0]])
    c = np.array([-1.0, -4.0])
    A = np.array([[1.0, -2.0]])
    b = np.array([0.0])

    s = DenseSolver()
    s.settings.eps_abs = 1e-6
    assert s.settings.eps_abs == 1e-6
    assert s.settings == Settings(eps_abs=1e-6)
    with _pytest.raises(AttributeError):
        s.settings.not_a_field = 1.0
    with _pytest.raises(Exception):
        # the underlying Settings stays frozen
        object.__getattribute__(s, "_settings").eps_abs = 1.0

    s.settings.max_iter = 1
    s.setup(P, c, A, b)
    assert s.solve() == Status.MAX_ITER_REACHED
    s.settings.max_iter = 250
    assert s.solve() == Status.SOLVED
    # assignment of a whole Settings (and of another solver's view) works
    s.settings = Settings()
    s2 = DenseSolver(Settings(eps_abs=1e-7))
    s.settings = s2.settings
    assert s.settings.eps_abs == 1e-7
