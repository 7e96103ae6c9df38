"""Batched (vmapped) and sharded solve tests — the headline device path
(SURVEY.md section 7 S5/S8 analogs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from piqp_tpu import Settings, Status, solve_dense
from piqp_tpu.batch import prepare_batch, solve_batch
from piqp_tpu.utils.random import dense_strongly_convex_qp

from helpers import check_optimality

BATCH = 8
N, P, M = 16, 4, 8


@pytest.fixture(scope="module")
def problems():
    return [dense_strongly_convex_qp(N, P, M, seed=100 + i) for i in range(BATCH)]


def test_batch_solves_all(problems):
    data = prepare_batch(problems)
    res = solve_batch(data)
    statuses = np.asarray(res.info.status)
    assert np.all(statuses == int(Status.SOLVED)), statuses
    for i, prob in enumerate(problems):
        res_i = jax.tree.map(lambda x: x[i], res)
        check_optimality(prob, res_i, tol=1e-6)


def test_batch_matches_single(problems):
    data = prepare_batch(problems)
    res = solve_batch(data)
    # the batched path must agree with the single-problem path bit-for-bit
    # in exact arithmetic; allow tiny float drift from fusion differences
    single = solve_dense(**problems[0])
    np.testing.assert_allclose(
        np.asarray(res.x[0]), np.asarray(single.x), rtol=1e-9, atol=1e-9
    )


def test_batch_sharded(problems):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    n_dev = len(jax.devices())
    assert n_dev == 8, f"expected 8 virtual devices, got {n_dev}"
    mesh = Mesh(np.array(jax.devices()), axis_names=("dp",))
    sharding = NamedSharding(mesh, PS("dp"))

    data = prepare_batch(problems)
    res = solve_batch(data, sharding=sharding)
    statuses = np.asarray(res.info.status)
    assert np.all(statuses == int(Status.SOLVED))
    # agrees with the unsharded solve to solver accuracy (different executable
    # => different reduction order; bitwise equality is not expected)
    res2 = solve_batch(data)
    np.testing.assert_allclose(
        np.asarray(res.x), np.asarray(res2.x), rtol=1e-6, atol=1e-7
    )


def test_batched_multistage_scenarios():
    """A fleet of perturbed MPC scenarios over one stage structure solves
    as a single vmapped dispatch (BASELINE.md config 5's shape): the batch
    machinery is representation-agnostic, so the structured backend
    composes with vmap exactly like the dense one."""
    import numpy as np
    from piqp_tpu import multistage as ms
    from piqp_tpu.batch import solve_batch

    base = ms.random_multistage_qp(T=16, D=4, Da=2, ra=2, rg=2, seed=0)
    rng = np.random.default_rng(1)
    B = 4
    datas = [
        base.replace(c=base.c + 0.01 * jnp.asarray(rng.standard_normal(base.n)))
        for _ in range(B)
    ]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)
    res = solve_batch(batch)
    assert np.all(np.asarray(res.info.status) == 1)


def test_batch_honors_kkt_solver_setting():
    """solve_batch must route Settings(kkt_solver=dense_lu) to the
    full-KKT backend, same as solve_prepared (ADVICE r1: it was silently
    ignored in batch mode)."""
    from piqp_tpu import KKTBackend
    from piqp_tpu.types import FullKKTQPData

    probs = [dense_strongly_convex_qp(8, 2, 4, seed=s) for s in range(3)]
    data = prepare_batch(probs)
    st = Settings(kkt_solver=KKTBackend.dense_lu)
    from piqp_tpu.batch import _route_backend

    assert type(_route_backend(data, st)) is FullKKTQPData
    res = solve_batch(data, settings=st)
    assert all(int(s) == Status.SOLVED for s in np.asarray(res.info.status))


def test_compact_matches_one_pass():
    """Straggler compaction solves every problem to the same tolerances as
    the one-pass batch (statuses identical, solutions within the KKT
    tolerance), with a deliberately tiny phase-1 budget so phase 2
    actually runs."""
    from piqp_tpu.batch import solve_batch_compact, warm_from_result

    probs = [dense_strongly_convex_qp(24, 8, 12, seed=300 + i) for i in range(24)]
    data = prepare_batch(probs)
    r1 = solve_batch(data)
    rc = solve_batch_compact(data, phase1_iters=6)
    np.testing.assert_array_equal(
        np.asarray(r1.info.status), np.asarray(rc.info.status)
    )
    assert np.all(np.asarray(rc.info.status) == int(Status.SOLVED))
    np.testing.assert_allclose(np.asarray(rc.x), np.asarray(r1.x), atol=1e-6)
    # stragglers carry phase-1 + phase-2 iteration counts
    assert int(np.max(np.asarray(rc.info.iter))) >= 6

    # warm re-solve path
    wdata = data.replace(c=data.c * 1.01)
    rw = solve_batch_compact(wdata, warm=warm_from_result(r1), phase1_iters=3)
    assert np.all(np.asarray(rw.info.status) == int(Status.SOLVED))

    # chunked phase 1 composes with compaction
    rk = solve_batch_compact(data, phase1_iters=6, chunk=8)
    np.testing.assert_array_equal(
        np.asarray(rk.info.status), np.asarray(r1.info.status)
    )
    np.testing.assert_allclose(np.asarray(rk.x), np.asarray(r1.x), atol=1e-6)


def test_compact_short_circuits_when_all_converge():
    from piqp_tpu.batch import solve_batch_compact

    probs = [dense_strongly_convex_qp(12, 4, 6, seed=400 + i) for i in range(8)]
    data = prepare_batch(probs)
    rc = solve_batch_compact(data, phase1_iters=200)
    assert np.all(np.asarray(rc.info.status) == int(Status.SOLVED))


def test_compact_preserves_infeasibility_detection():
    """An infeasible problem in the batch must come back certified, not
    retried forever: phase 2 gives it the full budget and the same
    detection path."""
    from piqp_tpu.batch import solve_batch_compact

    probs = [dense_strongly_convex_qp(12, 4, 6, seed=500 + i) for i in range(7)]
    # make one problem primal infeasible: contradictory equality rows
    bad = dense_strongly_convex_qp(12, 4, 6, seed=599)
    bad["A"] = np.vstack([bad["A"][:2], bad["A"][:2]])
    bad["b"] = np.concatenate([bad["b"][:2], bad["b"][:2] + 1.0])
    probs.append(bad)
    data = prepare_batch(probs)
    rc = solve_batch_compact(data, phase1_iters=4)
    st = np.asarray(rc.info.status)
    assert np.all(st[:7] == int(Status.SOLVED))
    assert st[7] == int(Status.PRIMAL_INFEASIBLE)


def test_sqp_fused_rounds_match_sequential(problems):
    """The fused lax.scan SQP sweep (solve_batch_sqp) must produce the same
    final iterates and statuses as issuing the same warm re-solves as
    separate dispatches with the same per-round costs."""
    from piqp_tpu.batch import solve_batch_sqp, warm_from_result

    data = prepare_batch(problems)
    cold = solve_batch(data)
    rounds = 3

    wf, statuses, iters = solve_batch_sqp(data, rounds=rounds, warm=cold)
    assert statuses.shape == (BATCH, rounds)
    assert np.all(np.asarray(statuses) == int(Status.SOLVED))

    # sequential reference: same schedule c_r = c * (1 + 0.01 (r+1))
    warm = warm_from_result(cold)
    for r in range(rounds):
        dr = jax.tree.map(lambda x: x, data)
        dr = dr.replace(c=data.c * (1.0 + 0.01 * (r + 1)))
        res = solve_batch(dr, warm=warm)
        warm = warm_from_result(res)
    np.testing.assert_allclose(
        np.asarray(wf.x), np.asarray(warm.x), rtol=1e-7, atol=1e-9
    )


def test_sqp_fused_explicit_c_rounds(problems):
    """Explicit per-round cost schedules (the general SQP linearization
    path) are accepted as a (rounds, n) broadcast or (B, rounds, n)."""
    from piqp_tpu.batch import solve_batch_sqp

    data = prepare_batch(problems)
    cold = solve_batch(data)
    rounds = 2
    c_rounds = np.stack([
        np.asarray(data.c) * (1.0 + 0.005 * (r + 1)) for r in range(rounds)
    ], axis=1)  # (B, rounds, n)
    wf, statuses, _ = solve_batch_sqp(
        data, rounds=rounds, warm=cold, c_rounds=jnp.asarray(c_rounds)
    )
    assert np.all(np.asarray(statuses) == int(Status.SOLVED))
