"""Horizon-sharded multistage backend tests.

Runs on the virtual 8-device CPU mesh (conftest).  Oracle: the sequential
multistage backend (itself validated against the dense condensed backend,
test_multistage.py) — the partitioned Schur-complement factorization must
reproduce its factor/solve results and full IPM solutions.

NOTE: named test_zz_* so these run LAST.  On the forced-host-platform CPU
backend, running shard_map collectives leaves the process in a state where
a later large XLA *compilation* can segfault (upstream jaxlib issue,
reproduced deterministically with this suite; GPU and standalone runs
are unaffected).  Keeping the mesh tests at the end means no compilation
follows them in-process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import piqp_tpu  # noqa: F401  (registers dispatch)
from piqp_tpu import Settings, Status, solve_prepared
from piqp_tpu import kkt as kkt_mod
from piqp_tpu import multistage as ms
from piqp_tpu.parallel import pad_stages, shard_horizon, solve_horizon_sharded
from piqp_tpu.types import Vars

from test_multistage import _rand_vars

NDEV = 4


def _mesh(ndev=NDEV):
    return Mesh(np.array(jax.devices()[:ndev]), axis_names=("sp",))


CASES = [
    dict(T=8, D=3, Da=2, ra=2, rg=2, seed=0),
    dict(T=16, D=4, Da=0, ra=2, rg=3, seed=1),
    dict(T=8, D=2, Da=1, ra=0, rg=2, seed=2),
    # T=68 over 4 devices -> Qi=16: chunk interiors factor by cyclic
    # reduction (log-depth per chip) instead of the sequential sweep
    dict(T=68, D=3, Da=2, ra=2, rg=2, seed=3),
]


@pytest.mark.parametrize("case", CASES)
def test_sharded_factor_solve_matches_sequential(case):
    settings = Settings()
    sdata = ms.random_multistage_qp(**case)
    mesh = _mesh()
    shdata = shard_horizon(sdata, mesh)
    assert shdata.T == sdata.T  # no padding needed for these cases

    vars = _rand_vars(sdata, case["seed"] + 50)
    info_rho, info_delta = 1e-6, 1e-4
    P_diag = piqp_tpu.ops.P_diag(sdata)

    ks_seq = kkt_mod.compute_scalings(
        sdata, settings, vars, info_rho, info_delta, jnp.asarray(False), P_diag
    )
    ks_seq, ok_seq = kkt_mod.factor(sdata, ks_seq)
    assert bool(ok_seq)

    ks_sh = kkt_mod.compute_scalings(
        shdata, settings, vars, info_rho, info_delta, jnp.asarray(False), P_diag
    )
    ks_sh, ok_sh = kkt_mod.factor(shdata, ks_sh)
    assert bool(ok_sh)

    rng = np.random.default_rng(7)
    v = jnp.asarray(rng.standard_normal(sdata.n))
    x_seq = kkt_mod.condensed_solve_x(sdata, ks_seq, v)
    x_sh = kkt_mod.condensed_solve_x(shdata, ks_sh, v)
    np.testing.assert_allclose(
        np.asarray(x_sh), np.asarray(x_seq), rtol=1e-9, atol=1e-10
    )


@pytest.mark.parametrize("case", CASES[:2])
def test_sharded_full_solve_matches_sequential(case):
    sdata = ms.random_multistage_qp(**case)
    res_seq = solve_prepared(sdata)
    assert int(res_seq.info.status) == Status.SOLVED

    res_sh = solve_horizon_sharded(sdata, _mesh())
    assert int(res_sh.info.status) == Status.SOLVED
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_seq.x), rtol=1e-6, atol=1e-7
    )
    np.testing.assert_allclose(
        np.asarray(res_sh.y), np.asarray(res_seq.y), rtol=1e-6, atol=1e-6
    )


def test_pad_stages_preserves_solution():
    case = dict(T=5, D=3, Da=2, ra=2, rg=2, seed=4)
    sdata = ms.random_multistage_qp(**case)
    res_seq = solve_prepared(sdata)
    assert int(res_seq.info.status) == Status.SOLVED

    # T=5 over 4 devices forces padding to T=8
    res_sh = solve_horizon_sharded(sdata, _mesh())
    assert int(res_sh.info.status) == Status.SOLVED

    T, D, Da = case["T"], case["D"], case["Da"]
    x_sh = np.asarray(res_sh.x)
    T_pad = (x_sh.shape[0] - Da) // D
    # original stage coords + arrow tail
    x_orig = np.concatenate(
        [x_sh[: T * D], x_sh[T_pad * D:]]
    )
    np.testing.assert_allclose(
        x_orig, np.asarray(res_seq.x), rtol=1e-6, atol=1e-7
    )
    # padded stages solve the isolated identity sub-problem -> exactly 0
    np.testing.assert_allclose(x_sh[T * D: T_pad * D], 0.0, atol=1e-9)


def test_eight_device_mesh():
    case = dict(T=16, D=3, Da=2, ra=2, rg=2, seed=6)
    sdata = ms.random_multistage_qp(**case)
    res_seq = solve_prepared(sdata)
    res_sh = solve_horizon_sharded(sdata, _mesh(8))
    assert int(res_sh.info.status) == Status.SOLVED
    np.testing.assert_allclose(
        np.asarray(res_sh.x), np.asarray(res_seq.x), rtol=1e-6, atol=1e-7
    )


def test_2d_fleet_dp_x_sp():
    """Scenario fleet of multistage QPs on a 2D mesh: batch axis sharded
    over dp, stage-blocked tensors over sp — GSPMD partitions the batched
    block einsums/scans from the input shardings alone (no shard_map)."""
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from piqp_tpu import Settings, multistage as ms
    from piqp_tpu import ruiz, solver

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("dp", "sp"))
    base = ms.random_multistage_qp(T=16, D=4, Da=2, ra=2, rg=2, seed=0)
    rng = np.random.default_rng(1)
    datas = [
        base.replace(c=base.c + 0.01 * jnp.asarray(rng.standard_normal(base.n)))
        for _ in range(2)
    ]
    fleet = jax.tree.map(lambda *xs: jnp.stack(xs), *datas)

    def spec(x):
        if x.ndim >= 3 and x.shape[1] == base.T:
            return P("dp", "sp")
        return P("dp")

    fleet = jax.tree.map(
        lambda x: jax.device_put(x, NamedSharding(mesh, spec(x))), fleet
    )
    settings = Settings()

    def one(d):
        sd, sc = ruiz.equilibrate(d, settings.preconditioner_iter,
                                  settings.preconditioner_scale_cost)
        return solver.solve_scaled(sd, sc, settings, True)

    with jax.default_matmul_precision("highest"):
        res = jax.jit(jax.vmap(one))(fleet)
    res = jax.block_until_ready(res)
    assert np.all(np.asarray(res.info.status) == 1)


def test_sharded_warm_restart_mpc_loop():
    """Warm-started sharded re-solve (the MPC pattern: solve, perturb data,
    warm re-solve) converges in fewer iterations to the same solution."""
    sdata = ms.random_multistage_qp(T=8, D=3, Da=2, ra=2, rg=2, seed=11)
    mesh = _mesh()
    res0 = solve_horizon_sharded(sdata, mesh)
    assert int(res0.info.status) == Status.SOLVED

    bumped = sdata.replace(c=sdata.c * 1.02)
    res_cold = solve_horizon_sharded(bumped, mesh)
    res_warm = solve_horizon_sharded(bumped, mesh, warm=res0)
    assert int(res_warm.info.status) == Status.SOLVED
    np.testing.assert_allclose(
        np.asarray(res_warm.x), np.asarray(res_cold.x), rtol=1e-6, atol=1e-7
    )
    assert int(res_warm.info.iter) <= int(res_cold.info.iter)

    # layout mismatch (unpadded warm vars) is rejected with a clear error
    from piqp_tpu.types import BasicVars

    short = BasicVars(
        x=res0.x[:-1], y=res0.y, z_l=res0.z_l, z_u=res0.z_u,
        z_bl=res0.z_bl[:-1], z_bu=res0.z_bu[:-1],
    )
    with pytest.raises(ValueError, match="padded stage layout"):
        solve_horizon_sharded(bumped, mesh, warm=short)


def test_sharded_solve_does_not_retrace():
    """Repeated solve_horizon_sharded calls (the MPC loop) must hit the
    jit cache — round 1 rebuilt a fresh closure per call and recompiled
    the most expensive executable in the repo every step."""
    from piqp_tpu.parallel.horizon import _solve_sharded_jit

    sdata = ms.random_multistage_qp(T=8, D=3, Da=2, ra=2, rg=2, seed=9)
    mesh = _mesh()
    res = solve_horizon_sharded(sdata, mesh)
    assert int(res.info.status) == Status.SOLVED
    compiles_before = _solve_sharded_jit._cache_size()
    for k in range(3):
        bumped = sdata.replace(c=sdata.c + 1e-3 * (k + 1))
        res = solve_horizon_sharded(bumped, mesh)
        assert int(res.info.status) == Status.SOLVED
    assert _solve_sharded_jit._cache_size() == compiles_before, "retraced"
