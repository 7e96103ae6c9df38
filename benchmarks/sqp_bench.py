"""SQP update+solve benchmark — the analog of the reference's
sqp_benchmarks (/root/reference/benchmarks/src/sqp_benchmarks.cpp:16-120):
repeated update() + solve() on the chain-mass and robot-arm SQP fixtures,
per backend.

Prints one JSON line per (fixture, backend) with median wall times for the
update and the re-solve.  The reference measures sparse_ldlt vs
sparse_ldlt_cond vs sparse_multistage on a CPU; here the backends are the
device multistage backend (values re-scattered host-side, compiled solve
reused — zero retracing) and the host sparse LU backend.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import piqp_tpu
from piqp_tpu import Settings, Status, solve_prepared
from piqp_tpu import multistage as ms
from piqp_tpu.hostsparse import solve_sparse_host
from piqp_tpu.utils.io import load_mat

DATA = "/root/reference/tests/data"
FIXTURES = ["chain_mass_sqp", "scenario_mpc"]
REPS = 5


def _perturb(prob, rng, scale=1e-3):
    """SQP-style value update: perturb the linear terms, keep the pattern."""
    out = dict(prob)
    out["c"] = prob["c"] + scale * rng.standard_normal(prob["c"].shape)
    if prob.get("b") is not None:
        out["b"] = prob["b"] + scale * rng.standard_normal(prob["b"].shape)
    return out


def bench_multistage(name, mixed=False):
    """Build and upload every perturbed problem before the first dispatch,
    then time the solves back-to-back, so host work stays out of the
    timed region."""
    prob = load_mat(os.path.join(DATA, name + ".mat"), sparse=True)
    rng = np.random.default_rng(0)

    # build + upload every perturbed problem before any dispatch
    upd_ts = []
    sdatas = []
    for _ in range(REPS):
        new = _perturb(prob, rng)
        t1 = time.perf_counter()
        sd, _ = ms.from_sparse(**new)
        upd_ts.append(time.perf_counter() - t1)
        sdatas.append(jax.device_put(sd))
    jax.block_until_ready(sdatas)

    settings = Settings(mixed_precision=mixed)

    t0 = time.perf_counter()
    sdata, layout = ms.from_sparse(**prob)
    res = solve_prepared(sdata, settings)  # warmup/compile
    np.asarray(res.x)  # readback: the only reliable completion barrier here
    setup_time = time.perf_counter() - t0
    assert int(res.info.status) == Status.SOLVED, int(res.info.status)

    t0 = time.perf_counter()
    outs = [solve_prepared(sd, settings) for sd in sdatas]
    for o in outs:
        np.asarray(o.x)
    solve_ms = (time.perf_counter() - t0) / REPS * 1e3
    for o in outs:
        assert int(o.info.status) == Status.SOLVED

    # warm-started re-solves seeded from the base solve (the actual SQP
    # inner-loop pattern; compile warmup happened above via `res`)
    wres = solve_prepared(sdatas[0], settings, warm=res)
    np.asarray(wres.x)
    t0 = time.perf_counter()
    wouts = [solve_prepared(sd, settings, warm=res) for sd in sdatas]
    for o in wouts:
        np.asarray(o.x)
    warm_ms = (time.perf_counter() - t0) / REPS * 1e3

    return dict(
        fixture=name,
        backend="multistage_device_mixed" if mixed else "multistage_device",
        setup_s=round(setup_time, 3),
        update_ms=round(float(np.median(upd_ts)) * 1e3, 2),
        solve_ms=round(solve_ms, 2),
        warm_solve_ms=round(warm_ms, 2),
        iters=int(outs[-1].info.iter),
        warm_iters=int(wouts[-1].info.iter),
        device=str(jax.devices()[0]),
    )


def bench_dense_device(name):
    """Dense condensed device backend with two-phase mixed precision —
    the routing winner for n ~ 1-2k single problems (docs/performance.md).
    Same upload-everything-then-dispatch pattern as bench_multistage."""
    from piqp_tpu.api import prepare_data, _solve_fresh

    prob = load_mat(os.path.join(DATA, name + ".mat"))
    rng = np.random.default_rng(0)
    settings = piqp_tpu.Settings(mixed_precision=True)

    upd_ts = []
    datas = []
    for _ in range(REPS):
        new = _perturb(prob, rng)
        t1 = time.perf_counter()
        d = jax.device_put(prepare_data(**new))
        upd_ts.append(time.perf_counter() - t1)
        datas.append(d)
    jax.block_until_ready(datas)

    t0 = time.perf_counter()
    data = jax.device_put(prepare_data(**prob))
    res, _ = _solve_fresh(data, settings, True)  # warmup/compile
    np.asarray(res.x)
    setup_time = time.perf_counter() - t0
    assert int(res.info.status) == Status.SOLVED, int(res.info.status)

    t0 = time.perf_counter()
    outs = [_solve_fresh(d, settings, True)[0] for d in datas]
    for o in outs:
        np.asarray(o.x)
    solve_ms = (time.perf_counter() - t0) / REPS * 1e3
    for o in outs:
        assert int(o.info.status) == Status.SOLVED

    # warm-started re-solves seeded from the base solve
    from piqp_tpu.batch import warm_from_result

    warm = warm_from_result(res)
    wres, _ = _solve_fresh(datas[0], settings, True, warm)  # compile
    np.asarray(wres.x)
    t0 = time.perf_counter()
    wouts = [_solve_fresh(d, settings, True, warm)[0] for d in datas]
    for o in wouts:
        np.asarray(o.x)
    warm_ms = (time.perf_counter() - t0) / REPS * 1e3

    return dict(
        fixture=name,
        backend="dense_device_mixed",
        setup_s=round(setup_time, 3),
        update_ms=round(float(np.median(upd_ts)) * 1e3, 2),
        solve_ms=round(solve_ms, 2),
        warm_solve_ms=round(warm_ms, 2),
        iters=int(outs[-1].info.iter),
        warm_iters=int(wouts[-1].info.iter),
        device=str(jax.devices()[0]),
    )


def bench_host(name):
    prob = load_mat(os.path.join(DATA, name + ".mat"), sparse=True)
    rng = np.random.default_rng(0)
    base = solve_sparse_host(**prob)
    assert base.info.status == int(Status.SOLVED)
    solve_ts, warm_ts = [], []
    res = wres = base
    for _ in range(REPS):
        new = _perturb(prob, rng)
        t0 = time.perf_counter()
        res = solve_sparse_host(**new)
        solve_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        wres = solve_sparse_host(**new, warm=base)
        warm_ts.append(time.perf_counter() - t0)
    return dict(
        fixture=name,
        backend="sparse_host",
        update_ms=0.0,  # host path re-prepares inside solve
        solve_ms=round(float(np.median(solve_ts)) * 1e3, 2),
        warm_solve_ms=round(float(np.median(warm_ts)) * 1e3, 2),
        iters=res.info.iter,
        warm_iters=wres.info.iter,
    )


_BACKENDS = {
    "multistage": bench_multistage,
    # mixed: f32 phase-A factors
    "multistage_mixed": lambda name: bench_multistage(name, mixed=True),
    "dense": bench_dense_device,
    "host": bench_host,
}


def main():
    """With (fixture, backend) args: run that one cell.  Without args:
    run one subprocess per cell, one JAX process on the card at a time."""
    if len(sys.argv) == 3:
        name, backend = sys.argv[1], sys.argv[2]
        try:
            print(json.dumps(_BACKENDS[backend](name)), flush=True)
        except Exception as e:  # pragma: no cover
            print(json.dumps(dict(fixture=name, backend=backend,
                                  error=str(e)[:200])), flush=True)
        return

    import subprocess

    for name in FIXTURES:
        for backend in _BACKENDS:
            subprocess.run(
                [sys.executable, os.path.abspath(__file__), name, backend],
                check=False,
            )


if __name__ == "__main__":
    main()
