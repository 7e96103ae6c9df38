"""BASELINE config 4: N=100-stage block-tridiagonal MPC QP through the
multistage (Riccati/Schur-analog) backend, plus the horizon-sharded run.

Usage:
  python benchmarks/horizon_bench.py            # single-device latency
  python benchmarks/horizon_bench.py --mesh     # horizon-sharded over every
                                                # visible device

Prints one JSON line per mode.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

T = 100  # the BASELINE config-4 horizon


def main():
    mesh_mode = "--mesh" in sys.argv

    import numpy as np
    import jax

    from piqp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("horizon_bench: needs a GPU, found " + jax.devices()[0].platform,
              file=sys.stderr)
        sys.exit(1)

    from piqp_tpu import Settings, Status, solve_prepared
    from piqp_tpu import multistage as ms

    sdata = ms.random_multistage_qp(T=T, D=8, Da=4, ra=4, rg=4, seed=4)

    if mesh_mode:
        from jax.sharding import Mesh
        from piqp_tpu.parallel.horizon import solve_horizon_sharded

        mesh = Mesh(np.array(jax.devices()), ("sp",))
        res = solve_horizon_sharded(sdata, mesh, "sp")
        np.asarray(res.x)
        t0 = time.perf_counter()
        res = solve_horizon_sharded(sdata, mesh, "sp")
        np.asarray(res.x)
        cold_dt = time.perf_counter() - t0

        # warm-started MPC re-solve after a cost shift
        sdata2 = sdata.replace(c=sdata.c * 1.01)
        resw = solve_horizon_sharded(sdata2, mesh, "sp", warm=res)  # compile
        np.asarray(resw.x)
        t0 = time.perf_counter()
        resw = solve_horizon_sharded(sdata2, mesh, "sp", warm=res)
        np.asarray(resw.x)
        warm_dt = time.perf_counter() - t0
        print(json.dumps(dict(
            mode="horizon_sharded", T=T, devices=len(mesh.devices.ravel()),
            platform=jax.default_backend(),
            status=int(res.info.status), iters=int(res.info.iter),
            solve_ms=round(cold_dt * 1e3, 2),
            warm_status=int(resw.info.status),
            warm_iters=int(resw.info.iter),
            warm_solve_ms=round(warm_dt * 1e3, 2),
        )))
        return

    sdata = jax.device_put(sdata)
    jax.block_until_ready(sdata)
    res = solve_prepared(sdata)  # warmup/compile
    np.asarray(res.x)
    assert int(res.info.status) == Status.SOLVED, int(res.info.status)

    t0 = time.perf_counter()
    res = solve_prepared(sdata)
    np.asarray(res.x)
    cold_ms = (time.perf_counter() - t0) * 1e3

    # warm-started re-solve after an MPC-style cost shift
    sdata2 = sdata.replace(c=sdata.c * 1.01)
    resw = solve_prepared(sdata2, warm=res)  # compile (warm variant)
    np.asarray(resw.x)
    t0 = time.perf_counter()
    resw = solve_prepared(sdata2, warm=res)
    np.asarray(resw.x)
    warm_ms = (time.perf_counter() - t0) * 1e3

    print(json.dumps(dict(
        mode="single_device", T=T, platform=jax.default_backend(),
        device=str(jax.devices()[0]),
        status=int(res.info.status), iters=int(res.info.iter),
        solve_ms=round(cold_ms, 2),
        warm_status=int(resw.info.status), warm_iters=int(resw.info.iter),
        warm_solve_ms=round(warm_ms, 2),
    )))


if __name__ == "__main__":
    main()
