"""BASELINE config 5: large-scale scenario program — an S-scenario
two-stage stochastic QP with consensus coupling through the first-stage
decision, solved as ONE structured problem.

Design: consensus coupling IS the multistage backend's arrow.
Each scenario is a stage block (local recourse variables, D of them), the
shared first-stage decision is the arrow block (Da variables), and the
scenario<->first-stage coupling rows live in Ag.  The sub-diagonal is zero,
so the "chain" degenerates to S independent blocks + one Schur complement
on the arrow — which is exactly how a scenario decomposition solves it,
except here the whole factorization is three batched einsums + one small
Cholesky per IPM iteration, and the scenario axis shards over a device
mesh (--mesh) with one psum-shaped reduction for the arrow Schur term.

Usage:
  python benchmarks/scenario_bench.py [S]        # single device, default
                                                 # S=10000 scenarios
  python benchmarks/scenario_bench.py [S] --mesh # scenario axis sharded
                                                 # over every visible device

Prints one JSON line: status, IPM iterations, warm solve latency,
scenarios/sec.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

D = 4    # recourse variables per scenario
DA = 8   # first-stage (consensus) variables
RA = 2   # coupling equality rows per scenario


def build(S: int, seed: int = 0):
    """S-scenario two-stage stochastic QP with a feasible interior."""
    import numpy as np

    rng = np.random.default_rng(seed)
    # local strongly convex costs, scenario-dependent
    M = rng.standard_normal((S, D, D)) * 0.3
    Pd = M @ M.transpose(0, 2, 1) + np.eye(D)[None] * (1.0 + rng.uniform(0, 1, (S, 1, 1)))
    Pa = np.zeros((S, DA, D))  # no cost cross-terms
    Pc = np.eye(DA) * 2.0      # first-stage cost
    c = rng.standard_normal(S * D + DA) * 0.5

    # coupling: A1 x_s + Ag xg = b_s  (recourse balances the first stage)
    A1 = rng.standard_normal((S, RA, D))
    Ag = rng.standard_normal((S, RA, DA)) * 0.5
    xg_sol = rng.uniform(-0.5, 0.5, DA)
    xs_sol = rng.uniform(-0.5, 0.5, (S, D))
    b = (np.einsum("srd,sd->sr", A1, xs_sol)
         + Ag @ xg_sol).reshape(-1)

    # box bounds with the solution interior
    n = S * D + DA
    x_l = np.full(n, -2.0)
    x_u = np.full(n, 2.0)

    from piqp_tpu import multistage as ms

    return ms.from_stage_blocks(
        Pd, None, Pa, Pc, c,
        A1=A1, A2=None, Ag=Ag, b=b,
        x_l=x_l, x_u=x_u,
    )


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    mesh_mode = "--mesh" in sys.argv
    S = int(args[0]) if args else 10000

    import numpy as np
    import jax

    from piqp_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if jax.devices()[0].platform != "gpu":
        print("scenario_bench: needs a GPU, found " + jax.devices()[0].platform,
              file=sys.stderr)
        sys.exit(1)

    from piqp_tpu import Status, solve_prepared

    sdata = build(S)

    if mesh_mode:
        from jax.sharding import Mesh
        from piqp_tpu.parallel.horizon import solve_horizon_sharded

        mesh = Mesh(np.array(jax.devices()), ("sp",))
        res = solve_horizon_sharded(sdata, mesh, "sp")
        np.asarray(res.x)
        t0 = time.perf_counter()
        res = solve_horizon_sharded(sdata, mesh, "sp")
        np.asarray(res.x)
        dt = time.perf_counter() - t0
        print(json.dumps(dict(
            mode="scenario_sharded", scenarios=S,
            devices=len(mesh.devices.ravel()), platform=jax.default_backend(),
            status=int(res.info.status), iters=int(res.info.iter),
            warm_solve_ms=round(dt * 1e3, 2),
            scenarios_per_s=round(S / dt, 1),
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
    dt = time.perf_counter() - t0

    print(json.dumps(dict(
        mode="single_device", scenarios=S, platform=jax.default_backend(),
        device=str(jax.devices()[0]),
        status=int(res.info.status), iters=int(res.info.iter),
        warm_solve_ms=round(dt * 1e3, 2),
        scenarios_per_s=round(S / dt, 1),
    )))


if __name__ == "__main__":
    main()
