"""Measure the device-vs-host routing crossover for unstructured sparse
problems (SparseSolver.DENSE_ROUTING_MAX_N, sparse.py).

The reference solves every corpus instance through one sparse LDL^T
(/root/reference/tests/src/sparse/maros_meszaros_tests.cpp:22-36); we route
by size instead (SURVEY.md section 7 design delta 3): small/medium sparse
problems densify onto the device's condensed Cholesky, large ones stay on the
host sparse backend.  This script measures BOTH routes on a ladder of real
Maros-Meszaros instances spanning n = 649..3873 and reports the measured
crossover, so the routing default is evidence, not folklore
(types.py Settings.dense_routing_max_n docstring).

Method per instance:
  - host:   solve_sparse_host wall time (the backend is NumPy/SciPy; its
            first call has no compile component worth separating).
  - device: solve_dense on the padded problem (mixed precision two-phase,
            the corpus-accurate device configuration).  The first call
            compiles; we time the SECOND call (steady-state, the number a
            routing decision actually faces — includes the per-dispatch
            cost, which is real for single-problem routing).

Usage: python benchmarks/routing_crossover.py [--quick]
Prints one JSON line per instance plus a summary line.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

import jax

from piqp_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from piqp_tpu import Settings, Status, solve_dense
from piqp_tpu.hostsparse import solve_sparse_host
from piqp_tpu.utils.io import load_mat
from piqp_tpu.utils.pad import pad_problem, unpad_result

MAROS = "/root/reference/tests/data/maros_meszaros"

# ladder spanning the plausible crossover region (n, name)
LADDER = [
    "PRIMAL2",      # n=649
    "QSCSD1",       # n=760
    "QSCFXM2",      # n=914
    "CVXQP2_M",     # n=1000, dense-ish QP
    "QSCRS8",       # n=1169
    "QSCSD6",       # n=1350
    "PRIMAL4",      # n=1489
    "QSCTAP2",      # n=1880
    "YAO",          # n=2002
    "MOSARQP1",     # n=2500
    "QSCSD8",       # n=2750
    "AUG3DCQP",     # n=3873
]
QUICK = [l for l in LADDER if l in
         ("PRIMAL2", "CVXQP2_M", "PRIMAL4", "YAO", "QSCSD8")]


def main():
    names = QUICK if "--quick" in sys.argv else LADDER
    dev = str(jax.devices()[0])
    dev_settings = Settings(mixed_precision=True)
    results = []
    for name in names:
        prob = load_mat(f"{MAROS}/{name}.mat")
        n = prob["P"].shape[0]

        # host route
        t0 = time.perf_counter()
        hres = solve_sparse_host(**prob, settings=Settings())
        host_s = time.perf_counter() - t0
        host_ok = int(hres.info.status) == int(Status.SOLVED)

        # device route (condensed dense, mixed precision)
        padded, dims = pad_problem(prob, bucket=True)
        try:
            res = solve_dense(**padded, settings=dev_settings)
            jax.block_until_ready(res.x)
            t0 = time.perf_counter()
            res = solve_dense(**padded, settings=dev_settings)
            jax.block_until_ready(res.x)
            device_s = time.perf_counter() - t0
            view = unpad_result(res, dims)
            device_ok = int(res.info.status) == int(Status.SOLVED)
            device_err = None
        except Exception as e:  # OOM / compile failure: route says host
            device_s, device_ok, device_err = float("inf"), False, str(e)[:160]

        row = dict(
            name=name, n=int(n), device=dev,
            host_s=round(host_s, 3), host_ok=host_ok,
            device_s=(round(device_s, 3) if np.isfinite(device_s) else None),
            device_ok=device_ok,
            winner=("device" if device_ok and device_s < host_s else "host"),
        )
        if device_err:
            row["device_err"] = device_err
        results.append(row)
        print(json.dumps(row), flush=True)

    # crossover: the largest n whose device route is correct AND faster,
    # below which the device also wins consistently
    device_wins = [r["n"] for r in results if r["winner"] == "device"]
    crossover = max(device_wins) if device_wins else 0
    summary = dict(
        summary="routing_crossover", device=dev,
        measured_crossover_n=crossover,
        device_wins=sorted(device_wins),
        host_wins=sorted(r["n"] for r in results if r["winner"] == "host"),
    )
    print(json.dumps(summary), flush=True)
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "routing_crossover.json"), "w") as f:
        json.dump(dict(instances=results, **summary), f, indent=1)


if __name__ == "__main__":
    main()
