"""Full-corpus report artifact: every Maros-Meszaros QP and Netlib LP
instance solved through the host sparse backend, with per-instance
status / iterations / wall time, written to benchmarks/corpus_report.json.

This is the committed evidence behind the corpus pass-rate claims
(reference gates: tests/src/sparse/maros_meszaros_tests.cpp:22-36 — every
instance returns PIQP_SOLVED; netlib_lp_tests.cpp:23-55 — feasible LPs
SOLVED, infeasible LPs certified PRIMAL/DUAL_INFEASIBLE with
infeasibility_threshold = 0.01).  The default test run caps instances at
n <= 2048 for CI time (tests/test_corpus.py); this script runs EVERYTHING
and records the tail so the claim is reproducible, not folklore.

Usage: python benchmarks/corpus_report.py [--max-n N] [--resume]
  --resume: keep existing per-instance rows (re-run only missing ones),
  so an interrupted run continues instead of restarting.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np

from piqp_tpu import Settings, Status
from piqp_tpu.hostsparse import solve_sparse_host
from piqp_tpu.utils.io import load_mat

DATA = "/root/reference/tests/data"
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "corpus_report.json")

SUITES = [
    ("maros_meszaros", DATA + "/maros_meszaros", Settings(),
     (int(Status.SOLVED),)),
    ("netlib_feasible", DATA + "/netlib/data",
     Settings(infeasibility_threshold=0.01), (int(Status.SOLVED),)),
    ("netlib_infeasible", DATA + "/netlib/infeas",
     Settings(infeasibility_threshold=0.01),
     (int(Status.PRIMAL_INFEASIBLE), int(Status.DUAL_INFEASIBLE))),
]


def main():
    max_n = None
    resume = "--resume" in sys.argv
    if "--max-n" in sys.argv:
        max_n = int(sys.argv[sys.argv.index("--max-n") + 1])

    report = {"suites": {}, "meta": {
        "solver": "piqp_tpu host sparse backend (hostsparse.py)",
        "settings": "defaults (eps_abs 1e-8, eps_rel 1e-9); "
                    "netlib: infeasibility_threshold 0.01",
    }}
    if resume and os.path.exists(OUT):
        with open(OUT) as f:
            report = json.load(f)

    for suite, directory, settings, want in SUITES:
        rows = report["suites"].setdefault(suite, {})
        names = sorted(
            os.path.basename(f)[:-4] for f in glob.glob(directory + "/*.mat")
        )
        for name in names:
            if resume and name in rows and "error" not in rows[name]:
                continue
            prob = load_mat(os.path.join(directory, name + ".mat"),
                            sparse=True)
            n = prob["P"].shape[0]
            if max_n is not None and n > max_n:
                continue
            t0 = time.perf_counter()
            try:
                res = solve_sparse_host(**prob, settings=settings)
                dt = time.perf_counter() - t0
                row = dict(
                    n=int(n), status=int(res.info.status),
                    iters=int(res.info.iter), wall_s=round(dt, 2),
                    ok=bool(int(res.info.status) in want),
                )
            except Exception as e:  # record, keep going
                row = dict(n=int(n), error=str(e)[:200],
                           wall_s=round(time.perf_counter() - t0, 2),
                           ok=False)
            rows[name] = row
            print(json.dumps({"suite": suite, "name": name, **row}),
                  flush=True)
            with open(OUT, "w") as f:
                json.dump(report, f, indent=1, sort_keys=True)

    # summary
    summary = {}
    for suite in report["suites"]:
        rows = report["suites"][suite]
        summary[suite] = dict(
            total=len(rows),
            ok=sum(1 for r in rows.values() if r.get("ok")),
            total_wall_s=round(sum(r.get("wall_s", 0)
                                   for r in rows.values()), 1),
            slowest=sorted(
                ((r.get("wall_s", 0), k) for k, r in rows.items()),
                reverse=True,
            )[:5],
        )
    report["summary"] = summary
    with open(OUT, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
